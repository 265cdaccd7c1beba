"""The benchmark of ``denovo_kmer_tpu_torch``, the port on the CUDA card.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``control.py`` runs the correctness
check's control; ``tests/`` holds the harness's own tests (``python -m pytest gpubench/tests``).
"""
