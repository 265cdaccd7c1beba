"""Inputs shared by the port's input tests (tests/test_torch_{cram,regions,sam_remote,
cli_slice}.py), written with the JAX package's writers from a seeded synthetic trio:
coordinate-sorted BAMs with their BAI, reference-based CRAMs with their CRAI (mom CRAM 3.0
rANS 4x8, dad CRAM 3.1 rANS Nx16, child CRAM 3.1 arith), SAM and `.sam.gz` copies, the
reference FASTA with its `.fai`; and a local HTTP server that honours single-range GETs
(tests/test_remote_io.py's handler)."""

import contextlib
import functools
import gzip
import http.server
import os
import shutil
import threading

from denovo_kmer_tpu.io.bai import write_bai
from denovo_kmer_tpu.io.bam import read_bam_records, sort_bam
from denovo_kmer_tpu.io.crai import write_crai
from denovo_kmer_tpu.io.cram import M_ARITH, M_RANS, M_RANSNX16, write_cram
from denovo_kmer_tpu.io.fasta import build_fai
from denovo_kmer_tpu.io.sam import write_sam
from denovo_kmer_tpu.io.synth import TrioSpec, make_trio, write_trio_bams

from test_remote_io import _RangeHandler  # noqa: E402 (single-range GETs, 206)

SAMPLES = ("mom", "dad", "child")
#: (block method, rANS order, CRAM version) of each sample's CRAM
CRAM_CODECS = {"mom": (M_RANS, 1, (3, 0)), "dad": (M_RANSNX16, 1, (3, 1)),
               "child": (M_ARITH, 0, (3, 1))}


def write_inputs(d, spec: TrioSpec = TrioSpec(genome_len=3000, read_len=60, coverage=6.0,
                                              n_denovo_snvs=3, seed=41)) -> dict:
    """Every input format of one trio under ``d``: ``{sample: {"bam", "cram", "sam",
    "sam_gz"}}`` plus ``"reference"`` (FASTA, 70-column lines, with its .fai)."""
    d = str(d)
    trio = make_trio(spec)
    raw = write_trio_bams(trio, os.path.join(d, "raw"))
    ref_fa = os.path.join(d, "ref.fa")
    with open(ref_fa, "w") as f:
        f.write(f">{spec.ref_name}\n")
        for i in range(0, len(trio.reference), 70):
            f.write(trio.reference[i:i + 70] + "\n")
    build_fai(ref_fa)
    header = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{spec.ref_name}\tLN:{len(trio.reference)}\n"
    out = {"reference": ref_fa}
    for s in SAMPLES:
        bam = sort_bam(raw[s], os.path.join(d, f"{s}.bam"))
        write_bai(bam)
        recs = list(read_bam_records(bam))
        cram = os.path.join(d, f"{s}.cram")
        method, order, version = CRAM_CODECS[s]
        write_cram(cram, [], mapped=[(r.seq, r.pos + 1, r.flag, r.qual) for r in recs],
                   reference=trio.reference, method=method, rans_order=order,
                   version=version, reads_per_container=100, sam_header=header)
        write_crai(cram)
        sam = write_sam(os.path.join(d, f"{s}.sam"), recs,
                        references=[(spec.ref_name, len(trio.reference))])
        with open(sam, "rb") as src, gzip.open(sam + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        out[s] = {"bam": bam, "cram": cram, "sam": sam, "sam_gz": sam + ".gz"}
    return out


@contextlib.contextmanager
def serve(directory, handler=_RangeHandler):
    """Serve ``directory`` on 127.0.0.1 from a thread; yields the base URL."""
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(handler, directory=str(directory)))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
