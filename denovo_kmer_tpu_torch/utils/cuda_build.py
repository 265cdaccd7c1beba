"""Build the package's hand-written CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``denovo_kmer_tpu_torch/_build/lib<name>-<hash>.so`` (the hash is of the source and the
flags, so an edited source rebuilds). Nothing is built at import: the first caller that
launches a kernel triggers the build. ``load_all`` starts one ``nvcc`` for each source at
once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
                           "denovo_kmer_tpu_torch/csrc at first use")
    return found


def _library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """The shared libraries of ``csrc/<name>.cu`` for each name; the missing ones are
    compiled first, all ``nvcc`` processes started together."""
    with _lock:
        todo = {n: _library_path(n) for n in names if n not in _libs}
        builds = {}
        for name, out in todo.items():
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.tmp{os.getpid()}"
                src = os.path.join(CSRC, f"{name}.cu")
                builds[name] = (tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{log}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, out in todo.items():
            _libs[name] = ctypes.CDLL(out)
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, compiled first if it is not built yet."""
    return load_all([name])[name]
