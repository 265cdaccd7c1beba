"""Build the package's hand-written CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``denovo_kmer_tpu_torch/_build/lib<name>-<hash>.so`` (the hash is of the source and the
flags, so an edited source rebuilds). Nothing is built at import: the first caller that
launches a kernel triggers the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

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


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, compiled first if it is not built yet."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.tmp{os.getpid()}"
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        lib = _libs[name] = ctypes.CDLL(out)
        return lib
