"""Build the package's CUDA sources (csrc/*.cu) with nvcc at first use.

Each source compiles on its own into a shared library with a plain C
interface, for sm_90a (Hopper), and is loaded with ctypes, as the JAX
package loads its native AES and codec shims.  The library lands in the
package's `_build/` directory, named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one is reused; ptxas's report
of each kernel's registers, spills and shared memory is kept beside it
(`ptxas_report`).  Nothing here runs at import time: a CPU-only machine
never reaches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

from .utils import prof

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# the tracer's counter of each source's nvcc runs and library loads, by
# the kernel's name: K1 (csrc/viterbi_acs.cu), K2 (csrc/resample_k2.cu)
_COUNTER = {"viterbi_acs": "build.k1", "resample_k2": "build.k2"}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None:
        # PyTorch's own search: $CUDA_HOME, then the toolkit's usual home
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin",
                                                     "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "audiowmark_tpu_torch need the CUDA toolkit")
    return path


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; returns the path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR,
                       "lib%s-%s.so" % (name, digest.hexdigest()[:16]))
    if os.path.exists(out):
        return out
    prof.count(_COUNTER[name])
    nvcc = nvcc_path()            # raises before any file is made
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed on csrc/%s.cu (exit %d):\n%s%s"
                           % (name, proc.returncode, proc.stdout,
                              proc.stderr))
    with open(out + ".log", "w") as f:       # ptxas: registers, spills
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return out


def ptxas_report(name: str) -> str:
    """What ptxas said of csrc/<name>.cu's kernels when it was built."""
    with open(build(name) + ".log") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build(name)
        prof.count(_COUNTER[name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
