"""Builds the port's CUDA kernels at first use.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. No
PyTorch header is included, so a build takes seconds. The library's
name carries a hash of the sources and the flags: an edited source
builds anew, an unchanged tree reuses the file. It goes into
``ergm_tpu_torch/_build/``, which git ignores; the compiler's report
(registers, shared memory, spills) is kept beside it as a ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD / f"libergm_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ergm_prefill_mha.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                                     ctypes.c_float, i, p]
    lib.ergm_prefill_mha.restype = i
    return lib


def build_log() -> str:
    """The compiler's report for the current library ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""
