"""Builds the port's CUDA kernels at first use.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. No PyTorch header is included, so a build takes seconds. The
library's name carries a hash of the sources (``*.cu`` and the ``*.cuh``
headers they include) and the flags: an edited source builds anew, an
unchanged tree reuses the file. It goes into ``ergm_tpu_torch/_build/``,
which git ignores; the compiler's report (registers, shared memory,
spills) is kept beside it as a ``.log``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

import torch

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD / f"libergm_kernels_{digest.hexdigest()[:16]}.so"


def _compile(work: pathlib.Path, lib_path: pathlib.Path) -> None:
    """Compile each source in its own ``nvcc``, all at once, then link."""
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    report, failed = [], []
    with contextlib.ExitStack() as stack:
        jobs = []
        for src in sources:
            log = stack.enter_context(open(work / f"{src.stem}.log", "w+"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(work / f"{src.stem}.o")]
            jobs.append((src, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        for src, log, proc in jobs:
            proc.wait()
            log.seek(0)
            text = log.read()
            report.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(f"{src.name} ({proc.returncode}):\n{text[:3000]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = work / "lib.so"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(work / f"{src.stem}.o") for src in sources)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    lib_path.with_suffix(".log").write_text("".join(report) + link.stdout + link.stderr)
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD) as work:
            _compile(pathlib.Path(work), lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    u, strides = ctypes.c_uint, ctypes.POINTER(ctypes.c_longlong)
    signatures = {
        "ergm_prefill_mha": [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, i, i, p, p],
        "ergm_fused_ln_mlp": [p, i, p, p, f, p, p, p, p, p, p, i, i, i, i, i, i, p, p, p],
        "ergm_fused_ln_mlp_clusters": [i, p],
        "ergm_fused_cross_decode": [p, i, p, p, f, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                    i, i, i, f, p, p],
        "ergm_decode_mha_int8": [p, ll, ll, p, p, p, p, p, ll, p, i, i, i, i, i, i, f, i, p],
        "ergm_block_mha_fwd": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides, f, i, i, f,
                               f, u, u, i, p],
        "ergm_block_mha_bwd": [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides,
                               f, i, i, f, f, u, u, i, p],
        "ergm_flash_mha_fwd": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides, f, i, p],
        "ergm_flash_mha_bwd": [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides,
                               f, i, p],
        "ergm_xent_fwd": [p, p, p, p, p, p, i, i, i, i, p],
        "ergm_xent_bwd_f32": [p, p, p, p, p, p, i, i, i, i, p],
        "ergm_xent_bwd_chunk": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, i
    return lib


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (the kernels' grids
    plan one CTA an SM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_aligned(kernel: str, tensors: dict, row_stride: int) -> None:
    """The decode GEMM's bf16 loads are 16-byte copies: each tensor must
    start on a 16-byte boundary and rows of ``row_stride`` elements keep
    that. Raises ValueError otherwise."""
    for name, x in tensors.items():
        if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or row_stride % 8):
            raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary with a row "
                             f"stride that is a multiple of 8 elements")


def build_log() -> str:
    """The compiler's report for the current library ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_report(log: str, source: str, pattern: str) -> dict:
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"}
    from a build's compiler report (``build_log()``), for the kernels of
    ``source`` (a ``csrc`` file name) whose mangled names match
    ``pattern``; {} where the report has no such source."""
    if f"== {source}" not in log:
        return {}
    section = log.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
    out, name = {}, None
    for line in section.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1) if re.search(pattern, m.group(1)) else None
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name] = f"{m.group(1)} bytes spill stores, {m.group(2)} bytes spill loads"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out
