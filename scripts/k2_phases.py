"""Where the time of kernel K2 (int8 decode attention) goes, phase by phase.

Builds the port's CUDA kernels with ``-DERGM_K2_PHASES`` (into
``ergm_tpu_torch/_build/phases/``, beside the normal build), so that thread 0
of each CTA of ``decode_kernel`` stamps ``clock64`` at the kernel's phase
boundaries and ``%globaltimer`` at its start and end; runs K2 in bf16 at the
shapes of ``chip_smoke.K2_SHAPES`` (the planned cluster size, then the ones
given with ``--cluster``); and prints, per shape, the span of the grid, the
median life of a CTA, the spread of the CTAs' starts, and the median of each
phase in cycles and in microseconds. Needs one NVIDIA GPU and nvcc:

    python3 scripts/k2_phases.py [--cluster=C ...]
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ergm_tpu_torch.ops import _build, decode_attention  # noqa: E402

CTAS, PHASES = 8192, 9  # kPhaseCtas, kPhases in csrc/decode_attention.cu
NAMES = ("requests and scales", "K landed", "QK", "softmax", "exchange", "p and V landed", "PV",
         "output")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_phases.py needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DERGM_K2_PHASES")
    _build.BUILD = _build.BUILD / "phases"
    lib = _build.load()
    lib.ergm_decode_phases.argtypes = [ctypes.c_void_p]
    lib.ergm_decode_phases.restype = ctypes.c_int
    clusters = [int(a.split("=", 1)[1]) for a in sys.argv[1:] if a.startswith("--cluster=")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = np.zeros(CTAS * (PHASES + 2), dtype=np.int64)
    for label, (b, h, t, index) in chip_smoke.K2_SHAPES.items():
        args = chip_smoke._k2_case(gen, b, h, t, index, torch.bfloat16)[0]
        for c in [decode_attention.plan(b, h, t, index,
                                        torch.cuda.get_device_properties(0).multi_processor_count),
                  *clusters]:
            if decode_attention.slice_keys(t, index, c) > decode_attention.MAX_KEYS:
                continue
            for _ in range(3):
                decode_attention.decode_mha_int8(*args, n_head=h, cluster=c)
            torch.cuda.synchronize()
            buf[:] = 0
            if lib.ergm_decode_phases(buf.ctypes.data):
                raise RuntimeError("reading the phase stamps failed")
            st = buf.reshape(CTAS, PHASES + 2)[:min(CTAS, b * h * c)]
            clock, start, end = st[:, :PHASES], st[:, PHASES], st[:, PHASES + 1]
            ns_per_cycle = np.median((end - start) / (clock[:, -1] - clock[:, 0]))
            cycles = np.median(np.diff(clock, axis=1), axis=0)
            print(f"{label} B={b} T={t} index {index}, cluster {c}, {len(st)} CTAs: grid span "
                  f"{(end.max() - start.min()) / 1e3:.2f} us, CTA life "
                  f"{np.median(end - start) / 1e3:.2f} us, starts spread over "
                  f"{(start.max() - start.min()) / 1e3:.2f} us")
            print("  " + ", ".join(f"{n} {cy:.0f} cycles ({cy * ns_per_cycle / 1e3:.2f} us)"
                                   for n, cy in zip(NAMES, cycles)))


if __name__ == "__main__":
    main()
