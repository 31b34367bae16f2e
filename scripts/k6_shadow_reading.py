"""Reads kernel K6's bf16 backward against ``chip_smoke.KernelShadow``'s
bar, call by call, on a longer run than the shadowed one.

``chip_smoke.py`` holds every K5 and K6 launch of a short gpt2-medium
training run through the command line (``CLI_SHADOW_DIALOGUES``
dialogues) against its plain version. This script runs the parallel
phase's bf16 run (``PAR_DIALOGUES`` dialogues, 8 steps of B=8 with
batches up to 512 tokens, in a one-rank NCCL world with ZeRO-1 asked
for) under the same shadow and prints, for each backward launch of K5
and K6, each gradient's shape and ``bf16_grad_ratio`` with its two terms
(whole tensor and worst row; above 1 fails the shadow's bar), and the
shadow's shares. It fails on nothing: it is a reading. Needs one NVIDIA
GPU and nvcc:

    python3 scripts/k6_shadow_reading.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    cs._build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    calls = []
    real = cs.bf16_grad_ratio

    def ratio(got, plain, exact):
        r = real(got, plain, exact)
        g, p, x = got.float(), plain.float(), exact.float()
        ek, ep = g - x, p - x
        whole = ek.pow(2).mean().sqrt() / (2 * ep.pow(2).mean().sqrt()).clamp_min(1e-30)
        rows = ek.pow(2).mean(-1).sqrt() / (2 * ep.pow(2).mean(-1).sqrt()
                                            + 0.1 * x.pow(2).mean().sqrt())
        calls.append((tuple(got.shape), r, whole.item(), rows.max().item()))
        return r

    cs.bf16_grad_ratio = ratio
    with tempfile.TemporaryDirectory() as root:
        cs._cli_data(root)
        argv = ["--mode=train", "--seed=0", f"--data_dir={root}", "--train_prefix=train",
                "--valid_prefix=valid", f"--model_type={cs.CLI_MODEL}", "--lr=1e-5",
                "--warmup_ratio=0.0", f"--batch_size={cs.CLI_B}", "--num_epochs=1",
                "--max_len=1024", "--output_dir=", f"--limit={cs.PAR_DIALOGUES}",
                "--dtype=bfloat16", f"--ckpt_dir={root}/ckpt", "--shard_opt_state"]
        shadow = cs.KernelShadow(cs.TRAIN_SHADOWED, cs.KernelShadow.BACKWARD)
        run = cs._par_cli(argv, 1, shadow)
    print(f"{len(run['losses'])} steps, losses {run['losses']}")
    print(f"shares (above 1 fails the shadow's bar): {shadow.shares()}")
    for shape, r, whole, row in calls:
        kernel = "K6" if shape[-1] != 64 else "K5"
        print(f"{kernel} backward gradient {shape}: ratio {r:.4f} (whole tensor {whole:.4f}, "
              f"worst row {row:.4f})")


if __name__ == "__main__":
    try:
        main()
    finally:
        cs.stop_processes()
