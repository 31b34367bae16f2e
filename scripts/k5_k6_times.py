"""Times kernels K5, K7 and K6 at the shapes of their rows in PERF.md,
from one or more trees of this repository, in turns.

K5 (block attention): bf16 [48, H, 512, Dh] with Dh x H = 768 at Dh =
24 (padded to 32 by the wrapper), 32, 64 (the training slice), 96 and
128, causal, dropout 0.1, forward and backward, and one
scaled_dot_product_attention call (causal, dropout 0.1) on the same
tensors. K7 (the shapes of JAX's
library flash kernel): bf16 [B, H, 2048, Dh] at [8, 12, ., 64], [2, 6, .,
128], and [2, 16, ., Dh] for Dh = 100, 256 and 384, causal, left pads
(the first batch row none, the others 217 keys; queries masked as their
keys), forward and backward, and one scaled_dot_product_attention call
(causal, no mask) on the same tensors; through
``ops/flash_attention.py::flash_mha`` where the tree has that module,
else through ``block_attention.block_mha``, which served K7's shapes
before it. K6 (fused cross-entropy):
bf16 forward and backward over GPT-2's vocabulary (50,271 rows) at
gpt2's training shape (N = 24,576, D = 768), gpt2-large's (6,144, 1,280)
and gpt2-xl's (2,048, 1,600), in bf16 and in fp32 (TF32 off; K6's f32
route). Each time is the median of CUDA-event
readings of single calls queued behind ~50 ms of device work, so that
the events bracket device time (``chip_smoke.py``'s ``_median_ms``).

Run on a machine with a CUDA GPU, from the repository root:

    python3 scripts/k5_k6_times.py [--trees=DIR[,DIR]]

Each tree (default: this one) is a directory holding an
``ergm_tpu_torch`` package; its kernels are built into its own
``ergm_tpu_torch/_build`` and timed in a process of its own. With two
trees A and B the runs go A, B, B, A and the script prints each
reading, each tree's better run, and B's time over A's per kernel.
Each tree's compiler report (registers and spills, from the build's
``.log``) for ``fused_ce.cu``'s f32 kernels and the bf16 kernels of
``block_attention.cu`` (K5's ``blk::``, or ``tc::`` in a tree from before
it, and K7's ``flash::`` and ``wide::``) is printed once, with any note of
ptxas that a kernel's wgmma run one at a time for want of registers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# K5's head widths (and heads) at [48, ., 512, .]
K5_HEADS = ((24, 32), (32, 24), (64, 12), (96, 8), (128, 6))
# K7's (batch, heads, head width) at L = 2,048
K7_SHAPES = ((8, 12, 64), (2, 6, 128), (2, 16, 100), (2, 16, 256), (2, 16, 384))
K7_PAD = 217
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K6_SHAPES = {"gpt2": (24576, 768), "gpt2-large": (6144, 1280), "gpt2-xl": (2048, 1600)}
V = 50271


def _child(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from ergm_tpu_torch.ops import _build, block_attention, fused_ce

    root = os.path.realpath(os.path.abspath(tree))
    if not os.path.realpath(block_attention.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {block_attention.__file__}, not the tree {root}")
    try:
        from ergm_tpu_torch.ops import flash_attention
        k7 = flash_attention.flash_mha
    except ImportError:  # a tree from before the port of ops/flash_attention.py
        k7 = block_attention.block_mha
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False

    def median_ms(fn, reps: int) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dh, heads in K5_HEADS:
        q, k, v, do = (torch.randn((48, heads, 512, dh), generator=gen,
                                   device="cuda").bfloat16() for _ in range(4))
        kw = dict(causal=True, scale=dh ** -0.5, dropout_rate=0.1, dropout_seed=1234)
        sdpa = dict(is_causal=True, scale=dh ** -0.5, dropout_p=0.1)
        out[f"K5 fwd dh{dh}"] = median_ms(lambda: block_attention.block_mha(q, k, v, **kw), 20)
        out[f"SDPA fwd dh{dh} K5"] = median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa), 20)
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = block_attention.block_mha(*xs, **kw)
        out[f"K5 bwd dh{dh}"] = median_ms(
            lambda: torch.autograd.grad(o, xs, do, retain_graph=True), 20)
        o = torch.nn.functional.scaled_dot_product_attention(*xs, **sdpa)
        out[f"SDPA bwd dh{dh} K5"] = median_ms(
            lambda: torch.autograd.grad(o, xs, do, retain_graph=True), 20)
        del q, k, v, do, xs, o
    for b, heads, dh in K7_SHAPES:
        q, k, v, do = (torch.randn((b, heads, 2048, dh), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        pads = torch.full((b,), K7_PAD, device="cuda")
        pads[0] = 0
        m = (torch.arange(2048, device="cuda")[None] >= pads[:, None]).to(torch.int32)
        kw = dict(causal=True, scale=dh ** -0.5, q_mask=m, kv_mask=m)
        out[f"K7 fwd dh{dh}"] = median_ms(lambda: k7(q, k, v, **kw), 10)
        sdpa = dict(is_causal=True, scale=dh ** -0.5)
        out[f"SDPA fwd dh{dh}"] = median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa), 10)
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = k7(*xs, **kw)
        out[f"K7 bwd dh{dh}"] = median_ms(
            lambda: torch.autograd.grad(o, xs, do, retain_graph=True), 10)
        o = torch.nn.functional.scaled_dot_product_attention(*xs, **sdpa)
        out[f"SDPA bwd dh{dh}"] = median_ms(
            lambda: torch.autograd.grad(o, xs, do, retain_graph=True), 10)
        del q, k, v, do, xs, o
        torch.cuda.empty_cache()
    for (model, (n, d)), dtype in ((m, t) for t in (torch.bfloat16, torch.float32)
                                   for m in K6_SHAPES.items()):
        h = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        w = (3.0 / d ** 0.5 * torch.randn((V, d), generator=gen, device="cuda")).to(dtype)
        lbl = torch.randint(0, V, (n,), generator=gen, device="cuda", dtype=torch.int32)
        lbl[::4] = -100
        g = torch.where(lbl >= 0, torch.randn((n,), generator=gen, device="cuda"), 0.0)
        _, logz = fused_ce.launch_fwd(h, w, lbl)
        tag = model if dtype == torch.bfloat16 else f"{model} fp32"
        reps = 5 if dtype == torch.bfloat16 else 3
        out[f"K6 fwd {tag}"] = median_ms(lambda: fused_ce.launch_fwd(h, w, lbl), reps)
        out[f"K6 bwd {tag}"] = median_ms(lambda: fused_ce.launch_bwd(h, w, lbl, logz, g), reps)
        del h, w, lbl, g, logz
        torch.cuda.empty_cache()
    out["card"] = torch.cuda.get_device_name(0)
    out["log"] = _build.library_path().with_suffix(".log").read_text()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", default=".")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(_child(args.child)))
        return
    trees = args.trees.split(",")
    order = trees if len(trees) == 1 else [trees[0], *trees[1:], *trees[1:][::-1], trees[0]]
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    sys.path.insert(0, ROOT)
    from ergm_tpu_torch.ops import _build

    runs = {t: [] for t in trees}
    for tree in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), f"--child={tree}"],
                             capture_output=True, text=True, check=True)
        reading = json.loads(res.stdout.strip().splitlines()[-1])
        log = reading.pop("log")
        reading["ptxas"] = {**_build.ptxas_report(log, "fused_ce.cu", "f32"),
                            **_build.ptxas_report(log, "block_attention.cu",
                                                  r"blk|wide|flash|tc")}
        runs[tree].append(reading)
        if len(runs[tree]) == 1:
            print(f"{tree} ptxas: {json.dumps(reading['ptxas'])}")
            # ptxas's notes that a kernel's wgmma run one at a time for want of registers
            for line in log.splitlines():
                if "C7512" in line:
                    print(f"{tree} ptxas: {line.strip()}")
        print(f"{tree}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in reading.items()
                                      if k not in ("card", "ptxas")), flush=True)
    best = {t: {k: min(r[k] for r in rs) for k in rs[0] if k not in ("card", "ptxas")}
            for t, rs in runs.items()}
    print(json.dumps({"power": smi, "best_ms": best}))
    if len(trees) == 2:
        a, b = trees
        print("ratio " + ", ".join(f"{k} {best[b][k] / best[a][k]:.4f}" for k in best[a]))


if __name__ == "__main__":
    main()
