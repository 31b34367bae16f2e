"""Splits the time of K1's and K4's bf16 kernels between their streamed
loads and their products.

Builds copies of the kernels beside the checkout's, into the git-ignored
``ergm_tpu_torch/_build/k1k4split/``: ``loads`` streams every tile and
chunk through the rings and forms no product (K1 stores zeros; K4 still
forms its LayerNorm statistics and runs its epilogue); ``products`` (K4)
streams only the ring's first stages and forms every product on them (so
its values are junk); ``nostats`` (K4) forms no LayerNorm statistics.
Each kernel's device time (torch.profiler, the median over 10 calls) at
``scripts/k1_k4_times.py``'s shapes, in each build. Where the full
kernel's time is near ``products``' the products and the work between
them set its pace; near ``loads``', the streaming does. Also prints how
many CTAs of K4's product the card holds at once in clusters of each
size (1-8) (``fused_decode.capacity``).

Run on a machine with a CUDA GPU, from the repository root:

    python3 scripts/k1_k4_split.py
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "ergm_tpu_torch" / "_build" / "k1k4split"
sys.path.insert(0, str(ROOT / "scripts"))
from k1_k4_times import K1_SHAPES, K4_SHAPES  # noqa: E402

K4_FULL = "    mbar_wait(full + s, (i / ST) & 1);\n"
# {variant: {source: [(old, new), ...]}}
EDITS = {
    "loads": {
        "prefill_attention.cu": [
            ("          if (active && i * KT < wend) scores<KT>(sc[i], qt, kOwn * c, "
             "ring + s * 2 * S::kTile);", ""),
            ("        if (i < n && active && i * KT < wend) {\n          pin(sc[i]);",
             "        if (false) {\n          pin(sc[i]);"),
            ("      if (active) {\n        // the row's max", "      if (false) {\n        // the row's max"),
            ("        if (active && k0 < wend) {", "        if (false) {")],
        "dense_hopper.cuh": [
            (K4_FULL, K4_FULL + "    if (lane == 0) mbar_arrive(empty + s);\n    continue;\n")]},
    "products": {
        "dense_hopper.cuh": [
            ("      for (int i = pre; i < chunks; ++i) {",
             "      for (int i = pre; i < min(chunks, ST); ++i) {"),
            (K4_FULL, "    if (i < ST) mbar_wait(full + s, 0);\n")]},
    "nostats": {
        "dense_hopper.cuh": [
            ("      row_stats(a.h + static_cast<long long>(m0 + r) * a.ldh, a.K, a.eps, mean, "
             "rstd);", "      mean = 0.0f;\n      rstd = 1.0f;")]},
}


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"k1_k4_split: the kernels changed, {text.count(old)} of {old!r}")
    return text.replace(old, new, 1)


def _child(variant: str) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ergm_tpu_torch.core.config import ModelConfig
    from ergm_tpu_torch.models import gpt2
    from ergm_tpu_torch.ops import _build, fused_decode, prefill_attention

    if variant != "kernels":
        _build.CSRC, _build.BUILD = OUT / variant / "csrc", OUT / variant / "build"
    _build.load()
    dev = "cuda"

    def device_us(fn, calls: int = 10) -> list:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        per = len(evs) // (calls + 1)
        evs = evs[-per * calls:]
        return [round(float(np.median([evs[c * per + i].time_range.elapsed_us()
                                        for c in range(calls)])), 3) for i in range(per)]

    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    if variant in ("kernels", "loads"):
        for label, B, H, L, Lk, causal in K1_SHAPES:
            D = H * 64
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).bfloat16()
            kv = torch.randn((B, Lk, 2 * D), generator=gen, device=dev).bfloat16()
            q = qkv[..., :D]
            k, v = (qkv[..., D:2 * D], qkv[..., 2 * D:]) if causal else kv.split(D, dim=-1)
            m = torch.ones((B, Lk), device=dev)
            out[f"K1 {label}"] = device_us(lambda: prefill_attention.prefill_mha(
                q, k, v, m, n_head=H, scale=0.125, causal=causal))
    for label, B, D, Fl, partial in K4_SHAPES:
        cfg = ModelConfig.from_model_type("gpt2", n_embd=D, n_head=D // 64, vocab_size=64,
                                          n_positions=16, dtype="bfloat16", n_layer=1)
        ln, mlp = gpt2.LayerNorm(D, dev), gpt2.MLP(D, Fl, dev)
        with torch.no_grad():
            for p in (*ln.parameters(), *mlp.parameters()):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=dev))
            ln.scale.add_(1.0)
        ln, mlp = ln.to(torch.bfloat16), mlp.to(torch.bfloat16)
        h = torch.randn((B, 1, D), generator=gen, device=dev).bfloat16()
        fn = fused_decode.fused_ln_mlp_partial if partial else fused_decode.fused_ln_mlp
        out[f"K4 {label}"] = device_us(lambda: fn(h, ln, mlp, cfg))
        if variant == "kernels":
            out[f"K4 {label} plans"] = [p._asdict() for p in fused_decode.LAST_PLANS]
        del ln, mlp, h
        torch.cuda.empty_cache()
    if variant == "kernels":
        out["capacity"] = fused_decode.capacity(torch.device(dev))
    print(json.dumps({variant: out}))


def main() -> None:
    if len(sys.argv) > 1:
        _child(sys.argv[1])
        return
    for name, edits in EDITS.items():
        dst = OUT / name / "csrc"
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(ROOT / "ergm_tpu_torch" / "csrc", dst)
        for src, pairs in edits.items():
            text = (dst / src).read_text()
            for old, new in pairs:
                text = _replace(text, old, new)
            (dst / src).write_text(text)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    for variant in ("kernels", *EDITS):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), variant],
                             capture_output=True, text=True, check=True)
        print(f"[{smi}] {res.stdout.strip().splitlines()[-1]}", flush=True)


if __name__ == "__main__":
    main()
