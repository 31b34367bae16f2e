"""Splits the time of K7's one-pass kernels (``csrc/block_attention.cu``,
namespace ``flash``) between their streamed loads and their products.

Builds two copies of the kernels beside the checkout's, into the
git-ignored ``ergm_tpu_torch/_build/split/``: ``loads`` streams every
tile through the ring and forms no product; ``products`` forms every
product on the first two tiles of the ring and loads no further tile
(so its values are junk). Each kernel's device time (torch.profiler, the
mean over 10 forward + backward calls of ``flash_attention.flash_mha``)
at bf16 [B, H, 2048, Dh], causal, left pads of 0 and 217 keys (the first
two batch rows; the others none), for Dh = 64 ([8, 12]), 128 ([2, 6]),
256 and 384 ([2, 16]), in each build. Where the full kernel's time is
near ``products``' the products and the work between them set its pace;
near ``loads``', the streaming does.

Run on a machine with a CUDA GPU, from the repository root:

    python3 scripts/k7_split.py
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "ergm_tpu_torch" / "_build" / "split"
HEADS = {64: (8, 12), 128: (2, 6), 256: (2, 16), 384: (2, 16)}  # Dh: (B, H)
L = 2048
PADS = (0, 217)
FIRST = "for (int i = 0; i < min(n, kStages); ++i) {"
# (kernel, {variant: [(old, new), ...]}): the edits of each kernel's body
EDITS = (
    ("fwd_kernel", {
        "loads": [("    if (k0 < wend) {", "    if (false) {")],
        "products": [("      for (int i = 0; i < n; ++i) {\n        const int s = i % kStages;",
                      f"      {FIRST}\n        const int s = i % kStages;"),
                     ("    mbar_wait(full + s, (i / kStages) & 1);\n    if (k0 < wend) {",
                      "    if (i < kStages) mbar_wait(full + s, 0);\n    if (k0 < wend) {")]}),
    ("bwd_dq_kernel", {
        "loads": [("    float sc[KT / 8][4], dp[KT / 8][4];",
                   "    if (false) {\n    float sc[KT / 8][4], dp[KT / 8][4];"),
                  ("    accumulate<S>(acc, sc, kt + grp * S::GB * KT * 64);",
                   "    accumulate<S>(acc, sc, kt + grp * S::GB * KT * 64);\n    }")],
        "products": [("    if (threadIdx.x == 0 && i + kStages < n) issue(i + kStages);", ""),
                     ("    mbar_wait(full + s, (i / kStages) & 1);\n    float sc",
                      "    if (i < kStages) mbar_wait(full + s, 0);\n    float sc")]}),
    ("bwd_dkdv_kernel", {
        "loads": [("    float x[KT / 8][4];  // S^T",
                   "    if (lane == 0) mbar_arrive(empty + s);\n    continue;\n"
                   "    float x[KT / 8][4];  // S^T")],
        "products": [("      for (int i = 0; i < n; ++i) {\n        const int s = i % kStages, q0",
                      f"      {FIRST}\n        const int s = i % kStages, q0"),
                     ("    mbar_wait(full + s, (i / kStages) & 1);\n    float x",
                      "    if (i < kStages) mbar_wait(full + s, 0);\n    float x")]}),
    ("bwd_dkdv_pair_kernel", {
        "loads": [("    float x[QT / 8][4], dp[QT / 8][4];",
                   "    if (lane == 0) mbar_arrive(empty + s);\n    continue;\n"
                   "    float x[QT / 8][4], dp[QT / 8][4];")],
        "products": [("      for (int i = 0; i < n; ++i) {\n        const int s = i % kStages, q0",
                      f"      {FIRST}\n        const int s = i % kStages, q0"),
                     ("    mbar_wait(full + s, (i / kStages) & 1);\n    float x",
                      "    if (i < kStages) mbar_wait(full + s, 0);\n    float x")]}),
)


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"k7_split: the kernels changed, {text.count(old)} of {old!r}")
    return text.replace(old, new, 1)


def _variants() -> dict:
    """{variant: source of block_attention.cu} for ``loads`` and
    ``products``, from the checkout's source: each kernel's body (from its
    name to the next kernel's) edited apart."""
    text = (ROOT / "ergm_tpu_torch" / "csrc" / "block_attention.cu").read_text()
    start, end = text.index("namespace flash {"), text.index("}  // namespace flash")
    body = text[start:end]
    marks = sorted((body.index(f"\n    {name}("), name) for name, _ in EDITS)
    marks.append((body.index("// The tensor map of one operand"), None))
    pre, post = body[:marks[0][0]], body[marks[-1][0]:]
    pieces = {marks[i][1]: body[marks[i][0]:marks[i + 1][0]] for i in range(len(marks) - 1)}
    out = {}
    for variant in ("loads", "products"):
        parts = dict(pieces)
        for name, edits in EDITS:
            for old, new in edits[variant]:
                parts[name] = _replace(parts[name], old, new)
        out[variant] = (text[:start] + pre + "".join(parts[m[1]] for m in marks[:-1]) + post
                        + text[end:])
    return out


def _child(variant: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ergm_tpu_torch.ops import _build, flash_attention

    if variant != "kernels":
        _build.CSRC, _build.BUILD = OUT / variant / "csrc", OUT / variant / "build"
    _build.load()
    for dh, (b, h) in HEADS.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((b, h, L, dh), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        pads = torch.zeros((b,), dtype=torch.long, device="cuda")
        pads[:len(PADS)] = torch.tensor(PADS[:b], device="cuda")
        m = (torch.arange(L, device="cuda")[None] >= pads[:, None]).to(torch.int32)
        kw = dict(causal=True, scale=dh ** -0.5, q_mask=m, kv_mask=m)
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def step():
            o = flash_attention.flash_mha(*xs, **kw)
            torch.autograd.grad(o, xs, do)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "flash::" in e.key:
                name = e.key.split("flash::")[1].split("<")[0]
                print(f"{variant} Dh={dh} [{b}, {h}, {L}] {name}: "
                      f"{e.device_time_total / e.count / 1e3:.4f} ms")


def main() -> None:
    if len(sys.argv) > 1:
        _child(sys.argv[1])
        return
    for name, text in _variants().items():
        dst = OUT / name / "csrc"
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(ROOT / "ergm_tpu_torch" / "csrc", dst)
        (dst / "block_attention.cu").write_text(text)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    for variant in ("kernels", "loads", "products"):
        subprocess.run([sys.executable, os.path.abspath(__file__), variant], check=True)


if __name__ == "__main__":
    main()
