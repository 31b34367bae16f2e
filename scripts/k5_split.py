"""Splits the time of K5's bf16 kernels (``csrc/block_attention.cu``,
namespace ``blk``) between their streamed loads and their products, and
times them on the other grid.

Builds three copies of the kernels beside the checkout's, into the
git-ignored ``ergm_tpu_torch/_build/k5split/``: ``grid`` runs each kernel
on the grid the checkout does not give it (one CTA an item where the
checkout has one CTA an SM walk the items, and the other way round);
``loads``
streams every tile through the ring and forms no product; ``products``
forms every product on the first two tiles of the ring and streams no
further tile (so its values are junk). Each kernel's device time
(torch.profiler, the mean over 10 forward + backward calls of
``block_attention.block_mha``) at bf16 [48, 768 / Dh, 512, Dh], causal,
dropout 0.1 (the training slice's configuration), for Dh = 32, 64, 96 and
128, in each build. Where the full kernel's time is near ``products``'
the products and the work between them set its pace; near ``loads'``, the
streaming does.

Run on a machine with a CUDA GPU, from the repository root:

    python3 scripts/k5_split.py
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "ergm_tpu_torch" / "_build" / "k5split"
HEADS = (32, 64, 96, 128)
B, L = 48, 512
GRID = "constexpr bool kWalks = C == 1;"
EMPTY = "        mbar_wait(bar.empty + s, ((it / kStages) + 1) & 1);"
FULL = "      mbar_wait(bar.full + s, (it / kStages) & 1);"
PRODUCTS = [(EMPTY, "        if (it >= kStages) continue;\n" + EMPTY),
            (FULL, "      if (it < kStages) mbar_wait(bar.full + s, 0);")]
# (kernel, {variant: [(old, new), ...]}): the edits of each kernel's body
EDITS = (
    ("fwd_kernel", {"loads": [("      if (k0 < wend) {", "      if (false) {")],
                    "products": PRODUCTS}),
    ("bwd_dq_kernel", {"loads": [("      if (k0 < wend) {", "      if (false) {")],
                       "products": PRODUCTS}),
    ("bwd_dkdv_kernel", {"loads": [("      float x[QT / 8][4], dp[QT / 8][4];",
                                    "      if (lane == 0) mbar_arrive(bar.empty + s);\n"
                                    "      continue;\n      float x[QT / 8][4], dp[QT / 8][4];")],
                         "products": PRODUCTS}),
)


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"k5_split: the kernels changed, {text.count(old)} of {old!r}")
    return text.replace(old, new, 1)


def _variants() -> dict:
    """{variant: source of block_attention.cu} for ``grid``, ``loads`` and
    ``products``, from the checkout's source: each kernel's body (from its
    name to the next kernel's) edited apart."""
    text = (ROOT / "ergm_tpu_torch" / "csrc" / "block_attention.cu").read_text()
    start, end = text.index("namespace blk {"), text.index("}  // namespace blk")
    body = text[start:end]
    marks = sorted((body.index(f"\n    {name}("), name) for name, _ in EDITS)
    marks.append((body.index("// The CTAs of a grid over"), None))
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
    out["grid"] = _replace(text, GRID, GRID.replace("==", "!="))
    return out


def _child(variant: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ergm_tpu_torch.ops import _build, block_attention

    if variant != "kernels":
        _build.CSRC, _build.BUILD = OUT / variant / "csrc", OUT / variant / "build"
    _build.load()
    for dh in HEADS:
        h = 768 // dh
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((B, h, L, dh), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        kw = dict(causal=True, scale=dh ** -0.5, dropout_rate=0.1, dropout_seed=1234)
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def step():
            o = block_attention.block_mha(*xs, **kw)
            torch.autograd.grad(o, xs, do)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "blk::" in e.key:
                name = e.key.split("blk::")[1].split("<")[0]
                print(f"{variant} Dh={dh} [{B}, {h}, {L}] {name}: "
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
    for variant in ("kernels", "grid", "loads", "products"):
        subprocess.run([sys.executable, os.path.abspath(__file__), variant], check=True)


if __name__ == "__main__":
    main()
