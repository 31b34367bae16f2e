"""Times kernels K1 and K4 at the shapes of their rows in PERF.md, with K3
as a control, from one or more trees of this repository, in turns.

K1 (prefill attention), bf16, H heads of 64: the self form (causal, a
left-pad key mask, q, k and v column slices of one fused [B, L, 3D]
projection) and the cross form (a ragged caption mask, q the same slice,
k and v column slices of a fused [B, Lk, 2D] one) at gpt2 (B = 256, L =
128, 12 heads, Lk = 32) and at gpt2-large's width (B = 64, 20 heads), the
cross form at Lq = 512 (B = 64, 12 heads); as readings on K1's cross form
at D = 1,280, the same with contiguous operands and with no mask. Beside
each, one scaled_dot_product_attention call on the same head views with
the form's masks as one boolean mask. K4 (the fused LN2 + MLP decode
tail), bf16, F = 4D: gpt2 at B = 256 and the beam path's 64 rows,
gpt2-large's F = 5,120 and Cerebras-GPT-2.7B's F = 10,240 at B = 64, and
the tensor-parallel form at 32 rows over 1,536 of gpt2's columns; the
host's wall time per call of calls issued behind ~100 ms of device work
(the host's cost alone: no call waits on the device), of a loop of calls
ended by one synchronise, and of calls each synchronised (the least of
five loops of 200 each). K3 (the fused
cross-attention decode sublayer) at gpt2, B = 256, the control that must
not move. Every kernel's plain version is timed beside it; K1's and K4's
kernels' device durations by torch.profiler. Each time is the median of
CUDA-event readings of single calls queued behind ~50 ms of device work,
so that the events bracket device time (``chip_smoke.py``'s
``_median_ms``).

Run on a machine with a CUDA GPU, from the repository root:

    python3 scripts/k1_k4_times.py [--trees=DIR[,DIR]] [--host=ROUNDS]

Each tree (default: this one) is a directory holding an ``ergm_tpu_torch``
package; its kernels are built into its own ``ergm_tpu_torch/_build`` and
timed in a process of its own. With two trees A and B the runs go A, B, B,
A and the script prints each reading, each tree's better run, and B's time
over A's per reading. Each tree's compiler report (registers and spills)
of the bf16 kernels of ``prefill_attention.cu`` and ``fused_decode.cu`` is
printed once, and each line of the output names the card and its power
limit. ``--host=N`` times only K4's host readings, N rounds of the trees
in turn (A B A B ...), and prints each tree's least and median.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K1: (label, B, heads, L, Lk, causal)
K1_SHAPES = (("gpt2 self", 256, 12, 128, 128, True), ("gpt2 cross", 256, 12, 128, 32, False),
             ("D1280 self", 64, 20, 128, 128, True), ("D1280 cross", 64, 20, 128, 32, False),
             ("Lq512 cross", 64, 12, 512, 32, False))
# K4: (label, B, D, F local, partial form)
K4_SHAPES = (("gpt2 B256", 256, 768, 3072, False), ("gpt2 B64", 64, 768, 3072, False),
             ("D1280 B64", 64, 1280, 5120, False), ("D2560 B64", 64, 2560, 10240, False),
             ("tp 32x1536", 32, 768, 1536, True))
HOST_CALLS, HOST_REPS = 200, 5


def _child(tree: str, host_only: bool = False) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ergm_tpu_torch.core.config import ModelConfig
    from ergm_tpu_torch.models import gpt2
    from ergm_tpu_torch.ops import _build, cross_decode, fused_decode, prefill_attention

    root = os.path.realpath(os.path.abspath(tree))
    if not os.path.realpath(prefill_attention.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {prefill_attention.__file__}, not the tree {root}")
    _build.load()
    dev = "cuda"

    def median_ms(fn, reps: int = 20) -> float:
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

    def durations(fn, calls: int = 5) -> list:
        """Each kernel's device duration (us) of one call, medians over
        ``calls`` calls; one unread call first (the profiler may miss it)."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        per = len(evs) // (calls + 1)
        evs = evs[-per * calls:]
        return [float(np.median([evs[c * per + i].time_range.elapsed_us() for c in range(calls)]))
                for i in range(per)]

    def host_us(fn) -> tuple:
        """Host wall per call, the least of HOST_REPS loops: calls issued
        behind ~100 ms of device work (so none waits on the device), a
        loop of calls ended by one synchronise, and calls each followed by
        one (the host's clock varies more than the device's: its cores are
        shared)."""
        fn()
        torch.cuda.synchronize()
        issue = loop = each = float("inf")
        for _ in range(HOST_REPS):
            torch.cuda._sleep(200_000_000)
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            issue = min(issue, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            loop = min(loop, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
                torch.cuda.synchronize()
            each = min(each, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
        return issue, loop, each

    def block(D: int, seed: int):
        cfg = ModelConfig.from_model_type("gpt2", n_embd=D, n_head=D // 64, vocab_size=64,
                                          n_positions=16, dtype="bfloat16", n_layer=1)
        blk = gpt2.Block(cfg, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in blk.named_parameters():
                x = torch.randn(p.shape, generator=g, device=dev)
                p.copy_(1.0 + 0.1 * x if name.endswith("scale") else 0.02 * x)
        return cfg, blk.to(torch.bfloat16).requires_grad_(False)

    gen = torch.Generator(device=dev).manual_seed(0)
    out, dur, host = {}, {}, {}
    for label, B, H, L, Lk, causal in () if host_only else K1_SHAPES:
        D = H * 64
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).bfloat16()
        kv = torch.randn((B, Lk, 2 * D), generator=gen, device=dev).bfloat16()
        q = qkv[..., :D]
        k, v = (qkv[..., D:2 * D], qkv[..., 2 * D:]) if causal else kv.split(D, dim=-1)
        if causal:
            lens = torch.randint(L // 2, L + 1, (B,), generator=gen, device=dev)
            m = (torch.arange(L, device=dev)[None] >= L - lens[:, None]).float()
        else:
            lens = torch.randint(1, Lk + 1, (B,), generator=gen, device=dev)
            m = (torch.arange(Lk, device=dev)[None] < lens[:, None]).float()
        cases = {label: (q, k, v, m)}
        if label == "D1280 cross":  # readings for the cross form's time at this width
            cases[f"{label} contiguous"] = (q.contiguous(), k.contiguous(), v.contiguous(), m)
            cases[f"{label} no mask"] = (q, k, v, None)
        for name, (qq, kk, vv, mm) in cases.items():
            run = lambda: prefill_attention.prefill_mha(  # noqa: E731
                qq, kk, vv, mm, n_head=H, scale=0.125, causal=causal)
            out[f"K1 {name}"] = median_ms(run)
            out[f"K1 plain {name}"] = median_ms(lambda: prefill_attention.prefill_mha_reference(
                qq, kk, vv, mm, n_head=H, scale=0.125, causal=causal), 5)
            heads = [x.view(B, -1, H, 64).transpose(1, 2) for x in (qq, kk, vv)]
            allowed = (mm if mm is not None else torch.ones((B, Lk), device=dev))[:, None, None] > 0
            if causal:
                allowed = allowed & torch.ones(L, Lk, dtype=torch.bool, device=dev).tril()
            out[f"SDPA {name}"] = median_ms(lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=allowed, scale=0.125))
            dur[f"K1 {name}"] = durations(run)
        del qkv, kv, q, k, v
    for label, B, D, Fl, partial in K4_SHAPES:
        cfg, blk = block(D, 1)
        ln, mlp = blk.ln_2, blk.mlp
        if partial:
            mlp = gpt2.MLP(D, Fl).to(dev)
            g = torch.Generator(device=dev).manual_seed(2)
            with torch.no_grad():
                for p in mlp.parameters():
                    p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
            mlp = mlp.to(torch.bfloat16).requires_grad_(False)
        h = torch.randn((B, 1, D), generator=gen, device=dev).bfloat16()
        if partial:
            run = lambda: fused_decode.fused_ln_mlp_partial(h, ln, mlp, cfg)  # noqa: E731
            plain = lambda: fused_decode.fused_ln_mlp_partial_reference(h, ln, mlp, cfg)  # noqa
        else:
            run = lambda: fused_decode.fused_ln_mlp(h, ln, mlp, cfg)  # noqa: E731
            plain = lambda: fused_decode.fused_ln_mlp_reference(h, ln, mlp, cfg)  # noqa: E731
        host[f"K4 {label}"] = host_us(run)
        if host_only:
            continue
        out[f"K4 {label}"] = median_ms(run)
        out[f"K4 plain {label}"] = median_ms(plain)
        dur[f"K4 {label}"] = durations(run)
        del blk, mlp, h
        torch.cuda.empty_cache()
    if host_only:
        return {"host_us": host, "card": torch.cuda.get_device_name(0)}
    # the control: K3 at gpt2, B = 256, over a 32-token int8 caption cache
    cfg, blk = block(768, 3)
    B, Lc, D, H = 256, 32, 768, 12
    h = torch.randn((B, 1, D), generator=gen, device=dev).bfloat16()
    codes = [torch.randint(-127, 128, (2, B, Lc, D), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [0.001 + 0.02 * torch.rand((2, B, Lc, H), generator=gen, device=dev)
              for _ in range(2)]
    lens = torch.randint(1, Lc + 1, (B,), generator=gen, device=dev)
    cmask = (torch.arange(Lc, device=dev)[None] < lens[:, None]).float()
    stacks = (*codes, *scales)
    out["K3 gpt2 B256"] = median_ms(
        lambda: cross_decode.fused_cross_decode(h, blk, 1, 0.125, stacks, cmask, cfg))
    out["K3 plain gpt2 B256"] = median_ms(
        lambda: cross_decode.fused_cross_decode_reference(h, blk, 1, 0.125, stacks, cmask, cfg))
    return {"ms": out, "durations_us": dur, "host_us": host,
            "card": torch.cuda.get_device_name(0),
            "log": _build.library_path().with_suffix(".log").read_text()}


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def _host_rounds(trees: list, rounds: int) -> None:
    """K4's host times alone, ``rounds`` times over the trees in turn (A B
    A B ...: a process each); prints each reading, then for each tree and
    shape the least and the median over the rounds of each reading."""
    import statistics

    smi = _smi()
    runs = {t: [] for t in trees}
    for _ in range(rounds):
        for tree in trees:
            res = subprocess.run([sys.executable, os.path.abspath(__file__), f"--child={tree}",
                                  "--host=1"], capture_output=True, text=True, check=True)
            reading = json.loads(res.stdout.strip().splitlines()[-1])["host_us"]
            runs[tree].append(reading)
            print(f"[{smi}] {tree} host us a call (issued behind device work, loop, each "
                  f"synchronised): {json.dumps(reading)}", flush=True)
    summary = {t: {k: {"least": [min(r[k][i] for r in rs) for i in range(3)],
                       "median": [statistics.median(r[k][i] for r in rs) for i in range(3)]}
                   for k in rs[0]} for t, rs in runs.items()}
    print(json.dumps({"power": smi, "rounds": rounds, "host_us": summary}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", default=".")
    ap.add_argument("--host", type=int, default=0,
                    help="only K4's host times, in this many rounds of the trees in turn")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(_child(args.child, args.host > 0)))
        return
    trees = args.trees.split(",")
    if args.host:
        _host_rounds(trees, args.host)
        return
    order = trees if len(trees) == 1 else [trees[0], *trees[1:], *trees[1:][::-1], trees[0]]
    smi = _smi()
    print(smi)
    sys.path.insert(0, ROOT)
    from ergm_tpu_torch.ops import _build

    runs = {t: [] for t in trees}
    for tree in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), f"--child={tree}"],
                             capture_output=True, text=True, check=True)
        reading = json.loads(res.stdout.strip().splitlines()[-1])
        log = reading.pop("log")
        runs[tree].append(reading)
        if len(runs[tree]) == 1:
            ptxas = {**_build.ptxas_report(log, "prefill_attention.cu", r"hop|tc"),
                     **_build.ptxas_report(log, "fused_decode.cu", r"wg|dense_tc")}
            print(f"[{smi}] {tree} ptxas: {json.dumps(ptxas)}")
        print(f"[{smi}] {tree}: " + ", ".join(f"{k} {v:.4f} ms"
                                               for k, v in reading["ms"].items()), flush=True)
        print(f"[{smi}] {tree} device durations (us): {json.dumps(reading['durations_us'])}")
        print(f"[{smi}] {tree} host us a call (issued behind device work, loop, each "
              f"synchronised): "
              f"{json.dumps(reading['host_us'])}", flush=True)
    best = {t: {k: min(r["ms"][k] for r in rs) for k in rs[0]["ms"]} for t, rs in runs.items()}
    host = {t: {k: [min(r["host_us"][k][i] for r in rs) for i in range(3)]
                for k in rs[0]["host_us"]} for t, rs in runs.items()}
    print(json.dumps({"power": smi, "best_ms": best, "best_host_us": host}))
    if len(trees) == 2:
        a, b = trees
        print(f"[{smi}] ratio " + ", ".join(f"{k} {best[b][k] / best[a][k]:.4f}"
                                            for k in best[a] if k in best[b]))


if __name__ == "__main__":
    main()
