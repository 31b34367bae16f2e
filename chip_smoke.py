"""Drive the PyTorch port's serving path once on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build: compile the port's CUDA kernels from ``ergm_tpu_torch/csrc``.
2. kernel: K1 (prefill attention) against its plain PyTorch version at
   the slice's shapes, causal [256, 128, 768] with and without a
   left-pad mask and cross q [256, 128, 768] over k/v [256, 32, 768]
   with a ragged caption mask, in bf16 (within 2e-2: output rounding
   plus summation order) and fp32 (within 2e-5, TF32 off); median
   times of both from CUDA events.
3. decode kernels: K3 (fused cross sublayer, B=256 over a 32-token int8
   caption cache with a ragged mask), K4 (fused LN2 + MLP, B=256,
   D=768, F=3072) and K2 (int8 decode attention, B=64, T=512, index
   400, left-pad mask) against their plain versions, fp32 with TF32 off
   (within 2e-4, 2e-5 and 3e-4) and bf16 (|kernel - plain| <= 2e-2 +
   1e-2 |plain|); median times of both from CUDA events.
4. reference: a small fp32 model on the card against the same model on
   the CPU (plain versions), prefill and decode logits within 1e-3:
   once with the decode switches off, and once with all three on
   (``ERGM_CROSS_KERNEL=1``, ``ERGM_DECODE_KERNEL=1``,
   ``decode_fused_mlp``) over a 512-slot cache, where K2, K3 and K4
   must each launch on the card.
5. slice: gpt2 at full width, random weights from seed 0, int8 KV and
   cross caches, int8 lm_head, bf16: ``generate`` at B=256 (128-token
   prompt, 128 new tokens, 32-token caption, image and audio features,
   top-p 0.8) with the switches off and with ``ERGM_CROSS_KERNEL=1``
   and ``decode_fused_mlp`` on, timed in turns (off, on, on, off); then
   ``generate_batch`` over 64 ragged greedy requests. K1 must launch
   2 x n_layer times per prefill, K3 and K4 n_layer times per decode
   step with the switches on.
6. long history: gpt2 at full width, B=64, a 384-token prompt, 128 new
   tokens in a 512-slot cache, with ``ERGM_DECODE_KERNEL=1`` and
   without, timed in turns; K2 must launch n_layer times per decode
   step.

Prints the card's name and power limit, a JSON line with each kernel's
numbers, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero without a GPU.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import time

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer.generate import generate, generate_batch
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.ops import (_build, cross_decode, decode_attention, fused_decode,
                                prefill_attention)

DEVICE = "cuda"
B, PROMPT, NEW, CAPTION, D, H = 256, 128, 128, 32, 768, 12
EOS, SP2 = 50256, 50258
# the headline serving configuration of bench.py:101-104
SLICE = dict(model_type="gpt2", vocab_size=50271, dtype="bfloat16", modality_dim=768,
             kv_cache_dtype="int8", weight_dtype="int8_lm_head", cross_kv_dtype="int8")
BF16_TOL, F32_TOL = 2e-2, 2e-5
# the decode kernels' fp32 bars (JAX's own tests of K2, K3 and K4)
K2_TOL, K3_TOL, K4_TOL = 3e-4, 2e-4, 2e-5
# the long-history phase: gpt2 at full width over a 512-slot cache
LONG_B, LONG_PROMPT, LONG_MAX = 64, 384, 512
SWITCHES = ("ERGM_CROSS_KERNEL", "ERGM_DECODE_KERNEL")


@contextlib.contextmanager
def switches(*names: str):
    """Sets JAX's decode-kernel switches ``names`` to 1 and the others off
    for the duration."""
    saved = {n: os.environ.pop(n, None) for n in SWITCHES}
    os.environ.update({n: "1" for n in names})
    try:
        yield
    finally:
        for n, v in saved.items():
            os.environ.pop(n, None)
            if v is not None:
                os.environ[n] = v


class StepCounter:
    """Counts the single-token decode steps that ``gpt2.forward`` runs."""

    def __enter__(self):
        self.real, self.steps = gpt2.forward, 0

        def forward(params, config, input_ids, *args, **kwargs):
            if kwargs.get("cache") is not None and input_ids.shape[1] == 1:
                self.steps += 1
            return self.real(params, config, input_ids, *args, **kwargs)
        gpt2.forward = forward
        return self

    def __exit__(self, *exc):
        gpt2.forward = self.real


def reset_launches() -> None:
    for mod in (prefill_attention, cross_decode, fused_decode, decode_attention):
        mod.LAUNCHES = 0


def _bf16_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """One bf16 output rounding plus the summation order."""
    return bool(((got.float() - want.float()).abs()
                 <= BF16_TOL + 1e-2 * want.float().abs()).all())


def _timed_pair(name: str, run, plain) -> tuple:
    """Median CUDA-event times of kernel and plain, in turns (plain,
    kernel, kernel, plain); returns (kernel ms, plain ms)."""
    p1, k1, k2, p2 = (_median_ms(f) for f in (plain, run, run, plain))
    print(f"{name} bf16: kernel {min(k1, k2):.4f} ms, plain {min(p1, p2):.4f} ms "
          f"(medians of 20; runs {k1:.4f}/{k2:.4f} and {p1:.4f}/{p2:.4f})")
    return min(k1, k2), min(p1, p2)


def _median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def kernel_phase(gen: torch.Generator) -> dict:
    """K1 vs plain at the slice's shapes. Returns the numbers for the JSON line."""
    res = {"max_abs_err": 0.0, "max_abs_err_f32": 0.0}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        # the model hands K1 column slices of the fused projections
        qkv = torch.randn((B, PROMPT, 3 * D), generator=gen, device=DEVICE).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        ckv = torch.randn((B, CAPTION, 2 * D), generator=gen, device=DEVICE).to(dtype)
        ck, cv = ckv.split(D, dim=-1)
        lens = torch.randint(PROMPT // 2, PROMPT + 1, (B,), generator=gen, device=DEVICE)
        leftpad = (torch.arange(PROMPT, device=DEVICE)[None] >= PROMPT - lens[:, None]).float()
        clens = torch.randint(1, CAPTION + 1, (B,), generator=gen, device=DEVICE)
        ragged = (torch.arange(CAPTION, device=DEVICE)[None] < clens[:, None]).float()
        cases = {"self": (q, k, v, None, True, 1.0),
                 "self_leftpad": (q, k, v, leftpad, True, leftpad[:, :, None]),
                 "cross": (q.contiguous(), ck, cv, ragged, False, 1.0)}
        for name, (qq, kk, vv, m, causal, rows) in cases.items():
            run = lambda: prefill_attention.prefill_mha(  # noqa: E731
                qq, kk, vv, m, n_head=H, scale=0.125, causal=causal)
            plain = lambda: prefill_attention.prefill_mha_reference(  # noqa: E731
                qq, kk, vv, m, n_head=H, scale=0.125, causal=causal)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = ((got.float() - want.float()) * rows).abs().max().item()
            print(f"K1 {name} {dtype}: max |kernel - plain| = {err:.3e} (tol {tol:g})")
            if not err <= tol:
                raise AssertionError(f"K1 {name} {dtype} disagrees with its plain version: {err}")
            key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
            res[key] = max(res[key], err)
            if dtype == torch.bfloat16 and name != "self":
                # plain, kernel, kernel, plain
                p1, k1, k2, p2 = (_median_ms(f) for f in (plain, run, run, plain))
                kern_ms, plain_ms = min(k1, k2), min(p1, p2)
                print(f"K1 {name} bf16: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms "
                      f"(medians of 20; runs {k1:.4f}/{k2:.4f} and {p1:.4f}/{p2:.4f})")
                prefix = "" if name == "self_leftpad" else "cross_"
                res[f"{prefix}ms"], res[f"{prefix}plain_ms"] = kern_ms, plain_ms
    return res


def _random_block(cfg: ModelConfig, gen: torch.Generator) -> gpt2.Block:
    """A decoder block at the config's width and dtype: N(0, 0.02)
    weights, N(0, 0.02) biases and N(1, 0.1) LayerNorm scales."""
    blk = gpt2.Block(cfg, device=DEVICE)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            x = torch.randn(p.shape, generator=gen, device=DEVICE)
            p.copy_(1.0 + 0.1 * x if name.endswith("scale") else 0.02 * x)
    return blk.to(cfg.compute_dtype).requires_grad_(False)


def decode_kernel_phase(gen: torch.Generator) -> dict:
    """K2, K3 and K4 against their plain versions at the slice's shapes.
    Returns each kernel's numbers for the JSON line."""
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = ModelConfig.from_model_type(**{**SLICE, "dtype": "bfloat16" if dtype == torch.bfloat16
                                              else "float32"})
        blk = _random_block(cfg, gen)
        L, D, Dh = 2, cfg.n_embd, cfg.head_dim
        h = torch.randn((B, 1, D), generator=gen, device=DEVICE).to(dtype)

        # K3: layer 1 of a two-layer stacked int8 caption cache, ragged mask
        codes = [torch.randint(-127, 128, (L, B, CAPTION, D), generator=gen, device=DEVICE,
                               dtype=torch.int8) for _ in range(2)]
        scales = [0.001 + 0.02 * torch.rand((L, B, CAPTION, H), generator=gen, device=DEVICE)
                  for _ in range(2)]
        clens = torch.randint(1, CAPTION + 1, (B,), generator=gen, device=DEVICE)
        cmask = (torch.arange(CAPTION, device=DEVICE)[None] < clens[:, None]).float()
        cmask[5] = 0.0  # a caption-less row
        stacks = (*codes, *scales)
        k3 = (lambda: cross_decode.fused_cross_decode(h, blk, 1, 0.125, stacks, cmask, cfg),
              lambda: cross_decode.fused_cross_decode_reference(h, blk, 1, 0.125, stacks,
                                                                cmask, cfg), K3_TOL)

        # K4: the LN2 + MLP tail at D=768, F=3072
        k4 = (lambda: fused_decode.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg),
              lambda: fused_decode.fused_ln_mlp_reference(h, blk.ln_2, blk.mlp, cfg), K4_TOL)

        # K2: layer 1 of a stacked int8 cache [2, 64, 12, 512, 64], read in
        # place; q a head view of a fused qkv projection; left-pad mask
        T, index = LONG_MAX, 400
        kq, vq = (torch.randint(-127, 128, (L, LONG_B, H, T, Dh), generator=gen, device=DEVICE,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((0.001 + 0.02 * torch.rand((L, LONG_B, H, T, 1), generator=gen,
                                             device=DEVICE)).bfloat16() for _ in range(2))
        qkv = torch.randn((LONG_B, 1, 3 * D), generator=gen, device=DEVICE).to(dtype)
        q = qkv[..., :D].view(LONG_B, 1, H, Dh).transpose(1, 2)
        pads = torch.randint(0, 200, (LONG_B,), generator=gen, device=DEVICE)
        kmask = (torch.arange(T, device=DEVICE)[None] >= pads[:, None]).float()
        k2_args = (q, kq[1], vq[1], ks[1], vs[1], index, 0.125, kmask)
        k2 = (lambda: decode_attention.decode_mha_int8(*k2_args, n_head=H),
              lambda: decode_attention.decode_mha_int8_reference(*k2_args, n_head=H), K2_TOL)

        for name, (run, plain, tol) in (("cross_decode", k3), ("fused_ln_mlp", k4),
                                        ("decode_mha_int8", k2)):
            r = res.setdefault(name, {"max_abs_err": 0.0, "max_abs_err_f32": 0.0})
            got, want = run(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {dtype}: shape {tuple(got.shape)} or non-finite")
            err = (got.float() - want.float()).abs().max().item()
            ok = _bf16_ok(got, want) if dtype == torch.bfloat16 else err <= tol
            bar = "2e-2 + 1e-2 |plain|" if dtype == torch.bfloat16 else f"{tol:g}"
            print(f"{name} {dtype}: max |kernel - plain| = {err:.3e} (bar {bar})")
            if not ok:
                raise AssertionError(f"{name} {dtype} disagrees with its plain version: {err}")
            if dtype == torch.bfloat16:
                r["max_abs_err"] = err
                r["ms"], r["plain_ms"] = _timed_pair(name, run, plain)
            else:
                r["max_abs_err_f32"] = err
    return res


def reference_phase() -> None:
    """A small fp32 model: the card's path against the CPU's plain path,
    prefill and three decode steps, within the CPU tests' 1e-3 bar for
    int8 caches. First with the decode switches off (the card through
    K1); then with all three on over a 512-slot cache (the card through
    K1, K2, K3 and K4)."""
    base = ModelConfig(n_layer=2, n_embd=128, n_head=2, vocab_size=256, n_positions=64,
                       modality_dim=768, dtype="float32", kv_cache_dtype="int8",
                       cross_kv_dtype="int8", weight_dtype="int8_lm_head")
    cpu = gpt2.params_for_inference(gpt2.init_params(torch.Generator().manual_seed(1), base),
                                    base)
    card = copy.deepcopy(cpu).to(DEVICE)
    rng = np.random.default_rng(1)
    b, L, lc, steps = 64, 16, 8, 3
    x = dict(input_ids=rng.integers(0, 256, (b, L)), token_type_ids=rng.integers(0, 256, (b, L)),
             imgs=rng.standard_normal((b, 768)).astype(np.float32),
             auds=rng.standard_normal((b, 768)).astype(np.float32),
             caption_ids=rng.integers(0, 256, (b, lc)))
    toks = rng.integers(0, 256, (steps, b, 1))
    for on, T in ((False, L + steps), (True, LONG_MAX)):
        cfg = base.replace(decode_fused_mlp=on)
        logits = {}
        with switches(*(SWITCHES if on else ())):
            for dev, params in (("cpu", cpu), (DEVICE, card)):
                t = {k: torch.as_tensor(v, device=dev) for k, v in x.items()}
                mask = torch.zeros((b, T), device=dev)
                mask[:, :L] = 1.0
                reset_launches()
                with torch.inference_mode():
                    cache = gpt2.init_kv_cache(cfg, b, T, caption_len=lc, device=dev)
                    o = gpt2.forward(params, cfg, attention_mask=mask, cache=cache,
                                     prefix_prefill=True, compute_logits="last", **t)
                    out = [o.logits[:, -1]]
                    for s in range(steps):
                        mask[:, L + s] = 1.0
                        o = gpt2.forward(params, cfg, torch.as_tensor(toks[s], device=dev),
                                         position_ids=torch.full((b, 1), L + s, device=dev),
                                         attention_mask=mask, cache=o.cache)
                        out.append(o.logits[:, -1])
                if dev == DEVICE:
                    counts = _launch_counts()
                    want = {"prefill_mha": 2 * cfg.n_layer,
                            **{k: (cfg.n_layer * steps if on else 0) for k in (
                                "fused_cross_decode", "fused_ln_mlp", "decode_mha_int8")}}
                    if counts != want:
                        raise AssertionError(f"small model launches {counts}, want {want}")
                logits[dev] = torch.stack(out).cpu()
        err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
        arm = "switches on, K1-K4, T=512" if on else "switches off, K1"
        print(f"reference ({arm}): small fp32 model, card vs CPU, max |logit diff| = "
              f"{err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"the card's forward disagrees with the CPU's ({arm}): {err}")


def _launch_counts() -> dict:
    return {"prefill_mha": prefill_attention.LAUNCHES,
            "fused_cross_decode": cross_decode.LAUNCHES,
            "fused_ln_mlp": fused_decode.LAUNCHES,
            "decode_mha_int8": decode_attention.LAUNCHES}


def _check_generate(out, cfg, ids, prompt: int, max_len: int) -> int:
    """The repo's own checks of a generate call; returns its new tokens."""
    b = ids.shape[0]
    tok, lengths, emo = out.tokens, out.lengths, out.emotion_logits
    if tok.shape != (b, max_len) or not torch.equal(tok[:, :prompt], ids):
        raise AssertionError(f"bad token buffer {tuple(tok.shape)}")
    if int(tok.min()) < 0 or int(tok.max()) >= cfg.vocab_size:
        raise AssertionError("token out of the vocabulary")
    if int(lengths.min()) <= prompt or int(lengths.max()) > max_len:
        raise AssertionError(f"lengths out of range: {int(lengths.min())}..{int(lengths.max())}")
    if emo.shape != (b, cfg.num_emotions) or not bool(torch.isfinite(emo).all()):
        raise AssertionError(f"emotion logits are not finite [{b}, 7]")
    return int(lengths.sum()) - b * prompt


def _generate_arms(label: str, params, arms: dict, inputs: dict, prompt: int, max_len: int,
                   card: str) -> dict:
    """Runs ``generate`` under each arm ({name: (config, switch names)}):
    one untimed first call each, then timed calls in turns (a, b, b, a).
    Each timed call starts from zeroed launch counts; K2-K4 must launch
    n_layer times per decode step where their switch is on, and never
    where it is off. Returns {arm: counts of its last timed call}."""
    ids = inputs["input_ids"]

    def run(cfg, names, seed):
        with switches(*names), StepCounter() as steps:
            reset_launches()
            t0 = time.time()
            out = generate(params, cfg, ids, prompt, max_len=max_len, eos_id=EOS, sp2_id=SP2,
                           top_p=0.8, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                           token_type_ids=inputs["token_type_ids"], imgs=inputs["imgs"],
                           auds=inputs["auds"], caption_ids=inputs["caption_ids"])
            torch.cuda.synchronize()
            wall = time.time() - t0
        return out, wall, steps.steps, _launch_counts()

    for name, (cfg, names) in arms.items():
        t0 = time.time()
        run(cfg, names, 0)
        print(f"{label} [{name}]: first call {time.time() - t0:.3f} s")
    order = list(arms)
    counts, walls = {}, {name: [] for name in order}
    for name in order + order[::-1]:
        cfg, names = arms[name]
        out, wall, steps, got = run(cfg, names, 1)
        new_tokens = _check_generate(out, cfg, ids, prompt, max_len)
        n = cfg.n_layer * steps
        want = {"fused_cross_decode": n if "ERGM_CROSS_KERNEL" in names else 0,
                "fused_ln_mlp": n if cfg.decode_fused_mlp else 0,
                "decode_mha_int8": n if "ERGM_DECODE_KERNEL" in names else 0}
        if {k: got[k] for k in want} != want or steps < 1:
            raise AssertionError(f"{label} [{name}]: launches {got} over {steps} decode steps, "
                                 f"want {want}")
        walls[name].append(wall)
        counts[name] = got
        b = ids.shape[0]
        print(f"{label} [{name}] B={b}: {wall:.3f} s, {b / wall:.2f} utt/s, "
              f"{new_tokens / wall:.0f} new tok/s ({new_tokens} tokens, {steps} decode steps), "
              f"launches {got} on {card}")
    runs = {k: "/".join(f"{w:.3f}" for w in v) for k, v in walls.items()}
    print(f"{label}: wall s " + ", ".join(f"{k} {min(walls[k]):.3f} (runs {runs[k]})"
                                          for k in walls))
    return counts


def _gpt2_inputs(rng, b: int, prompt: int) -> dict:
    return {"input_ids": torch.as_tensor(rng.integers(0, 50000, (b, prompt)), device=DEVICE),
            "token_type_ids": torch.as_tensor(rng.integers(0, 50000, (b, prompt)),
                                              device=DEVICE),
            "imgs": torch.as_tensor(rng.standard_normal((b, 768)), device=DEVICE).bfloat16(),
            "auds": torch.as_tensor(rng.standard_normal((b, 768)), device=DEVICE).bfloat16(),
            "caption_ids": torch.as_tensor(rng.integers(0, 50000, (b, CAPTION)), device=DEVICE)}


def slice_phase(card: str) -> tuple:
    """Full-width gpt2: generate at B=256 with the decode switches off and
    with K3 and K4 on, 64 ragged generate_batch requests, and the
    long-history generate with K2 on and off. Returns the slice's
    kernels-on launch counts and the long-history K2 arm's."""
    cfg = ModelConfig.from_model_type(**SLICE)
    t0 = time.time()
    params = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
    torch.cuda.synchronize()
    print(f"slice: gpt2 init + int8 lm_head in {time.time() - t0:.2f} s")
    arms = {"kernels off": (cfg, ()),
            "K3+K4 on": (cfg.replace(decode_fused_mlp=True), ("ERGM_CROSS_KERNEL",))}
    counts = _generate_arms("slice generate", params, arms,
                            _gpt2_inputs(np.random.default_rng(0), B, PROMPT), PROMPT,
                            PROMPT + NEW, card)
    for name, got in counts.items():
        if got["prefill_mha"] != 2 * cfg.n_layer:
            raise AssertionError(f"[{name}] K1 launched {got['prefill_mha']} times in one "
                                 f"prefill, want {2 * cfg.n_layer}")

    brng = np.random.default_rng(1)
    n = 64
    prompts = [brng.integers(0, 50000, int(m)).tolist()
               for m in [PROMPT] + list(brng.integers(8, PROMPT + 1, n - 1))]
    captions = [None if i % 4 == 3 else brng.integers(0, 50000, int(brng.integers(4, 33))).tolist()
                for i in range(n)]
    prefill_attention.LAUNCHES = 0
    t0 = time.time()
    results, bemo = generate_batch(
        params, cfg, prompts, max_len=PROMPT + NEW, eos_id=EOS, sp2_id=SP2,
        imgs=brng.standard_normal((n, 768)).astype(np.float32),
        auds=brng.standard_normal((n, 768)).astype(np.float32), captions=captions,
        greedy=True, max_new_tokens=32)
    bwall = time.time() - t0
    if prefill_attention.LAUNCHES != 2 * cfg.n_layer:
        raise AssertionError(f"generate_batch: K1 launched {prefill_attention.LAUNCHES} times")
    if len(results) != n or any(not 1 <= len(r) <= 32 for r in results):
        raise AssertionError("generate_batch: wrong continuation lengths")
    if any(t < 0 or t >= cfg.vocab_size for r in results for t in r):
        raise AssertionError("generate_batch: token out of the vocabulary")
    if bemo.shape != (n, cfg.num_emotions) or not np.isfinite(bemo).all():
        raise AssertionError("generate_batch: emotion logits are not finite [64, 7]")
    print(f"slice generate_batch: {n} ragged greedy requests ({n // 4} without a caption) "
          f"in {bwall:.3f} s on {card}")

    long_arms = {"K2 on": (cfg, ("ERGM_DECODE_KERNEL",)), "kernels off": (cfg, ())}
    long_counts = _generate_arms("long history", params, long_arms,
                                 _gpt2_inputs(np.random.default_rng(2), LONG_B, LONG_PROMPT),
                                 LONG_PROMPT, LONG_MAX, card)
    return counts["K3+K4 on"], long_counts["K2 on"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    _build.load()
    print(f"build: K1-K4 compiled and loaded in {time.time() - t0:.2f} s")
    print(_build.build_log().strip())

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1 = kernel_phase(gen)
    decode = decode_kernel_phase(gen)
    reference_phase()
    on, long_on = slice_phase(card)

    rows = [("prefill_mha", "prefill_attention", "prefill_attention.py:111", on, k1),
            ("fused_cross_decode", "cross_decode", "cross_decode.py:127", on,
             decode["cross_decode"]),
            ("fused_ln_mlp", "fused_decode", "fused_decode.py:99", on, decode["fused_ln_mlp"]),
            ("decode_mha_int8", "decode_attention", "decode_attention.py:151", long_on,
             decode["decode_mha_int8"])]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"ergm_tpu_torch/csrc/{src}.cu",
        "replaces": f"ergm_tpu/ops/{tpu}", "launches": counts[name], **nums}
        for name, src, tpu, counts, nums in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
