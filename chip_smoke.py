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
3. reference: a small fp32 model on the card (through K1) against the
   same model on the CPU (plain attention), prefill and decode logits.
4. slice: gpt2 at full width, random weights from seed 0, int8 KV and
   cross caches, int8 lm_head, bf16: ``generate`` at B=256 (128-token
   prompt, 128 new tokens, 32-token caption, image and audio features,
   top-p 0.8), then ``generate_batch`` over 64 ragged greedy requests.
   K1 must launch 2 x n_layer times per prefill.

Prints the card's name and power limit, a JSON line with each kernel's
numbers, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero without a GPU.
"""

from __future__ import annotations

import copy
import json
import subprocess
import time

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.infer.generate import generate, generate_batch
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.ops import _build, prefill_attention

DEVICE = "cuda"
B, PROMPT, NEW, CAPTION, D, H = 256, 128, 128, 32, 768, 12
EOS, SP2 = 50256, 50258
# the headline serving configuration of bench.py:101-104
SLICE = dict(model_type="gpt2", vocab_size=50271, dtype="bfloat16", modality_dim=768,
             kv_cache_dtype="int8", weight_dtype="int8_lm_head", cross_kv_dtype="int8")
BF16_TOL, F32_TOL = 2e-2, 2e-5


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


def reference_phase() -> None:
    """A small fp32 model: the card's path (through K1) against the CPU's
    plain path, prefill and three decode steps, within the CPU tests' 1e-3
    bar for int8 caches."""
    cfg = ModelConfig(n_layer=2, n_embd=128, n_head=2, vocab_size=256, n_positions=64,
                      modality_dim=768, dtype="float32", kv_cache_dtype="int8",
                      cross_kv_dtype="int8", weight_dtype="int8_lm_head")
    cpu = gpt2.params_for_inference(gpt2.init_params(torch.Generator().manual_seed(1), cfg), cfg)
    card = copy.deepcopy(cpu).to(DEVICE)
    rng = np.random.default_rng(1)
    b, L, lc, steps = 64, 16, 8, 3
    x = dict(input_ids=rng.integers(0, 256, (b, L)), token_type_ids=rng.integers(0, 256, (b, L)),
             imgs=rng.standard_normal((b, 768)).astype(np.float32),
             auds=rng.standard_normal((b, 768)).astype(np.float32),
             caption_ids=rng.integers(0, 256, (b, lc)))
    toks = rng.integers(0, 256, (steps, b, 1))
    logits = {}
    for dev, params in (("cpu", cpu), (DEVICE, card)):
        t = {k: torch.as_tensor(v, device=dev) for k, v in x.items()}
        mask = torch.zeros((b, L + steps), device=dev)
        mask[:, :L] = 1.0
        before = prefill_attention.LAUNCHES
        with torch.inference_mode():
            cache = gpt2.init_kv_cache(cfg, b, L + steps, caption_len=lc, device=dev)
            o = gpt2.forward(params, cfg, attention_mask=mask, cache=cache, prefix_prefill=True,
                             compute_logits="last", **t)
            out = [o.logits[:, -1]]
            for s in range(steps):
                mask[:, L + s] = 1.0
                o = gpt2.forward(params, cfg, torch.as_tensor(toks[s], device=dev),
                                 position_ids=torch.full((b, 1), L + s, device=dev),
                                 attention_mask=mask, cache=o.cache)
                out.append(o.logits[:, -1])
        if dev == DEVICE and prefill_attention.LAUNCHES - before != 2 * cfg.n_layer:
            raise AssertionError("the small model's prefill did not go through K1")
        logits[dev] = torch.stack(out).cpu()
    err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
    print(f"reference: small fp32 model, card vs CPU, max |logit diff| = {err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"the card's forward disagrees with the CPU's: {err}")


def slice_phase(card: str) -> int:
    """Full-width gpt2 generate at B=256 and 64 ragged generate_batch
    requests. Returns K1's launch count from the timed generate."""
    cfg = ModelConfig.from_model_type(**SLICE)
    t0 = time.time()
    params = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
    torch.cuda.synchronize()
    print(f"slice: gpt2 init + int8 lm_head in {time.time() - t0:.2f} s")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 50000, (B, PROMPT)), device=DEVICE)
    tts = torch.as_tensor(rng.integers(0, 50000, (B, PROMPT)), device=DEVICE)
    imgs = torch.as_tensor(rng.standard_normal((B, 768)), device=DEVICE).bfloat16()
    auds = torch.as_tensor(rng.standard_normal((B, 768)), device=DEVICE).bfloat16()
    caps = torch.as_tensor(rng.integers(0, 50000, (B, CAPTION)), device=DEVICE)

    def run(seed):
        return generate(params, cfg, ids, PROMPT, max_len=PROMPT + NEW, eos_id=EOS, sp2_id=SP2,
                        top_p=0.8, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                        token_type_ids=tts, imgs=imgs, auds=auds, caption_ids=caps)

    t0 = time.time()
    run(0)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    prefill_attention.LAUNCHES = 0
    t0 = time.time()
    out = run(1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = prefill_attention.LAUNCHES
    if launches != 2 * cfg.n_layer:
        raise AssertionError(f"K1 launched {launches} times in one prefill, "
                             f"want {2 * cfg.n_layer}")
    tok, lengths, emo = out.tokens, out.lengths, out.emotion_logits
    if tok.shape != (B, PROMPT + NEW) or not torch.equal(tok[:, :PROMPT], ids):
        raise AssertionError(f"bad token buffer {tuple(tok.shape)}")
    if int(tok.min()) < 0 or int(tok.max()) >= cfg.vocab_size:
        raise AssertionError("token out of the vocabulary")
    if int(lengths.min()) <= PROMPT or int(lengths.max()) > PROMPT + NEW:
        raise AssertionError(f"lengths out of range: {int(lengths.min())}..{int(lengths.max())}")
    if emo.shape != (B, cfg.num_emotions) or not bool(torch.isfinite(emo).all()):
        raise AssertionError("emotion logits are not finite [B, 7]")
    new_tokens = int(lengths.sum()) - B * PROMPT
    print(f"slice generate B={B}: first call {first_s:.3f} s, timed call {wall:.3f} s, "
          f"{B / wall:.2f} utt/s, {new_tokens / wall:.0f} new tok/s ({new_tokens} tokens) "
          f"on {card}")

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
    return launches


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
    print(f"build: K1 compiled and loaded in {time.time() - t0:.2f} s")
    print(_build.build_log().strip())

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1 = kernel_phase(gen)
    reference_phase()
    launches = slice_phase(card)

    print(json.dumps({"kernels": [{
        "name": "prefill_mha", "route": "cuda",
        "source": "ergm_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "ergm_tpu/ops/prefill_attention.py:111",
        "launches": launches, **k1}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
