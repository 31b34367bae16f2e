"""The port's cached prompt prefill routes its self-attention as JAX does
(``ergm_tpu/models/gpt2.py:797-809``): under ``attention_impl="auto"`` the
plain math is forced only for prompts of at most 128 tokens at a batch of
64 or more, where K1's branch comes first; every other prompt keeps
``auto`` (K5 inside its gate on the card) and passes the attention mask as
the query mask. A spy on ``multihead_attention`` records what it is given."""
import numpy as np
import pytest
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.ops import prefill_attention as tpa

torch.set_num_threads(1)


@pytest.mark.parametrize("B,L,n_head,want", [
    (2, 256, 2, "auto"),   # B < 64: K5's route, with the query mask
    (2, 128, 2, "auto"),
    (64, 128, 2, "k1"),    # JAX's short-prompt, large-batch branch: K1 first
    (64, 128, 4, "xla"),   # ... and the plain math where K1's gate declines (head_dim 32)
])
def test_prompt_prefill_routes_as_jax(monkeypatch, B, L, n_head, want):
    cfg = ModelConfig(n_layer=1, n_embd=128, n_head=n_head, vocab_size=64, n_positions=256,
                      dtype="float32")
    params = tg.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    seen = []
    real_mha, real_k1 = tg.multihead_attention, tpa.prefill_mha

    def spy(q, k, v, **kw):
        seen.append(("mha", kw.get("impl"), kw.get("q_mask"), kw.get("kv_mask")))
        return real_mha(q, k, v, **kw)

    def k1_spy(*args, **kw):
        seen.append(("k1", None, None, None))
        return real_k1(*args, **kw)

    monkeypatch.setattr(tg, "multihead_attention", spy)
    monkeypatch.setattr(tpa, "prefill_mha", k1_spy)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 64, (B, L)))
    mask = torch.ones((B, L))
    mask[0, :L // 4] = 0.0  # a left-padded row
    cache = tg.init_kv_cache(cfg, B, L, device="cpu")
    with torch.inference_mode():
        out = tg.forward(params, cfg, ids, attention_mask=mask, cache=cache,
                         prefix_prefill=True, compute_logits="last")
    assert bool(torch.isfinite(out.logits).all())
    assert len(seen) == cfg.n_layer
    route, impl, q_mask, kv_mask = seen[0]
    if want == "k1":
        assert route == "k1"
        return
    assert route == "mha" and impl == want
    assert q_mask is not None and torch.equal(q_mask, mask) and torch.equal(kv_mask, mask)
