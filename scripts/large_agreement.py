"""Writes ergm_tpu's results on the seeded weights and inputs of
``ergm_tpu_torch.models.seeded``, which ``chip_smoke.py`` holds the port
to on the card: ``tests/fixtures/large_agreement.json`` for
``AGREEMENT`` (gpt2-large's published width, n_embd 1,280, 20 heads,
n_inner 5,120, at ``AGREEMENT["n_layer"]`` of its 36 layers) or, with
``--recipe=gpt2``, ``tests/fixtures/gpt2_agreement.json`` for
``GPT2_AGREEMENT`` (gpt2 at its published width and all 12 layers) or,
with ``--recipe=cerebras-2.7b``,
``tests/fixtures/cerebras_2p7b_agreement.json`` for
``CEREBRAS_2P7B_AGREEMENT`` (Cerebras-GPT-2.7B's published widths, n_embd
2,560, 32 heads of 80, n_inner 10,240, at 2 of its 32 layers).

fp32 on the CPU, dropout 0, GPT-2's vocabulary. It records:

- greedy ``generate`` over the recipe's ``rows`` requests (prompt,
  token types, image and audio features, a caption): the new tokens, each
  row's length, the top-2 logit margin of every decision (the logits of
  generate's prefill and cached decode steps, replayed teacher-forced),
  and the emotion logits;
- the LM loss of the recipe's ``steps`` AdamW steps (constant rate
  ``lr``, optax's defaults) on one batch.

Run from the repository root on a CPU (a few minutes, ~4 GB each; the
Cerebras recipe ~1 min):

    JAX_PLATFORMS=cpu python scripts/large_agreement.py [--recipe=gpt2|cerebras-2.7b]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ergm_tpu.core.config import ModelConfig  # noqa: E402
from ergm_tpu.infer import generate as jgen  # noqa: E402
from ergm_tpu.models import gpt2 as jg  # noqa: E402
from ergm_tpu.train import steps as jsteps  # noqa: E402
from ergm_tpu_torch.models.seeded import (AGREEMENT, CEREBRAS_2P7B_AGREEMENT,  # noqa: E402
                                          GPT2_AGREEMENT, MARGIN, agreement_config,
                                          agreement_inputs, seeded_tree)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                        "fixtures")
# --recipe: (the recipe, its name in seeded.py, the fixture it writes)
RECIPES = {"large": (AGREEMENT, "AGREEMENT", "large_agreement.json"),
           "gpt2": (GPT2_AGREEMENT, "GPT2_AGREEMENT", "gpt2_agreement.json"),
           "cerebras-2.7b": (CEREBRAS_2P7B_AGREEMENT, "CEREBRAS_2P7B_AGREEMENT",
                             "cerebras_2p7b_agreement.json")}


def decision_logits(params, cfg, req: dict, tokens: np.ndarray, max_len: int,
                    sp2_id: int) -> list:
    """The logits behind each of generate's decisions (ergm_tpu/infer/
    generate.py's prefill, then its cached decode steps), the tokens fed
    teacher-forced: [slot s predicted by them for s in prompt .. max_len)."""
    fwd = jax.jit(lambda p, **kw: jg.forward(p, cfg, **kw),
                  static_argnames=("prefix_prefill", "compute_logits"))
    ids = req["input_ids"]
    B, lp = ids.shape
    cache = jg.init_kv_cache(cfg, B, max_len, caption_len=req["caption_ids"].shape[1])
    mask = np.zeros((B, max_len), np.float32)
    mask[:, :lp] = 1.0
    pos = np.broadcast_to(np.arange(lp), (B, lp))
    o = fwd(params, input_ids=jnp.asarray(ids), token_type_ids=jnp.asarray(req["token_type_ids"]),
            position_ids=jnp.asarray(pos), attention_mask=jnp.asarray(mask),
            imgs=jnp.asarray(req["imgs"]), auds=jnp.asarray(req["auds"]),
            caption_ids=jnp.asarray(req["caption_ids"]), cache=cache, prefix_prefill=True,
            compute_logits="last")
    out = [np.asarray(o.logits[:, -1])]
    mask[:, lp] = 1.0
    for cur in range(lp + 1, max_len):
        step_pos = np.full((B, 1), min(cur - 1, cfg.n_positions - 1))
        o = fwd(params, input_ids=jnp.asarray(tokens[:, cur - 1:cur]),
                token_type_ids=jnp.full((B, 1), sp2_id),
                position_ids=jnp.asarray(step_pos), attention_mask=jnp.asarray(mask),
                cache=o.cache)
        out.append(np.asarray(o.logits[:, -1]))
        mask[:, cur] = 1.0
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="large")
    a, name, fixture_name = RECIPES[ap.parse_args().recipe]
    cfg = agreement_config(ModelConfig, a)
    out_path = os.path.join(FIXTURES, fixture_name)
    t0 = time.time()
    tree = seeded_tree(cfg, a["seed"])
    inputs = agreement_inputs(cfg, a["seed"], a)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    del tree
    print(f"seeded tree: {sum(x.size for x in jax.tree_util.tree_leaves(params)):,} "
          f"parameters, {time.time() - t0:.1f} s")

    req, lp = inputs["generate"], a["prompt"]
    max_len = lp + a["new"]
    pi = jg.params_for_inference(params, cfg)
    out = jax.jit(lambda p: jgen.generate(
        p, cfg, jnp.asarray(req["input_ids"]), lp, max_len=max_len, eos_id=a["eos_id"],
        sp2_id=a["sp2_id"], token_type_ids=jnp.asarray(req["token_type_ids"]),
        imgs=jnp.asarray(req["imgs"]), auds=jnp.asarray(req["auds"]),
        caption_ids=jnp.asarray(req["caption_ids"]), greedy=True))(pi)
    tokens, lengths = np.asarray(out.tokens), np.asarray(out.lengths)
    logits = decision_logits(pi, cfg, req, tokens, max_len, a["sp2_id"])
    top2 = [np.sort(x, axis=-1)[:, -2:] for x in logits]
    margins = np.stack([t[:, 1] - t[:, 0] for t in top2], axis=1)  # [B, new]
    for s, x in enumerate(logits):  # the replay is generate's own
        live = (lp + s < lengths) & (margins[:, s] > MARGIN)
        assert (x.argmax(-1)[live] == tokens[live, lp + s]).all(), s
    print(f"generate: {time.time() - t0:.1f} s; lengths {lengths.tolist()}, smallest margin "
          f"{float(margins.min()):.3e}")

    tx = optax.adamw(a["lr"], b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    state = jsteps.create_train_state(params, tx)
    step = jsteps.make_train_step(cfg, tx)
    batch = {k: jnp.asarray(v) for k, v in inputs["train"].items()}
    losses = []
    for _ in range(a["steps"]):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["lm_loss"]))
    print(f"train: LM losses {losses}, {time.time() - t0:.1f} s")

    fixture = {
        "about": f"ergm_tpu's results on ergm_tpu_torch.models.seeded's {name} weights and "
                 "inputs (scripts/large_agreement.py), fp32 on a CPU",
        "agreement": a,
        "config": {k: getattr(cfg, k) for k in ("n_layer", "n_embd", "n_head", "n_inner",
                                               "vocab_size", "n_positions", "modality_dim")},
        "tokens": tokens[:, lp:].tolist(),
        "lengths": lengths.tolist(),
        "margins": margins.tolist(),
        "emotion_logits": np.asarray(out.emotion_logits).tolist(),
        "lm_losses": losses,
    }
    os.makedirs(FIXTURES, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(fixture, f, indent=1)
    print(f"wrote {out_path} ({os.path.getsize(out_path):,} bytes)")


if __name__ == "__main__":
    main()
