"""Seeded weights and inputs that the two packages can share without a
checkpoint, in numpy only.

``seeded_tree(config, seed)`` gives a parameter tree in the layout of
``ergm_tpu.models.gpt2.init_params`` (the same keys and shapes, the
blocks stacked on a leading layer axis, float32): JAX takes it through
``jnp.asarray``, the port through ``models.convert.params_from_numpy``.
Kernels and embeddings are N(0, initializer_range) (the residual
projections N(0, initializer_range / sqrt(2 n_layer)), as in the init);
biases and LayerNorm parameters are perturbed by N(0, 0.02), so that no
term of the model is trivial.

``agreement_inputs(config, seed, recipe)`` gives the inputs of a
full-width agreement check (``scripts/large_agreement.py`` writes JAX's
results on them, ``chip_smoke.py`` holds the port to them): greedy
requests with token types, image and audio features and a caption, and
one training batch. Three recipes: ``AGREEMENT`` (gpt2-large's width at 4
of its 36 layers), ``GPT2_AGREEMENT`` (gpt2 at its full 12 layers) and
``CEREBRAS_2P7B_AGREEMENT`` (Cerebras-GPT-2.7B's width at 2 of its 32
layers); ``agreement_config`` builds a recipe's configuration.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

# The agreement check: gpt2-large's width (its published n_embd, n_head and
# n_inner) at AGREEMENT["n_layer"] of its 36 layers, fp32, dropout 0.
AGREEMENT = dict(model_type="gpt2-large", n_layer=4, vocab_size=50271, seed=0, rows=4,
                 prompt=32, caption=8, new=16, train_b=2, train_l=128, steps=2, lr=1e-4,
                 eos_id=50256, sp2_id=50258)
# The same check for gpt2 at its published width and all 12 of its layers:
# the same rows, steps and bars, emotion logits within GPT2_EMOTION_TOL.
GPT2_AGREEMENT = dict(AGREEMENT, model_type="gpt2", n_layer=12)
# Cerebras-GPT-2.7B's published widths (cerebras/Cerebras-GPT-2.7B's
# config.json: n_embd 2,560, 32 heads of 80, n_inner 10,240, n_positions
# 2,048; GPT-2's architecture and vocabulary), no preset: its ModelConfig
# comes from the constructor
CEREBRAS_2P7B = dict(n_embd=2560, n_head=32, n_inner=10240, n_positions=2048)
# The same check at that width and 2 of its 32 layers
CEREBRAS_2P7B_AGREEMENT = dict(AGREEMENT, model_type="Cerebras-GPT-2.7B", n_layer=2,
                               widths=CEREBRAS_2P7B)
# the bars: tokens equal up to each row's first decision whose top-2 margin
# in JAX is at most MARGIN; emotion logits within EMOTION_TOL; the LM loss of
# step 1 within STEP1_RTOL and of step 2 within STEP2_RTOL, relative
MARGIN, EMOTION_TOL, STEP1_RTOL, STEP2_RTOL = 1e-3, 1e-3, 1e-5, 2e-3
GPT2_EMOTION_TOL = 1e-4


def agreement_config(cls, recipe: Dict[str, Any]):
    """Recipe ``recipe``'s configuration as ``cls`` (either package's
    ``ModelConfig``): its ``widths`` through the constructor, or else its
    preset, at its depth and vocabulary, fp32, dropout 0."""
    kw = dict(n_layer=recipe["n_layer"], vocab_size=recipe["vocab_size"], dtype="float32",
              embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    if "widths" in recipe:
        return cls(**recipe["widths"], **kw)
    return cls.from_model_type(recipe["model_type"], **kw)


def seeded_tree(config, seed: int) -> Dict[str, Any]:
    """JAX's parameter tree for ``config`` as float32 numpy arrays drawn from
    ``seed``."""
    c = config
    L, D, I, V = c.n_layer, c.n_embd, c.inner_dim, c.vocab_size
    std = c.initializer_range
    proj_std = std / (2 * L) ** 0.5
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(scale)
        return x

    def dense(shape, scale=std):
        return {"kernel": normal((L, *shape), scale), "bias": normal((L, shape[1]), 0.02)}

    def ln(shape=(L, D)):
        return {"scale": 1.0 + normal(shape, 0.02), "bias": normal(shape, 0.02)}

    tree: Dict[str, Any] = {
        "wte": {"embedding": normal((V, D), std)},
        "wpe": {"embedding": normal((c.n_positions, D), std)},
        "blocks": {
            "ln_1": ln(),
            "attn": {"c_attn": dense((D, 3 * D)), "c_proj": dense((D, D), proj_std)},
            "ln_2": ln(),
            "mlp": {"c_fc": dense((D, I)), "c_proj": dense((I, D), proj_std)},
        },
        "ln_f": ln((D,)),
        "emotion_head": {"kernel": normal((D, c.num_emotions), std)},
    }
    if c.use_cross_attention:
        tree["blocks"]["ln_cross"] = ln()
        tree["blocks"]["cross_attn"] = {"q_attn": dense((D, D)), "c_attn": dense((D, 2 * D)),
                                        "c_proj": dense((D, D), proj_std)}
    if c.modality_dim != c.n_embd:
        for name in ("img_proj", "aud_proj"):
            tree[name] = {"kernel": normal((c.modality_dim, D), std),
                          "bias": normal((D,), 0.02)}
    return tree


def agreement_inputs(config, seed: int,
                     recipe: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """{"generate": the greedy requests, "train": one training batch} of
    ``recipe``'s sizes, drawn from ``seed`` over ``config``'s vocabulary.
    Every request shares the prompt length; the training batch has ignored
    labels on its first quarter and ragged captions and sequence lengths."""
    a, M = recipe, config.modality_dim
    rng = np.random.default_rng(seed + 1)
    b, lp, lc = a["rows"], a["prompt"], a["caption"]
    gen = dict(input_ids=rng.integers(0, a["eos_id"], (b, lp)),
               token_type_ids=rng.integers(0, a["eos_id"], (b, lp)),
               imgs=rng.standard_normal((b, M)).astype(np.float32),
               auds=rng.standard_normal((b, M)).astype(np.float32),
               caption_ids=rng.integers(0, a["eos_id"], (b, lc)))
    b, n = a["train_b"], a["train_l"]
    ids = rng.integers(0, a["eos_id"], (b, n))
    labels = ids.copy()
    labels[:, :n // 4] = -100
    train = dict(input_ids=ids, token_type_ids=rng.integers(0, a["eos_id"], (b, n)),
                 labels=labels, emotion_labels=rng.integers(0, config.num_emotions, (b,)),
                 valid=np.ones((b,), bool),
                 seq_lengths=rng.integers(n // 2, n + 1, (b,)),
                 imgs=rng.standard_normal((b, M)).astype(np.float32),
                 auds=rng.standard_normal((b, M)).astype(np.float32),
                 caption_ids=rng.integers(0, a["eos_id"], (b, lc)),
                 caption_mask=(np.arange(lc)[None] < rng.integers(1, lc + 1, (b, 1))
                               ).astype(np.float32))
    return {"generate": gen, "train": train}
