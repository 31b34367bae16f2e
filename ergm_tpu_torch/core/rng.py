"""Deterministic seeds for dropout (the role of ``ergm_tpu/core/rng.py``).

JAX threads keys and folds in a step, a layer and a site
(``jax.random.fold_in``). The port folds integers the same way: every
dropout mask of a training step is a function of (step seed, layer,
site) alone, drawn from a generator made for it, so a rematerialised
forward (``torch.utils.checkpoint``) draws the same mask again.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, *data: int) -> int:
    """A seed in [0, 2**31) from ``seed`` and the integers ``data``
    (splitmix64 rounds)."""
    x = int(seed) & _MASK64
    for d in data:
        x = (x + 0x9E3779B97F4A7C15 * (int(d) + 1)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & 0x7FFFFFFF
