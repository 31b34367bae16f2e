"""Learning-rate schedule (counterpart of ``ergm_tpu/train/schedule.py``):
polynomial decay with linear warmup, power 2, as HF's
``get_polynomial_decay_schedule_with_warmup`` configured by the
reference (warmup steps, total steps, power 2, lr_end 1e-7):

    step < warmup:  lr * step / warmup
    step >= total:  lr_end
    else:           lr_end + (lr - lr_end) * (1 - (step-warmup)/(total-warmup))**power

``step`` counts optimizer updates: update i runs at ``schedule(i)``, as
optax applies it, so update 0 runs at lr 0 when warmup > 0. The
arithmetic is JAX's, in float32.
"""

from __future__ import annotations

import numpy as np


def polynomial_warmup_schedule(lr: float, warmup_steps: int, total_steps: int,
                               power: float = 2.0, lr_end: float = 1e-7):
    warmup_steps = max(int(warmup_steps), 0)
    total_steps = max(int(total_steps), warmup_steps + 1)

    def schedule(step) -> float:
        s = np.float32(step)
        if s >= total_steps:
            return float(np.float32(lr_end))
        if s < warmup_steps:
            return float(lr * s / np.float32(max(warmup_steps, 1)))
        frac = 1.0 - (s - warmup_steps) / np.float32(total_steps - warmup_steps)
        return float(lr_end + (lr - lr_end) * np.clip(frac, 0.0, 1.0) ** power)

    return schedule
