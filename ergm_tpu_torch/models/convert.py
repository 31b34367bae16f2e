"""Checkpoint conversion into the port's modules (counterpart of
``ergm_tpu/models/convert.py``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.models.gpt2 import GPT2


def _flatten(node: Dict[str, Any], prefix: str, layer, out: Dict[str, np.ndarray]) -> None:
    for key, val in node.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", layer, out)
        else:
            arr = np.asarray(val)
            out[f"{prefix}{key}"] = arr if layer is None else arr[layer]


def params_from_numpy(tree: Dict[str, Any], config: ModelConfig, device="cuda") -> GPT2:
    """A JAX parameter tree of numpy arrays (``jax.tree_util.tree_map(
    np.asarray, params)`` of full-precision params, e.g. from
    ``ergm_tpu.models.gpt2.init_params`` or a checkpoint) -> ``GPT2``.

    The tree's ``blocks`` arrays are stacked on a leading layer axis;
    layer ``i`` becomes ``blocks[i]``. Every other leaf copies as it is
    (kernels keep their [in, out] orientation). The tensors land on
    ``device``, the card unless the caller asks for the CPU. Quantize
    afterwards with ``params_for_inference``."""
    device = resolve(device)
    flat: Dict[str, np.ndarray] = {}
    for key, node in tree.items():
        if key == "blocks":
            for li in range(config.n_layer):
                _flatten(node, f"blocks.{li}.", li, flat)
        else:
            _flatten(node, f"{key}.", None, flat)
    state = {k: torch.tensor(np.ascontiguousarray(v), device=device) for k, v in flat.items()}
    model = GPT2(config, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    return model
