"""A copy of ``ergm_tpu/utils/torch_io.py`` (the port imports nothing of ``ergm_tpu``).

Torch checkpoint IO helpers (host-side, no network).
"""

from __future__ import annotations

import os
from typing import Any, Mapping


def load_torch_state(model_dir_or_file: str) -> Mapping[str, Any]:
    """State dict from a local HF checkpoint dir (model.safetensors /
    pytorch_model.bin) or a single torch file (.bin/.pt/.ckpt). A
    reference-style blob with 'model_state_dict' (src/main.py:186-196)
    unwraps to the inner dict. A ``model.safetensors`` directory needs the
    ``safetensors`` package and raises without it."""
    path = model_dir_or_file
    if os.path.isdir(path):
        safep = os.path.join(path, "model.safetensors")
        binp = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(safep):
            try:
                from safetensors.torch import load_file
            except ImportError as e:
                raise ImportError(f"{safep} needs the 'safetensors' package, which is not "
                                  f"installed; install it or save the weights as "
                                  f"pytorch_model.bin") from e
            return load_file(safep)
        if os.path.exists(binp):
            path = binp
        else:
            raise FileNotFoundError(f"no model weights under {model_dir_or_file}")
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        return blob["model_state_dict"]
    return blob
