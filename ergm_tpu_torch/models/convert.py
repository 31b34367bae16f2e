"""Checkpoint conversion into the port's modules (counterpart of
``ergm_tpu/models/convert.py``).

HF GPT-2 stores its attention and MLP weights as Conv1D ``[in, out]``,
the port's orientation, so they copy straight across; ``nn.Linear``
heads (the emotion head, the image and audio projections) store
``[out, in]`` and are transposed. ``lm_head`` is tied to ``wte`` and
never stored. A checkpoint without cross-attention (pretrained GPT-2)
or without the heads gets those parts from the port's random init, and
one with a smaller vocabulary gets new ``wte`` rows
(``gpt2.resize_token_embeddings``), as the reference's non-strict load
and ``resize_token_embeddings`` give them.

``audio_params_from_numpy`` and ``vision_params_from_numpy`` build the
encoders of ``tools/audio.py`` and ``tools/vision.py`` from JAX's trees
the same way (their HF state dicts go through ``hf_to_audio_params`` and
``hf_to_vision_params`` there).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.models.gpt2 import GPT2, init_params, resize_token_embeddings

if TYPE_CHECKING:  # the encoders import this module, not the other way round
    from ergm_tpu_torch.tools.audio import AudioEncoder, AudioEncoderConfig
    from ergm_tpu_torch.tools.vision import VisionEncoder, VisionEncoderConfig

# the port's modules stored as nn.Linear ([out, in]) in a checkpoint, outside
# HF's ``transformer.`` prefix
_HEADS = ("emotion_head", "img_proj", "aud_proj")
# what a checkpoint may lack: the cross-attention of a pretrained GPT-2 and
# the heads, taken from the random init instead
_OPTIONAL = ("ln_cross", "cross_attn") + _HEADS
_HF_MODULE = {"blocks": "h", "ln_cross": "ln_cross_attn", "cross_attn": "crossattention"}


def _flatten(node: Dict[str, Any], prefix: str, layer, out: Dict[str, np.ndarray]) -> None:
    for key, val in node.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", layer, out)
        else:
            arr = np.asarray(val)
            out[f"{prefix}{key}"] = arr if layer is None else arr[layer]


def _module_from_tree(module: torch.nn.Module, tree: Dict[str, Any], stacked: str,
                      n_layer: int, device: torch.device) -> torch.nn.Module:
    """Fills ``module`` (built on the meta device) from a JAX parameter tree
    of numpy arrays: the ``stacked`` subtree's arrays carry a leading layer
    axis and layer ``i`` becomes ``{stacked}.{i}``; a list subtree's entry
    ``i`` becomes ``{key}.{i}``; every other leaf copies as it is."""
    flat: Dict[str, np.ndarray] = {}
    for key, node in tree.items():
        if key == stacked:
            for li in range(n_layer):
                _flatten(node, f"{key}.{li}.", li, flat)
        elif isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                _flatten(sub, f"{key}.{i}.", None, flat)
        elif isinstance(node, dict):
            _flatten(node, f"{key}.", None, flat)
        else:
            flat[key] = np.asarray(node)
    state = {k: torch.tensor(np.ascontiguousarray(v), device=device) for k, v in flat.items()}
    module.load_state_dict(state, strict=True, assign=True)
    return module


def params_from_numpy(tree: Dict[str, Any], config: ModelConfig, device="cuda") -> GPT2:
    """A JAX parameter tree of numpy arrays (``jax.tree_util.tree_map(
    np.asarray, params)`` of full-precision params, e.g. from
    ``ergm_tpu.models.gpt2.init_params`` or a checkpoint) -> ``GPT2``.

    The tree's ``blocks`` arrays are stacked on a leading layer axis;
    layer ``i`` becomes ``blocks[i]``. Every other leaf copies as it is
    (kernels keep their [in, out] orientation). The tensors land on
    ``device``, the card unless the caller asks for the CPU. Quantize
    afterwards with ``params_for_inference``."""
    return _module_from_tree(GPT2(config, device="meta"), tree, "blocks", config.n_layer,
                             resolve(device))


def audio_params_from_numpy(tree: Dict[str, Any], cfg: AudioEncoderConfig,
                            device="cuda") -> AudioEncoder:
    """JAX's audio-encoder tree as numpy arrays (``ergm_tpu.tools.audio``'s
    ``init_audio_params`` or ``hf_to_audio_params``: the
    ``feature_extractor`` list, ``pos_conv``, ``layers`` stacked on a
    leading layer axis) -> ``AudioEncoder`` on ``device``, frozen."""
    from ergm_tpu_torch.tools.audio import AudioEncoder

    module = AudioEncoder(cfg, device="meta")
    return _module_from_tree(module, tree, "layers", cfg.num_layers,
                             resolve(device)).requires_grad_(False)


def vision_params_from_numpy(tree: Dict[str, Any], cfg: VisionEncoderConfig,
                             device="cuda") -> VisionEncoder:
    """JAX's vision-encoder tree as numpy arrays (``layers`` stacked on a
    leading layer axis) -> ``VisionEncoder`` on ``device``, frozen."""
    from ergm_tpu_torch.tools.vision import VisionEncoder

    module = VisionEncoder(cfg, device="meta")
    return _module_from_tree(module, tree, "layers", cfg.num_layers,
                             resolve(device)).requires_grad_(False)


def _hf_name(key: str) -> Tuple[str, bool]:
    """A port parameter name -> (its HF name without the ``transformer.``
    prefix, whether the tensor is transposed there)."""
    mod, leaf = key.rsplit(".", 1)
    leaf = "bias" if leaf == "bias" else "weight"
    if mod in _HEADS:
        return f"{mod}.{leaf}", leaf == "weight"
    return ".".join(_HF_MODULE.get(m, m) for m in mod.split(".")) + f".{leaf}", False


def _to_tensor(x) -> torch.Tensor:
    # a copy: the converted model must not share storage with the source
    return torch.as_tensor(np.asarray(x)).clone() if not isinstance(x, torch.Tensor) \
        else x.detach().cpu().clone()


def _strip_prefix(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k.removeprefix("transformer."): _to_tensor(v) for k, v in state.items()}


def infer_geometry(state_dict: Mapping[str, Any]) -> Dict[str, int]:
    """(n_layer, n_embd, n_positions, vocab_size) of a GPT-2 state dict.
    n_head is not recoverable from the weights and comes from the config."""
    sd = _strip_prefix(state_dict)
    n_layer = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("h."))
    vocab, n_embd = sd["wte.weight"].shape
    return {"n_layer": n_layer, "n_embd": n_embd,
            "n_positions": sd["wpe.weight"].shape[0], "vocab_size": vocab}


def hf_to_params(state_dict: Mapping[str, Any], config: ModelConfig,
                 generator: Optional[torch.Generator] = None, device="cuda") -> GPT2:
    """An HF GPT-2 state dict (GPT2Model, GPT2LMHeadModel, or the
    reference's model with ``crossattention.*`` and ``emotion_head.*``)
    -> ``GPT2`` on ``device``, the card unless the caller asks for the
    CPU. What the checkpoint lacks of the cross-attention and the heads,
    and the rows of a larger ``config.vocab_size``, are drawn from
    ``generator`` (a CPU generator seeded with 0 when None)."""
    sd = _strip_prefix(state_dict)
    vocab = sd["wte.weight"].shape[0]
    if vocab > config.vocab_size:
        raise ValueError(f"checkpoint vocab {vocab} > config vocab {config.vocab_size}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_params(generator, config.replace(vocab_size=vocab), device=device)
    with torch.no_grad():
        for key, p in model.named_parameters():
            name, transposed = _hf_name(key)
            if name not in sd:
                if not any(part in _OPTIONAL for part in key.split(".")):
                    raise KeyError(f"missing tensor {name!r} in checkpoint")
                continue
            p.copy_(sd[name].t() if transposed else sd[name])
    model.config = config.replace(vocab_size=vocab)
    return resize_token_embeddings(model, generator, config.vocab_size, config)


def params_to_hf(params: GPT2, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """The full-precision model as an HF-style state dict of CPU tensors,
    ``lm_head.weight`` tied to ``wte``."""
    out = {}
    for key, p in params.named_parameters():
        name, transposed = _hf_name(key)
        if not name.startswith(_HEADS):
            name = f"transformer.{name}"
        out[name] = (p.t() if transposed else p).detach().cpu().contiguous().clone()
    out["lm_head.weight"] = out["transformer.wte.weight"]
    return out


def load_torch_checkpoint(path: str, config: ModelConfig,
                          generator: Optional[torch.Generator] = None, device="cuda") -> GPT2:
    """A reference ``.ckpt`` file (a dict with ``model_state_dict``) or a
    bare state dict, as a ``GPT2`` on ``device``."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    return hf_to_params(state, config, generator=generator, device=device)
