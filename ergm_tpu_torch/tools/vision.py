"""BLIP ViT-B/16 visual encoder (counterpart of ``ergm_tpu/tools/vision.py``).

A 16x16 patch conv, the cls token and learned position embeddings,
pre-LN blocks with one fused ``qkv`` product, and the post LayerNorm,
one submodule per block. ``hf_to_vision_params`` loads an HF
``BlipVisionModel`` state dict without importing ``transformers``.

At 384 px the encoder sees 577 tokens. That is not a multiple of 128,
so its attention takes the plain math, as on the TPU (JAX's Pallas
gates refuse it too); tokens are not padded to reach a kernel. The patch
conv runs in fp32 with cuDNN's TF32 off (``audio.fp32_convolutions``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.models import convert
from ergm_tpu_torch.models.gpt2 import Dense, LayerNorm, dense, layer_norm
from ergm_tpu_torch.ops.attention import multihead_attention
from ergm_tpu_torch.tools.audio import _np, _param, _split_heads, fp32_convolutions


@dataclasses.dataclass(frozen=True)
class VisionEncoderConfig:
    """BLIP-base vision geometry by default (ViT-B/16 at 384px)."""

    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"
    attention_impl: str = "auto"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class PatchEmbed(nn.Module):
    def __init__(self, hidden: int, patch: int, device=None):
        super().__init__()
        self.kernel = _param(hidden, 3, patch, patch, device=device)
        self.bias = _param(hidden, device=device)


class VisionBlock(nn.Module):
    """Pre-LN ViT block (HF BlipEncoderLayer)."""

    def __init__(self, hidden: int, inner: int, device=None):
        super().__init__()
        self.qkv = Dense(hidden, 3 * hidden, device=device)
        self.proj = Dense(hidden, hidden, device=device)
        self.ln1 = LayerNorm(hidden, device)
        self.fc1 = Dense(hidden, inner, device=device)
        self.fc2 = Dense(inner, hidden, device=device)
        self.ln2 = LayerNorm(hidden, device)


class VisionEncoder(nn.Module):
    """Parameter container named like JAX's tree; ``VisionEncoder(cfg)(images)``
    runs ``vision_encoder``."""

    def __init__(self, config: VisionEncoderConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        H = c.hidden_size
        self.patch_embed = PatchEmbed(H, c.patch_size, device)
        self.cls_token = _param(1, 1, H, device=device)
        self.pos_embed = _param(1, c.num_patches + 1, H, device=device)
        self.layers = nn.ModuleList(VisionBlock(H, c.intermediate_size, device)
                                    for _ in range(c.num_layers))
        self.post_layernorm = LayerNorm(H, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return vision_encoder(self, self.config, images)


@torch.no_grad()
def init_vision_params(generator: torch.Generator, cfg: VisionEncoderConfig,
                       device="cuda") -> VisionEncoder:
    """Random init with JAX's distributions: N(0, 0.02) kernels, cls token
    and positions, zero biases, unit scales; drawn from ``generator``,
    placed on ``device`` (the card unless the caller asks for the CPU)."""
    model = VisionEncoder(cfg, device=resolve(device))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * 0.02)
    return model.requires_grad_(False)


def vision_encoder(params: VisionEncoder, cfg: VisionEncoderConfig,
                   images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] (HF pixel_values layout) -> [B, patches+1, hidden]
    (BlipVisionModel last_hidden_state, the tensor
    feature_extraction.py:48-52 extracts)."""
    dtype = cfg.compute_dtype
    eps = cfg.layer_norm_eps
    with fp32_convolutions():
        x = F.conv2d(images.float(), params.patch_embed.kernel, stride=cfg.patch_size)
    B, H, gh, gw = x.shape
    x = x.reshape(B, H, gh * gw).transpose(1, 2)
    x = x + params.patch_embed.bias
    cls = params.cls_token.expand(B, 1, H)
    h = torch.cat([cls, x], dim=1)
    h = h + params.pos_embed[:, : h.shape[1]]
    h = h.to(dtype)

    nh = cfg.num_heads
    for p in params.layers:
        y = layer_norm(h, p.ln1, eps)
        q, k, v = (_split_heads(t, nh) for t in dense(y, p.qkv).chunk(3, dim=-1))
        a = multihead_attention(q, k, v, causal=False, impl=cfg.attention_impl)
        a = a.transpose(1, 2).reshape(h.shape)
        h = h + dense(a, p.proj)
        y = F.gelu(dense(layer_norm(h, p.ln2, eps), p.fc1))
        h = h + dense(y, p.fc2)
    return layer_norm(h, params.post_layernorm, eps)


def extract_image_features(params: VisionEncoder, cfg: VisionEncoderConfig,
                           images: torch.Tensor) -> torch.Tensor:
    """Mean-pooled image feature [B, hidden] (feature_extraction.py:64-70)."""
    return torch.mean(vision_encoder(params, cfg, images), dim=1)


def hf_to_vision_tree(state: Mapping[str, Any], cfg: VisionEncoderConfig) -> Dict[str, Any]:
    """An HF BlipVisionModel state dict (optionally under a
    'vision_model.' prefix; torch tensors or numpy) -> JAX's parameter
    tree as numpy arrays; nn.Linear weights transpose to (in, out)."""
    sd = {}
    for k, v in state.items():
        if k.startswith("vision_model."):
            k = k[len("vision_model."):]
        sd[k] = _np(v)
    L = cfg.num_layers

    def stack_lin(fmt):
        w = np.stack([sd[fmt.format(i) + ".weight"].T for i in range(L)])
        b = np.stack([sd[fmt.format(i) + ".bias"] for i in range(L)])
        return {"kernel": w, "bias": b}

    def stack_ln(fmt):
        return {"scale": np.stack([sd[fmt.format(i) + ".weight"] for i in range(L)]),
                "bias": np.stack([sd[fmt.format(i) + ".bias"] for i in range(L)])}

    return {
        "patch_embed": {"kernel": sd["embeddings.patch_embedding.weight"],
                        "bias": sd["embeddings.patch_embedding.bias"]},
        "cls_token": sd["embeddings.class_embedding"].reshape(1, 1, -1),
        "pos_embed": sd["embeddings.position_embedding"],
        "layers": {
            "qkv": stack_lin("encoder.layers.{}.self_attn.qkv"),
            "proj": stack_lin("encoder.layers.{}.self_attn.projection"),
            "ln1": stack_ln("encoder.layers.{}.layer_norm1"),
            "fc1": stack_lin("encoder.layers.{}.mlp.fc1"),
            "fc2": stack_lin("encoder.layers.{}.mlp.fc2"),
            "ln2": stack_ln("encoder.layers.{}.layer_norm2"),
        },
        "post_layernorm": {"scale": sd["post_layernorm.weight"],
                           "bias": sd["post_layernorm.bias"]},
    }


def hf_to_vision_params(state: Mapping[str, Any], cfg: VisionEncoderConfig,
                        device="cuda") -> VisionEncoder:
    """An HF BlipVisionModel state dict -> ``VisionEncoder`` on ``device``
    (the card unless the caller asks for the CPU)."""
    return convert.vision_params_from_numpy(hf_to_vision_tree(state, cfg), cfg, device=device)
