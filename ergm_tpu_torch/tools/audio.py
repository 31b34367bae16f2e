"""wav2vec2-style audio encoder and its signal front end (counterpart of
``ergm_tpu/tools/audio.py``).

- ``resample`` / ``log_mel_spectrogram``: the signal front end (linear
  resampling; frame, Hann window, rFFT, mel filterbank, log),
- ``AudioEncoder``: the wav2vec2 architecture, one submodule per layer:
  a 7-layer strided conv feature extractor with a per-channel group norm
  on layer 0 and exact GELU, LayerNorm and the feature projection, a
  weight-normed grouped convolutional position embedding, and post-LN
  encoder layers. ``hf_to_audio_params`` loads an HF ``Wav2Vec2Model``
  state dict without importing ``transformers``,
- ``extract_audio_features``: the mean-pooled utterance feature.

Self-attention goes through ``ops/attention.py::multihead_attention``
with ``causal=False``, as JAX's does: on the card a clip whose frame
count is a multiple of 128 takes kernel K5 (``ops/block_attention.py``),
inside JAX's block gate up to 1,024 frames and inside its flash gate
above; other frame counts take the plain math, as on the TPU.

JAX runs every convolution at ``precision="highest"``. cuDNN runs fp32
convolutions in TF32 unless told otherwise, so each convolution here runs
with cuDNN's TF32 off (``fp32_convolutions``), whatever the process's
setting.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.models import convert
from ergm_tpu_torch.models.gpt2 import Dense, LayerNorm, dense, layer_norm
from ergm_tpu_torch.ops.attention import multihead_attention


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """wav2vec2-base geometry by default (HF Wav2Vec2Config defaults)."""

    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"
    attention_impl: str = "auto"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def frames_for_samples(self, n: int) -> int:
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN's TF32 off for the duration, restored after (JAX's
    ``precision="highest"``); no effect on the CPU."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Signal frontend
# ---------------------------------------------------------------------------


def resample(wav: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Linear-interpolation resample along the last axis (the reference
    relies on librosa's 16 kHz load, feature_extraction.py:18)."""
    if orig_sr == target_sr:
        return wav
    n_in = wav.shape[-1]
    n_out = int(round(n_in * target_sr / orig_sr))
    # positions rounded once from float64 (jnp.linspace's float32 quotients
    # are not all correctly rounded on XLA's CPU backend: they may differ
    # by one float32 ulp)
    pos = torch.linspace(0.0, n_in - 1.0, n_out, dtype=torch.float64,
                         device=wav.device).float()
    i0 = torch.clamp(torch.floor(pos).long(), 0, n_in - 1)
    i1 = torch.clamp(i0 + 1, 0, n_in - 1)
    frac = pos - i0
    return wav[..., i0] * (1.0 - frac) + wav[..., i1] * frac


def mel_filterbank(num_mels: int, n_fft: int, sr: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """[num_mels, n_fft//2+1] triangular (HTK) mel filterbank."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((num_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, num_mels + 1):
        l, c, r = bins[m - 1], bins[m], bins[m + 1]
        for k in range(l, c):
            if c > l:
                fb[m - 1, k] = (k - l) / (c - l)
        for k in range(c, r):
            if r > c:
                fb[m - 1, k] = (r - k) / (r - c)
    return fb


def log_mel_spectrogram(
    wav: torch.Tensor,  # [B, T] or [T]
    *,
    sr: int = 16000,
    n_fft: int = 400,
    hop: int = 160,
    num_mels: int = 80,
) -> torch.Tensor:
    """[B, frames, num_mels] log-mel features on wav's device (frame →
    Hann window → rFFT → mel projection → log)."""
    if wav.dim() == 1:
        wav = wav[None]
    B, T = wav.shape
    n_frames = 1 + (T - n_fft) // hop if T >= n_fft else 0
    if n_frames <= 0:
        raise ValueError(f"waveform too short for n_fft={n_fft}")
    idx = (torch.arange(n_frames, device=wav.device)[:, None] * hop
           + torch.arange(n_fft, device=wav.device)[None, :])
    frames = wav[:, idx]  # [B, frames, n_fft]
    window = torch.as_tensor(np.hanning(n_fft + 1)[:-1], dtype=torch.float32, device=wav.device)
    spec = torch.abs(torch.fft.rfft(frames * window, dim=-1)) ** 2
    fb = torch.as_tensor(mel_filterbank(num_mels, n_fft, sr), device=wav.device)
    mel = torch.einsum("bfk,mk->bfm", spec, fb)
    return torch.log(torch.clamp_min(mel, 1e-10))


# ---------------------------------------------------------------------------
# wav2vec2-style encoder
# ---------------------------------------------------------------------------


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


class ConvLayer(nn.Module):
    """One feature-extractor layer: ``conv`` [C_out, C_in, K]; layer 0 also
    has the per-channel GroupNorm's ``gn_scale`` and ``gn_bias``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, group_norm: bool, device=None):
        super().__init__()
        self.conv = _param(c_out, c_in, kernel, device=device)
        self.gn_scale = _param(c_out, device=device) if group_norm else None
        self.gn_bias = _param(c_out, device=device) if group_norm else None


class FeatureProjection(nn.Module):
    def __init__(self, c: int, hidden: int, device=None):
        super().__init__()
        self.layer_norm = LayerNorm(c, device)
        self.projection = Dense(c, hidden, device=device)


class PosConv(nn.Module):
    """The weight-normed positional conv, materialised: ``weight``
    [H, H / groups, K] and ``bias`` [H]."""

    def __init__(self, hidden: int, groups: int, kernel: int, device=None):
        super().__init__()
        self.weight = _param(hidden, hidden // groups, kernel, device=device)
        self.bias = _param(hidden, device=device)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer (HF Wav2Vec2EncoderLayer, base variant)."""

    def __init__(self, hidden: int, inner: int, device=None):
        super().__init__()
        self.q_proj = Dense(hidden, hidden, device=device)
        self.k_proj = Dense(hidden, hidden, device=device)
        self.v_proj = Dense(hidden, hidden, device=device)
        self.out_proj = Dense(hidden, hidden, device=device)
        self.layer_norm = LayerNorm(hidden, device)
        self.intermediate = Dense(hidden, inner, device=device)
        self.output = Dense(inner, hidden, device=device)
        self.final_layer_norm = LayerNorm(hidden, device)


class AudioEncoder(nn.Module):
    """Parameter container named like JAX's tree; ``AudioEncoder(cfg)(wav)``
    runs ``audio_encoder``."""

    def __init__(self, config: AudioEncoderConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        convs, c_in = [], 1
        for i, (ch, kern) in enumerate(zip(c.conv_dim, c.conv_kernel)):
            convs.append(ConvLayer(c_in, ch, kern, group_norm=i == 0, device=device))
            c_in = ch
        self.feature_extractor = nn.ModuleList(convs)
        self.feature_projection = FeatureProjection(c.conv_dim[-1], c.hidden_size, device)
        self.pos_conv = PosConv(c.hidden_size, c.num_conv_pos_embedding_groups,
                                c.num_conv_pos_embeddings, device)
        self.encoder_layer_norm = LayerNorm(c.hidden_size, device)
        self.layers = nn.ModuleList(EncoderLayer(c.hidden_size, c.intermediate_size, device)
                                    for _ in range(c.num_layers))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return audio_encoder(self, self.config, wav)


@torch.no_grad()
def init_audio_params(generator: torch.Generator, cfg: AudioEncoderConfig,
                      device="cuda") -> AudioEncoder:
    """Random init with JAX's distributions: conv kernels N(0, 2 / (C_in·K)),
    every other kernel and the positional conv N(0, 0.02), zero biases,
    unit scales. The draws come from ``generator`` (made on its device);
    the parameters live on ``device``, the card unless the caller asks for
    the CPU."""
    model = AudioEncoder(cfg, device=resolve(device))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "gn_bias"):
            p.zero_()
        elif leaf in ("scale", "gn_scale"):
            p.fill_(1.0)
        else:
            std = (2.0 / (p.shape[1] * p.shape[2])) ** 0.5 if leaf == "conv" else 0.02
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * std)
    return model.requires_grad_(False)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.view(b, l, n_head, d // n_head).transpose(1, 2)


def audio_encoder(params: AudioEncoder, cfg: AudioEncoderConfig,
                  wav: torch.Tensor) -> torch.Tensor:
    """[B, T] 16 kHz waveform -> [B, frames, hidden] (HF Wav2Vec2Model
    last_hidden_state semantics, the tensor feature_extraction.py:23-26
    extracts)."""
    dtype = cfg.compute_dtype
    eps = cfg.layer_norm_eps
    x = wav[:, None, :].float()  # [B, 1, T]

    # conv feature extractor (group-norm on layer 0, gelu everywhere)
    with fp32_convolutions():
        for i, layer in enumerate(params.feature_extractor):
            x = F.conv1d(x, layer.conv, stride=cfg.conv_stride[i])
            if layer.gn_scale is not None:
                # per-channel GroupNorm(num_groups=channels) over time
                mean = x.mean(dim=-1, keepdim=True)
                var = x.var(dim=-1, keepdim=True, unbiased=False)
                x = (x - mean) * torch.rsqrt(var + eps)
                x = x * layer.gn_scale[None, :, None] + layer.gn_bias[None, :, None]
            x = F.gelu(x)

    h = x.transpose(1, 2)  # [B, frames, C]
    fp = params.feature_projection
    h = layer_norm(h, fp.layer_norm, eps)
    h = dense(h.to(dtype), fp.projection)

    # convolutional positional embedding (weight-normed conv, groups=16)
    pad = cfg.num_conv_pos_embeddings // 2
    with fp32_convolutions():
        pos = F.conv1d(h.transpose(1, 2).float(), params.pos_conv.weight, padding=pad,
                       groups=cfg.num_conv_pos_embedding_groups)
    pos = pos + params.pos_conv.bias[None, :, None]
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[..., :-1]
    pos = F.gelu(pos).transpose(1, 2)
    h = h + pos.to(dtype)
    h = layer_norm(h, params.encoder_layer_norm, eps)

    nh = cfg.num_heads
    for p in params.layers:
        q, k, v = (_split_heads(dense(h, proj), nh) for proj in (p.q_proj, p.k_proj, p.v_proj))
        a = multihead_attention(q, k, v, causal=False, impl=cfg.attention_impl)
        a = a.transpose(1, 2).reshape(h.shape)
        h = layer_norm(h + dense(a, p.out_proj), p.layer_norm, eps)
        ff = F.gelu(dense(h, p.intermediate))
        h = layer_norm(h + dense(ff, p.output), p.final_layer_norm, eps)
    return h


def extract_audio_features(params: AudioEncoder, cfg: AudioEncoderConfig,
                           wav: torch.Tensor) -> torch.Tensor:
    """Mean-pooled utterance feature [B, hidden]
    (feature_extraction.py:56-62)."""
    return torch.mean(audio_encoder(params, cfg, wav), dim=1)


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------


def _np(t):
    return t if isinstance(t, np.ndarray) else t.detach().cpu().numpy()


def hf_to_audio_tree(state: Mapping[str, Any], cfg: AudioEncoderConfig) -> Dict[str, Any]:
    """An HF Wav2Vec2Model state dict (optionally under a 'wav2vec2.'
    prefix; torch tensors or numpy) -> JAX's parameter tree as numpy
    arrays (``ergm_tpu/tools/audio.py::hf_to_audio_params``'s layout).
    nn.Linear weights transpose to (in, out); the weight-normed positional
    conv is materialized (w = g * v / ||v||, norms over (out, in) per
    kernel position), from the ``parametrizations.weight.original0/1``
    names or the older ``weight_g`` / ``weight_v``."""
    sd = {}
    for k, v in state.items():
        if k.startswith("wav2vec2."):
            k = k[len("wav2vec2."):]
        sd[k] = _np(v)
    L = cfg.num_layers

    convs = []
    for i in range(len(cfg.conv_dim)):
        layer = {"conv": sd[f"feature_extractor.conv_layers.{i}.conv.weight"]}
        if i == 0:
            layer["gn_scale"] = sd["feature_extractor.conv_layers.0.layer_norm.weight"]
            layer["gn_bias"] = sd["feature_extractor.conv_layers.0.layer_norm.bias"]
        convs.append(layer)

    if "encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd:
        g = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"]
        v = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"]
    else:  # older torch weight_norm naming
        g = sd["encoder.pos_conv_embed.conv.weight_g"]
        v = sd["encoder.pos_conv_embed.conv.weight_v"]
    norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0, keepdims=True)[None]
    pos_w = g * v / np.maximum(norm, 1e-12)

    def stack_lin(fmt):
        w = np.stack([sd[fmt.format(i) + ".weight"].T for i in range(L)])
        b = np.stack([sd[fmt.format(i) + ".bias"] for i in range(L)])
        return {"kernel": w, "bias": b}

    def stack_ln(fmt):
        return {"scale": np.stack([sd[fmt.format(i) + ".weight"] for i in range(L)]),
                "bias": np.stack([sd[fmt.format(i) + ".bias"] for i in range(L)])}

    return {
        "feature_extractor": convs,
        "feature_projection": {
            "layer_norm": {"scale": sd["feature_projection.layer_norm.weight"],
                           "bias": sd["feature_projection.layer_norm.bias"]},
            "projection": {"kernel": sd["feature_projection.projection.weight"].T,
                           "bias": sd["feature_projection.projection.bias"]},
        },
        "pos_conv": {"weight": pos_w, "bias": sd["encoder.pos_conv_embed.conv.bias"]},
        "encoder_layer_norm": {"scale": sd["encoder.layer_norm.weight"],
                               "bias": sd["encoder.layer_norm.bias"]},
        "layers": {
            "q_proj": stack_lin("encoder.layers.{}.attention.q_proj"),
            "k_proj": stack_lin("encoder.layers.{}.attention.k_proj"),
            "v_proj": stack_lin("encoder.layers.{}.attention.v_proj"),
            "out_proj": stack_lin("encoder.layers.{}.attention.out_proj"),
            "layer_norm": stack_ln("encoder.layers.{}.layer_norm"),
            "intermediate": stack_lin("encoder.layers.{}.feed_forward.intermediate_dense"),
            "output": stack_lin("encoder.layers.{}.feed_forward.output_dense"),
            "final_layer_norm": stack_ln("encoder.layers.{}.final_layer_norm"),
        },
    }


def hf_to_audio_params(state: Mapping[str, Any], cfg: AudioEncoderConfig,
                       device="cuda") -> AudioEncoder:
    """An HF Wav2Vec2Model state dict -> ``AudioEncoder`` on ``device`` (the
    card unless the caller asks for the CPU), through ``hf_to_audio_tree``."""
    return convert.audio_params_from_numpy(hf_to_audio_tree(state, cfg), cfg, device=device)
