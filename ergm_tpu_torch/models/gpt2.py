"""ERGM GPT-2 backbone in PyTorch (counterpart of ``ergm_tpu/models/gpt2.py``).

The parameters live in ``nn.Module``s named like the JAX parameter tree
(``wte``, ``wpe``, ``blocks[i].attn.c_attn`` ...), one ``Block`` per
layer in an ``nn.ModuleList`` where JAX stacks them on a leading layer
axis. Dense kernels keep GPT-2's Conv1D orientation ``[in, out]``, so a
JAX or HF checkpoint converts by copying (``models/convert.py``).

The math mirrors the JAX functions one by one and keeps their rounding
points: f32 LayerNorm statistics, f32 matmul accumulation, f32 softmax,
bf16-rounded int8 KV scales. Layers and decode steps are Python loops.

Training (``forward`` with ``labels`` and ``deterministic=False``) runs
JAX's dropout sites with masks fixed by (step seed, layer, site)
(``core/rng.py``), its remat policies through ``torch.utils.checkpoint``,
self-attention through kernel K5 (``ops/block_attention.py``) and the LM
loss through kernel K6 (``ops/fused_ce.py``) on the card. Over a mesh
(``forward(mesh=...)``, ``core/mesh.py``) each data rank runs its rows,
and with a model axis its head groups and MLP columns (Megatron's tensor
parallelism, ``_Shard``), in training and in the cached forward of
inference alike (the cache then holds this rank's rows and heads).
Inference is deterministic. Batched short prompt prefill routes its self- and
cross-attention through kernel K1 (``ops/prefill_attention.py``). Single-token decode
steps route, under JAX's switches (all off by default), through kernel
K3 for the int8 cross sublayer (``ERGM_CROSS_KERNEL=1``,
``ops/cross_decode.py``), K4 for the LN2 + MLP tail
(``config.decode_fused_mlp``, ``ops/fused_decode.py``) and K2 for the
int8 self-attention over a cache of 512 slots or more
(``ERGM_DECODE_KERNEL=1``, ``ops/decode_attention.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ergm_tpu_torch.core import device as core_device
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.device import resolve
from ergm_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, head_groups, local_heads
from ergm_tpu_torch.core.rng import fold_seed
from ergm_tpu_torch.ops import (cross_decode, decode_attention, fused_ce, fused_decode,
                                prefill_attention)
from ergm_tpu_torch.ops.attention import matmul_f32, multihead_attention
from ergm_tpu_torch.parallel.collectives import copy_to_model, global_mean, reduce_from_model


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param(d, device=device)
        self.bias = _param(d, device=device)


class Dense(nn.Module):
    """GPT-2 Conv1D: ``kernel`` [in, out] and ``bias`` [out]. Weight-only
    int8 serving replaces ``kernel`` with ``kernel_q`` int8 [in, out] and
    per-out-channel ``kernel_scale`` [1, out] (``quantize_params_int8``)."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True, device=None):
        super().__init__()
        self.kernel = _param(n_in, n_out, device=device)
        self.bias = _param(n_out, device=device) if bias else None
        self.register_buffer("kernel_q", None)
        self.register_buffer("kernel_scale", None)


class Embedding(nn.Module):
    """A [rows, D] table; the tied vocab table may be int8 with per-row
    ``embedding_scale`` [V, 1] instead."""

    def __init__(self, rows: int, d: int, device=None):
        super().__init__()
        self.embedding = _param(rows, d, device=device)
        self.register_buffer("embedding_q", None)
        self.register_buffer("embedding_scale", None)


class Attention(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.c_attn = Dense(d, 3 * d, device=device)
        self.c_proj = Dense(d, d, device=device)


class CrossAttention(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.q_attn = Dense(d, d, device=device)
        self.c_attn = Dense(d, 2 * d, device=device)
        self.c_proj = Dense(d, d, device=device)


class MLP(nn.Module):
    def __init__(self, d: int, inner: int, device=None):
        super().__init__()
        self.c_fc = Dense(d, inner, device=device)
        self.c_proj = Dense(inner, d, device=device)


class Block(nn.Module):
    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        d = config.n_embd
        self.ln_1 = LayerNorm(d, device)
        self.attn = Attention(d, device)
        if config.use_cross_attention:
            self.ln_cross = LayerNorm(d, device)
            self.cross_attn = CrossAttention(d, device)
        self.ln_2 = LayerNorm(d, device)
        self.mlp = MLP(d, config.inner_dim, device)


class GPT2(nn.Module):
    """Parameter container; ``GPT2(config)(input_ids, ...)`` runs ``forward``."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.wte = Embedding(c.vocab_size, c.n_embd, device)
        self.wpe = Embedding(c.n_positions, c.n_embd, device)
        self.blocks = nn.ModuleList(Block(c, device) for _ in range(c.n_layer))
        self.ln_f = LayerNorm(c.n_embd, device)
        self.emotion_head = Dense(c.n_embd, c.num_emotions, bias=False, device=device)
        if c.modality_dim != c.n_embd:
            self.img_proj = Dense(c.modality_dim, c.n_embd, device=device)
            self.aud_proj = Dense(c.modality_dim, c.n_embd, device=device)

    def forward(self, input_ids, **kwargs) -> "ModelOutput":
        return forward(self, self.config, input_ids, **kwargs)


@torch.no_grad()
def init_params(generator: torch.Generator, config: ModelConfig, device="cuda") -> GPT2:
    """Random init as JAX's: N(0, initializer_range) kernels and
    embeddings, N(0, initializer_range / sqrt(2 n_layer)) for every
    ``c_proj``, zero biases, unit LayerNorm scales. The draws come from
    ``generator`` (made on its device); the parameters live on ``device``,
    the card unless the caller asks for the CPU."""
    c = config
    model = GPT2(c, device=resolve(device))
    std = c.initializer_range
    proj_std = std / (2 * c.n_layer) ** 0.5
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            s = proj_std if ".c_proj." in name else std
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * s)
    return model


@torch.no_grad()
def prune_heads(params: GPT2, config: ModelConfig,
                heads_to_prune: Dict[int, List[int]]) -> Tuple[GPT2, ModelConfig]:
    """Remove self-attention heads IN PLACE (reference: src/model.py:
    106-117); returns ``(params, new_config)``.

    As in JAX every layer keeps ``n_head - k`` heads, so each listed
    layer prunes the same number k; unlisted layers drop their
    highest-indexed heads. The head dim stays (``head_dim_override``) and
    so does ``n_embd``; the model must not have been quantized."""
    c = config
    counts = {len(v) for v in heads_to_prune.values()}
    if len(counts) != 1:
        raise ValueError("stacked-layer pruning needs the same number of "
                         "pruned heads per listed layer")
    new_heads = c.n_head - counts.pop()
    hd, D = c.head_dim, c.n_embd
    for li, blk in enumerate(params.blocks):
        pruned = set(heads_to_prune.get(li, []))
        keep = [h for h in range(c.n_head) if h not in pruned] if pruned \
            else list(range(new_heads))
        cols = torch.cat([torch.arange(h * hd, (h + 1) * hd) for h in keep])
        qkv = torch.cat([cols, D + cols, 2 * D + cols])
        attn = blk.attn
        attn.c_attn.kernel = nn.Parameter(attn.c_attn.kernel[:, qkv].clone())
        attn.c_attn.bias = nn.Parameter(attn.c_attn.bias[qkv].clone())
        attn.c_proj.kernel = nn.Parameter(attn.c_proj.kernel[cols].clone())
    new_cfg = c.replace(n_head=new_heads, head_dim_override=hd, n_inner=c.inner_dim)
    params.config = new_cfg
    return params, new_cfg


@torch.no_grad()
def resize_token_embeddings(params: GPT2, generator: torch.Generator, new_vocab: int,
                            config: ModelConfig) -> GPT2:
    """Extend ``wte`` IN PLACE to ``new_vocab`` rows for added special
    tokens, like HF ``resize_token_embeddings`` (reference: src/main.py:
    63): the new rows are N(0, initializer_range) drawn from ``generator``
    (on its device); the tied lm_head follows. Returns ``params``."""
    wte = params.wte
    old = wte.embedding.shape[0]
    if new_vocab > old:
        extra = torch.randn((new_vocab - old, wte.embedding.shape[1]), generator=generator,
                            device=generator.device) * config.initializer_range
        wte.embedding = nn.Parameter(torch.cat([wte.embedding, extra.to(wte.embedding)]))
        params.config = params.config.replace(vocab_size=new_vocab)
    return params


def _quantize_kernel(kernel: torch.Tensor):
    """Per-output-channel symmetric int8 over the input dim: [in, out] ->
    (int8 [in, out], f32 scale [1, out])."""
    kf = kernel.float()
    scale = torch.clamp_min(kf.abs().amax(dim=-2, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def quantize_params_int8(params: GPT2, config: ModelConfig) -> GPT2:
    """Weight-only int8 for serving, IN PLACE (returns ``params``).

    ``wte`` becomes ``embedding_q`` int8 + per-row ``embedding_scale``
    (the tied lm_head applies the scale on the logit axis). With
    ``weight_dtype="int8"`` every dense kernel but the emotion head's
    also becomes ``kernel_q`` + per-out-channel ``kernel_scale``;
    ``"int8_lm_head"`` quantizes ``wte`` only. Scales are stored in the
    compute dtype. Quantize from the full-precision weights."""
    dt = config.compute_dtype
    wte = params.wte
    if wte.embedding_q is None:
        emb = wte.embedding.float()
        s = torch.clamp_min(emb.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
        wte.embedding_q = torch.clamp(torch.round(emb / s), -127, 127).to(torch.int8)
        wte.embedding_scale = s.to(dt)
        wte.embedding = None
    if config.weight_dtype == "int8":
        for name, mod in params.named_modules():
            if isinstance(mod, Dense) and name != "emotion_head" and mod.kernel is not None:
                q, s = _quantize_kernel(mod.kernel)
                mod.kernel_q, mod.kernel_scale = q, s.to(dt)
                mod.kernel = None
    return params


def params_for_inference(params: GPT2, config: ModelConfig) -> GPT2:
    """Quantize as ``weight_dtype`` asks, cast the floating-point weights
    to the compute dtype and freeze them, IN PLACE (returns ``params``)."""
    if config.weight_dtype in ("int8", "int8_lm_head"):
        quantize_params_int8(params, config)
    elif config.weight_dtype != "auto":
        raise ValueError(f"unsupported weight_dtype {config.weight_dtype!r}")
    return params.to(config.compute_dtype).requires_grad_(False)


def embed_rows(wte: Embedding, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Row gather from the (possibly int8) tied vocab table."""
    if wte.embedding_q is not None:
        return wte.embedding_q[ids].to(dtype) * wte.embedding_scale[ids].to(dtype)
    return wte.embedding[ids].to(dtype)


def wte_dense(wte: Embedding, dtype) -> torch.Tensor:
    """The dense [V, D] vocab table (dequantized if int8)."""
    if wte.embedding_q is not None:
        return wte.embedding_q.to(dtype) * wte.embedding_scale.to(dtype)
    return wte.embedding.to(dtype)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, p: LayerNorm, eps: float) -> torch.Tensor:
    xf = x.float()  # f32 statistics for bf16 stability
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


def dense_weight(p: Dense, dtype) -> torch.Tensor:
    """The [in, out] kernel in ``dtype`` (int8 kernels dequantized)."""
    if p.kernel_q is not None:
        return p.kernel_q.to(dtype) * p.kernel_scale.to(dtype)
    return p.kernel.to(dtype)


def dense(x: torch.Tensor, p: Dense) -> torch.Tensor:
    """y = x @ kernel + bias, kernel [in, out], in x's dtype. The product
    accumulates in f32 and the bias joins before the single rounding
    (cuBLAS's addmm epilogue on the GPU). int8 kernels dequantize first."""
    w = dense_weight(p, x.dtype)
    y = torch.addmm(p.bias.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[1])


def _activation(name: str):
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu
    if name == "relu":
        return F.relu
    raise ValueError(f"unsupported activation {name!r}")


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.view(b, l, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Fixed-size decode cache, updated IN PLACE by ``forward``.

    ``k``/``v``: [L, B, H, T, Dh]. ``index`` counts the filled positions:
    a Python int shared by all rows (the scalar cursor of ``generate``),
    or a [B] int32 tensor of per-row write cursors (``per_row_index``,
    the continuous server's layout: row b's K/V lie at [0, index[b]) and
    a single-token step writes at index[b]). With
    ``kv_cache_dtype="int8"`` they hold int8 codes with per-(token, head)
    bf16 scales ``k_scale``/``v_scale`` [L, B, H, T, 1]; ``"int4"`` packs
    two codes in [-7, 7] per byte, [L, B, H, T, Dh/2] (``_pack_int4``).
    The caption's cross K/V are computed once at prefill into
    ``ck``/``cv``, merged-head [L, B, Lc, H*Dh]; with
    ``cross_kv_dtype="int8"`` they are int8 with per-(token, head) f32
    scales ``ck_scale``/``cv_scale`` [L, B, Lc, H].

    ``sk``/``sv`` [L, B, H, K, Dh] (compute dtype) stage a server decode
    block over a quantized cache: step j of the block writes every row's K/V at the uniform
    index j there, and ``flush_staging`` commits the K steps to the main
    cache once, quantized once. They are None outside a block."""

    k: torch.Tensor
    v: torch.Tensor
    index: Union[int, torch.Tensor] = 0
    ck: Optional[torch.Tensor] = None
    cv: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    ck_scale: Optional[torch.Tensor] = None
    cv_scale: Optional[torch.Tensor] = None
    sk: Optional[torch.Tensor] = None
    sv: Optional[torch.Tensor] = None


def init_kv_cache(config: ModelConfig, batch: int, max_len: int,
                  caption_len: int = 0, device="cuda",
                  per_row_index: bool = False, mesh=None) -> KVCache:
    """A zeroed cache on ``device`` (the card unless the caller asks for
    the CPU); ``per_row_index`` gives it a [batch] int32 cursor tensor.
    Over a ``mesh`` ``batch`` is this rank's rows and the cache holds this
    model rank's heads (``core.mesh.local_heads``)."""
    c = config
    device = resolve(device)
    if c.kv_cache_dtype not in ("auto", "int8", "int4"):
        raise ValueError(f"unknown kv_cache_dtype {c.kv_cache_dtype!r}")
    h0, h1 = local_heads(c.n_head, mesh)
    H = h1 - h0
    quant = c.kv_cache_dtype != "auto"
    dm = c.head_dim // 2 if c.kv_cache_dtype == "int4" else c.head_dim
    shape = (c.n_layer, batch, H, max_len, dm)
    dt = torch.int8 if quant else c.compute_dtype
    cache = KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                    v=torch.zeros(shape, dtype=dt, device=device))
    if per_row_index:
        cache.index = torch.zeros((batch,), dtype=torch.int32, device=device)
    if quant:
        sshape = (c.n_layer, batch, H, max_len, 1)
        cache.k_scale = torch.zeros(sshape, dtype=torch.bfloat16, device=device)
        cache.v_scale = torch.zeros(sshape, dtype=torch.bfloat16, device=device)
    if c.use_cross_attention and caption_len > 0:
        cquant = c.cross_kv_dtype == "int8"
        cshape = (c.n_layer, batch, caption_len, H * c.head_dim)
        cdt = torch.int8 if cquant else c.compute_dtype
        cache.ck = torch.zeros(cshape, dtype=cdt, device=device)
        cache.cv = torch.zeros(cshape, dtype=cdt, device=device)
        if cquant:
            csshape = (c.n_layer, batch, caption_len, H)
            cache.ck_scale = torch.zeros(csshape, dtype=torch.float32, device=device)
            cache.cv_scale = torch.zeros(csshape, dtype=torch.float32, device=device)
    return cache


def _kv_bits(config: ModelConfig) -> int:
    return 4 if config.kv_cache_dtype == "int4" else 8


def _quantize_kv(x: torch.Tensor, bits: int = 8):
    """[..., D] -> (int8 codes, bf16 scale [..., 1]). The scale is rounded
    to bf16 BEFORE the divide, so the stored codes invert exactly through
    the stored scale; ``torch.round`` is half-to-even like ``jnp.round``.
    ``bits=4`` clips to [-7, 7] and packs two codes a byte, [..., D/2]."""
    lim = 127.0 if bits == 8 else 7.0
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / lim).to(torch.bfloat16)
    safe = torch.where(scale == 0, 1.0, scale.float())
    q = torch.clamp(torch.round(xf / safe), -lim, lim).to(torch.int8)
    return (_pack_int4(q) if bits == 4 else q), scale


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7], [..., D] -> [..., D/2], two a byte: the low
    nibbles hold q[..., :D/2], the high nibbles q[..., D/2:] (JAX's
    halves layout, so unpacking is a concatenation)."""
    D = q.shape[-1]
    return (q[..., D // 2:] << 4) | (q[..., :D // 2] & 15)


def _unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """[..., D/2] packed -> [..., D] int8 codes, each nibble sign-extended
    by arithmetic shifts of the int8 byte."""
    return torch.cat([(p << 4) >> 4, p >> 4], dim=-1)


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Codes (int4 packed or int8) times their scales, in the compute dtype."""
    dt = config.compute_dtype
    if config.kv_cache_dtype == "int4":
        codes = _unpack_int4(codes)
    return codes.to(dt) * scale.to(dt)


def _scatter_rows(full: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` [L, B, H, K, Dm] into ``full`` [L, B, H, T, Dm] IN
    PLACE, row b's K entries at positions ``pos[b]`` ([B, K], long);
    entries at positions >= T are dropped, as JAX's ``mode="drop"``
    scatter drops them, without reading a position on the host and
    without an out-of-range index (which asserts on the device).

    Dropped entries are sent to T-1 carrying the value that T-1 ends up
    with: the row's own entry for T-1 when it writes one, else T-1's old
    value. Every write to a duplicated index then carries the same
    value, so their order does not matter."""
    T, K = full.shape[3], new.shape[3]
    start = pos[:, :1]
    valid = pos < T
    src = torch.where(valid, torch.arange(K, device=pos.device)[None, :],
                      (T - 1 - start).clamp(0, K - 1))
    keep = (valid | (start <= T - 1))[..., None, None, None]
    b_ix = torch.arange(full.shape[1], device=pos.device)[:, None]
    tc = pos.clamp(max=T - 1)
    # advanced indices [B, K] around the sliced L/H axes: values [B, K, L, H, Dm]
    full[:, b_ix, :, tc] = torch.where(keep, new[:, b_ix, :, src], full[:, b_ix, :, tc])


def flush_staging(cache: KVCache, K: int, config: ModelConfig) -> KVCache:
    """Commit a decode block's staged K/V (``sk``/``sv``, [L, B, H, K,
    Dh]) into the main cache at each row's pre-block cursor ``index - K``
    (writes past capacity drop), quantized once from the staged values,
    so the committed codes are byte-identical to a per-step quantized
    write's. Returns the cache without its staging buffers."""
    if cache.sk is None:
        return cache
    pos = (cache.index.long() - K)[:, None] + torch.arange(K, device=cache.k.device)[None, :]
    bits = _kv_bits(config)
    for codes, scales, staged in ((cache.k, cache.k_scale, cache.sk),
                                  (cache.v, cache.v_scale, cache.sv)):
        q, s = _quantize_kv(staged, bits)
        _scatter_rows(codes, pos, q)
        _scatter_rows(scales, pos, s)
    return dataclasses.replace(cache, sk=None, sv=None)


# ---------------------------------------------------------------------------
# Transformer forward
# ---------------------------------------------------------------------------


def lm_logits(params: GPT2, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head tied to wte: [B, L, D] -> [B, L, V] f32 logits; an int8
    table applies its per-row scale on the logit axis."""
    wte = params.wte
    B, L, D = hidden.shape
    h2 = hidden.reshape(-1, D)
    if wte.embedding_q is not None:
        logits = (matmul_f32(h2, wte.embedding_q.to(hidden.dtype).t())
                  * wte.embedding_scale[:, 0].float())
    else:
        logits = matmul_f32(h2, wte.embedding.to(hidden.dtype).t())
    return logits.view(B, L, -1)


class ModelOutput(NamedTuple):
    logits: Optional[torch.Tensor]  # [B, L, V] f32; None when compute_logits=False
    emotion_logits: torch.Tensor    # [B, num_emotions] f32
    hidden: torch.Tensor            # [B, L, D] final hidden states
    loss: Optional[torch.Tensor] = None
    lm_loss: Optional[torch.Tensor] = None
    emotion_loss: Optional[torch.Tensor] = None
    cache: Optional[KVCache] = None


Scale = Union[float, torch.Tensor]


def _attn_scale(config: ModelConfig, li: int) -> Scale:
    scale = (1.0 / config.head_dim ** 0.5) if config.scale_attn_weights else 1.0
    if config.scale_attn_by_inverse_layer_idx:
        # JAX divides by a traced f32 layer index here; the f32 tensor
        # keeps that arithmetic (and the kernel folds it into q, as JAX does)
        return torch.tensor(scale, dtype=torch.float32) / (li + 1.0)
    return scale


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from a generator seeded with
    ``seed`` (None: off). The same seed draws the same mask, in a
    rematerialised forward too."""
    if seed is None or rate == 0.0:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


@dataclasses.dataclass
class _Shard:
    """What one rank of a mesh runs of a training forward: its rows of
    the global batch (from ``b_off``) and, with a model axis, its head
    group [h0, h0 + heads) of ``n_head`` and the matching MLP columns.

    - ``model``: the model axis's group (None without tensor
      parallelism). Megatron's f (``copy_to_model``) stands before each
      column-parallel product and g (``reduce_from_model``) after each
      row-parallel ``c_proj``, whose bias joins once, after g. Everything
      else (LayerNorms, embeddings, residuals, the emotion head and the
      loss) is replicated across the model axis and so gets equal
      gradients there.
    - Attention-probability dropout draws the single device's masks: the
      seed is folded to ``seed + b_off * n_head + h0`` and the hash's head
      stride is ``n_head`` (``attention.dropout_keep``).
    - The per-site masks act on replicated activations: every model rank
      draws them from the same seed, with the data rank folded in
      (``_site``), so no two data ranks drop the same positions of
      different rows, and data rank 0 draws the single device's.
    - The cached forward runs the same f and g. Every kernel gate reads
      the global ``batch`` (this rank's rows times the data axis) and the
      global config, as JAX's do, so the ranks of a model group take the
      same route; the kernels then run on this rank's rows and heads."""

    model: object
    data_rank: int
    b_off: int
    h0: int
    heads: int
    n_head: int
    parts: int = 1
    batch: int = 0


def _shard_of(mesh, config: ModelConfig, rows: int) -> Optional[_Shard]:
    if mesh is None:
        return None
    parts = mesh.axis_size(MODEL_AXIS)
    model = mesh.group(MODEL_AXIS) if parts > 1 else None
    if parts > 1 and model is None:
        raise ValueError(f"a model axis of {parts} needs a torch.distributed world")
    h0, h1 = head_groups(config.n_head, parts)[mesh.index(MODEL_AXIS)]
    dr = mesh.index(DATA_AXIS)
    return _Shard(model=model, data_rank=dr, b_off=dr * rows, h0=h0, heads=h1 - h0,
                  n_head=config.n_head, parts=parts, batch=rows * mesh.axis_size(DATA_AXIS))


def _heads(config: ModelConfig, shard: Optional[_Shard]) -> int:
    return config.n_head if shard is None else shard.heads


def _gate_batch(B: int, shard: Optional[_Shard]) -> int:
    """The batch a kernel gate reads: the global one over a mesh."""
    return B if shard is None else shard.batch


def _model_group(shard: Optional[_Shard]):
    return None if shard is None else shard.model


def _site(seed: Optional[int], site: int, data_rank: int = 0) -> Optional[int]:
    """The seed of a dropout site; a data rank other than 0 folds itself
    in (see ``_Shard``)."""
    if seed is None:
        return None
    s = fold_seed(seed, site)
    return fold_seed(s, data_rank) if data_rank else s


def _data_rank(shard: Optional[_Shard]) -> int:
    return 0 if shard is None else shard.data_rank


def _attn_seed(seed: Optional[int], site: int, shard: Optional[_Shard]) -> tuple:
    """(the attention dropout seed, the hash's head stride) of a site: the
    single device's masks for this rank's rows and heads."""
    s = _site(seed, site)
    if s is None or shard is None:
        return s, None
    return s + shard.b_off * shard.n_head + shard.h0, shard.n_head


def _col_in(x: torch.Tensor, shard: Optional[_Shard]) -> torch.Tensor:
    """The input of a column-parallel product (Megatron's f)."""
    if shard is None or shard.model is None:
        return x
    return copy_to_model(x, shard.model)


def _row_dense(x: torch.Tensor, p: Dense, shard: Optional[_Shard]) -> torch.Tensor:
    """A row-parallel ``c_proj``: this rank's partial product in f32, summed
    over the model axis (Megatron's g), then the bias, one rounding."""
    if shard is None or shard.model is None:
        return dense(x, p)
    y = matmul_f32(x.reshape(-1, x.shape[-1]), dense_weight(p, x.dtype))
    y = reduce_from_model(y, shard.model)
    return (y + p.bias.float()).to(x.dtype).view(*x.shape[:-1], y.shape[-1])


def _attn_project(out: torch.Tensor, p: Attention, shard: Optional[_Shard] = None
                  ) -> torch.Tensor:
    return _row_dense(_merge_heads(out), p.c_proj, shard)


def _self_attention(h, p: Attention, li, *, config, attn_mask, seed=None,
                    shard: Optional[_Shard] = None):
    """No-cache self-attention sublayer; ``seed`` (the layer's, None when
    deterministic) turns on attention-probability and residual dropout.
    Padded queries are masked as keys are (K5's zero rows). ``shard``:
    this rank's rows and head group over a mesh."""
    c = config
    L = h.shape[1]
    heads = c.n_head if shard is None else shard.heads
    q, k, v = (_split_heads(x, heads) for x in dense(_col_in(h, shard), p.c_attn).chunk(3, dim=-1))
    kv_mask = None if attn_mask is None else attn_mask[:, :L]
    aseed, stride = _attn_seed(seed, 1, shard)
    out = multihead_attention(q, k, v, causal=True, kv_mask=kv_mask, q_mask=kv_mask,
                              scale=_attn_scale(c, li), impl=c.attention_impl,
                              dropout_rate=c.attn_pdrop, deterministic=seed is None,
                              seed=aseed, dropout_head_stride=stride)
    return _dropout(_row_dense(_merge_heads(out), p.c_proj, shard), c.resid_pdrop,
                    _site(seed, 2, _data_rank(shard)))


def _self_attention_cached(h, p: Attention, li: int, cache: KVCache, *, config,
                           attn_mask, prefix_prefill: bool = False,
                           stage_index: Optional[int] = None,
                           shard: Optional[_Shard] = None):
    """Self-attention over the cache.

    Scalar cursor ``cache.index``: writes the new tokens' K/V at it
    (quantized for an int8 or int4 cache). The initial prompt prefill
    attends over the FRESH k/v; the batched short form goes through
    kernel K1. Other calls attend over the cache's layer slice:
    dequantized first below T=512, with the scales factored out of both
    products from T=512 on. Per-row cursors go to ``_self_attention_rows``.
    ``shard``: this rank's rows and head group over a mesh."""
    if torch.is_tensor(cache.index):
        return _self_attention_rows(h, p, li, cache, config=config, attn_mask=attn_mask,
                                    stage_index=stage_index, shard=shard)
    c = config
    B, L, _ = h.shape
    H, Dh = _heads(c, shard), c.head_dim
    Bg = _gate_batch(B, shard)
    qm, km, vm = dense(h, p.c_attn).chunk(3, dim=-1)  # merged views [B, L, D]
    idx = cache.index
    T = cache.k.shape[-2]
    if idx + L > T:
        raise ValueError(f"cache overflow: {idx} + {L} new positions > capacity {T}")
    k4, v4 = km.view(B, L, H, Dh), vm.view(B, L, H, Dh)
    quant = cache.k_scale is not None
    if quant:
        bits = _kv_bits(c)
        kq, ksc = _quantize_kv(k4, bits)
        vq, vsc = _quantize_kv(v4, bits)
        cache.k[li, :, :, idx:idx + L] = kq.transpose(1, 2)
        cache.v[li, :, :, idx:idx + L] = vq.transpose(1, 2)
        cache.k_scale[li, :, :, idx:idx + L] = ksc.transpose(1, 2)
        cache.v_scale[li, :, :, idx:idx + L] = vsc.transpose(1, 2)
    else:
        cache.k[li, :, :, idx:idx + L] = k4.transpose(1, 2)
        cache.v[li, :, :, idx:idx + L] = v4.transpose(1, 2)
    scale = _attn_scale(c, li)

    if prefix_prefill and L > 1:
        # the caller guarantees cache.index == 0
        m = None if attn_mask is None else attn_mask[:, :L]
        if (c.attention_impl == "auto" and L <= 128 and Bg >= 64
                and prefill_attention.supported(Bg, L, c, True)):
            out_m = prefill_attention.prefill_mha(qm, km, vm, m, n_head=H, scale=scale)
            return _row_dense(out_m, p.c_proj, shard)
        # JAX's rule (ergm_tpu/models/gpt2.py:797-809): the plain math
        # only for short prompts at large batch; otherwise "auto" keeps
        # K5 inside its gate and K7's route past it on the card
        impl = c.attention_impl
        if impl == "auto" and L <= 128 and Bg >= 64:
            impl = "xla"
        out = multihead_attention(_split_heads(qm, H), _split_heads(km, H),
                                  _split_heads(vm, H), causal=True, kv_mask=m, q_mask=m,
                                  scale=scale, impl=impl)
        return _attn_project(out, p, shard)

    q = _split_heads(qm, H)
    if quant and L == 1 and T >= 512:
        # scale-factored attention over the raw codes: kernel K2 under
        # ERGM_DECODE_KERNEL=1 (int8 only), else its plain version (int4
        # codes unpacked first)
        kc, vc = cache.k[li], cache.v[li]
        if decode_attention.supported(Bg, T, c):
            attend = decode_attention.decode_mha_int8
        else:
            attend = decode_attention.decode_mha_int8_reference
            if c.kv_cache_dtype == "int4":
                kc, vc = _unpack_int4(kc), _unpack_int4(vc)
        out_m = attend(q, kc, vc, cache.k_scale[li], cache.v_scale[li],
                       idx, scale, None if attn_mask is None else attn_mask[:, :T], n_head=H)
        return _row_dense(out_m[:, None, :], p.c_proj, shard)
    tail = (torch.arange(T, device=h.device) < idx + L).float()[None, :]
    kv_mask = tail if attn_mask is None else attn_mask[:, :T] * tail
    if quant:
        k_all = _dequantize(cache.k[li], cache.k_scale[li], c)
        v_all = _dequantize(cache.v[li], cache.v_scale[li], c)
    else:
        k_all, v_all = cache.k[li], cache.v[li]
    out = multihead_attention(q, k_all, v_all, causal=True, kv_mask=kv_mask, scale=scale,
                              causal_offset=idx, impl=c.attention_impl)
    return _attn_project(out, p, shard)


def _self_attention_rows(h, p: Attention, li: int, cache: KVCache, *, config, attn_mask,
                         stage_index: Optional[int], shard: Optional[_Shard] = None):
    """Self-attention under per-row cursors (the server's steps,
    ``ergm_tpu/models/gpt2.py:658-737,820-875,905-922``); no value is read
    on the host.

    Row b writes its L new entries at [index[b], index[b] + L) (entries
    past capacity are dropped) and query j of the row sees the keys at
    kpos <= index[b] + j: the single-token decode step, and with L > 1 the
    speculative verify window and the server's extension (session deltas,
    prompt chunks). The attention is the plain math (K5's gates take no
    bias, and no single query). A quantized cache writes its codes and
    scales straight into the cache and attends by dequantize-then-attend,
    except for single-token steps, which a quantized cache decodes STAGED
    (``cache.sk`` set), as the server runs them: step ``stage_index`` of
    the block writes every row's K/V at that uniform index of the staging
    buffers, and the query attends, by one softmax over both score
    vectors, over the main cache's flushed prefix [0, index[b] -
    stage_index) and the staging tail [0, stage_index], read through the
    quantize-dequantize round trip that ``flush_staging`` will commit, so
    reads agree with a per-step quantized cache."""
    c = config
    B, L, _ = h.shape
    H = _heads(c, shard)
    q, k, v = (_split_heads(x, H) for x in dense(h, p.c_attn).chunk(3, dim=-1))  # [B, H, L, Dh]
    idx = cache.index.long()
    T = cache.k.shape[-2]
    scale = _attn_scale(c, li)
    quant = cache.k_scale is not None
    kpos = torch.arange(T, device=h.device)[None, :]
    if (cache.sk is not None) != (quant and L == 1):
        raise ValueError("under per-row cursors a quantized cache decodes staged (sk/sv set) "
                         "single-token steps; a compute-dtype cache and multi-token steps "
                         "write the cache directly")
    if cache.sk is not None:
        cache.sk[li, :, :, stage_index] = k[:, :, 0]
        cache.sv[li, :, :, stage_index] = v[:, :, 0]
        k_main = _dequantize(cache.k[li], cache.k_scale[li], c)
        v_main = _dequantize(cache.v[li], cache.v_scale[li], c)
        k_tail, v_tail = (_dequantize(*_quantize_kv(staged, _kv_bits(c)), c)
                          for staged in (cache.sk[li], cache.sv[li]))
        Ks = k_tail.shape[2]
        main_mask = (kpos < (idx - stage_index)[:, None]).float()
        stage_mask = (torch.arange(Ks, device=h.device) <= stage_index).float()[None, :]
        lm = matmul_f32(q, k_main.to(q.dtype).transpose(-1, -2)) * scale
        ls = matmul_f32(q, k_tail.to(q.dtype).transpose(-1, -2)) * scale
        lm = lm + ((1.0 - main_mask) * -1e9)[:, None, None, :]
        ls = ls + ((1.0 - stage_mask) * -1e9)[:, None, None, :]
        probs = torch.softmax(torch.cat([lm, ls], dim=-1), dim=-1)
        pv = v_main.dtype
        out = (torch.matmul(probs[..., :T].to(pv), v_main)
               + torch.matmul(probs[..., T:].to(pv), v_tail.to(pv)))
        return _attn_project(out, p, shard)
    pos = idx[:, None] + torch.arange(L, device=h.device)[None, :]  # [B, L]
    if quant:
        bits = _kv_bits(c)
        for x, codes, scales in ((k, cache.k, cache.k_scale), (v, cache.v, cache.v_scale)):
            xq, xs = _quantize_kv(x, bits)
            _scatter_rows(codes[li:li + 1], pos, xq[None])
            _scatter_rows(scales[li:li + 1], pos, xs[None])
        k_all = _dequantize(cache.k[li], cache.k_scale[li], c)
        v_all = _dequantize(cache.v[li], cache.v_scale[li], c)
    else:
        _scatter_rows(cache.k[li:li + 1], pos, k[None].to(cache.k.dtype))
        _scatter_rows(cache.v[li:li + 1], pos, v[None].to(cache.v.dtype))
        k_all, v_all = cache.k[li], cache.v[li]
    # query j of row b sees kpos <= index[b] + j: a [B, 1, L, T] bias
    bias = torch.where(kpos[:, None, :] <= pos[:, :, None], 0.0, -1e9)[:, None]
    out = multihead_attention(q, k_all, v_all, causal=False,
                              kv_mask=None if attn_mask is None else attn_mask[:, :T],
                              q_mask=None if attn_mask is None else attn_mask[:, :L],
                              extra_bias=bias, scale=scale, impl=c.attention_impl)
    return _attn_project(out, p, shard)


def _capless_row_gate(out: torch.Tensor, enc_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the cross-attention residual of rows whose caption mask is all
    zero: with every key at -1e9 the softmax would spread uniformly over
    pad embeddings instead of being a no-op."""
    if enc_mask is None:
        return out
    has = enc_mask.float().sum(dim=-1) > 0
    return out * has[:, None, None].to(out.dtype)


CachedKV = Tuple[torch.Tensor, ...]


def _cross_attention(h, enc, p: CrossAttention, li: int, *, config, enc_mask,
                     cached_kv: Optional[CachedKV], prefill_kernel_ok: bool = False,
                     seed: Optional[int] = None, shard: Optional[_Shard] = None):
    """Cross-attention: Q from h, K/V from the caption states ``enc``
    through the shared ``c_attn``; non-causal; caption-less rows get a zero
    residual. ``cached_kv`` (decode) is ``(ck, cv[, ck_scale, cv_scale])``
    in the cache's merged layout [B, Lc, H*Dh]. Returns (out, fresh merged
    (k, v) or None). ``shard`` (training over a mesh): this rank's rows
    and head group."""
    c = config
    H, Dh = _heads(c, shard), c.head_dim
    scale = _attn_scale(c, li)
    if cached_kv is not None and h.shape[1] == 1:
        # single-token decode: reduce within the merged minor dim; int8
        # scales factor out of both reductions
        qf = dense(h, p.q_attn)[:, 0, :]
        out = cross_decode.cross_attention_decode(qf, cached_kv, enc_mask, scale, H)
        return _capless_row_gate(_row_dense(out[:, None, :], p.c_proj, shard), enc_mask), None
    qm = dense(_col_in(h, shard), p.q_attn)
    if cached_kv is not None:
        # multi-token step over the cached caption K/V
        B = qm.shape[0]
        k_r = cached_kv[0].view(B, -1, H, Dh)
        v_r = cached_kv[1].view(B, -1, H, Dh)
        if len(cached_kv) == 4:
            dt = h.dtype
            k_r = k_r.to(dt) * cached_kv[2].to(dt)[..., None]
            v_r = v_r.to(dt) * cached_kv[3].to(dt)[..., None]
        logits = matmul_f32(_split_heads(qm, H), k_r.permute(0, 2, 3, 1)) * scale
        if enc_mask is not None:
            logits = logits + (1.0 - enc_mask.float())[:, None, None, :] * -1e9
        probs = torch.softmax(logits, dim=-1)
        out = _merge_heads(torch.matmul(probs.to(v_r.dtype), v_r.transpose(1, 2)))
        return _capless_row_gate(_row_dense(out, p.c_proj, shard), enc_mask), None
    km, vm = dense(_col_in(enc, shard), p.c_attn).chunk(2, dim=-1)  # merged [B, Lc, H*Dh]
    B, Lq, Lc = h.shape[0], h.shape[1], km.shape[1]
    Bg = _gate_batch(B, shard)
    if (prefill_kernel_ok and c.attention_impl == "auto" and Bg >= 64 and Lc % 8 == 0
            and prefill_attention.supported(Bg, Lq, c, True)):
        out = prefill_attention.prefill_mha(qm, km, vm, enc_mask, n_head=H, scale=scale,
                                            causal=False)
    else:
        aseed, stride = _attn_seed(seed, 3, shard)
        out = _merge_heads(multihead_attention(
            _split_heads(qm, H), _split_heads(km, H), _split_heads(vm, H),
            causal=False, kv_mask=enc_mask, scale=scale, impl=c.attention_impl,
            dropout_rate=c.attn_pdrop, deterministic=seed is None, seed=aseed,
            dropout_head_stride=stride))
    out = _capless_row_gate(_row_dense(out, p.c_proj, shard), enc_mask)
    return _dropout(out, c.resid_pdrop, _site(seed, 4, _data_rank(shard))), (km, vm)


def _mlp(h, p: MLP, *, config, seed=None, shard: Optional[_Shard] = None):
    out = _row_dense(_activation(config.activation)(dense(_col_in(h, shard), p.c_fc)), p.c_proj,
                     shard)
    return _dropout(out, config.resid_pdrop, _site(seed, 5, _data_rank(shard)))


def _write_cross_cache(cache: KVCache, li: int, km, vm, config) -> None:
    """Store a layer's fresh caption K/V (merged [B, Lc, H*Dh], the cache's
    heads) in the cache; int8 quantizes per (token, head) over the Dh
    groups of the minor dim."""
    c = config
    if cache.ck_scale is None:
        cache.ck[li] = km
        cache.cv[li] = vm
        return
    for x, codes, scales in ((km, cache.ck, cache.ck_scale), (vm, cache.cv, cache.cv_scale)):
        b, lc, d = x.shape
        q, s = _quantize_kv(x.view(b, lc, d // c.head_dim, c.head_dim))
        codes[li] = q.view(b, lc, d)
        scales[li] = s[..., 0].float()


def _train_block(h, blk: Block, li: int, enc, enc_mask, c: ModelConfig, attention_mask,
                 use_cross: bool, seed: Optional[int], mlp_remat: bool, cross_remat: bool,
                 shard: Optional[_Shard] = None):
    """One uncached block: pre-LN self-attention, cross-attention over the
    caption states, MLP, each a residual; ``mlp_remat`` / ``cross_remat``
    checkpoint the MLP / cross sublayer (their inputs, the LayerNorm
    outputs, are kept). ``shard``: this rank's part over a mesh."""
    eps = c.layer_norm_epsilon
    h = h + _self_attention(layer_norm(h, blk.ln_1, eps), blk.attn, li, config=c,
                            attn_mask=attention_mask, seed=seed, shard=shard)
    if use_cross:
        def cross(x, e):
            return _cross_attention(x, e, blk.cross_attn, li, config=c, enc_mask=enc_mask,
                                    cached_kv=None, seed=seed, shard=shard)[0]
        ca_in = layer_norm(h, blk.ln_cross, eps)
        h = h + (checkpoint(cross, ca_in, enc, use_reentrant=False, preserve_rng_state=False)
                 if cross_remat else cross(ca_in, enc))
    mlp_in = layer_norm(h, blk.ln_2, eps)
    if mlp_remat:
        return h + checkpoint(lambda x: _mlp(x, blk.mlp, config=c, seed=seed, shard=shard),
                              mlp_in, use_reentrant=False, preserve_rng_state=False)
    return h + _mlp(mlp_in, blk.mlp, config=c, seed=seed, shard=shard)


# remat "dots" (JAX's checkpoint_dots_with_no_batch_dims): the weight
# products are saved; everything else is recomputed, the batched score and
# PV products (bmm), the elementwise work and K5's autograd.Function, whose
# kernel launch is no dispatcher operation
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.linear.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _decode_block(h, blk: Block, li: int, cache: KVCache, enc, enc_mask, cross_stacks,
                  c: ModelConfig, attention_mask, prefix_prefill: bool, use_cross: bool,
                  stage_index: Optional[int], shard: Optional[_Shard] = None):
    """One block over the KV cache (prefill or decode step), updating it;
    ``shard``: this rank's rows and heads over a mesh (K3 and K4 then take
    their tensor-parallel forms)."""
    eps = c.layer_norm_epsilon
    attn_in = layer_norm(h, blk.ln_1, eps)
    h = h + _self_attention_cached(attn_in, blk.attn, li, cache, config=c,
                                   attn_mask=attention_mask, prefix_prefill=prefix_prefill,
                                   stage_index=stage_index, shard=shard)
    if cross_stacks is not None:
        h = cross_decode.fused_cross_decode(h, blk, li, _attn_scale(c, li), cross_stacks,
                                            enc_mask, c, group=_model_group(shard))
    elif use_cross:
        ckv = None
        if enc is None:
            ckv = (cache.ck[li], cache.cv[li])
            if cache.ck_scale is not None:
                ckv += (cache.ck_scale[li], cache.cv_scale[li])
        ca_out, fresh = _cross_attention(
            layer_norm(h, blk.ln_cross, eps), enc, blk.cross_attn, li, config=c,
            enc_mask=enc_mask, cached_kv=ckv, prefill_kernel_ok=True, shard=shard)
        h = h + ca_out
        if fresh is not None and cache.ck is not None:
            _write_cross_cache(cache, li, *fresh, c)
    parts = 1 if shard is None else shard.parts
    if c.decode_fused_mlp and fused_decode.supported(h, blk.mlp, c,
                                                     _gate_batch(h.shape[0], shard), parts):
        return fused_decode.fused_ln_mlp(h, blk.ln_2, blk.mlp, c,
                                         group=_model_group(shard))  # kernel K4
    return h + _mlp(layer_norm(h, blk.ln_2, eps), blk.mlp, config=c, shard=shard)


def transformer(
    params: GPT2,
    config: ModelConfig,
    input_ids: torch.Tensor,  # [B, L]
    *,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,  # [B, Lk] 0/1 over keys
    imgs: Optional[torch.Tensor] = None,  # [B, modality_dim]
    auds: Optional[torch.Tensor] = None,  # [B, modality_dim]
    caption_ids: Optional[torch.Tensor] = None,  # [B, Lc]
    encoder_hidden_states: Optional[torch.Tensor] = None,  # [B, Lc, D]
    encoder_attention_mask: Optional[torch.Tensor] = None,  # [B, Lc] 0/1
    cache: Optional[KVCache] = None,
    prefix_prefill: bool = False,  # the initial prompt: cache.index == 0
    stage_index: Optional[int] = None,  # step in a staged server decode block
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GPT2Model.forward: returns (final hidden [B, L, D], advanced cache or None).

    Dropout runs when ``deterministic`` is False and a ``dropout_seed``
    (the step's) is given, at JAX's sites: the embedding (site 0) and, in
    layer i (seed ``fold_seed(step seed, 1000 + i)``), the attention
    probabilities (1), the attention residual (2), the cross-attention
    probabilities (3) and residual (4) and the MLP residual (5).

    ``mesh`` (``core/mesh.py``): the inputs are this rank's rows of the
    global batch and, with a model axis, the parameters its shard
    (``shard_params``); a ``cache`` then holds this rank's rows and heads
    (``init_kv_cache(mesh=...)``); see ``_Shard``."""
    c = config
    dtype = c.compute_dtype
    B, L = input_ids.shape
    decode = cache is not None
    shard = _shard_of(mesh, c, B)
    qkv = params.blocks[0].attn.c_attn
    if shard is not None and shard.model is not None and (
            (qkv.kernel if qkv.kernel is not None else qkv.kernel_q).shape[1]
            != 3 * shard.heads * c.head_dim):
        raise ValueError("over a model axis the parameters must be this rank's shard "
                         "(core.mesh.shard_params)")
    if decode and cache.k.shape[2] != _heads(c, shard):
        raise ValueError(f"the cache holds {cache.k.shape[2]} heads, this rank runs "
                         f"{_heads(c, shard)} (init_kv_cache(mesh=...))")
    if position_ids is None:
        past = cache.index if decode else 0
        if torch.is_tensor(past):  # per-row cursors
            past = past.long()[:, None]
        position_ids = past + torch.arange(L, device=input_ids.device)[None, :].expand(B, L)

    h = embed_rows(params.wte, input_ids, dtype)
    enc = encoder_hidden_states
    if caption_ids is not None and enc is None and c.use_cross_attention:
        enc = embed_rows(params.wte, caption_ids, dtype)
    use_cross = c.use_cross_attention and (
        enc is not None or (decode and cache.ck is not None))
    if use_cross and not hasattr(params.blocks[0], "cross_attn"):
        raise ValueError("cross-attention inputs given but model has no cross-attn params "
                         "(config.use_cross_attention=False)")

    # image and audio features join the first two REAL positions; with a
    # left-padded mask those differ per row
    slot0 = slot1 = None
    if (imgs is not None or auds is not None) and attention_mask is not None:
        m = attention_mask[:, :L].float()
        csum = torch.cumsum(m, dim=-1)
        slot0 = ((csum == 1) & (m > 0)).to(dtype)
        slot1 = ((csum == 2) & (m > 0)).to(dtype)
    for feats, proj, slot, pos in ((imgs, "img_proj", slot0, 0), (auds, "aud_proj", slot1, 1)):
        if feats is None:
            continue
        f = feats.to(dtype)
        if hasattr(params, proj):
            f = dense(f, getattr(params, proj))
        if slot is not None:
            h = h + slot[..., None] * f[:, None, :]
        elif pos < L:
            h[:, pos, :] += f

    h = h + params.wpe.embedding[position_ids].to(dtype)
    if token_type_ids is not None:
        h = h + embed_rows(params.wte, token_type_ids, dtype)  # token types through wte
    seed = None if deterministic or decode else dropout_seed
    h = _dropout(h, c.embd_pdrop, _site(seed, 0, _data_rank(shard)))

    enc_mask = encoder_attention_mask if use_cross else None
    eps = c.layer_norm_epsilon
    # kernel K3 for the int8 cross sublayer: decided once per call, as JAX
    # decides once per trace (gpt2.py:1201-1215)
    cross_stacks = None
    if decode and use_cross and enc is None and cache.ck_scale is not None:
        cross_stacks = (cache.ck, cache.cv, cache.ck_scale, cache.cv_scale)
        if not cross_decode.supported(h, params.blocks[0], cross_stacks, c,
                                      1 if shard is None else shard.parts):
            cross_stacks = None
    remat = c.remat and not decode and torch.is_grad_enabled()
    # "mlp" checkpoints the MLP and cross sublayers, "mlp_only" the MLP
    # only; self-attention keeps its residuals (K5 is not recomputed).
    # "full" checkpoints the whole block, "dots" too but keeps its weight
    # products (_dots_policy).
    mlp_remat = remat and c.remat_policy in ("mlp", "mlp_only")
    cross_remat = mlp_remat and c.remat_policy == "mlp"
    for li, blk in enumerate(params.blocks):
        layer_seed = None if seed is None else fold_seed(seed, 1000 + li)
        if decode:
            h = _decode_block(h, blk, li, cache, enc, enc_mask, cross_stacks, c, attention_mask,
                              prefix_prefill, use_cross, stage_index, shard)
        elif remat and not mlp_remat:
            # the masks come from seeded generators, not the global RNG state
            kw = {"context_fn": _DOTS_CONTEXT} if c.remat_policy == "dots" else {}
            h = checkpoint(_train_block, h, blk, li, enc, enc_mask, c, attention_mask, use_cross,
                           layer_seed, False, False, shard, use_reentrant=False,
                           preserve_rng_state=False, **kw)
        else:
            h = _train_block(h, blk, li, enc, enc_mask, c, attention_mask, use_cross, layer_seed,
                             mlp_remat, cross_remat, shard)

    h = layer_norm(h, params.ln_f, eps)
    new_cache = dataclasses.replace(cache, index=cache.index + L) if decode else None
    return h, new_cache


def chunked_lm_loss(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                    ignore_index: int = -100, chunk: int = 128) -> torch.Tensor:
    """Shifted LM cross-entropy without [B, L, V] logits: position t is
    scored against labels[t+1], the mean over non-ignored targets. The
    sequence goes in chunks of ``chunk`` positions under
    ``torch.utils.checkpoint``, so each chunk's f32 logits exist only
    while it is computed, forward and backward (JAX's scan of
    ``jax.checkpoint`` pieces)."""
    tot, cnt = chunked_lm_sums(hidden, wte, labels, ignore_index, chunk)
    return tot / torch.clamp_min(cnt, 1.0)


def chunked_lm_sums(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                    ignore_index: int = -100, chunk: int = 128) -> tuple:
    """``chunked_lm_loss``'s (NLL sum, target count)."""
    B, L, D = hidden.shape
    shifted = torch.cat([labels[:, 1:], torch.full((B, 1), ignore_index, dtype=labels.dtype,
                                                   device=labels.device)], dim=1)

    def piece(h_c, l_c):
        logits = matmul_f32(h_c, wte.to(h_c.dtype).t())
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, l_c.clamp_min(0).long()[..., None])[..., 0]
        mask = (l_c != ignore_index).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    tot = cnt = 0.0
    for s in range(0, L, chunk):
        h_c, l_c = hidden[:, s:s + chunk], shifted[:, s:s + chunk]
        if torch.is_grad_enabled():
            ps, pc = checkpoint(piece, h_c, l_c, use_reentrant=False, preserve_rng_state=False)
        else:
            ps, pc = piece(h_c, l_c)
        tot, cnt = tot + ps, cnt + pc
    return tot, cnt


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: Optional[int] = None) -> torch.Tensor:
    """Mean CE over non-ignored targets (torch CrossEntropyLoss), f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = logz - gold
    if ignore_index is None:
        return nll.mean()
    mask = (labels != ignore_index).float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def lm_loss(hidden: torch.Tensor, params: GPT2, config: ModelConfig,
            labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """The LM loss without logits, by ``lm_loss_impl``: ``auto`` takes
    kernel K6 for CUDA tensors (``core.device.on_card``; as JAX goes fused on
    the TPU) where K6 takes the shape (``fused_ce.kernel_takes``: every
    width D, as JAX's kernel, in float32 or bfloat16), and the chunked
    loss on the CPU and elsewhere (float16, which no path of ``ergm_tpu``
    reaches: not ported); ``fused`` takes K6, or its plain
    version on the CPU, and on the card raises on what K6 does not take;
    ``chunked`` the chunked loss.

    Over a mesh (``hidden`` and ``labels`` this rank's rows) the loss is
    the mean over the global count of targets, JAX's rule
    (``ergm_tpu/models/gpt2.py:1529-1547``): a pure data-parallel mesh
    takes ``fused_lm_loss_sharded`` where K6 is taken; a model axis takes
    the chunked loss under ``auto`` (K6 under ``fused``), normalised over
    the data axis (``global_mean``)."""
    c = config
    wte = wte_dense(params.wte, hidden.dtype)
    impl = c.lm_loss_impl
    if impl not in ("auto", "fused", "chunked"):
        raise ValueError(f"unknown lm_loss_impl {impl!r}")
    fused = impl == "fused" or (impl == "auto" and core_device.on_card(hidden)
                                and fused_ce.kernel_takes(hidden))
    if mesh is None:
        if fused:
            return fused_ce.fused_lm_loss(hidden, wte, labels)
        return chunked_lm_loss(hidden, wte, labels, chunk=c.loss_chunk)
    pure_dp = not any(a != DATA_AXIS and mesh.shape[a] > 1 for a in mesh.axis_names)
    if fused and pure_dp and DATA_AXIS in mesh.axis_names:
        return fused_ce.fused_lm_loss_sharded(hidden, wte, labels, mesh)
    if impl == "fused":
        s, n = fused_ce.masked_nll_sums(hidden, wte, labels)
    else:
        s, n = chunked_lm_sums(hidden, wte, labels, chunk=c.loss_chunk)
    return global_mean(s, n, mesh.group(DATA_AXIS))


def forward(
    params: GPT2,
    config: ModelConfig,
    input_ids: torch.Tensor,
    *,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    imgs: Optional[torch.Tensor] = None,
    auds: Optional[torch.Tensor] = None,
    caption_ids: Optional[torch.Tensor] = None,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_attention_mask: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    emotion_labels: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    cache: Optional[KVCache] = None,
    prefix_prefill: bool = False,
    stage_index: Optional[int] = None,
    seq_lengths: Optional[torch.Tensor] = None,
    compute_logits: Union[bool, str] = True,  # True | False | "last"
    mesh=None,
) -> ModelOutput:
    """GPT2LMHeadModel.forward.

    ``labels`` (-100 = ignored) give the shifted LM loss: from the dense
    logits when they are computed, else without them (``lm_loss``);
    ``emotion_labels`` the emotion CE; ``loss`` is their sum when both are
    given. ``compute_logits="last"`` computes the logits of the final
    position only (the prefill of ``generate``). ``seq_lengths`` [B]: the
    emotion head reads each row's last REAL token instead of the final
    position. Dropout: see ``transformer``. A given ``cache`` is updated in
    place; the returned one carries the advanced index. ``stage_index``:
    the step of a staged server decode block (a cache with per-row
    cursors and ``sk``/``sv`` buffers, see ``_self_attention_rows``).
    ``mesh``: training, evaluation and the cached forward of inference
    over a mesh (``transformer``); the losses are then means over the
    global batch, and the logits (the lm_head and the emotion head are
    replicated) are equal on every rank of a model group."""
    c = config
    hidden, new_cache = transformer(
        params, c, input_ids, token_type_ids=token_type_ids, position_ids=position_ids,
        attention_mask=attention_mask, imgs=imgs, auds=auds, caption_ids=caption_ids,
        encoder_hidden_states=encoder_hidden_states,
        encoder_attention_mask=encoder_attention_mask, cache=cache,
        prefix_prefill=prefix_prefill, stage_index=stage_index, deterministic=deterministic,
        dropout_seed=dropout_seed, mesh=mesh)
    logits = None
    if compute_logits:
        logits = lm_logits(params, hidden[:, -1:, :] if compute_logits == "last" else hidden)
    if seq_lengths is not None:
        idx = torch.clamp(seq_lengths.long() - 1, 0, hidden.shape[1] - 1)
        last_hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    else:
        last_hidden = hidden[:, -1, :]
    emotion_logits = matmul_f32(last_hidden, params.emotion_head.kernel.to(hidden.dtype))

    lm = emo = None
    if labels is not None:
        if compute_logits == "last":
            raise ValueError("compute_logits='last' cannot serve an LM loss (labels given); "
                             "use True or False")
        if logits is not None:
            lm = cross_entropy(logits[:, :-1, :], labels[:, 1:], ignore_index=-100)
            if mesh is not None:
                n = (labels[:, 1:] != -100).sum()
                lm = global_mean(lm * n, n, mesh.group(DATA_AXIS))
        else:
            lm = lm_loss(hidden, params, c, labels, mesh=mesh)
    if emotion_labels is not None:
        emo = cross_entropy(emotion_logits, emotion_labels)
        if mesh is not None:
            n = torch.tensor(float(emotion_labels.numel()), device=emo.device)
            emo = global_mean(emo * n, n, mesh.group(DATA_AXIS))
    loss = lm + emo if lm is not None and emo is not None else (lm if lm is not None else emo)
    return ModelOutput(logits=logits, emotion_logits=emotion_logits, hidden=hidden, loss=loss,
                       lm_loss=lm, emotion_loss=emo, cache=new_cache)
