"""Model configuration for the PyTorch port.

``ModelConfig`` and ``TrainConfig`` have the field names and defaults of
``ergm_tpu.core.config`` (tests hold them equal), so a configuration
means the same thing in both packages. The port carries
its own copy because every ``ergm_tpu`` module loads JAX on import.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# GPT-2 family hyperparameters, keyed by the reference model_type strings.
GPT2_SIZES = {
    "distilgpt2": dict(n_layer=6, n_head=12, n_embd=768),
    "gpt2": dict(n_layer=12, n_head=12, n_embd=768),
    "gpt2-medium": dict(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-large": dict(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-xl": dict(n_layer=48, n_head=25, n_embd=1600),
}

GPT2_VOCAB_SIZE = 50257


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture, training and serving config of the ERGM GPT-2 backbone.

    Training reads the dropout rates (``embd_pdrop``, ``attn_pdrop``,
    ``resid_pdrop``; inference is deterministic), ``remat`` and
    ``remat_policy`` (``mlp``, ``mlp_only``, ``full`` or ``dots``),
    ``loss_chunk`` and ``lm_loss_impl`` (``auto``: kernel K6 for
    CUDA tensors at every n_embd in float32 or bfloat16, the chunked loss
    on the CPU and elsewhere; ``fused``: K6, or its plain version on the
    CPU). ``attention_impl`` ``auto`` routes training self-attention to
    kernel K5 (JAX's block gate: head widths a multiple of 8 up to 128; its
    flash gate without dropout: any below 128 and any multiple of 128;
    float32 or bfloat16; the plain math elsewhere) and batched short
    prefill to K1. ``decode_scan_unroll`` is inert (there is no layer scan).
    ``decode_fused_mlp`` routes each single-token decode step's LN2 + MLP
    + residual tail through kernel K4 (``ops/fused_decode.py``) where its
    gate allows, as in JAX; off by default.
    """

    vocab_size: int = GPT2_VOCAB_SIZE
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_inner: Optional[int] = None  # defaults to 4*n_embd
    activation: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    scale_attn_weights: bool = True
    scale_attn_by_inverse_layer_idx: bool = False
    # always behaves as True: the softmax runs in f32
    reorder_and_upcast_attn: bool = False
    num_emotions: int = 7
    use_cross_attention: bool = True
    modality_dim: int = 768
    # "bfloat16" activations with f32 softmax, or "float32" (parity mode)
    dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "mlp"
    loss_chunk: int = 128
    lm_loss_impl: str = "auto"
    # "auto" routes batched short prefill to the prefill-attention kernel;
    # "xla" keeps the plain attention math everywhere
    attention_impl: str = "auto"
    decode_scan_unroll: int = 1
    decode_fused_mlp: bool = False
    # self-attention cache storage: "auto" (compute dtype) or "int8" with
    # per-(token, head) bf16 scales
    kv_cache_dtype: str = "auto"
    # caption (cross) cache storage: "auto" or "int8" with per-(token, head)
    # f32 scales factored out of the decode reductions
    cross_kv_dtype: str = "auto"
    # serving weights: "auto", "int8" (every dense kernel and wte) or
    # "int8_lm_head" (wte only)
    weight_dtype: str = "auto"
    head_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is not a multiple of n_head {self.n_head}")
        return self.n_embd // self.n_head

    @property
    def inner_dim(self) -> int:
        return self.n_inner if self.n_inner is not None else 4 * self.n_embd

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @classmethod
    def from_model_type(cls, model_type: str, **overrides) -> "ModelConfig":
        """Build a config from a reference model_type string (e.g. 'gpt2-medium')."""
        if model_type not in GPT2_SIZES:
            raise ValueError(
                f"Unknown model_type {model_type!r}; expected one of {sorted(GPT2_SIZES)}")
        return cls(**{**GPT2_SIZES[model_type], **overrides})

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TrainConfig:
    """Runtime config of training, the fields and defaults of
    ``ergm_tpu.core.config.TrainConfig`` (the reference CLI's flags).

    ``mesh_shape`` / ``mesh_axis_names`` lay the training mesh over the
    world's ranks (``core/mesh.py``; -1 absorbs the world) and
    ``shard_opt_state`` turns on ZeRO-1 (``Trainer``). ``prng_impl`` is
    carried for equality and does nothing.
    """

    seed: int = 0
    mode: str = "train"  # train | infer
    data_dir: str = "data"
    train_prefix: str = "train"
    valid_prefix: str = "valid"
    model_type: str = "gpt2"
    bos_token: str = "<bos>"
    sp1_token: str = "<sp1>"
    sp2_token: str = "<sp2>"
    lr: float = 2e-5
    warmup_ratio: float = 0.1
    batch_size: int = 16
    num_workers: int = 0
    num_epochs: int = 100
    max_len: int = 1024
    max_turns: int = 10
    top_p: float = 0.95
    ckpt_dir: str = "saved_models"
    output_dir: str = "outputs"
    ckpt_name: Optional[str] = None
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    dtype: str = "bfloat16"
    remat: bool = True
    tokenizer_dir: Optional[str] = None
    init_params: Optional[str] = None  # a params file saved with torch.save
    keep_best: Optional[int] = None  # retain only the N lowest-PPL checkpoints
    log_every: int = 50
    prng_impl: str = "rbg"
    # dropout overrides (None = ModelConfig defaults)
    attn_pdrop: Optional[float] = None
    resid_pdrop: Optional[float] = None
    embd_pdrop: Optional[float] = None
    adam_mu_dtype: Optional[str] = None
    remat_policy: Optional[str] = None  # None = ModelConfig default "mlp"
    grad_accum_steps: int = 1
    shard_opt_state: bool = False
    # on the first SIGTERM, save ckpt_dir/preempt_ckpt at the next step
    # block and return (resume with ckpt_name="preempt")
    save_on_preempt: bool = True
    length_grouped: int = 0  # K > 1: sort by length within K * batch_size
    pad_multiple: int = 128  # batch lengths pad to multiples of this

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
