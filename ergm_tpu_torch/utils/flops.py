"""Model-FLOPs accounting for the Trainer's throughput and MFU
(counterpart of ``ergm_tpu/utils/flops.py``).

MFU counts the model's REQUIRED math (6*P per trained token plus the
causal attention term, the PaLM-appendix convention); remat recompute
shows up as lost MFU by design.
"""

from __future__ import annotations

from typing import Optional

# dense bf16 peak TFLOP/s by device-name substring (NVIDIA's data sheets,
# SXM parts at their full power limit)
PEAK_TFLOPS = {"h100": 989.0, "h200": 989.0}


def device_peak_tflops(kind: str) -> Optional[float]:
    kind = kind.lower()
    for key, val in PEAK_TFLOPS.items():
        if key in kind:
            return val
    return None


def model_flops_per_token(cfg, seq_len: int) -> float:
    """Required train FLOPs per token: 6*P_matmul + causal attention
    (12*L*D*T/2 = 6*L*D*T). P counts matmul-participating params (the
    tied vocab projection once; gathered embeddings not)."""
    D, L, I, V = cfg.n_embd, cfg.n_layer, cfg.inner_dim, cfg.vocab_size
    per_layer = (3 * D * D + D * D) + (D * I + I * D)  # qkv+proj, mlp
    if cfg.use_cross_attention:
        per_layer += D * D + 2 * D * D + D * D  # q_attn, kv, proj
    p_matmul = L * per_layer + V * D  # + logits projection
    return 6.0 * p_matmul + 6.0 * L * D * seq_len
