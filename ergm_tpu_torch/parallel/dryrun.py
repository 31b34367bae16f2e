"""The multi-device dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``): one training step of a data x model = (n/2, 2)
mesh with ZeRO-1, a greedy decode over the same mesh, and one step at
gpt2-xl's head geometry (D=1600, 25 heads: 13/12 a model rank), tiny
elsewhere.

JAX runs it in one process over n devices; here every rank of a world
of n ranks calls ``dryrun_multichip(n, device)`` with its own device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.mesh import (DATA_AXIS, batch_rows, make_mesh, shard_opt_state,
                                      shard_params, zero1_sharding_tree)
from ergm_tpu_torch.infer.generate import generate
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.parallel.collectives import all_gather_rows
from ergm_tpu_torch.train.steps import AdamW, create_train_state, make_train_step


def example_batch(vocab: int, batch: int, seq: int, modality_dim: int, device) -> dict:
    """JAX's ``_example_batch``: ids, token types, labels (30 % ignored),
    emotion labels, image and audio features and 32 caption ids a row."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab - 20, (batch, seq))
    out = {"input_ids": ids,
           "token_type_ids": rng.integers(0, vocab - 20, (batch, seq)),
           "labels": np.where(rng.random((batch, seq)) < 0.3, -100, ids),
           "emotion_labels": rng.integers(0, 7, (batch,)),
           "imgs": rng.standard_normal((batch, modality_dim)).astype(np.float32),
           "auds": rng.standard_normal((batch, modality_dim)).astype(np.float32),
           "caption_ids": rng.integers(0, vocab - 20, (batch, 32)),
           "valid": np.ones((batch,), bool)}
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def _zero1_step(cfg: ModelConfig, mesh, device, seed: int, seq: int, n: int) -> tuple:
    """One AdamW step with ZeRO-1 over ``mesh``: (loss, the state, the
    moments' ZeRO-1 dims)."""
    params = shard_params(gpt2.init_params(torch.Generator(device=device).manual_seed(seed),
                                           cfg, device=device), mesh)
    tx = AdamW(1e-4)
    state = create_train_state(params, tx)
    dims = zero1_sharding_tree(params, mesh)
    shard_opt_state(state.opt_state, mesh, dims)
    step = make_train_step(cfg, tx, device=device, mesh=mesh, opt_shardings=dims)
    batch = example_batch(cfg.vocab_size, n, seq, cfg.modality_dim, device)
    lo, hi = batch_rows(n, mesh)
    state, metrics = step(state, {k: v[lo:hi] for k, v in batch.items()}, seed)
    return float(metrics["loss"]), state, dims, batch


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Every rank of a world of ``n_devices`` ranks (even) calls this on
    its ``device``; raises on a non-finite loss, a decode that did not
    reach its prompt length, or ZeRO-1 sharding under half the moments.
    Returns the readings (rank 0 prints them)."""
    if n_devices % 2:
        raise ValueError("the dry run wants an even device count (data x model)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs in a world of {n_devices} ranks, "
                         f"this one has {world}")
    device = torch.device(device)
    mesh = make_mesh((n_devices // 2, 2), (DATA_AXIS, "model"))

    cfg = ModelConfig(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=8,
                      dtype="float32", modality_dim=64, use_cross_attention=True)
    loss, state, _, batch = _zero1_step(cfg, mesh, device, 0, 64, n_devices)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # the sharded generation path: each data rank's rows on its head group
    lo, hi = batch_rows(n_devices, mesh)
    with torch.inference_mode():
        out = generate(state.params, cfg, batch["input_ids"][lo:hi, :16], 16, max_len=24,
                       eos_id=cfg.vocab_size - 1, sp2_id=3, greedy=True, mesh=mesh)
    lengths = all_gather_rows(out.lengths, mesh.group(DATA_AXIS)).cpu().numpy()
    if not (lengths >= 16).all():
        raise AssertionError(f"decode lengths {lengths.tolist()} below the prompt's 16")

    # gpt2-xl's true head geometry at 2 layers: 25 heads over model=2
    xl = ModelConfig.from_model_type("gpt2-xl", n_layer=2, vocab_size=512, n_positions=64,
                                     dtype="float32", modality_dim=64,
                                     use_cross_attention=True)
    if (xl.n_head, xl.n_embd) != (25, 1600):
        raise AssertionError(f"gpt2-xl geometry {(xl.n_head, xl.n_embd)}")
    xl_loss, xl_state, dims, _ = _zero1_step(xl, mesh, device, 1, 32, n_devices)
    if not np.isfinite(xl_loss):
        raise AssertionError(f"non-finite xl loss {xl_loss}")
    sharded = sum(d is not None for d in dims)
    if sharded < len(dims) // 2:
        raise AssertionError(f"ZeRO-1 shards {sharded} of {len(dims)} moments")
    heads = xl_state.params.blocks[0].attn.c_attn.kernel.shape[1] // (3 * xl.head_dim)
    out = {"loss": loss, "mesh": dict(mesh.shape), "lengths": lengths.tolist(),
           "xl_loss": xl_loss, "xl_heads": heads, "zero1_sharded": (sharded, len(dims))}
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}) ok: loss={loss:.4f}, mesh={out['mesh']}, "
              f"decode lengths={out['lengths'][:4]}, xl(D=1600,H=25) loss={xl_loss:.4f} "
              f"({heads} heads on rank 0), zero1-sharded {sharded}/{len(dims)} moments")
    return out
