"""Checkpoint conversion CLI: HF or torch GPT-2 state dicts <-> the port's
params (counterpart of ``ergm_tpu/cli/convert_ckpt.py``, the same flags).

    # an HF GPT-2 directory or a torch state dict (a reference .ckpt) ->
    # a params file; start training or inference from it with
    # --init_params (train/checkpoint.py::restore_params reads it)
    python -m ergm_tpu_torch.cli.convert_ckpt --src path/to/ckpt_or_hf_dir \
        --dst converted_params.pt --model_type gpt2 --vocab_size 50270

    # a port checkpoint directory (state.pt) or params file -> an HF-style
    # torch state dict
    python -m ergm_tpu_torch.cli.convert_ckpt --reverse \
        --src saved_models/gpt2/best_ckpt_... --dst exported.pt \
        --model_type gpt2

A checkpoint of ``ergm_tpu`` (orbax) reaches the port in two steps,
because the port reads no orbax: ``python -m ergm_tpu.cli.convert_ckpt
--reverse`` exports it as an HF-style state dict where JAX is installed,
then this tool converts that file.
"""

from __future__ import annotations

import argparse
import os

import torch

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.models.convert import hf_to_params, infer_geometry, params_to_hf
from ergm_tpu_torch.utils.torch_io import load_torch_state


def _port_params(src: str, model_type: str, n_head) -> gpt2.GPT2:
    """A port checkpoint directory (``state.pt``) or params file as a
    ``GPT2`` on the CPU, its geometry read from the tensors."""
    path = os.path.join(src, "state.pt") if os.path.isdir(src) else src
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("params", blob)
    n_layer = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    vocab, n_embd = sd["wte.embedding"].shape
    overrides = dict(vocab_size=vocab, n_layer=n_layer, n_embd=n_embd,
                     n_positions=sd["wpe.embedding"].shape[0],
                     use_cross_attention="blocks.0.cross_attn.c_attn.kernel" in sd,
                     modality_dim=(sd["img_proj.kernel"].shape[0] if "img_proj.kernel" in sd
                                   else n_embd))
    if n_head:
        overrides["n_head"] = n_head
    cfg = ModelConfig.from_model_type(model_type, **overrides)
    params = gpt2.GPT2(cfg, device="cpu")
    params.load_state_dict(sd, strict=True)
    return params


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert checkpoints to/from the PyTorch port. An ergm_tpu (orbax) "
                    "checkpoint: export it with `python -m ergm_tpu.cli.convert_ckpt "
                    "--reverse` first, then convert that file here.")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--model_type", default="gpt2")
    p.add_argument("--vocab_size", type=int, default=None,
                   help="Target vocab (with special tokens); defaults to the "
                        "checkpoint's own vocab. --reverse exports the vocab the "
                        "checkpoint holds.")
    p.add_argument("--reverse", action="store_true",
                   help="Export the port's params (a checkpoint directory or a "
                        "params file) to an HF-style torch state dict.")
    p.add_argument("--no_cross_attention", action="store_true")
    p.add_argument("--n_head", type=int, default=None,
                   help="Head count (defaults to the model_type's); geometry "
                        "otherwise inferred from the checkpoint.")
    args = p.parse_args(argv)

    if args.reverse:
        params = _port_params(args.src, args.model_type, args.n_head)
        sd = params_to_hf(params, params.config)
        torch.save(sd, args.dst)
        print(f"wrote torch state dict ({len(sd)} tensors) to {args.dst}")
        return

    state = load_torch_state(args.src)
    geom = infer_geometry(state)
    src_vocab = geom.pop("vocab_size")
    vocab = args.vocab_size or src_vocab
    overrides = dict(geom, vocab_size=vocab, use_cross_attention=not args.no_cross_attention)
    if args.n_head:
        overrides["n_head"] = args.n_head
    cfg = ModelConfig.from_model_type(args.model_type, **overrides)
    params = hf_to_params(state, cfg, device="cpu")
    torch.save({"params": params.state_dict()}, args.dst)
    print(f"converted {args.src} (vocab {src_vocab} -> {vocab}) to {args.dst}")


if __name__ == "__main__":
    main()
