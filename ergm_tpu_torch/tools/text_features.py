"""Text feature extraction: mean-pooled GPT-2 hidden states per utterance
(counterpart of ``ergm_tpu/tools/text_features.py``).

Capability of src/scripts/text_feature.py:16-28 (the live part above its
sys.exit): run each flattened utterance through GPT-2 and keep the mean
over sequence positions of the final hidden state, pickled per split.
Runs on the port's ``gpt2.transformer`` with an attention mask and JAX's
bucketing: ``batch_size`` rows padded to a multiple of ``pad_multiple``
tokens, the last batch completed with zero rows. On the card a bucket
that is a multiple of 128 takes kernel K5 for its self-attention.

Usage::

    python -m ergm_tpu_torch.tools.text_features --input_json=ids.json \\
        --output_file=text_feats.pkl [--init_params=HF_CHECKPOINT]
"""

from __future__ import annotations

import argparse
import json
import pickle
from typing import List, Sequence

import numpy as np
import torch


@torch.inference_mode()
def extract_text_features(params, config, utterance_ids: Sequence[Sequence[int]],
                          batch_size: int = 16, pad_multiple: int = 64) -> List[np.ndarray]:
    """Mean-pooled final hidden state per utterance ([hidden] float32 each),
    on the device of ``params``.

    Pads each batch to a bucketed length; the mean runs over real tokens
    only (the torch reference mean-pools unpadded single sequences).
    """
    from ergm_tpu_torch.models import gpt2

    device = next(params.parameters()).device
    feats: List[np.ndarray] = []
    for s in range(0, len(utterance_ids), batch_size):
        chunk = utterance_ids[s:s + batch_size]
        longest = max(len(u) for u in chunk)
        L = min(((longest + pad_multiple - 1) // pad_multiple) * pad_multiple,
                config.n_positions)
        ids = np.zeros((batch_size, L), np.int64)
        mask = np.zeros((batch_size, L), np.float32)
        for i, u in enumerate(chunk):
            u = list(u)[:L]
            ids[i, :len(u)] = u
            mask[i, :len(u)] = 1.0
        m = torch.as_tensor(mask, device=device)
        hidden, _ = gpt2.transformer(params, config, torch.as_tensor(ids, device=device),
                                     attention_mask=m)
        denom = torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
        out = (hidden.float() * m[..., None]).sum(dim=1) / denom
        feats.extend(out[:len(chunk)].cpu().numpy())
    return feats


def main(argv=None):
    p = argparse.ArgumentParser(description="Mean-pooled GPT-2 text features")
    p.add_argument("--input_json", required=True,
                   help="JSON list of utterance token-id lists "
                        "(e.g. a flattened *_sent_emo_ids.json).")
    p.add_argument("--output_file", required=True)
    p.add_argument("--model_type", default="gpt2")
    p.add_argument("--init_params", default=None,
                   help="Local HF-format GPT-2 checkpoint: a directory with "
                        "pytorch_model.bin or model.safetensors, or a single torch "
                        "file (a reference .ckpt included), never downloaded. JAX "
                        "checkpoints reach it through ergm_tpu/cli/convert_ckpt.py's "
                        "HF export. Random init otherwise.")
    p.add_argument("--vocab_size", type=int, default=50257)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device the model runs on (default: the card).")
    args = p.parse_args(argv)

    from ergm_tpu_torch.core.config import ModelConfig
    from ergm_tpu_torch.models import gpt2

    cfg = ModelConfig.from_model_type(args.model_type, vocab_size=args.vocab_size,
                                      dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    if args.init_params:
        from ergm_tpu_torch.models.convert import hf_to_params
        from ergm_tpu_torch.utils.torch_io import load_torch_state

        params = hf_to_params(load_torch_state(args.init_params), cfg, generator=gen,
                              device=args.device)
    else:
        params = gpt2.init_params(gen, cfg, device=args.device)

    with open(args.input_json) as f:
        utterances = json.load(f)
    flat = [u if u and isinstance(u[0], int) else [t for turn in u for t in turn]
            for u in utterances]
    feats = extract_text_features(params, cfg, flat)
    with open(args.output_file, "wb") as f:
        pickle.dump(feats, f)
    print(f"{len(feats)} utterance features -> {args.output_file}")


if __name__ == "__main__":
    main()
