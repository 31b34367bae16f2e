#!/bin/bash
# Data assembly launcher of the PyTorch port: load_data.sh's call through
# ergm_tpu_torch's load_data.
python -m ergm_tpu_torch.cli.load_data \
    --data_dir="${DATA_DIR:-data}" \
    --train_prefix="train" \
    --valid_prefix="valid" \
    --train_frac=0.85 \
    --model_type="${MODEL_TYPE:-gpt2}" \
    "$@"
