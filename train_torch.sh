#!/bin/bash
# Train launcher of the PyTorch port: train.sh's calls and defaults through
# ergm_tpu_torch's CLI, on CUDA device 0 unless --gpu says otherwise
# (--gpu=cpu for the CPU). The reference's broken --layers flag is
# accepted and ignored (SURVEY.md §2.4.7).
python -m ergm_tpu_torch.cli.main \
    --seed=0 \
    --mode="train" \
    --data_dir="${DATA_DIR:-data}" \
    --train_prefix="train" \
    --valid_prefix="${VALID_PREFIX:-test}" \
    --model_type="${MODEL_TYPE:-gpt2-medium}" \
    --bos_token="<bos>" \
    --sp1_token="<sp1>" \
    --sp2_token="<sp2>" \
    --lr=1e-5 \
    --warmup_ratio=0.0 \
    --batch_size="${BATCH_SIZE:-8}" \
    --num_workers=0 \
    --num_epochs="${NUM_EPOCHS:-100}" \
    --max_len=1024 \
    "$@"
