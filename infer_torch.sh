#!/bin/bash
# Inference launcher of the PyTorch port: infer.sh's calls and defaults
# through ergm_tpu_torch's CLI (--gpu=cpu for the CPU).
ckpt_name="$1"
if [ -z "$ckpt_name" ]; then
    echo "Error: ckpt_name is empty. Usage: ./infer_torch.sh <ckpt_name|best>"
    exit 1
fi
shift
python -m ergm_tpu_torch.cli.main \
    --seed=0 \
    --mode="infer" \
    --data_dir="${DATA_DIR:-data}" \
    --output_dir="outputs" \
    --model_type="${MODEL_TYPE:-gpt2}" \
    --bos_token="<bos>" \
    --sp1_token="<sp1>" \
    --sp2_token="<sp2>" \
    --batch_size="${BATCH_SIZE:-1}" \
    --max_len=1024 \
    --max_turns=35 \
    --top_p=0.8 \
    --ckpt_dir="saved_models" \
    --valid_prefix="${VALID_PREFIX:-test}" \
    --ckpt_name="$ckpt_name" \
    "$@"
