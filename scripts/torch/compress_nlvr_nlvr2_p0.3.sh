#!/bin/bash
# The port's run of scripts/compress_nlvr_nlvr2_p0.3.sh:
# python -m madtp_tpu_torch.cli.compress_nlvr with the same flags, one process
# per visible card (rank r on card r, joined through --num_processes /
# --process_id / --coordinator).  NUM_CARDS and MADTP_PORT override the
# card count and the coordinator's port.
# Compress BLIP-NLVR to 70% GFLOPs (reference scripts/compress_nlvr_nlvr2_p0.3.sh;
# one process per card replaces torchrun's per-GPU processes)
N=${NUM_CARDS:-$(nvidia-smi -L 2>/dev/null | grep -c '^GPU')}
N=$(( N > 0 ? N : 1 ))
PORT=${MADTP_PORT:-29500}
pids=()
for r in $(seq 0 $((N - 1))); do
    python -m madtp_tpu_torch.cli.compress_nlvr \
        --fast_train \
        --p 0.3 \
        --epoch 15 \
        --pretrained pretrained/model_base_nlvr.pth \
        --config configs/nlvr.yaml \
        --output_dir output/nlvr_nlvr2_compression_p0.3 \
        --num_processes "$N" --process_id "$r" --coordinator "127.0.0.1:$PORT" &
    pids+=($!)
done
status=0
for p in "${pids[@]}"; do wait "$p" || status=$?; done
exit "$status"
