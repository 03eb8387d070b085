#!/bin/bash
# The port's run of scripts/compress_caption_coco_p0.75.sh:
# python -m madtp_tpu_torch.cli.compress_caption with the same flags, one process
# per visible card (rank r on card r, joined through --num_processes /
# --process_id / --coordinator).  NUM_CARDS and MADTP_PORT override the
# card count and the coordinator's port.
N=${NUM_CARDS:-$(nvidia-smi -L 2>/dev/null | grep -c '^GPU')}
N=$(( N > 0 ? N : 1 ))
PORT=${MADTP_PORT:-29500}
pids=()
for r in $(seq 0 $((N - 1))); do
    python -m madtp_tpu_torch.cli.compress_caption \
        --fast_train \
        --p 0.75 \
        --epoch 5 \
        --pretrained pretrained/model_base_caption_capfilt_large.pth \
        --config configs/caption_coco.yaml \
        --output_dir output/caption_coco_compression_p0.75 \
        --num_processes "$N" --process_id "$r" --coordinator "127.0.0.1:$PORT" &
    pids+=($!)
done
status=0
for p in "${pids[@]}"; do wait "$p" || status=$?; done
exit "$status"
