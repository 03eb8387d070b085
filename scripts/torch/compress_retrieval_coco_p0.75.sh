#!/bin/bash
# The port's run of scripts/compress_retrieval_coco_p0.75.sh:
# python -m madtp_tpu_torch.cli.compress_retrieval with the same flags, one process
# per visible card (rank r on card r, joined through --num_processes /
# --process_id / --coordinator).  NUM_CARDS and MADTP_PORT override the
# card count and the coordinator's port.
# NOTE: --p 0.65 != the filename's p0.75 — this mirrors the reference's own
# scripts/compress_retrieval_coco_p0.75.sh (its released runs used the adjusted ratio).
N=${NUM_CARDS:-$(nvidia-smi -L 2>/dev/null | grep -c '^GPU')}
N=$(( N > 0 ? N : 1 ))
PORT=${MADTP_PORT:-29500}
pids=()
for r in $(seq 0 $((N - 1))); do
    python -m madtp_tpu_torch.cli.compress_retrieval \
        --fast_train \
        --p 0.65 \
        --epoch 10 \
        --pretrained pretrained/model_base_retrieval_coco.pth \
        --config configs/retrieval_coco.yaml \
        --output_dir output/retrieval_coco_compression_p0.65_T1 \
        --num_processes "$N" --process_id "$r" --coordinator "127.0.0.1:$PORT" &
    pids+=($!)
done
status=0
for p in "${pids[@]}"; do wait "$p" || status=$?; done
exit "$status"
