#!/bin/bash
# The port's run of scripts/evaluate_vqa_vqa2_p0.5_compressed.sh:
# python -m madtp_tpu_torch.cli.compress_vqa with the same flags, one process
# per visible card (rank r on card r, joined through --num_processes /
# --process_id / --coordinator).  NUM_CARDS and MADTP_PORT override the
# card count and the coordinator's port.
# --pretrained matches the reference's released-checkpoint path verbatim
# (its eval scripts target renamed release artifacts).  A local compress
# run saves per-epoch checkpoint_NN.pth (no best gate, like the
# reference) — point --pretrained at checkpoint_02.pth to evaluate it.
N=${NUM_CARDS:-$(nvidia-smi -L 2>/dev/null | grep -c '^GPU')}
N=$(( N > 0 ? N : 1 ))
PORT=${MADTP_PORT:-29500}
pids=()
for r in $(seq 0 $((N - 1))); do
    python -m madtp_tpu_torch.cli.compress_vqa \
        --fast_eval \
        --evaluate \
        --config configs/vqa.yaml \
        --pretrained output/vqa_vqa2_compression_p0.5/model_base_vqa_capfilt_large_vqa2_p0.5_compressed.pth \
        --output_dir output/vqa_vqa2_compression_p0.5 \
        --num_processes "$N" --process_id "$r" --coordinator "127.0.0.1:$PORT" &
    pids+=($!)
done
status=0
for p in "${pids[@]}"; do wait "$p" || status=$?; done
exit "$status"
