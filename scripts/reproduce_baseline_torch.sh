#!/bin/bash
# Turnkey BASELINE.md reproduction runbook with the PyTorch port (adunet_torch):
# scripts/reproduce_baseline.sh's flags, tables and synthetic mode, driving
# adunet_torch.cli.run_experiment and the port's plot_experiment_metrics.
#
# One command per BASELINE table, going from staged dataset paths to the
# reference-schema summary tables:
#   E1  fixed-depth sweep   -> <out>/fixed_depth/plots/summary_metrics.csv
#   E2  adaptive-depth sweep-> <out>/adaptive_depth/plots/summary_metrics.csv
#   SEG protocol A/B sweep  -> <out>/seg_protocols/logs/*/config.json
# Every run takes --device (cuda by default, raising without a GPU; cpu on a
# host without one). The sweeps' batches are the H100 table's
# (adunet_torch.experiments.H100_BATCH_SIZES); --quick sets its own.
# The plots need matplotlib; without it plot_experiment_metrics writes
# summary_metrics.csv and then fails on the figures.
#
# DIV2K/ISIC are not in the repository; when they are staged
# (scripts/stage_dataset.sh), point the flags at them. --synthetic swaps in
# the reproducible stand-in corpora (scripts/make_synth_corpus.py,
# make_synth_isic.py) through the SAME entry points.
#
# Usage:
#   scripts/reproduce_baseline_torch.sh --div2k-train DIR --div2k-valid DIR \
#       --isic-images DIR --isic-masks DIR --isic-val-images DIR \
#       --isic-val-masks DIR [--out DIR] [--mode print|run|sbatch] \
#       [--tables sr,seg] [--epochs N] [--device cuda|cpu]
#   scripts/reproduce_baseline_torch.sh --synthetic --mode run   # stand-in corpora
#   scripts/reproduce_baseline_torch.sh --synthetic --quick --mode run --device cpu  # CI-sized
set -eo pipefail
cd "$(dirname "$0")/.."

MODE=print
OUT=runs/baseline_repro_torch
DEVICE=cuda
TABLES=sr,seg
EPOCHS=""
SYNTHETIC=0
QUICK=0
DIV2K_TRAIN="" DIV2K_VALID="" ISIC_IMG="" ISIC_MASK="" ISIC_VIMG="" ISIC_VMASK=""

while [ $# -gt 0 ]; do
  case "$1" in
    --div2k-train)    DIV2K_TRAIN=$2; shift 2 ;;
    --div2k-valid)    DIV2K_VALID=$2; shift 2 ;;
    --isic-images)    ISIC_IMG=$2; shift 2 ;;
    --isic-masks)     ISIC_MASK=$2; shift 2 ;;
    --isic-val-images) ISIC_VIMG=$2; shift 2 ;;
    --isic-val-masks) ISIC_VMASK=$2; shift 2 ;;
    --out)            OUT=$2; shift 2 ;;
    --mode)           MODE=$2; shift 2 ;;
    --tables)         TABLES=$2; shift 2 ;;
    --epochs)         EPOCHS=$2; shift 2 ;;
    --synthetic)      SYNTHETIC=1; shift ;;
    --quick)          QUICK=1; shift ;;
    --device)         DEVICE=$2; shift 2 ;;
    *) echo "unknown flag: $1" >&2; exit 2 ;;
  esac
done

mkdir -p "$OUT"

if [ "$SYNTHETIC" = 1 ]; then
  SIZE=512; N_TRAIN=48; N_EVAL=12
  [ "$QUICK" = 1 ] && { SIZE=64; N_TRAIN=8; N_EVAL=4; }
  [ -d "$OUT/synth/train_hr" ] || python scripts/make_synth_corpus.py \
      --mode natural --out "$OUT/synth/train_hr" --n $N_TRAIN --size $SIZE --seed 0
  [ -d "$OUT/synth/eval_hr" ] || python scripts/make_synth_corpus.py \
      --mode natural --out "$OUT/synth/eval_hr" --n $N_EVAL --size $SIZE --seed 777
  [ -d "$OUT/synth/isic/train_images" ] || python scripts/make_synth_isic.py \
      --out "$OUT/synth/isic" --n-train $((N_TRAIN / 2)) --n-val $N_EVAL \
      --size $SIZE --seed 5
  DIV2K_TRAIN="$OUT/synth/train_hr"; DIV2K_VALID="$OUT/synth/eval_hr"
  ISIC_IMG="$OUT/synth/isic/train_images"; ISIC_MASK="$OUT/synth/isic/train_masks"
  ISIC_VIMG="$OUT/synth/isic/val_images"; ISIC_VMASK="$OUT/synth/isic/val_masks"
fi

SR_EXTRA=(--patches_per_image 16 --device_cache --patience 15)
SCALE_ARGS=()
SEG_EXTRA=()
EPOCH_ARGS=()
[ -n "$EPOCHS" ] && EPOCH_ARGS=(--epochs "$EPOCHS")
if [ "$QUICK" = 1 ]; then
  EPOCH_ARGS=(--epochs 1)
  SCALE_ARGS=(--scales 0.5 --eval_patch_size 32)
  SR_EXTRA=(--patches_per_image 4 --patch_size 32 --batch_size 8 --patience 99)
  SEG_EXTRA=(--image_size 32 --base_channels 4 --depth 1 --batch_size 4)
fi

case ",$TABLES," in *",sr,"*)
  [ -n "$DIV2K_TRAIN" ] || { echo "SR tables need --div2k-train (or --synthetic)" >&2; exit 2; }
  for exp in fixed_depth adaptive_depth; do
    python -m adunet_torch.cli.run_experiment --experiment $exp --mode "$MODE" \
      --device "$DEVICE" \
      --high_res_dir "$DIV2K_TRAIN" --auto_eval --eval_hr_dir "$DIV2K_VALID" \
      --model_dir "$OUT/$exp/models" --log_dir "$OUT/$exp/logs" \
      --metadata_dir "$OUT/$exp/metadata" --sbatch_dir "$OUT/$exp/sbatch" \
      "${EPOCH_ARGS[@]}" "${SCALE_ARGS[@]}" \
      --extra_args "${SR_EXTRA[@]}"
    if [ "$MODE" = run ]; then
      python -m adunet_torch.cli.plot_experiment_metrics \
        --experiment-dir "$OUT/$exp/logs" --output-dir "$OUT/$exp/plots"
      echo "[$exp] summary table: $OUT/$exp/plots/summary_metrics.csv"
    fi
  done ;;
esac

case ",$TABLES," in *",seg,"*)
  [ -n "$ISIC_IMG" ] || { echo "seg table needs --isic-images (or --synthetic)" >&2; exit 2; }
  PROTO_ARGS=(--protocols A B)
  [ "$QUICK" = 1 ] && PROTO_ARGS=(--protocols A)
  python -m adunet_torch.cli.run_experiment --experiment seg_protocols --mode "$MODE" \
    --device "$DEVICE" \
    --train_images "$ISIC_IMG" --train_masks "$ISIC_MASK" \
    --val_images "$ISIC_VIMG" --val_masks "$ISIC_VMASK" \
    --model_dir "$OUT/seg_protocols/models" --log_dir "$OUT/seg_protocols/logs" \
    --metadata_dir "$OUT/seg_protocols/metadata" --sbatch_dir "$OUT/seg_protocols/sbatch" \
    "${EPOCH_ARGS[@]}" "${PROTO_ARGS[@]}" \
    ${SEG_EXTRA:+--extra_args "${SEG_EXTRA[@]}"}
  [ "$MODE" = run ] && echo "[seg] per-run val dice/iou: $OUT/seg_protocols/logs/*/config.json"
  ;;
esac

echo "BASELINE reproduction ($MODE mode) complete under $OUT"
