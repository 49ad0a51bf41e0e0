#!/usr/bin/env bash
# Snapshot + evaluation watcher for a live spemb training run (the port of
# recipes/soak/spemb_watch.sh).
#
# The trainer prunes epoch checkpoints to keep_nbest, so curve points must
# be snapshotted out of the live exp dir promptly.  This loop (a) copies
# every --every-th epoch checkpoint (checkpoints/epoch_N.pt, written
# whole by an atomic rename) into the curve snapshot dir as soon as it
# appears, and (b) sequentially evaluates any snapshot that has no curve
# json yet with python -m a3t_tpu_torch.recipes.soak.curve_eval on
# <device> (default cuda, which shares the card with the live trainer;
# pass cpu to leave the card to the trainer, as the JAX watcher leaves
# it the TPU).
#
#   bash a3t_tpu_torch/recipes/soak/spemb_watch.sh <workdir> [exp_name] \
#       [every] [vocoder] [device]
#
# Exits when <workdir>/<exp_name>/DONE appears (touched by the launcher
# after the trainer exits) and all queued evals have run.
set -u
W=${1:?workdir}
EXP=${2:-exp_spemb}
EVERY=${3:-8}
REPO=$(cd "$(dirname "$0")/../../.." && pwd)
VOC=${4:-$REPO/artifacts/vocoder}
DEV=${5:-cuda}
SNAP="$W/curve_ckpts_$EXP"
mkdir -p "$SNAP/checkpoints"
cd "$REPO"

snapshot() {
  for f in "$W/$EXP"/checkpoints/epoch_*.pt; do
    [ -f "$f" ] || continue
    n=$(basename "$f" .pt); n=${n#epoch_}
    # a non-numeric n would be a fatal arithmetic error in
    # non-interactive bash
    case $n in (*[!0-9]*|'') continue;; esac
    [ $((n % EVERY)) -eq 0 ] || continue
    dst="$SNAP/checkpoints/epoch_$n.pt"
    [ -e "$dst" ] && continue
    cp "$f" "$dst.tmp" && mv "$dst.tmp" "$dst"
    echo "[watch] snapshotted epoch_$n"
  done
  cp -f "$W/$EXP/config.yaml" "$W/$EXP/tokens.txt" "$SNAP/" 2>/dev/null
}

eval_one() {
  for f in "$SNAP"/checkpoints/epoch_*.pt; do
    [ -f "$f" ] || continue
    n=$(basename "$f" .pt); n=${n#epoch_}
    case $n in (*[!0-9]*|'') continue;; esac
    out="$W/${EXP}_curve_e$n.json"
    [ -e "$out" ] && continue
    echo "[watch] evaluating epoch_$n ($DEV)"
    python -m a3t_tpu_torch.recipes.soak.curve_eval \
      --workdir "$W" --exp-name "$EXP" --epoch "$n" \
      --vocoder "$VOC" --eval-utts 8 --device "$DEV" \
      > "$W/curve_${EXP}_e$n.log" 2>&1
    return 0   # one eval per outer loop so snapshots stay fresh
  done
  return 1
}

while true; do
  snapshot
  eval_one || {
    if [ -e "$W/$EXP/DONE" ]; then echo "[watch] done"; exit 0; fi
    sleep 20
  }
done
