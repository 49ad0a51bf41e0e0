#!/usr/bin/env bash
# Speaker-conditioned training launcher (the port of
# recipes/soak/launch_spemb.sh, the round-5 sequence of RUN12K.md).
# Runs stage 4 (--spemb) of python -m a3t_tpu_torch.recipes.soak.run on the
# card, bounded by a wall-clock timeout, then marks DONE for the curve
# watcher (spemb_watch.sh) and exports a bf16 params-only stash with
# python -m a3t_tpu_torch.bin.export_params, so that a wiped work
# directory can warm-start again.  The warm start reads the JAX package's
# unconditioned stash artifacts/soak12k_params; the export goes to
# <workdir>/spemb_params, in the port's format, and leaves the JAX
# package's artifacts/spemb_params alone.
#
#   bash a3t_tpu_torch/recipes/soak/launch_spemb.sh <workdir> [epochs] \
#       [timeout_s]
set -u
W=${1:?workdir}
EPOCHS=${2:-80}
LIMIT=${3:-11000}
REPO=$(cd "$(dirname "$0")/../../.." && pwd)
cd "$REPO"
mkdir -p "$W"

timeout "$LIMIT" python -m a3t_tpu_torch.recipes.soak.run --workdir "$W" \
  --stage 4 --stop-stage 4 --exp-name exp_spemb --spemb \
  --n-utts 12000 --n-speakers 16 \
  --epochs "$EPOCHS" --iters-per-epoch 400 --warmup-steps 1000 \
  --steps-per-dispatch 8 --mlm-prob-factor 1.0 \
  --init-params artifacts/soak12k_params \
  2>&1 | tee -a "$W/train_spemb.log"
rc=${PIPESTATUS[0]}
touch "$W/exp_spemb/DONE"
echo "[launch] trainer exited rc=$rc; exporting stash"
CK="$W/exp_spemb/checkpoints"
AVE=$(ls "$CK"/ave_*.pt 2>/dev/null | sort | tail -1)
if [ -n "$AVE" ]; then EPOCH=$(basename "$AVE"); else EPOCH=latest; fi
python -m a3t_tpu_torch.bin.export_params --exp "$W/exp_spemb" \
  --epoch "$EPOCH" --out "$W/spemb_params" 2>&1 | tail -2 || true
echo "[launch] done"
