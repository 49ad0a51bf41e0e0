#!/usr/bin/env bash
# Post-training queue (the port of recipes/soak/post_train.sh, parts A
# and D).  Waits for the spemb trainer to finish (the DONE marker of
# launch_spemb.sh), then runs:
#   A. the final evaluation battery on the best conditioned checkpoint
#      (+-8 sweep, speaker-average source, short/long length controls,
#      unconditioned short control) through
#      python -m a3t_tpu_torch.recipes.soak.curve_eval on <device>
#      (default cuda: the trainer has finished, so the card is free;
#      pass cpu to keep the battery off the card);
#   D. the round-5 report, <workdir>/MCD_r05.json, through
#      python -m a3t_tpu_torch.recipes.soak.assemble_mcd_r05.
# The JAX queue's part B (the real-speech fine-tune) waits for the
# real-speech recipe's files, and part C (the step bench) for the port's
# benchmark.  Each stage is bounded and logged; a wipe can re-run this
# script.
#
#   bash a3t_tpu_torch/recipes/soak/post_train.sh <workdir> [device]
set -u
W=${1:?workdir}
DEV=${2:-cuda}
REPO=$(cd "$(dirname "$0")/../../.." && pwd)
cd "$REPO"
log() { echo "[post $(date +%H:%M:%S)] $*"; }

while [ ! -e "$W/exp_spemb/DONE" ]; do sleep 30; done
log "trainer finished"

SNAP="$W/curve_ckpts_exp_spemb/checkpoints"
CK="$W/exp_spemb/checkpoints"

# --- wait (bounded 20 min) for the curve watcher to drain its queue ---
pending() {
  for f in "$SNAP"/epoch_*.pt; do
    [ -f "$f" ] || continue
    n=$(basename "$f" .pt); n=${n#epoch_}
    case $n in (*[!0-9]*|'') continue;; esac
    [ -e "$W/exp_spemb_curve_e$n.json" ] || return 0
  done
  return 1
}
i=0
while pending && [ $i -lt 60 ]; do sleep 20; i=$((i + 1)); done
log "watcher queue drained"

best=$(python - "$W" <<'PY'
import json, os, sys
w = sys.argv[1]
pts = []
for f in os.listdir(w):
    if f.startswith("exp_spemb_curve_e") and f.endswith(".json"):
        with open(os.path.join(w, f)) as fh:
            r = json.load(fh)
        if "seen" in r:
            e = int(f[len("exp_spemb_curve_e"):-5])
            pts.append((r["seen"]["mean_mcd"] + r["unseen"]["mean_mcd"], e))
print(min(pts)[1] if pts else 0)
PY
)
log "best curve epoch: $best"

ev() {  # ev <out> <curve_eval args...>
  local out=$1; shift
  [ -e "$out" ] && return 0
  timeout 2400 python -m a3t_tpu_torch.recipes.soak.curve_eval \
    --workdir "$W" --device "$DEV" --vocoder artifacts/vocoder "$@" \
    --out "$out" > "${out%.json}.log" 2>&1 && log "$(basename "$out") done"
}

# --- A. evaluation battery --------------------------------------------
# the trainer's own checkpoints (10, 11) bracket the left edge of the
# snapshot grid in case the curve minimum sits before epoch 16
for e in $((best - 8)) 10 11 $best $((best + 8)); do
  [ "$e" -gt 0 ] || continue
  [ -f "$SNAP/epoch_$e.pt" ] || [ -f "$CK/epoch_$e.pt" ] || continue
  ev "$W/sweep_spemb_e$e.json" \
    --exp-name exp_spemb --epoch "$e" --eval-utts 8
done
ev "$W/sweep_spemb_e${best}_spkavg.json" \
  --exp-name exp_spemb --epoch "$best" --eval-utts 8 \
  --spemb-source speaker
# short-utterance controls: the regime the round-5 conditioning targets
ev "$W/ctrl_short_spemb_spk.json" \
  --exp-name exp_spemb --epoch "$best" --eval-utts 24 \
  --max-phones 12 --spemb-source speaker
ev "$W/ctrl_short_spemb_ctx.json" \
  --exp-name exp_spemb --epoch "$best" --eval-utts 24 \
  --max-phones 12 --spemb-source context
ev "$W/ctrl_short_uncond.json" \
  --exp-name exp_uncond_cal --epoch 1 --eval-utts 24 --max-phones 12
# long control: no regression at reference-protocol lengths
ev "$W/ctrl_long_spemb.json" \
  --exp-name exp_spemb --epoch "$best" --eval-utts 24 \
  --min-phones 18 --max-phones 23 --spemb-source speaker
log "evaluation battery complete"

# --- D. assemble the round-5 quality record ---------------------------
python -m a3t_tpu_torch.recipes.soak.assemble_mcd_r05 --workdir "$W" \
  --out "$W/MCD_r05.json" --device "$DEV" > "$W/assemble.log" 2>&1 \
  && log "MCD_r05.json assembled"
log "queue complete"
