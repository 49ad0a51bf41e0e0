"""Assemble MCD_r03-style report from the soak workdir's eval artifacts
(the port of ``recipes/soak/assemble_mcd_report.py``; the same JSON, byte
for byte, from the same files).

Collects the steps-vs-MCD curve points, the final Griffin-Lim and
neural-vocoder evaluations, aligner quality and vocoder training history
into one top-level JSON (the round-over-round quality record).  The fixed
entries describe the JAX recipe's runs that made the repo's records.  Like
every entry point of the port, it refuses to start without a CUDA card
unless given ``--device cpu``.

    python -m a3t_tpu_torch.recipes.soak.assemble_mcd_report --workdir W \
        --out MCD_r03.json
"""

from __future__ import annotations

import argparse
import json
import os

from a3t_tpu_torch.recipes.soak.run import DEFAULT_WORKDIR


def load(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def summarize_gate(rep):
    if rep is None:
        return None
    out = {"checkpoint": rep.get("checkpoint"),
           "vocoder": rep.get("vocoder")}
    for split in ("seen", "unseen"):
        if split in rep:
            r = rep[split]
            out[split] = {"n": r["n"],
                          "mean_mcd": round(r["mean_mcd"], 2),
                          "vocoder_ceiling_mcd": round(
                              r["vocoder_ceiling_mcd"], 2)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--out", default="MCD_r03.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run is for (default cuda); the "
                         "assembly is host work")
    args = ap.parse_args(argv)

    from a3t_tpu_torch.device import resolve_device

    resolve_device(args.device)
    w = args.workdir

    voc_hist = load(os.path.join(w, "vocoder", "history.json")) or []
    report = {
        "harness": "a3t_tpu.bin.mcd_gate via recipes/soak/run.py stage 5 "
                   "(reference protocol: sedit_mcd.py:43-135)",
        "published_checkpoint_comparison": (
            "BLOCKED: published A3T checkpoints + VCTK audio are external "
            "downloads (reference README.md:5-8); no egress here. Loading "
            "path parity-tested (tests/test_parity.py); see "
            "docs/MCD_GATE.md for the command where assets exist."),
        "round2_baseline": {
            "steps": 8800,
            "seen_mcd": 14.98, "unseen_mcd": 15.18,
            "griffin_lim_ceiling": "~8.8-9.0",
            "note": "round-2 corpus/alignments were regenerated this "
                    "round (same seeds, later synthesizer), so round-3 "
                    "numbers share eval splits with each other, not "
                    "bit-level with round 2",
        },
        "steps_note": "epochs 1-88 ran 100 iters each (round 2), later "
                      "epochs 400 — epoch 112 = ~18.4k steps, epoch 136 "
                      "(end) = ~28k",
        "steps_vs_mcd_curve": {
            f"epoch{e}": summarize_gate(load(os.path.join(
                w, f"curve_e{e}.json")))
            for e in sorted(
                int(f[len("curve_e"):-len(".json")])
                for f in os.listdir(w)
                if f.startswith("curve_e") and f.endswith(".json"))
        },
        "final_griffin_lim": summarize_gate(
            load(os.path.join(w, "soak_mcd_gl.json"))),
        "final_neural_vocoder": summarize_gate(
            load(os.path.join(w, "soak_mcd_pwg.json"))),
        # per-checkpoint full-protocol evals (MCD swings ~1 dB between
        # adjacent epochs; inference should ship the best checkpoint, the
        # reference's n-best averaging notwithstanding)
        "checkpoint_sweep": {
            f[len("sweep_"):-len(".json")]: summarize_gate(load(
                os.path.join(w, f)))
            for f in sorted(
                (f for f in os.listdir(w)
                 if f.startswith("sweep_") and f.endswith(".json")),
                # numeric epoch order (epoch_2 before epoch_10), vocoder
                # suffix second; files are named sweep_epoch_<n>_<voc>.json
                key=lambda f: (
                    int(f.split("_")[2]) if f.split("_")[2].isdigit()
                    else 0, f))
        },
        "vocoder_training": {
            "recipe": "a3t_tpu.bin.train_vocoder: 15k spectral-only + 7k "
                      "adversarial steps, crop 64 frames x batch 8, "
                      "scan+remat+phase-conv generator",
            "final": voc_hist[-1] if voc_hist else None,
        },
        "aligner_eval": load(os.path.join(w, "aligner_eval.json")),
        "speaker_model": load(os.path.join(w, "exp_xvector",
                                           "xvector.json")) and {
            k: v for k, v in load(os.path.join(
                w, "exp_xvector", "xvector.json")).items()
            if k in ("n_speakers", "eval_acc", "eval_n")},
        "edit_demo": load(os.path.join(w, "demo", "demo.json")),
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1)[:2000])


if __name__ == "__main__":
    main()
