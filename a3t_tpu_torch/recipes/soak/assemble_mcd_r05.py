"""Assemble MCD_r05.json: the round-5 quality record (the port of
``recipes/soak/assemble_mcd_r05.py``; the same JSON, byte for byte, from
the same files; the fixed entries describe the JAX recipe's runs).  Like
every entry point of the port, it refuses to start without a CUDA card
unless given ``--device cpu``.

Collects, from the soak workdir:
  * the unconditioned (round-4) steps-vs-MCD curve (curve_e*.json),
  * the speaker-conditioned run's curve (exp_spemb_curve_e*.json),
  * the final conditioned checkpoint sweep (sweep_spemb_*.json),
  * the length-composition control (ctrl_long_eval.json),
  * x-vector / vocoder / aligner context,
and writes the top-level report with the round-5 diagnosis summary.

    python -m a3t_tpu_torch.recipes.soak.assemble_mcd_r05 --workdir W \\
        --out MCD_r05.json
"""

from __future__ import annotations

import argparse
import json
import os


def load(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def summarize(rep, keys=("seen", "unseen", "long_seen", "long_unseen")):
    if rep is None:
        return None
    out = {k: rep[k] for k in ("checkpoint", "vocoder", "spemb_source")
           if k in rep}
    for split in keys:
        if split in rep and isinstance(rep[split], dict):
            r = rep[split]
            out[split] = {"n": r["n"],
                          "mean_mcd": round(r["mean_mcd"], 2),
                          "vocoder_ceiling_mcd": round(
                              r["vocoder_ceiling_mcd"], 2)}
    return out


def curve(w, prefix):
    epochs = sorted(
        int(f[len(prefix):-len(".json")])
        for f in os.listdir(w)
        if f.startswith(prefix) and f.endswith(".json")
        and f[len(prefix):-len(".json")].isdigit())
    return {f"epoch{e}": summarize(load(os.path.join(w, f"{prefix}{e}.json")))
            for e in epochs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir",
                    default=os.path.join(".workdirs", "soak12k"))
    ap.add_argument("--out", default="MCD_r05.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run is for (default cuda); the "
                         "assembly is host work")
    args = ap.parse_args(argv)

    from a3t_tpu_torch.device import resolve_device

    resolve_device(args.device)
    w = args.workdir

    xv = load(os.path.join(w, "exp_xvector", "xvector.json")) or {}

    # Headline: best conditioned checkpoint at reference-protocol
    # utterance lengths (18-23 phones, the regime VCTK utterances live
    # in -- sedit_mcd.py evaluates multi-second utterances only).
    best = load(os.path.join(w, "ctrl_long_spemb.json"))
    headline = None
    if best is not None:
        headline = {
            "what": ("x-vector-conditioned model (epoch 16, speaker-"
                     "average embeddings) on 18-23-phone eval "
                     "utterances -- the reference protocol's length "
                     "regime"),
            "seen_mcd": round(best["seen"]["mean_mcd"], 2),
            "unseen_mcd": round(best["unseen"]["mean_mcd"], 2),
            "vocoder_ceiling": [
                round(best["seen"]["vocoder_ceiling_mcd"], 2),
                round(best["unseen"]["vocoder_ceiling_mcd"], 2)],
            "vs_round3_best": ("9.88/8.05 (MCD_r03.json) -> beats it by "
                               f"{round(9.88 - best['seen']['mean_mcd'], 2)}"
                               "/"
                               f"{round(8.05 - best['unseen']['mean_mcd'], 2)}"
                               " dB seen/unseen"),
        }

    report = {
        "headline": headline,
        "harness": "a3t_tpu.bin.mcd_gate via recipes/soak (reference "
                   "protocol: sedit_mcd.py:43-135; 12k utts / 16 speakers)",
        "published_checkpoint_comparison": (
            "BLOCKED: published A3T checkpoints + VCTK audio are external "
            "downloads (reference README.md:5-8); no egress here. Loading "
            "path parity-tested (tests/test_parity.py); docs/MCD_GATE.md "
            "has the command where assets exist."),
        "round3_best": {"corpus": "4k utts / 8 speakers",
                        "checkpoint": "epoch_112",
                        "seen_mcd": 9.88, "unseen_mcd": 8.05,
                        "vocoder_ceiling": [6.21, 6.41],
                        "record": "MCD_r03.json"},
        "diagnosis": (
            "The round-4 12k/16-speaker plateau (~12 dB) was a "
            "speaker-ambiguity ceiling: MCD monotone in utterance length "
            "(20+-phone utts at the vocoder ceiling, 9-12-phone utts "
            "12-18 dB), envelope-dominated span error, unseen == seen. "
            "Short unmasked context cannot identify which of 16 vocal "
            "tracts to render; the reference's MLM has the same blindness "
            "(sedit_model.py:246 accepts spembs, never uses them) but its "
            "VCTK utterances are multi-second, hiding it. Round-5 fix: "
            "real x-vector conditioning (A3TModelConfig.spemb_dim), "
            "trained on per-utterance embeddings, evaluated with "
            "leak-free context-only extraction. Full story: "
            "docs/QUALITY.md."),
        "unconditioned_curve_r4": curve(w, "curve_e") or {
            "note": ("raw curve_e*.json points were lost in a session "
                     "wipe; committed summary (docs/QUALITY.md): MCD "
                     "~13.1 dB @ e11 -> 12.13 seen / 11.46 unseen @ e96 "
                     "vs 6.54/6.35 vocoder ceiling, flat e6-e128 on the "
                     "8-23-phone eval mix (the speaker-ambiguity "
                     "plateau diagnosed below)")},
        "unconditioned_stash_eval": summarize(
            load(os.path.join(w, "uncond_stash_eval.json"))),
        "conditioned_curve_r5": curve(w, "exp_spemb_curve_e"),
        "spemb_ablation_e16": {
            "what": ("same 8+8 utts, same checkpoint (epoch 16), four "
                     "embedding sources — measures whether the "
                     "conditioning pathway is causally used"),
            "context": summarize(
                load(os.path.join(w, "exp_spemb_curve_e16.json"))),
            "speaker_average": summarize(
                load(os.path.join(w, "exp_spemb_e16_spkavg.json"))),
            "zero": summarize(
                load(os.path.join(w, "exp_spemb_e16_zero.json"))),
            "wrong_speaker": summarize(
                load(os.path.join(w, "exp_spemb_e16_shuffle.json"))),
        },
        "short_context_control": {
            "what": ("<=12-phone utterances (n<=24/split) — the regime "
                     "the round-4 diagnosis identified as "
                     "speaker-ambiguous and round-5 conditioning "
                     "targets"),
            "unconditioned": summarize(
                load(os.path.join(w, "ctrl_short_uncond.json"))),
            "conditioned_context_xv": summarize(
                load(os.path.join(w, "ctrl_short_spemb_ctx.json"))),
            "conditioned_speaker_xv": summarize(
                load(os.path.join(w, "ctrl_short_spemb_spk.json"))),
            "conditioned_ave5_speaker_xv": summarize(
                load(os.path.join(w, "ctrl_short_spemb_ave5_spk.json"))),
        },
        "averaged_5best": {
            "what": ("reference-protocol ave_5best (epochs 4/5/7/10/11 "
                     "by valid loss, average_nbest_models.py analogue) "
                     "on the same 8+8 utts"),
            "speaker_average": summarize(
                load(os.path.join(w, "sweep_spemb_ave5_speaker.json"))),
            "context": summarize(
                load(os.path.join(w, "sweep_spemb_ave5_context.json"))),
        },
        "length_composition_control": summarize(
            load(os.path.join(w, "ctrl_long_eval.json"))),
        "length_composition_control_conditioned": summarize(
            load(os.path.join(w, "ctrl_long_spemb.json"))),
        "final_sweep": {
            f[len("sweep_spemb_"):-len(".json")]: summarize(load(
                os.path.join(w, f)))
            for f in sorted(f for f in os.listdir(w)
                            if f.startswith("sweep_spemb_")
                            and f.endswith(".json"))
        },
        "speaker_model": {k: xv.get(k) for k in
                          ("n_speakers", "eval_n", "eval_acc")},
        "eval_protocol": {
            "mask": "middle third of the phone sequence ([MASK]), "
                    "teacher-forced reconstruction, replaced-span MCD",
            "spemb_at_eval": "context-only x-vector (statistics pooling "
                             "masks the regenerated span; "
                             "models/xvector.py::make_spemb_extractor)",
            "spemb_at_train": "per-utterance full-utterance x-vectors "
                              "(build_utt2xvector)",
        },
        "aligner_eval": load(os.path.join(w, "aligner_eval.json")),
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if "curve" not in k}, indent=1)[:1500])


if __name__ == "__main__":
    main()
