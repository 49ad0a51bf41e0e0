"""One steps-vs-MCD curve point, evaluated beside a live training run (the
port of ``recipes/soak/curve_eval.py``).

Snapshots ``exp/checkpoints/epoch_N`` out of the live training directory
(epoch checkpoints are pruned to the newest ``keep_nbest``) and runs the
stage-5 MCD gate protocol (replaced-span MCD, teacher-forced — reference
protocol sedit_mcd.py:43-135) on both eval splits.

    python -m a3t_tpu_torch.recipes.soak.curve_eval --workdir W \\
        --epoch 110 --vocoder W/vocoder [--device cpu]

The evaluation runs on ``--device``, the CUDA card unless ``--device cpu``
is given, by the port's rule.  The JAX recipe's ``--device`` defaults to
``cpu`` instead, to keep its evaluations off the TPU while the trainer
holds it; ``--device cpu`` here is that use.  The experiment is the port's
(``epoch_N.pt`` files) or the JAX package's (orbax ``epoch_N/``
directories); the trained vocoder dir is either package's too.

Writes ``<workdir>/curve_e<N>.json`` (consumed by assemble_mcd_report).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from a3t_tpu_torch.recipes.soak.run import DEFAULT_WORKDIR


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--exp-name", default="exp",
                    help="experiment dir name under the workdir")
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--ckpt-name", default="",
                    help="evaluate a named checkpoint (e.g. ave_5best) "
                         "already present in the snapshot dir instead of "
                         "an epoch_N checkpoint; --epoch then only tags "
                         "outputs")
    ap.add_argument("--vocoder", default="",
                    help="trained vocoder dir; empty = Griffin-Lim")
    ap.add_argument("--eval-utts", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the evaluation (default cuda; "
                         "'cpu' to leave the card to a live training run)")
    # length-composition control (docs/QUALITY.md): restrict the eval to
    # utterances whose phone count falls in [min,max] — the reference's
    # VCTK protocol only ever measures the long regime
    ap.add_argument("--min-phones", type=int, default=0)
    ap.add_argument("--max-phones", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="override the output json path")
    ap.add_argument("--spemb-source", default="context",
                    choices=("context", "speaker", "zero", "shuffle"),
                    help="x-vector fed to a spemb model at eval: 'context' "
                         "= leak-free context-only extraction from the "
                         "edited audio; 'speaker' = the speaker's averaged "
                         "training x-vector (the reference's spk2xvector "
                         "lookup, sedit_inference.py:203-210) — unseen "
                         "speakers have no training average and fall back "
                         "to context extraction; 'zero'/'shuffle' are "
                         "ablations (no embedding / a rotated wrong-speaker "
                         "assignment) that measure whether the conditioning "
                         "pathway is causally used")
    return ap


def _copy_checkpoint(src_dir: str, dst_dir: str, name: str) -> None:
    """Copy checkpoint ``name`` (the JAX package's directory, or the port's
    ``name.pt`` file) from ``src_dir`` into ``dst_dir`` unless there."""
    for entry in (name, f"{name}.pt"):
        dst = os.path.join(dst_dir, entry)
        if os.path.exists(dst):
            return
    for entry in (name, f"{name}.pt"):
        src = os.path.join(src_dir, entry)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst_dir, entry))
            return
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(dst_dir, entry))
            return
    raise FileNotFoundError(f"no checkpoint {name} in {src_dir}")


def speaker_spembs(split, uids, utt2spk, spk2xv, ds, xv_dir, frontend):
    """The 'speaker' source's x-vectors of ``uids``: the training average
    of a seen speaker; for the unseen split, the mean of the other
    utterances of the same speaker within the split."""
    if split == "eval_seen":
        return {u: spk2xv[utt2spk[u]] for u in uids
                if utt2spk.get(u) in spk2xv}
    # the unseen split's voices are brand new (speaker_seed=99, run.py
    # stage1) but its utt2spk REUSES the training label names, so the npz
    # lookup would fetch the wrong voice.  Build leave-one-out within-split
    # speaker averages instead — the reference's spk2xvector likewise
    # averages the eval speakers' own utterances (generate_spk2xv over the
    # dump).
    from a3t_tpu_torch.models.xvector import build_utt2xvector, load_xvector

    xvm, mvn = load_xvector(xv_dir, device=frontend.device)
    u2x = build_utt2xvector(xvm, frontend, ds, mel_mvn=mvn)
    spembs = {}
    for u in uids:
        others = [o for o in ds.uids
                  if o != u and utt2spk.get(o) == utt2spk.get(u)]
        if others:
            spembs[u] = np.mean([u2x[o] for o in others], axis=0)
    return spembs


def shuffled(spembs, uids, utt2spk):
    """Wrong-speaker ablation: rotate the embeddings among the eval uids so
    every utterance is conditioned on a DIFFERENT speaker's average."""
    us = [u for u in uids if u in spembs]
    vals = [spembs[u] for u in us]
    n = len(us)
    out = dict(spembs)
    for i, u in enumerate(us):
        j = (i + 1) % n
        while utt2spk.get(us[j]) == utt2spk.get(u) and j != i:
            j = (j + 1) % n
        out[u] = vals[j]
    return out


def main(argv=None) -> dict:
    """Evaluate one checkpoint on both splits; returns the report."""
    args = parser().parse_args(argv)

    from a3t_tpu_torch.bin.mcd_gate import run_gate
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text
    from a3t_tpu_torch.device import resolve_device
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.eval.mcd import MCDConfig
    from a3t_tpu_torch.inference import FileAlignmentSource, SpeechEditor
    from a3t_tpu_torch.tasks.mlm import MLMTask

    device = resolve_device(args.device)
    w = args.workdir
    exp = os.path.join(w, args.exp_name)
    snap = os.path.join(w, f"curve_ckpts_{args.exp_name}"
                        if args.exp_name != "exp" else "curve_ckpts")
    snap_ckpts = os.path.join(snap, "checkpoints")
    os.makedirs(snap_ckpts, exist_ok=True)
    _copy_checkpoint(os.path.join(exp, "checkpoints"), snap_ckpts,
                     args.ckpt_name or f"epoch_{args.epoch}")
    for name in ("config.yaml", "tokens.txt"):
        shutil.copy(os.path.join(exp, name), os.path.join(snap, name))

    model, cfg, conv = MLMTask.build_model_from_dir(
        snap, which="ave" if args.ckpt_name.startswith("ave")
        else str(args.epoch), device=device)
    mcd_cfg = MCDConfig(shiftms=1000.0 * cfg.frontend.hop_length
                        / cfg.frontend.fs)

    vocoder = None
    if args.vocoder:
        from a3t_tpu_torch.train import vocoder as vocoder_mod

        vocoder = vocoder_mod.load_vocoder(args.vocoder, device=device)

    xv_dir = os.path.join(w, "exp_xvector")
    spemb_fn = None
    if getattr(cfg.model, "spemb_dim", 0) > 0:
        from a3t_tpu_torch.models.xvector import make_spemb_extractor

        spemb_fn = make_spemb_extractor(
            xv_dir, LogMelFrontend(cfg.frontend, device=device))

    spk2xv = None
    if spemb_fn is not None and args.spemb_source in ("speaker", "shuffle"):
        with np.load(os.path.join(xv_dir, "spk2xvector.npz")) as f:
            spk2xv = {k: np.asarray(f[k], np.float32) for k in f.files}

    report = {"checkpoint": args.ckpt_name or f"epoch_{args.epoch}",
              "vocoder": args.vocoder or "griffin-lim"}
    if spemb_fn is not None:
        report["spemb_source"] = args.spemb_source
    for split in ("eval_seen", "eval_unseen"):
        split_dir = os.path.join(w, "data", split)
        texts = read_2column_text(os.path.join(split_dir, "text"))
        lexicon = {p.upper(): [p] for t in texts.values()
                   for p in t.split()}
        editor = SpeechEditor(model, cfg.frontend, conv, lexicon=lexicon,
                              vocoder=vocoder, spemb_fn=spemb_fn,
                              device=device)
        ds = A3TDataset(split_dir, conv)
        aligner = FileAlignmentSource(split_dir)
        uids = ds.uids
        if args.min_phones or args.max_phones:
            lo = args.min_phones or 0
            hi = args.max_phones or 10**9
            uids = [u for u in uids
                    if lo <= len(texts[u].split()) <= hi]
        if args.eval_utts:
            uids = uids[: args.eval_utts]
        spembs = None
        if spemb_fn is not None and args.spemb_source == "zero":
            dim = int(cfg.model.spemb_dim)
            spembs = {u: np.zeros(dim, np.float32) for u in uids}
        if spk2xv is not None:
            utt2spk = read_2column_text(os.path.join(split_dir, "utt2spk"))
            spembs = speaker_spembs(
                split, uids, utt2spk, spk2xv, ds, xv_dir,
                LogMelFrontend(cfg.frontend, device=device))
            if args.spemb_source == "shuffle":
                spembs = shuffled(spembs, uids, utt2spk)
        out_dir = os.path.join(w, "mcd_out", args.exp_name,
                               f"curve_e{args.epoch}", split)
        result = run_gate(editor, texts, ds, aligner, uids, out_dir,
                          mcd_config=mcd_cfg, spembs=spembs)
        key = split.replace("eval_", "")
        report[key] = result
        print(f"   MCD [{key}] e{args.epoch} over {result['n']} utts: "
              f"{result['mean_mcd']:.2f} dB (vocoder ceiling "
              f"{result['vocoder_ceiling_mcd']:.2f} dB)", flush=True)

    tag = "" if args.exp_name == "exp" else f"{args.exp_name}_"
    out = args.out or os.path.join(w, f"{tag}curve_e{args.epoch}.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}", flush=True)
    return report


if __name__ == "__main__":
    main()
