"""Batch decoding for evaluation and listening tests: the port of
``a3t_tpu/bin/batch_decode.py`` (aggregate_output/sedit_decode.py:39-98).

    python -m a3t_tpu_torch.bin.batch_decode --exp-dir exp/a3t \\
        --data-dir dump/eval --task-file tasks.txt --out-dir decode \\
        [--middle-third-mask] [--fs2-exp exp/fs2 --spk-xvector spk2xv.npz]

Task file, one utterance per line: ``uid|new text`` (phones, ``[MASK]``
allowed); a bare ``uid`` or ``--middle-third-mask`` takes the MCD
protocol's mask.  Writes per utterance ``<uid>_full.wav`` (the vocoded
edited mel), ``<uid>_replaced.wav`` (the edited span spliced into the
original audio) and ``<uid>_gt_span.wav`` (the ground-truth span); with
``--fs2-exp`` also the three FastSpeech2 baselines
``<uid>_baseline{1,2,3}.wav`` (espnet2/bin/sedit_inference.py:160-260),
conditioned on the speaker's entry of ``--spk-xvector`` (a spk2xvector
``.npz``, speakers from the data directory's ``utt2spk``).  Runs on the
CUDA card unless ``--device cpu`` is given; returns ``{uid: {name: wav}}``
from ``main``.
"""

from __future__ import annotations

import argparse
import os


def read_tasks(path: str) -> list[tuple[str, str]]:
    """(uid, new text) per line of a ``uid|text`` task file."""
    tasks = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if "|" in line:
                uid, new_text = line.rstrip("\n").split("|", 1)
                tasks.append((uid.strip(), new_text.strip()))
            elif line.strip():
                tasks.append((line.strip(), ""))
    return tasks


def main(argv=None):
    parser = argparse.ArgumentParser(description="A3T batch decode "
                                                 "(PyTorch)")
    parser.add_argument("--exp-dir", required=True)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--task-file", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--checkpoint", default="ave")
    parser.add_argument("--vocoder", default=None,
                        help="parallel_wavegan checkpoint (Griffin-Lim if "
                             "unset)")
    parser.add_argument("--uniform-duration", type=float, default=0.1)
    parser.add_argument("--middle-third-mask", action="store_true",
                        help="ignore the task text; run the MCD protocol "
                             "mask")
    parser.add_argument("--fs2-exp", default=None,
                        help="FastSpeech2 experiment directory; also decode "
                             "baseline1/2/3 per utterance")
    parser.add_argument("--fs2-checkpoint", default="ave")
    parser.add_argument("--spk-xvector", default=None,
                        help="spk2xvector .npz for speaker-conditioned "
                             "baselines (needs data-dir/utt2spk)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    import numpy as np

    from a3t_tpu_torch.bin.sedit import build_editor, refuse_unported
    from a3t_tpu_torch.data.fileio import read_2column_text, write_wav
    from a3t_tpu_torch.eval.mcd import middle_third_mask_str
    from a3t_tpu_torch.inference import (FS2Baselines, diff_phone_spans,
                                         resolve_mask_str)

    ns = argparse.Namespace(
        exp_dir=args.exp_dir, data_dir=args.data_dir,
        checkpoint=args.checkpoint, vocoder=args.vocoder,
        duration_model=None, spk_xvector=None,
        uniform_duration=args.uniform_duration, device=args.device)
    refuse_unported(ns)
    editor, aligner, dataset, texts = build_editor(ns)
    hop = editor.fe.config.hop_length
    fs = editor.fe.config.fs
    os.makedirs(args.out_dir, exist_ok=True)

    baselines, spk2xv, utt2spk = None, None, {}
    if args.fs2_exp:
        from a3t_tpu_torch.tasks.fs2 import FS2Task

        fs2, _, fs2_conv = FS2Task.build_model_from_dir(
            args.fs2_exp, which=args.fs2_checkpoint, device=editor.device)
        baselines = FS2Baselines(fs2, fs2_conv, editor.fe,
                                 vocoder=editor.vocoder)
        if args.spk_xvector:
            with np.load(args.spk_xvector) as f:
                spk2xv = {k: f[k] for k in f.files}
            utt2spk = read_2column_text(
                os.path.join(args.data_dir, "utt2spk"))

    written = {}
    for uid, new_text in read_tasks(args.task_file):
        old_str = texts[uid]
        if args.middle_third_mask or not new_text:
            new_text = middle_third_mask_str(old_str)
        wav = dataset[uid]["audio"]
        ali = aligner(uid)
        res = editor.edit(wav, ali, old_str, new_text,
                          mask_reconstruct="[MASK]" in new_text)
        s, e = res.old_span_boundary
        wavs = {"full": res.prediction, "replaced": res.origin_replaced,
                "gt_span": wav[s * hop:e * hop]}
        print(uid, "spans", res.old_span_boundary, res.new_span_boundary)

        if baselines is not None:
            spembs = (spk2xv[utt2spk[uid]]
                      if spk2xv is not None and uid in utt2spk else None)
            resolved = resolve_mask_str(ali, old_str, new_text,
                                        editor.lexicon, editor.g2p)
            wavs["baseline1"] = baselines.baseline1(resolved, prompt_wav=wav,
                                                    spembs=spembs)
            # baseline2 synthesizes only the edited text: the added span's
            # phones (the replaced span's for [MASK])
            new_phns, span_rep, span_add = diff_phone_spans(
                ali, old_str, new_text, editor.lexicon, editor.g2p)
            if "[MASK]" in new_text:
                tgt_phns = list(ali.phones)[span_rep[0]:span_rep[1]]
            else:
                tgt_phns = new_phns[span_add[0]:span_add[1]]
            wavs["baseline2"] = baselines.baseline2(
                wav, ali, old_str, new_text, " ".join(tgt_phns),
                editor.lexicon, editor.mel, spembs=spembs)
            wavs["baseline3"] = baselines.baseline3(
                wav, ali, old_str, new_text, editor.lexicon, editor.mel,
                spembs=spembs)
        for name, w in wavs.items():
            write_wav(os.path.join(args.out_dir, f"{uid}_{name}.wav"), fs,
                      np.asarray(w))
        written[uid] = wavs
    return written


if __name__ == "__main__":
    main()
