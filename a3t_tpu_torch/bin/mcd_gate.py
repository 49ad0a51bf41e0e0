"""The MCD gate, the reference's sedit_mcd protocol as a CLI: the port of
``a3t_tpu/bin/mcd_gate.py``.

For each utterance: mask ``tokens[:n//3] + [MASK] + tokens[-n//3:]``,
reconstruct it teacher-forced with the A3T model, vocode, write
full/replaced/unreplaced wav splits for ours, the ground truth and the
vocoder's resynthesis of the unedited mel (the ceiling), then the MCD over
the replaced spans with the reference's analysis settings (mcep_dim 80,
f0 80-7600, shiftms 300, power-silence stripping, DTW).

    python -m a3t_tpu_torch.bin.mcd_gate --exp-dir exp/a3t \
        --data-dir dump/eval --uids p361_420,p361_421 --vocoder pwg.pkl \
        --out exp/mcd

The model comes from an experiment directory of ``a3t_tpu_torch.bin.train``
or a published ESPnet A3T checkpoint (``--espnet-ckpt``, with its
``config.yaml`` alongside), the vocoder from a ``parallel_wavegan``
checkpoint, a vocoder directory of ``a3t_tpu_torch.bin.train_vocoder``
(``--vocoder DIR``: ``state.pt`` with its mel statistics) or of
``a3t_tpu.bin.train_vocoder`` (its orbax ``state/``, such as
``artifacts/vocoder``), or Griffin-Lim.  With
``--duration-model`` (a FastSpeech2 experiment or ESPnet ``.pth``,
conditioned on ``--spk-xvector``) the masked span is regenerated at the
predicted durations rather than the original timeline.  Writes ``<out>/MCD.json`` with the JAX CLI's keys.  Runs on the
CUDA card unless ``--device cpu`` is given; the MCD analysis runs on the
host.  ``--exp-dir`` may also be an experiment of the JAX package (orbax
checkpoints).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from a3t_tpu_torch.bin.sedit import (make_duration_fn, make_vocoder,
                                     phone_lexicon, refuse_unported)
from a3t_tpu_torch.eval.mcd import MCDConfig, mcd_between_waveforms
from a3t_tpu_torch.eval.mcd import middle_third_mask_str as protocol_mask

# the reference protocol's utterance lists (sedit_mcd.py:58-75)
VCTK_SEEN = [
    "p361_420", "p361_421", "p361_422", "p361_423", "p361_424",
    "p362_420", "p362_421", "p362_422", "p362_423", "p362_424",
    "p363_419", "p363_420", "p363_421", "p363_422", "p363_423",
    "p364_304", "p364_305", "p364_306", "p364_309", "p364_308",
    "p374_420", "p374_421", "p374_422", "p374_423", "p374_424",
    "p376_291", "p376_292", "p376_293", "p376_294", "p376_295",
]
VCTK_UNSEEN = [
    "p228_367", "p228_368", "p228_369", "p228_370", "p228_371",
    "p229_388", "p229_389", "p229_390", "p229_391", "p229_392",
    "p230_413", "p230_414", "p230_415", "p230_416", "p230_417",
    "p231_472", "p231_473", "p231_474", "p231_475", "p231_476",
    "p232_411", "p232_412", "p232_413", "p232_414", "p232_415",
    "p233_388", "p233_389", "p233_390", "p233_391", "p233_392",
]


def save_splits(wav, left: int, right: int, out: str, prefix: str, fs: int,
                uid: str):
    """The full/replaced/unreplaced wav triplet (sedit_mcd.py:20-28)."""
    from a3t_tpu_torch.data.fileio import write_wav

    for name, data in (
        ("full", wav),
        ("replaced", wav[left:right]),
        ("unreplaced", np.concatenate([wav[:left], wav[right:]])),
    ):
        d = os.path.join(out, prefix, name)
        os.makedirs(d, exist_ok=True)
        write_wav(os.path.join(d, uid + ".wav"), fs, data)


def build_editor(args):
    """(editor, texts) for ``args``."""
    from a3t_tpu_torch.data.fileio import read_2column_text
    from a3t_tpu_torch.device import resolve_device
    from a3t_tpu_torch.inference import SpeechEditor
    from a3t_tpu_torch.text import letter_to_sound

    dev = resolve_device(args.device)
    if args.espnet_ckpt:
        from a3t_tpu_torch.compat.espnet import load_espnet_a3t

        model, fe_cfg, conv = load_espnet_a3t(args.espnet_ckpt, device=dev)
    else:
        from a3t_tpu_torch.tasks.mlm import MLMTask

        model, task_cfg, conv = MLMTask.build_model_from_dir(
            args.exp_dir, which=args.checkpoint, device=dev)
        fe_cfg = task_cfg.frontend
    texts = read_2column_text(os.path.join(args.data_dir, "text"))
    editor = SpeechEditor(
        model, fe_cfg, conv, vocoder=make_vocoder(args.vocoder, fe_cfg, dev),
        duration_fn=(make_duration_fn(args, dev)
                     if getattr(args, "duration_model", None) else None),
        lexicon=phone_lexicon(texts), g2p=letter_to_sound, device=dev)
    return editor, texts


def run_gate(editor, texts, dataset, alignments, uids, out: str,
             mcd_config=None, spembs=None) -> dict:
    """Decode, save the splits and score the MCD for ``uids``; returns the
    report.  ``spembs`` ({uid: (E,) float32}) gives a speaker-conditioned
    model explicit x-vectors (the reference's spk2xvector lookup,
    sedit_inference.py:203-210); uids it lacks take the editor's
    ``spemb_fn``."""
    fs = editor.fe.config.fs
    hop = editor.fe.config.hop_length
    cfg = mcd_config or MCDConfig(
        mcep_dim=80, fftl=1024, shiftms=300.0, f0min=80, f0max=7600)

    mask_reconstruct = editor.duration_fn is None
    per_utt, per_utt_vocoder = {}, {}
    for uid in uids:
        wav = dataset[uid]["audio"]
        text = texts[uid]
        res = editor.edit(wav, alignments(uid), text, protocol_mask(text),
                          mask_reconstruct=mask_reconstruct,
                          spemb=None if spembs is None else spembs.get(uid))
        s_new, e_new = res.new_span_boundary
        s_old, e_old = res.old_span_boundary
        save_splits(res.prediction, s_new * hop, e_new * hop, out, "sedit",
                    fs, uid)
        save_splits(wav, s_old * hop, e_old * hop, out, "gt", fs, uid)
        # vocoder ceiling: resynthesize the unedited mel (sedit_mcd.py:124)
        voc = editor._vocode(res.mel_original)
        save_splits(voc, s_old * hop, e_old * hop, out, "vocoder", fs, uid)

        gt_span = wav[s_old * hop: e_old * hop]
        per_utt[uid] = mcd_between_waveforms(
            res.prediction[s_new * hop: e_new * hop], gt_span, fs, cfg)
        per_utt_vocoder[uid] = mcd_between_waveforms(
            voc[s_old * hop: e_old * hop], gt_span, fs, cfg)

    def mean(d):
        vals = [v for v in d.values() if np.isfinite(v)]
        return float(np.mean(vals)) if vals else float("nan")

    return {
        "n": len(per_utt),
        "mean_mcd": mean(per_utt),
        "vocoder_ceiling_mcd": mean(per_utt_vocoder),
        "per_utt": per_utt,
        "per_utt_vocoder": per_utt_vocoder,
        "protocol": {
            "mask": "tokens[:n//3] + [MASK] + tokens[-n//3:]",
            "teacher_forcing": True,
            "mcep_dim": cfg.mcep_dim, "shiftms": cfg.shiftms,
            "f0min": cfg.f0min, "f0max": cfg.f0max,
        },
    }


def main(argv=None):
    """Run the gate and write ``MCD.json``; returns the report."""
    ap = argparse.ArgumentParser(description="A3T speech-editing MCD gate "
                                             "(PyTorch)")
    ap.add_argument("--exp-dir", default=None,
                    help="a3t_tpu_torch experiment directory")
    ap.add_argument("--espnet-ckpt", default=None,
                    help="published ESPnet A3T .pth (config.yaml alongside)")
    ap.add_argument("--checkpoint", default="ave")
    ap.add_argument("--data-dir", required=True,
                    help="dir with wav.scp/text/mfa_start/mfa_end")
    ap.add_argument("--uids", default=None,
                    help="comma list / file of uids; 'vctk_seen' / "
                         "'vctk_unseen' select the protocol lists; "
                         "default = all utterances in data-dir")
    ap.add_argument("--duration-model", default=None,
                    help="FastSpeech2 duration predictor (FS2 experiment "
                         "directory or ESPnet .pth)")
    ap.add_argument("--spk-xvector", default=None,
                    help=".npy x-vector (E,) for the duration model")
    ap.add_argument("--vocoder", default=None,
                    help="parallel_wavegan checkpoint or vocoder directory "
                         "of either package's bin.train_vocoder "
                         "(Griffin-Lim if unset)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if not args.exp_dir and not args.espnet_ckpt:
        ap.error("one of --exp-dir / --espnet-ckpt is required")
    refuse_unported(args, vocoder_dirs=True)

    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.inference import FileAlignmentSource

    editor, texts = build_editor(args)
    dataset = A3TDataset(args.data_dir, editor.tokens)
    alignments = FileAlignmentSource(args.data_dir)

    if args.uids == "vctk_seen":
        uids = VCTK_SEEN
    elif args.uids == "vctk_unseen":
        uids = VCTK_UNSEEN
    elif args.uids and os.path.exists(args.uids):
        with open(args.uids) as f:
            uids = [ln.strip() for ln in f if ln.strip()]
    elif args.uids:
        uids = args.uids.split(",")
    else:
        uids = list(dataset.uids)

    os.makedirs(args.out, exist_ok=True)
    report = run_gate(editor, texts, dataset, alignments, uids, args.out)
    with open(os.path.join(args.out, "MCD.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"n={report['n']} mean MCD: {report['mean_mcd']:.2f} "
          f"(vocoder ceiling {report['vocoder_ceiling_mcd']:.2f})")
    return report


if __name__ == "__main__":
    main()
