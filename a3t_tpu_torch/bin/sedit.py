"""Speech-editing CLI: the port of ``a3t_tpu/bin/sedit.py``.

    # regenerate a span so the utterance says the new text
    python -m a3t_tpu_torch.bin.sedit edit --exp-dir exp/a3t \
        --data-dir dump/dev --uid utt001 --new-text "HH AH0 L OW1 W ER1 L D" \
        --out edited.wav

    # prompt TTS: continue the utterance with new content
    python -m a3t_tpu_torch.bin.sedit prompt --exp-dir exp/a3t \
        --data-dir dump/dev --uid utt001 \
        --new-text "<prompt text> <continuation>" --out out.wav

    # MCD-style reconstruction of the span under [MASK]
    python -m a3t_tpu_torch.bin.sedit reconstruct --exp-dir exp/a3t \
        --data-dir dump/dev --uid utt001 --new-text "A B [MASK] E F" \
        --out rec.wav

    # durations of the new phones from a FastSpeech2 conditioned on a
    # speaker's x-vector
    python -m a3t_tpu_torch.bin.sedit edit --exp-dir exp/a3t \
        --data-dir dump/dev --uid utt001 --new-text "..." --out edited.wav \
        --duration-model exp/fs2 --spk-xvector spk1.npy

The model comes from an experiment directory of ``a3t_tpu_torch.bin.train``
(``--checkpoint``: ave, latest or epoch_N), the vocoder from a
``parallel_wavegan`` checkpoint (``--vocoder PKL``) or Griffin-Lim when
none is given.  New phones last ``--uniform-duration`` seconds each, or
what ``--duration-model`` predicts: a FastSpeech2 experiment of
``tasks/fs2.py`` or an ESPnet FastSpeech2 ``.pth`` with its
``config.yaml``, conditioned on ``--spk-xvector`` (one (E,) ``.npy``).
New text is read through a phone-level lexicon (every phone of the data
directory's ``text`` maps to itself) and the native letter-to-sound engine
for other words.  Runs on the CUDA card unless ``--device cpu`` is given.
The model's experiment directory may also be one of the JAX package
(orbax checkpoints).  A vocoder directory is refused, as the JAX CLI reads
only a pickle (``bin.mcd_gate --vocoder DIR`` takes one of either
package's ``bin.train_vocoder``).
"""

from __future__ import annotations

import argparse
import os


def refuse_unported(args, vocoder_dirs: bool = False) -> None:
    """Raise for ``--spk-xvector`` without the duration model it conditions
    (the JAX CLI ignores it there), and for a vocoder directory unless
    ``vocoder_dirs`` (mcd_gate's, as in JAX: the port's ``state.pt`` or
    the JAX package's orbax ``state/``, read by ``load_vocoder``)."""
    if args.spk_xvector and not args.duration_model:
        raise ValueError("--spk-xvector conditions the duration model; "
                         "give --duration-model too")
    if args.vocoder and os.path.isdir(args.vocoder) and not vocoder_dirs:
        raise ValueError(
            f"{args.vocoder} is a directory: this CLI takes a "
            "parallel_wavegan checkpoint, as the JAX CLI does (bin.mcd_gate "
            "--vocoder takes a vocoder directory)")


def make_vocoder(path, frontend_config, device):
    """A callable (B, F, n_mels) mel -> (B, S) wav: a vocoder directory of
    ``bin.train_vocoder`` (``train/vocoder.py::load_vocoder``), or the
    parallel_wavegan checkpoint at ``path`` (the default generator, hop
    300, with the front-end's mel bins) with its noise drawn from a
    generator seeded with 0 in every call; None (Griffin-Lim) without a
    path."""
    if not path:
        return None
    if os.path.isdir(path):
        from a3t_tpu_torch.train.vocoder import load_vocoder

        return load_vocoder(path, device)
    import torch

    from a3t_tpu_torch.models.pwg import (ParallelWaveGANGenerator, PWGConfig,
                                          load_pwg_checkpoint)

    cfg = PWGConfig(aux_channels=frontend_config.n_mels)
    if cfg.upsample_factor != frontend_config.hop_length:
        raise ValueError(f"the parallel_wavegan generator upsamples by "
                         f"{cfg.upsample_factor}, the front-end's hop is "
                         f"{frontend_config.hop_length}")
    gen = ParallelWaveGANGenerator(cfg)
    gen.load_state_dict(load_pwg_checkpoint(path, cfg), strict=True)
    gen = gen.to(device).eval()
    noise = torch.Generator(device=device)
    return lambda mel: gen(mel, generator=noise.manual_seed(0))


def phone_lexicon(texts: dict) -> dict:
    """Every phone of a data directory's texts maps to itself."""
    phones = {p for t in texts.values() for p in t.split()}
    return {p.upper(): [p] for p in phones}


def make_duration_fn(args, device):
    """The editor's duration function: ``--duration-model`` conditioned on
    ``--spk-xvector``, else ``--uniform-duration`` seconds per phone (None
    when that is 0)."""
    if args.duration_model:
        import numpy as np

        from a3t_tpu_torch.inference.durations import load_duration_fn

        spembs = np.load(args.spk_xvector) if args.spk_xvector else None
        return load_duration_fn(args.duration_model, spembs=spembs,
                                device=device)
    if args.uniform_duration > 0:
        return lambda phones, wav: [args.uniform_duration] * len(phones)
    return None


def build_editor(args):
    """(editor, alignments, dataset, texts) for ``args``."""
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text
    from a3t_tpu_torch.device import resolve_device
    from a3t_tpu_torch.inference import FileAlignmentSource, SpeechEditor
    from a3t_tpu_torch.tasks.mlm import MLMTask
    from a3t_tpu_torch.text import letter_to_sound

    dev = resolve_device(args.device)
    model, cfg, conv = MLMTask.build_model_from_dir(
        args.exp_dir, which=args.checkpoint, device=dev)
    texts = read_2column_text(os.path.join(args.data_dir, "text"))
    editor = SpeechEditor(
        model, cfg.frontend, conv,
        vocoder=make_vocoder(args.vocoder, cfg.frontend, dev),
        duration_fn=make_duration_fn(args, dev),
        lexicon=phone_lexicon(texts), g2p=letter_to_sound, device=dev)
    dataset = A3TDataset(args.data_dir, conv)
    return editor, FileAlignmentSource(args.data_dir), dataset, texts


def main(argv=None):
    """Edit one utterance and write the wav; returns the ``EditResult``
    (edit, reconstruct) or the prompt TTS dict."""
    parser = argparse.ArgumentParser(description="A3T speech editing "
                                                 "(PyTorch)")
    parser.add_argument("mode", choices=["edit", "prompt", "reconstruct"])
    parser.add_argument("--exp-dir", required=True)
    parser.add_argument("--data-dir", required=True,
                        help="dir with wav.scp/text/mfa_start/mfa_end")
    parser.add_argument("--uid", required=True)
    parser.add_argument("--new-text", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--checkpoint", default="ave")
    parser.add_argument("--vocoder", default=None,
                        help="parallel_wavegan checkpoint (Griffin-Lim if "
                             "unset)")
    parser.add_argument(
        "--duration-model", "--duration-exp-dir", dest="duration_model",
        default=None,
        help="FastSpeech2 duration predictor: an FS2 experiment directory "
             "or an ESPnet .pth checkpoint (with config.yaml alongside)")
    parser.add_argument("--spk-xvector", default=None,
                        help=".npy x-vector (E,) for the duration model's "
                             "speaker conditioning")
    parser.add_argument("--uniform-duration", type=float, default=0.1,
                        help="per-phone duration in seconds for new phones "
                             "(ignored with --duration-model)")
    parser.add_argument(
        "--dynamic-eval", default=None, metavar="LR,STEPS",
        help="test-time fine-tuning on the utterance before decoding, "
             "e.g. 5e-5,3")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    refuse_unported(args)

    from a3t_tpu_torch.data.fileio import write_wav

    editor, aligner, dataset, texts = build_editor(args)
    wav = dataset[args.uid]["audio"]
    align = aligner(args.uid)
    old_str = texts[args.uid]

    if args.dynamic_eval:
        from a3t_tpu_torch.inference.baselines import dynamic_evaluation

        lr, steps = args.dynamic_eval.split(",")
        editor = dynamic_evaluation(editor, wav, align, old_str,
                                    lr=float(lr), steps=int(steps))

    fs = editor.fe.config.fs
    if args.mode == "prompt":
        res = editor.prompt_tts(wav, align, old_str, args.new_text)
        write_wav(args.out, fs, res["full"])
    elif args.mode == "reconstruct":
        res = editor.reconstruct_masked_span(wav, align, old_str,
                                             args.new_text)
        write_wav(args.out, fs, res.origin_replaced)
    else:
        res = editor.edit(wav, align, old_str, args.new_text)
        write_wav(args.out, fs, res.origin_replaced)
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
