"""VCTK data preparation (egs2/vctk/sedit local/data_vctk.sh analogue): the
port of ``recipes/vctk/prepare.py``.

From a VCTK-Corpus checkout (wav48/<spk>/*.wav + txt/<spk>/*.txt):
  1. Kaldi-style dirs with speaker-aware tr_no_dev/dev splits and the
     held-out speakers in eval_unseen (the unseen-speaker MCD protocol),
  2. native-g2p phonemization (lexicon.txt),
  3. the format stage: the 48 kHz sources to mono PCM16 at --target-fs,
  4. native forced alignment at the target rate.

    python -m a3t_tpu_torch.recipes.vctk --corpus /data/VCTK-Corpus \
        --out dump/vctk [--unseen-speakers p225 p226 ...] \
        [--dev-per-spk 5] [--target-fs 24000] [--skip-align] [--device cpu]

Every stage runs on the host; like every entry point of the port, the
recipe refuses to start without a CUDA card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import glob
import os

from a3t_tpu_torch.recipes.ljspeech import phonemizer, write_lexicon


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--unseen-speakers", nargs="*",
                        default=["p225", "p226", "p227", "p228"])
    parser.add_argument("--dev-per-spk", type=int, default=5)
    parser.add_argument("--source-fs", type=int, default=48000,
                        help="expected corpus sample rate (wav48 = 48 kHz)")
    parser.add_argument("--target-fs", type=int, default=24000,
                        help="training sample rate; matches "
                             "configs/a3t_conformer_24k.yaml")
    parser.add_argument("--skip-align", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device the run is for (default cuda)")
    args = parser.parse_args(argv)

    from a3t_tpu_torch.align import align_corpus
    from a3t_tpu_torch.data.fileio import write_2column_text
    from a3t_tpu_torch.data.format_wav import format_data_dir
    from a3t_tpu_torch.device import resolve_device

    resolve_device(args.device)
    wav_root = os.path.join(args.corpus, "wav48")
    txt_root = os.path.join(args.corpus, "txt")
    lexicon: dict[str, list[str]] = {}
    phonemize = phonemizer(lexicon)

    splits = {"tr_no_dev": {}, "dev": {}, "eval_unseen": {}}
    spk_map = {k: {} for k in splits}
    for spk in sorted(os.listdir(wav_root)):
        wavs = sorted(glob.glob(os.path.join(wav_root, spk, "*.wav")))
        for i, wav in enumerate(wavs):
            uid = os.path.splitext(os.path.basename(wav))[0]
            txt = os.path.join(txt_root, spk, uid + ".txt")
            if not os.path.exists(txt):
                continue
            with open(txt, encoding="utf-8") as f:
                phones = " ".join(phonemize(f.read().strip()))
            if not phones:
                continue
            if spk in args.unseen_speakers:
                split = "eval_unseen"
            elif i < args.dev_per_spk:
                split = "dev"
            else:
                split = "tr_no_dev"
            splits[split][uid] = (wav, phones)
            spk_map[split][uid] = spk

    for name, data in splits.items():
        d = os.path.join(args.out, name)
        write_2column_text(os.path.join(d, "wav.scp"),
                           {u: v[0] for u, v in data.items()})
        write_2column_text(os.path.join(d, "text"),
                           {u: v[1] for u, v in data.items()})
        write_2column_text(os.path.join(d, "utt2spk"), spk_map[name])
        report = format_data_dir(d, d, args.target_fs,
                                 expected_source_fs=args.source_fs)
        print(f"{name}: {len(data)} utts (formatted -> "
              f"{args.target_fs} Hz, {report['source_fs_counts']})")
    write_lexicon(os.path.join(args.out, "lexicon.txt"), lexicon)

    if not args.skip_align:
        model_path = os.path.join(args.out, "aligner.bin")
        for name in splits:
            print(f"aligning {name}...")
            align_corpus(os.path.join(args.out, name),
                         sample_rate=args.target_fs, n_iterations=10,
                         model_path=model_path if name == "tr_no_dev" else None)


if __name__ == "__main__":
    main()
