"""LJSpeech data preparation (egs2/ljspeech/sedit local/data.sh analogue):
the port of ``recipes/ljspeech/prepare.py``.

From an LJSpeech-1.1 checkout (metadata.csv + wavs/*.wav):
  1. write Kaldi-style data dirs (wav.scp, text, utt2spk) with an
     eval1/dev/tr_no_dev split,
  2. phonemize the transcripts with the native g2p (lexicon built on the
     fly and written to lexicon.txt),
  3. format every split to mono PCM16 at --fs,
  4. force-align with the native aligner -> mfa_text/mfa_start/mfa_end.

    python -m a3t_tpu_torch.recipes.ljspeech --corpus /data/LJSpeech-1.1 \
        --out dump/ljspeech [--dev-utts 100 --eval-utts 100] [--fs 22050] \
        [--skip-align] [--device cpu]

Every stage runs on the host; like every entry point of the port, the
recipe refuses to start without a CUDA card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import csv
import os


def phonemizer(lexicon: dict[str, list[str]]):
    """transcript -> phones, through ``clean_words`` and the native g2p,
    filling ``lexicon`` (upper-cased words) as it goes."""
    from a3t_tpu_torch.inference.sedit import clean_words
    from a3t_tpu_torch.text.native_g2p import letter_to_sound

    def phonemize(transcript: str) -> list[str]:
        phones = []
        for w in clean_words(transcript):
            wu = w.upper()
            if wu not in lexicon:
                lexicon[wu] = letter_to_sound(w)
            phones.extend(lexicon[wu])
        return phones

    return phonemize


def write_lexicon(path: str, lexicon: dict[str, list[str]]) -> None:
    with open(path, "w") as f:
        for w in sorted(lexicon):
            f.write(f"{w} {' '.join(lexicon[w])}\n")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--dev-utts", type=int, default=100)
    parser.add_argument("--eval-utts", type=int, default=100)
    parser.add_argument("--fs", type=int, default=22050,
                        help="training sample rate; sources are formatted "
                             "(resampled) to this before alignment")
    parser.add_argument("--skip-align", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device the run is for (default cuda)")
    args = parser.parse_args(argv)

    from a3t_tpu_torch.align import align_corpus
    from a3t_tpu_torch.data.fileio import write_2column_text
    from a3t_tpu_torch.data.format_wav import format_data_dir
    from a3t_tpu_torch.device import resolve_device

    resolve_device(args.device)
    entries = []
    with open(os.path.join(args.corpus, "metadata.csv"),
              encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="|"):
            uid, normalized = row[0], row[-1]
            wav = os.path.join(args.corpus, "wavs", uid + ".wav")
            if os.path.exists(wav):
                entries.append((uid, wav, normalized))
    entries.sort()

    splits = {
        "eval1": entries[: args.eval_utts],
        "dev": entries[args.eval_utts: args.eval_utts + args.dev_utts],
        "tr_no_dev": entries[args.eval_utts + args.dev_utts:],
    }
    lexicon: dict[str, list[str]] = {}
    phonemize = phonemizer(lexicon)
    for name, split in splits.items():
        d = os.path.join(args.out, name)
        wav_scp, text = {}, {}
        for uid, wav, transcript in split:
            phones = phonemize(transcript)
            if not phones:
                continue
            wav_scp[uid] = wav
            text[uid] = " ".join(phones)
        write_2column_text(os.path.join(d, "wav.scp"), wav_scp)
        write_2column_text(os.path.join(d, "text"), text)
        write_2column_text(os.path.join(d, "utt2spk"),
                           {u: "LJ" for u in wav_scp})
        report = format_data_dir(d, d, args.fs)
        print(f"{name}: {len(wav_scp)} utts (formatted -> {args.fs} Hz, "
              f"{report['source_fs_counts']})")
    write_lexicon(os.path.join(args.out, "lexicon.txt"), lexicon)

    if not args.skip_align:
        model_path = os.path.join(args.out, "aligner.bin")
        for name in ("tr_no_dev", "dev", "eval1"):
            print(f"aligning {name}...")
            align_corpus(os.path.join(args.out, name),
                         sample_rate=args.fs, n_iterations=10,
                         model_path=model_path if name == "tr_no_dev" else None)


if __name__ == "__main__":
    main()
