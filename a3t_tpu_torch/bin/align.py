"""Forced-alignment CLI (align_english.py batch-mode analogue): the port of
``a3t_tpu/bin/align.py``.

    python -m a3t_tpu_torch.bin.align --data-dir data/train \
        --sample-rate 16000 [--save-model aligner.bin] [--iters 10] \
        [--lexicon lexicon.txt]

Reads wav.scp + text (phone strings; or words with --lexicon), trains
monophone models on the corpus (flat start), writes
mfa_text/mfa_start/mfa_end.  The aligner runs on the host; like every entry
point of the port, the CLI refuses to start without a CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="A3T forced alignment")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--save-model", default=None)
    parser.add_argument("--lexicon", default=None,
                        help="word<space>PH1 PH2... file; text treated as "
                             "words when given")
    parser.add_argument("--device", default="cuda",
                        help="torch device the run is for (default cuda)")
    args = parser.parse_args(argv)

    from a3t_tpu_torch.align import align_corpus
    from a3t_tpu_torch.device import resolve_device

    resolve_device(args.device)
    lexicon = None
    if args.lexicon:
        lexicon = {}
        with open(args.lexicon, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    lexicon[parts[0].upper()] = parts[1:]

    out = align_corpus(
        args.data_dir, args.out_dir, lexicon=lexicon,
        sample_rate=args.sample_rate, n_iterations=args.iters,
        model_path=args.save_model)
    print(f"alignments written to {out}")
    return out


if __name__ == "__main__":
    main()
