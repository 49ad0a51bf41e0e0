"""Pack a prepared data directory into record shards
(``a3t_tpu_torch/data/records.py``), with the JAX CLI's flags:

    python -m a3t_tpu_torch.bin.pack_records --data-dir dump/raw/tr_no_dev \
        --tokens exp/a3t/tokens.txt --out dump/records/tr_no_dev

Without ``--tokens`` (or when it names no file) the token list is built
from the directory's ``text``; either way it is saved as
``<out>/tokens.txt``.  ``--speech-only`` packs the audio alone.  The
shards and the index equal the JAX CLI's, so either package trains on
either's records (``bin.train --set train_data_dir=<out>``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="pack a corpus into records")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--tokens", default=None,
                    help="token list (built from the text file if omitted)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--shard-mb", type=int, default=512)
    ap.add_argument("--speech-only", action="store_true")
    args = ap.parse_args(argv)

    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text
    from a3t_tpu_torch.data.records import pack_records
    from a3t_tpu_torch.text import TokenIDConverter, build_token_list

    conv = None
    if not args.speech_only:
        if args.tokens and os.path.exists(args.tokens):
            conv = TokenIDConverter(args.tokens)
        else:
            texts = read_2column_text(os.path.join(args.data_dir, "text"))
            conv = TokenIDConverter(build_token_list(texts.values()))
        os.makedirs(args.out, exist_ok=True)
        conv.save(os.path.join(args.out, "tokens.txt"))
    ds = A3TDataset(args.data_dir, conv, speech_only=args.speech_only)
    pack_records(ds, args.out, shard_mb=args.shard_mb)
    print(f"packed {len(ds)} utterances -> {args.out}")


if __name__ == "__main__":
    main()
