"""Tokenize a text corpus / build a vocabulary with counts: the port of
``a3t_tpu/bin/tokenize_text.py``.

The recipe token-list stage (espnet2/bin/tokenize_text.py, driven by
mlm.sh:257-260 with token_type=word + phn_as_word=true so HTK phones are
the vocabulary).  Covers the A3T-exercised surface: Kaldi ``uid text``
or plain-line input, 1-based field slicing ("2-" drops the uid column),
word/char tokenization, and write-vocabulary mode with count cutoff /
size cap / pinned special symbols.  A vocabulary written with the
recipe's pins (below) is the ``token_list`` file that ``TokenIDConverter``
and ``bin.train`` read.  The work is host work; like every entry point of
the port, the CLI refuses to start without a CUDA card unless
``--device cpu`` is given.

    python -m a3t_tpu_torch.bin.tokenize_text -i data/text -o tokens.txt \
        --field 2- --write-vocabulary \
        --add-symbol '<blank>:0' --add-symbol '<unk>:1' \
        --add-symbol '<sos/eos>:-1'
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter


def field_slice(field: str) -> slice:
    """1-based field spec ('2', '2-', '2-5', '-5') -> 0-based slice
    (cut(1)-style, tokenize_text.py::field2slice)."""
    field = field.strip()
    if "-" in field:
        lo, hi = field.split("-", 1)
        start = int(lo) - 1 if lo.strip() else None
        stop = int(hi) if hi.strip() else None
    else:
        start = int(field) - 1
        stop = start + 1
    if (start is not None and start < 0) or \
            (stop is not None and stop <= (start or 0)):
        raise ValueError(f"bad 1-based field spec: {field!r}")
    return slice(start, stop)


def tokenize_line(line: str, token_type: str, space_symbol: str) -> list[str]:
    if token_type == "word":
        return line.split()
    if token_type == "char":
        return [space_symbol if c == " " else c for c in line.strip()]
    raise ValueError(f"unsupported token_type: {token_type}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", "-i", required=True, help="'-' for stdin")
    ap.add_argument("--output", "-o", required=True, help="'-' for stdout")
    ap.add_argument("--field", "-f", default=None,
                    help="1-based token fields, e.g. '2-' to drop the uid")
    ap.add_argument("--token-type", "-t", default="word",
                    choices=["word", "char"])
    ap.add_argument("--space-symbol", default="<space>")
    ap.add_argument("--write-vocabulary", action="store_true",
                    help="emit a unique token list instead of token lines")
    ap.add_argument("--vocabulary-size", type=int, default=0,
                    help="cap the vocabulary (0 = no cap)")
    ap.add_argument("--cutoff", type=int, default=0,
                    help="drop tokens with count <= cutoff")
    ap.add_argument("--add-symbol", action="append", default=[],
                    help="'SYMBOL:POSITION', e.g. '<blank>:0', "
                         "'<sos/eos>:-1' (repeatable)")
    ap.add_argument("--write-counts", action="store_true",
                    help="append counts to the vocabulary lines")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run is for (default cuda)")
    args = ap.parse_args(argv)

    from a3t_tpu_torch.device import resolve_device

    resolve_device(args.device)

    fin = sys.stdin if args.input == "-" else open(args.input,
                                                   encoding="utf-8")
    fout = sys.stdout if args.output == "-" else open(args.output, "w",
                                                      encoding="utf-8")
    sl = field_slice(args.field) if args.field else None

    counter: Counter = Counter()
    try:
        for raw in fin:
            cols = raw.rstrip("\n").split()
            if sl is not None:
                cols = cols[sl]
            toks = tokenize_line(" ".join(cols), args.token_type,
                                 args.space_symbol)
            if args.write_vocabulary:
                counter.update(toks)
            else:
                print(" ".join(toks), file=fout)
    finally:
        if fin is not sys.stdin:
            fin.close()
    if not args.write_vocabulary:
        if fout is not sys.stdout:
            fout.close()
        return

    # specials are pinned positions and excluded from counting
    specials = []
    for spec in args.add_symbol:
        sym, _, pos = spec.rpartition(":")
        if not sym:
            raise ValueError(f"bad --add-symbol (want 'SYMBOL:POS'): {spec}")
        specials.append((sym, int(pos)))
        counter.pop(sym, None)

    ranked = [(t, c) for t, c in counter.most_common() if c > args.cutoff]
    if args.vocabulary_size > 0:
        # the reference caps the FINAL list including --add-symbol entries
        # (espnet2/bin/tokenize_text.py:146-149)
        if args.vocabulary_size <= len(specials):
            raise ValueError(
                f"vocabulary_size {args.vocabulary_size} must exceed the "
                f"{len(specials)} --add-symbol entries")
        ranked = ranked[: args.vocabulary_size - len(specials)]

    # resolve every pinned position against the FINAL length, then fill
    # the remaining slots with the ranked tokens in order
    total = len(ranked) + len(specials)
    out: list = [None] * total
    for sym, pos in specials:
        idx = pos if pos >= 0 else total + pos
        if not 0 <= idx < total or out[idx] is not None:
            raise ValueError(f"--add-symbol position clash at {idx}")
        out[idx] = (sym, None)
    it = iter(ranked)
    out = [slot if slot is not None else next(it) for slot in out]
    try:
        for tok, cnt in out:
            if args.write_counts and cnt is not None:
                print(f"{tok} {cnt}", file=fout)
            else:
                print(tok, file=fout)
    finally:
        if fout is not sys.stdout:
            fout.close()


if __name__ == "__main__":
    main()
