"""Phone tokens: a copy of ``a3t_tpu/text/tokenizer.py``.

The sedit recipes tokenize text that is already phones, so the tokenizer is
a whitespace split and the vocabulary is the phone set plus specials
(espnet2/text/token_id_converter.py).
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence

BLANK = "<blank>"
UNK = "<unk>"
SOS_EOS = "<sos/eos>"


def tokenize(text: str) -> list[str]:
    return text.split()


def build_token_list(
    texts: Iterable[str],
    specials_first: Sequence[str] = (BLANK, UNK),
    specials_last: Sequence[str] = (SOS_EOS,),
    min_count: int = 1,
) -> list[str]:
    """Vocabulary from a corpus of (phone) strings, sorted by token: blank
    and unk first, sos/eos last (the recipe's token-list stage)."""
    counter: Counter[str] = Counter()
    for t in texts:
        counter.update(tokenize(t))
    toks = sorted(k for k, c in counter.items() if c >= min_count)
    return list(specials_first) + toks + list(specials_last)


class TokenIDConverter:
    """token <-> id mapping (espnet2/text/token_id_converter.py)."""

    def __init__(self, token_list: Sequence[str] | str, unk_symbol: str = UNK):
        if isinstance(token_list, str):
            with open(token_list, encoding="utf-8") as f:
                token_list = [line.rstrip("\n") for line in f if line.strip()]
        self.token_list = list(token_list)
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        if len(self.token2id) != len(self.token_list):
            raise ValueError("duplicated tokens in token list")
        self.unk_symbol = unk_symbol
        if unk_symbol not in self.token2id:
            raise ValueError(f"unk symbol {unk_symbol!r} missing from token list")
        self.unk_id = self.token2id[unk_symbol]

    def __len__(self):
        return len(self.token_list)

    def tokens2ids(self, tokens: Iterable[str]) -> list[int]:
        return [self.token2id.get(t, self.unk_id) for t in tokens]

    def ids2tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.token_list[int(i)] for i in ids]

    def text2ids(self, text: str) -> list[int]:
        return self.tokens2ids(tokenize(text))

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            for t in self.token_list:
                f.write(t + "\n")
