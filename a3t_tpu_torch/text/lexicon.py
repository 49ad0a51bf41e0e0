"""Pronouncing-lexicon IO (CMU dictionary format): a copy of
``a3t_tpu/text/lexicon.py``, kept here so that the port imports nothing of
the JAX package.

The reference's aligner ships the public CMU pronouncing dictionary
(tools/alignment/aligner/english/dict, 127k entries) and merges per-run
OOV pronunciations from the english2phoneme binary
(align_english.py:20-67).  This module parses that format — including
``WORD(2)`` alternate-pronunciation entries and comment lines — and builds
lexicons from any word list via the native rule-based g2p as the fallback.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, Optional


def load_cmu_dict(path: str, keep_alternates: bool = False,
                  strip_stress: bool = False) -> dict[str, list[str]]:
    """CMU-format dict file -> {WORD: [phones]} (first pronunciation wins
    unless ``keep_alternates``, which keeps ``WORD(2)``-style keys)."""
    lex: dict[str, list[str]] = {}
    with open(path, encoding="latin-1") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";;;"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            word = parts[0]
            phones = parts[1:]
            if strip_stress:
                phones = [re.sub(r"\d", "", p) for p in phones]
            m = re.match(r"^(.*)\((\d+)\)$", word)
            if m and not keep_alternates:
                continue  # alternate pronunciation; first one already kept
            key = word if keep_alternates else word.upper()
            lex.setdefault(key, phones)
    return lex


def save_cmu_dict(lexicon: dict[str, list[str]], path: str):
    with open(path, "w", encoding="utf-8") as f:
        for word in sorted(lexicon):
            f.write(f"{word}  {' '.join(lexicon[word])}\n")


def build_lexicon(
    words: Iterable[str],
    g2p: Callable[[str], list[str]],
    base: Optional[dict[str, list[str]]] = None,
) -> dict[str, list[str]]:
    """Lexicon covering ``words``: entries from ``base`` (e.g. a loaded CMU
    dict) where present, rule-based g2p for the rest (the reference's OOV
    path, align_english.py:46-67)."""
    out: dict[str, list[str]] = {}
    base = base or {}
    for w in words:
        key = w.upper()
        if key in out:
            continue
        if key in base:
            out[key] = list(base[key])
        else:
            out[key] = list(g2p(w))
    return out
