"""Rule-based English letter-to-sound (OOV fallback): a copy of
``a3t_tpu/text/g2p.py``, kept here so that the port imports nothing of the
JAX package.

Stands in for the reference's english2phoneme C binary
(tools/english2phoneme, driven via sedit_inference.py:263-298) until/beside
the native C++ rule engine in native/g2p.  This is a compact clean-room
rule set producing ARPAbet with stress digits in the same post-processed
form the reference emits (JH/HH expansions, AX -> AH0, default stress 1).

Accuracy matters little here: the lexicon covers in-vocabulary words; this
only catches stray OOVs so inference never crashes.
"""

from __future__ import annotations

# digraph -> phone (checked before single letters)
_DIGRAPHS = {
    "ch": "CH", "sh": "SH", "th": "TH", "ph": "F", "wh": "W",
    "ck": "K", "ng": "NG", "qu": "K W",
    "ee": "IY1", "ea": "IY1", "oo": "UW1", "ou": "AW1", "ow": "OW1",
    "ai": "EY1", "ay": "EY1", "oi": "OY1", "oy": "OY1", "au": "AO1",
    "ar": "AA1 R", "er": "ER0", "ir": "ER1", "or": "AO1 R", "ur": "ER1",
}

_SINGLE = {
    "a": "AE1", "e": "EH1", "i": "IH1", "o": "AA1", "u": "AH1", "y": "IY0",
    "b": "B", "c": "K", "d": "D", "f": "F", "g": "G", "h": "HH",
    "j": "JH", "k": "K", "l": "L", "m": "M", "n": "N", "p": "P",
    "q": "K", "r": "R", "s": "S", "t": "T", "v": "V", "w": "W",
    "x": "K S", "z": "Z",
}


def letter_to_sound(word: str) -> list[str]:
    """Word -> ARPAbet phone list via greedy digraph/letter rules."""
    w = "".join(ch for ch in word.lower() if ch.isalpha())
    phones: list[str] = []
    i = 0
    while i < len(w):
        pair = w[i : i + 2]
        if pair in _DIGRAPHS:
            phones.extend(_DIGRAPHS[pair].split())
            i += 2
            continue
        # silent final e
        if w[i] == "e" and i == len(w) - 1 and phones:
            i += 1
            continue
        ch = w[i]
        if ch in _SINGLE:
            phones.extend(_SINGLE[ch].split())
        i += 1
    return phones or ["AH0"]
