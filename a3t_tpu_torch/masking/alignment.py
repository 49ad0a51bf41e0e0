"""Alignment-aware masking and segment positions, host-side numpy.

A copy of ``a3t_tpu/masking/alignment.py:31-104`` (the two functions that
inference uses), kept here so that the port imports nothing of the JAX
package.  Semantics follow espnet2/train/collate_fn.py:290-385: frames
aligned to phone j and the j-th text token both get segment id j+1
(0 = unaligned / padding).
"""

from __future__ import annotations

import numpy as np


def masked_positions_from_boundary(
    n_frames: int, span_boundary: np.ndarray
) -> np.ndarray:
    """Frame mask from explicit (start, end, start, end, ...) boundaries."""
    mask = np.zeros(n_frames, dtype=bool)
    sb = np.asarray(span_boundary).reshape(-1)
    for s, e in zip(sb[::2], sb[1::2]):
        mask[int(s) : int(e)] = True
    return mask


def segment_positions(
    n_frames: int,
    n_text: int,
    align_start: np.ndarray,
    align_end: np.ndarray,
    n_phones: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(speech_segment_pos (n_frames,), text_segment_pos (n_text,)) int32.

    Frames aligned to phone j get id j+1; text token j gets id j+1; all other
    positions stay 0 (the padding id of the segment embedding table).
    """
    speech_pos = np.zeros(n_frames, dtype=np.int32)
    text_pos = np.zeros(n_text, dtype=np.int32)
    for j in range(int(n_phones)):
        s = int(align_start[j])
        e = int(align_end[j])
        speech_pos[s:e] = j + 1
        if j < n_text:
            text_pos[j] = j + 1
    return speech_pos, text_pos
