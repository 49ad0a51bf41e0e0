"""Alignment-aware masking and segment positions, host-side numpy.

A copy of ``a3t_tpu/masking/alignment.py:28-142``, kept here so that the
port imports nothing of the JAX package.  Semantics follow
espnet2/train/collate_fn.py:290-385: ``phones_masking`` picks masked phones
with T5 span statistics and expands them to their aligned frames; frames
aligned to phone j and the j-th text token both get segment id j+1
(0 = unaligned / padding).
"""

from __future__ import annotations

import numpy as np

from a3t_tpu_torch.masking.spans import random_spans_noise_mask

# Mean frame-span cap for speech-only (alignment-free) masking,
# mirroring espnet2/train/collate_fn.py:359 and sedit_model.py:96 (max_span).
MAX_FRAME_SPAN = 50


def masked_positions_from_boundary(
    n_frames: int, span_boundary: np.ndarray
) -> np.ndarray:
    """Frame mask from explicit (start, end, start, end, ...) boundaries."""
    mask = np.zeros(n_frames, dtype=bool)
    sb = np.asarray(span_boundary).reshape(-1)
    for s, e in zip(sb[::2], sb[1::2]):
        mask[int(s) : int(e)] = True
    return mask


def phones_masking(
    n_frames: int,
    align_start: np.ndarray,
    align_end: np.ndarray,
    n_phones: int,
    mlm_prob: float,
    mean_phn_span: float,
    rng: np.random.Generator,
    span_boundary: np.ndarray | None = None,
) -> np.ndarray:
    """Boolean (n_frames,) mask of frames to reconstruct for one utterance.

    Args:
        align_start/align_end: (>= n_phones,) frame indices per phone.
        n_phones: number of valid alignment entries.
        mlm_prob: fraction of phones (or frames) to mask.
        mean_phn_span: mean masked-span length in phones; 0 switches to
            alignment-free frame-span masking.
        span_boundary: optional explicit frame spans (inference editing).
    """
    if span_boundary is not None:
        return masked_positions_from_boundary(n_frames, span_boundary)
    if mlm_prob >= 1.0:
        return np.ones(n_frames, dtype=bool)
    if mean_phn_span == 0:
        mean_span = min(n_frames * mlm_prob // 3, MAX_FRAME_SPAN)
        return np.asarray(
            random_spans_noise_mask(n_frames, mlm_prob, max(mean_span, 1), rng)
        )
    mask = np.zeros(n_frames, dtype=bool)
    if n_phones < 2:
        return mask
    phn_mask = random_spans_noise_mask(n_phones, mlm_prob, mean_phn_span, rng)
    for j in np.nonzero(phn_mask)[0]:
        s = int(align_start[j])
        e = int(align_end[j])
        mask[s:e] = True
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


def duration_reduction(
    n_frames: int,
    align_start: np.ndarray,
    align_end: np.ndarray,
    n_phones: int,
    masked_position: np.ndarray,
    feats_length: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Reduced-sequence reordering for the duration-aware TTS variant
    (espnet2/train/collate_fn.py:290-328): a masked phone keeps only its
    first frame, which records the phone's duration; unmasked phones keep
    all their frames.  Returns ``(reordered_index, durations,
    reduced_length)``: ``reordered_index`` lists the kept frames and then
    the dropped ones, so its first ``reduced_length`` entries are the
    reduced sequence.  As in the reference, masked frames before the first
    phone collapse to position 0 with duration 1, so the durations need
    not sum to the utterance's frames.
    """
    first_idx: list[int] = []
    last_idx: list[int] = []
    durations = np.ones(n_frames, dtype=np.int32)
    e = 0
    for j in range(int(n_phones)):
        s, e = int(align_start[j]), int(align_end[j])
        if j == 0:
            if masked_position[0:s].sum() == 0:
                first_idx.extend(range(0, s))
            else:
                first_idx.append(0)
                last_idx.extend(range(1, s))
        if masked_position[s:e].sum() == 0:
            first_idx.extend(range(s, e))
        else:
            first_idx.append(s)
            last_idx.extend(range(s + 1, e))
            durations[s] = e - s
    reduced_length = len(first_idx) + int(feats_length) - e
    first_idx.extend(range(e, n_frames))
    reordered = np.asarray(first_idx + last_idx, dtype=np.int32)
    return reordered, durations, reduced_length
