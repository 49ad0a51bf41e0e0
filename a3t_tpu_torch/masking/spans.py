"""T5-style random span noise masks: a copy of ``a3t_tpu/masking/spans.py``,
kept here so that the port imports nothing of the JAX package.

Reimplements the statistics of the T5 ``random_spans_helper`` used by the
reference (espnet2/train/collate_fn.py:387-446): given a sequence length, a
target noise density and a mean noise-span length, the number of noise tokens
and spans is fixed deterministically, spans alternate non-noise/noise starting
with non-noise, and all masks satisfying those counts are equally likely.

Unlike the reference (which draws from the global numpy RNG), every function
takes an explicit ``numpy.random.Generator`` so masking is reproducible and
shardable across data-loader workers.
"""

from __future__ import annotations

import numpy as np


def _random_segmentation(
    num_items: int, num_segments: int, rng: np.random.Generator
) -> np.ndarray:
    """Randomly partition ``num_items`` into ``num_segments`` positive parts."""
    first_in_segment = np.zeros(num_items, dtype=bool)
    if num_segments > 1:
        # Choose which of the num_items-1 interior boundaries start a segment.
        cut = rng.permutation(num_items - 1) < (num_segments - 1)
        first_in_segment[1:] = cut
    segment_id = np.cumsum(first_in_segment)
    return np.bincount(segment_id, minlength=num_segments)


def span_counts(length: int, noise_density: float, mean_span: float) -> tuple[int, int]:
    """(num_noise_tokens, num_noise_spans) for the T5 scheme."""
    num_noise = int(np.round(length * noise_density))
    num_noise = min(max(num_noise, 1), length - 1)
    num_spans = max(int(np.round(num_noise / mean_span)), 1)
    return num_noise, num_spans


def random_spans_noise_mask(
    length: int,
    noise_density: float,
    mean_span: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Boolean (length,) mask with T5 span-corruption statistics."""
    if length <= 1:
        return np.zeros(max(length, 0), dtype=bool)
    num_noise, num_spans = span_counts(length, noise_density, mean_span)
    num_nonnoise = length - num_noise

    noise_lens = _random_segmentation(num_noise, num_spans, rng)
    nonnoise_lens = _random_segmentation(num_nonnoise, num_spans, rng)

    interleaved = np.stack([nonnoise_lens, noise_lens], axis=1).reshape(-1)
    span_starts = np.cumsum(interleaved)[:-1]
    start_indicator = np.zeros(length, dtype=np.int8)
    start_indicator[span_starts] = 1
    span_num = np.cumsum(start_indicator)
    return (span_num % 2) == 1
