"""Synthetic raw-audio batches with plausible alignment structure: a copy
of ``a3t_tpu/data/synthetic.py``.

Produces the host-side batch layout the train step consumes (see
train/train_step.py), with harmonic audio so the mel front-end sees
realistic dynamic range.  Given the same ``np.random.Generator`` state it
returns the same arrays as the JAX package's, bit for bit.
"""

from __future__ import annotations

import numpy as np

from a3t_tpu_torch.masking import phones_masking, segment_positions


def make_synthetic_batch(
    rng: np.random.Generator,
    batch_size: int = 8,
    n_samples: int = 300 * 400,
    n_text: int = 60,
    hop_length: int = 300,
    vocab_size: int = 80,
    mlm_prob: float = 0.8,
    mean_phn_span: float = 8.0,
    fs: int = 24000,
) -> dict:
    b, t = batch_size, n_text
    n_frames = 1 + n_samples // hop_length

    # Harmonic audio with random f0 per utterance.
    ts = np.arange(n_samples) / fs
    f0 = rng.uniform(80, 300, (b, 1))
    audio = sum(
        (0.3 / (k + 1)) * np.sin(2 * np.pi * (k + 1) * f0 * ts[None, :])
        for k in range(4)
    )
    audio = (audio + 0.01 * rng.standard_normal((b, n_samples))).astype(np.float32)

    audio_lengths = np.full(b, n_samples, np.int32)
    audio_lengths[1:] = rng.integers(n_samples // 2, n_samples, b - 1)

    text = rng.integers(1, vocab_size, (b, t)).astype(np.int32)
    text_mask = np.ones((b, t), bool)

    masked = np.zeros((b, n_frames), bool)
    ssp = np.zeros((b, n_frames), np.int32)
    tsp = np.zeros((b, t), np.int32)
    for i in range(b):
        f_valid = audio_lengths[i] // hop_length + 1
        cuts = np.sort(rng.choice(np.arange(1, f_valid), t - 1, replace=False))
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [f_valid]])
        masked[i] = phones_masking(
            n_frames, starts, ends, t, mlm_prob, mean_phn_span, rng
        )
        ssp[i], tsp[i] = segment_positions(n_frames, t, starts, ends, t)

    return dict(
        audio=audio,
        audio_lengths=audio_lengths,
        text=text,
        text_mask=text_mask,
        masked_position=masked,
        speech_segment_pos=ssp,
        text_segment_pos=tsp,
    )
