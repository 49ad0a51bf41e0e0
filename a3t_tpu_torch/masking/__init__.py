from a3t_tpu_torch.masking.alignment import (
    duration_reduction,
    masked_positions_from_boundary,
    phones_masking,
    segment_positions,
)
from a3t_tpu_torch.masking.spans import random_spans_noise_mask

__all__ = ["duration_reduction", "masked_positions_from_boundary",
           "phones_masking", "random_spans_noise_mask", "segment_positions"]
