from a3t_tpu_torch.masking.alignment import (
    masked_positions_from_boundary,
    segment_positions,
)

__all__ = ["masked_positions_from_boundary", "segment_positions"]
