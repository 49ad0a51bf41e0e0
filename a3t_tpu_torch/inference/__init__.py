from a3t_tpu_torch.inference.sedit import (
    EditResult,
    SpeechEditor,
    UtteranceAlignment,
    diff_phone_spans,
    duration_adjust_factor,
    masked_mel_boundary,
    words2phns,
)

__all__ = ["EditResult", "SpeechEditor", "UtteranceAlignment",
           "diff_phone_spans", "duration_adjust_factor", "masked_mel_boundary",
           "words2phns"]
