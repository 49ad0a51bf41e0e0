from a3t_tpu_torch.inference.baselines import (
    dynamic_evaluation,
    resolve_mask_str,
)
from a3t_tpu_torch.inference.sedit import (
    EditResult,
    FileAlignmentSource,
    SpeechEditor,
    UtteranceAlignment,
    diff_phone_spans,
    duration_adjust_factor,
    masked_mel_boundary,
    merge_utterances,
    words2phns,
)

__all__ = ["EditResult", "FileAlignmentSource", "SpeechEditor",
           "UtteranceAlignment", "diff_phone_spans", "duration_adjust_factor",
           "dynamic_evaluation", "masked_mel_boundary", "merge_utterances",
           "resolve_mask_str", "words2phns"]
