from a3t_tpu_torch.inference.baselines import (
    FS2Baselines,
    dynamic_evaluation,
    resolve_mask_str,
)
from a3t_tpu_torch.inference.durations import (
    load_duration_fn,
    make_fs2_duration_fn,
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

__all__ = ["EditResult", "FS2Baselines", "FileAlignmentSource",
           "SpeechEditor", "load_duration_fn", "make_fs2_duration_fn",
           "UtteranceAlignment", "diff_phone_spans", "duration_adjust_factor",
           "dynamic_evaluation", "masked_mel_boundary", "merge_utterances",
           "resolve_mask_str", "words2phns"]
