from a3t_tpu_torch.dsp.frontend import (
    LinearSpectrogramFrontend,
    LogMelConfig,
    LogMelFrontend,
    LogSpectrogramFrontend,
)
from a3t_tpu_torch.dsp.griffin_lim import (griffin_lim, logmel_to_wav,
                                           mel_to_linear)
from a3t_tpu_torch.dsp.mel import hz_to_mel, mel_filterbank, mel_to_hz
from a3t_tpu_torch.dsp.normalize import (
    GlobalMVN,
    UtteranceMVN,
    aggregate_stats,
    collect_stats,
)
from a3t_tpu_torch.dsp.stft import (dft_matrices, frame_signal, hann_window,
                                    istft, padded_window, stft)

__all__ = ["LinearSpectrogramFrontend", "LogMelConfig", "LogMelFrontend",
           "LogSpectrogramFrontend", "hz_to_mel", "mel_filterbank",
           "mel_to_hz", "GlobalMVN", "UtteranceMVN", "aggregate_stats",
           "collect_stats", "dft_matrices", "frame_signal", "griffin_lim",
           "hann_window", "istft", "logmel_to_wav", "mel_to_linear",
           "padded_window", "stft"]
