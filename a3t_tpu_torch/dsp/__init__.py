from a3t_tpu_torch.dsp.frontend import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.dsp.mel import hz_to_mel, mel_filterbank, mel_to_hz
from a3t_tpu_torch.dsp.stft import frame_signal, hann_window, padded_window, stft

__all__ = ["LogMelConfig", "LogMelFrontend", "hz_to_mel", "mel_filterbank",
           "mel_to_hz", "frame_signal", "hann_window", "padded_window", "stft"]
