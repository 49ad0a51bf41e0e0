from a3t_tpu_torch.eval.mcd import (
    dtw_path,
    evaluate_masked_reconstruction,
    mcd_between_waveforms,
    mcep_from_wav,
)

__all__ = ["mcep_from_wav", "dtw_path", "mcd_between_waveforms",
           "evaluate_masked_reconstruction"]
