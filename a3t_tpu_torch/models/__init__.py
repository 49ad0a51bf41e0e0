from a3t_tpu_torch.models.conformer import EncoderConfig
from a3t_tpu_torch.models.mlm import A3TMLMModel, A3TModelConfig, build_model
from a3t_tpu_torch.models.pwg import (
    ParallelWaveGANGenerator,
    PWGConfig,
    PWGDiscriminator,
    build_vocoder,
    convert_pwg_state,
    load_pwg_checkpoint,
)

__all__ = ["EncoderConfig", "A3TMLMModel", "A3TModelConfig", "build_model",
           "ParallelWaveGANGenerator", "PWGConfig", "PWGDiscriminator",
           "build_vocoder",
           "convert_pwg_state", "load_pwg_checkpoint"]
