"""The shipped configurations as Python constants.

The JAX package reads its configs through ``yaml`` (a3t_tpu/tasks/config.py);
the port needs no YAML reader: ``configs/a3t_conformer_24k.yaml`` and
``configs/a3t_longformer_16k.yaml`` are written out here as dataclasses
(front-end, model with its dropout rates, optimizer).
"""

from __future__ import annotations

from a3t_tpu_torch.dsp.frontend import LogMelConfig
from a3t_tpu_torch.models.conformer import EncoderConfig
from a3t_tpu_torch.models.mlm import A3TModelConfig
from a3t_tpu_torch.models.pwg import PWGConfig
from a3t_tpu_torch.train.optim import OptimConfig

# configs/a3t_conformer_24k.yaml: front-end
FRONTEND_24K = LogMelConfig(fs=24000, n_fft=2048, hop_length=300,
                            win_length=1200, n_mels=80, fmin=80.0, fmax=7600.0)


def a3t_conformer_24k(vocab_size: int = 80,
                      compute_dtype: str = "float32") -> A3TModelConfig:
    """configs/a3t_conformer_24k.yaml: model.  The vocabulary is the
    token list's length (80 in the JAX package's RTF bench);
    ``compute_dtype="bfloat16"`` on encoder and decoder is the JAX bench's
    mixed precision (bench.py:90-94), in which both trained stashes were
    trained."""
    stack = dict(attention_dim=384, attention_heads=2, linear_units=1536,
                 num_blocks=4, dropout_rate=0.2, positional_dropout_rate=0.2,
                 attention_dropout_rate=0.2, macaron_style=True,
                 use_cnn_module=True,
                 positionwise_layer_type="conv1d",
                 positionwise_conv_kernel_size=3, activation_type="swish",
                 selfattention_layer_type="legacy_rel_selfattn",
                 compute_dtype=compute_dtype)
    return A3TModelConfig(
        odim=FRONTEND_24K.n_mels, vocab_size=vocab_size,
        encoder=EncoderConfig(cnn_module_kernel=7, **stack),
        decoder=EncoderConfig(cnn_module_kernel=31, **stack),
        postnet_layers=5, postnet_chans=256, postnet_filts=5)


# configs/a3t_conformer_24k.yaml: optim (Adam + Noam, yaml :55-59)
OPTIM_24K = OptimConfig(lr=1.0, model_size=384, warmup_steps=4000,
                        grad_clip=1.0)

# ParallelWaveGAN at the 24 kHz recipe size (upsample 4*5*3*5 = hop 300)
PWG_24K = PWGConfig()

# configs/a3t_longformer_16k.yaml: front-end (yaml :12-19)
FRONTEND_16K = LogMelConfig(fs=16000, n_fft=1024, hop_length=200,
                            win_length=800, n_mels=80, fmin=80.0, fmax=7600.0)


def a3t_longformer_16k(vocab_size: int = 80) -> A3TModelConfig:
    """configs/a3t_longformer_16k.yaml: model (yaml :21-52): 2 speech-only
    pre-encoder blocks and 4 encoder blocks of window-512 attention with
    global text, conv1d feed-forwards, no conv module, no decoder, bfloat16
    compute.  Its optimizer is ``OPTIM_24K`` (yaml :67-70)."""
    enc = EncoderConfig(
        attention_dim=384, attention_heads=2, linear_units=1536,
        num_blocks=4, dropout_rate=0.2, positional_dropout_rate=0.2,
        attention_dropout_rate=0.2, macaron_style=False,
        use_cnn_module=False, positionwise_layer_type="conv1d",
        positionwise_conv_kernel_size=3, activation_type="swish",
        selfattention_layer_type="longformer", attention_window=512,
        use_pallas_attention=True, pre_speech_layers=2,
        compute_dtype="bfloat16")
    return A3TModelConfig(odim=FRONTEND_16K.n_mels, vocab_size=vocab_size,
                          encoder=enc, decoder=None, use_segment_emb=True,
                          postnet_layers=5, postnet_chans=256,
                          postnet_filts=5)
