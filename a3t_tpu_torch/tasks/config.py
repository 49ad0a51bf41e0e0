"""YAML-driven task configuration: the port of ``a3t_tpu/tasks/config.py``.

The whole configuration is a tree of dataclasses with the JAX package's
field names: ``load_config(path, overrides)`` <-> ``save_config(cfg,
path)``, and ``--set a.b.c=value`` overrides.  YAML is read and written by
:mod:`a3t_tpu_torch.tasks.yaml_subset`, not PyYAML, and resolves scalars as
``yaml.safe_load`` does, overrides included.  Unknown keys raise
``KeyError``, and a boolean field given anything but ``true`` or ``false``
raises ``ValueError``.

The shipped configurations also stand here as constants (front-end, model
with its dropout rates, optimizer), equal to what ``load_config`` gives for
``configs/a3t_conformer_24k.yaml`` and ``configs/a3t_longformer_16k.yaml``.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Any, Optional

from a3t_tpu_torch.data.batcher import BatcherConfig
from a3t_tpu_torch.dsp.frontend import LogMelConfig
from a3t_tpu_torch.models.conformer import EncoderConfig
from a3t_tpu_torch.models.mlm import A3TModelConfig
from a3t_tpu_torch.models.pwg import PWGConfig
from a3t_tpu_torch.tasks import yaml_subset
from a3t_tpu_torch.train.optim import OptimConfig
from a3t_tpu_torch.train.trainer import TrainerConfig

@dataclasses.dataclass
class MeshConfig:
    """The JAX package's device-mesh settings (``a3t_tpu/parallel/mesh.py``).
    The port's mesh is one process per card (``parallel/``), ``dp * sp *
    tp`` of them, rank ``(d * sp + s) * tp + t``: ``data_parallel`` None
    means the number of processes over ``sequence_parallel x
    tensor_parallel``, and any other value must cover them with them.
    ``tensor_parallel`` splits a Conformer model's heads and feed-forward
    units, ``sequence_parallel`` the frames of each row (every frame bucket
    a multiple of it, and for the longformer of sp x half-window x
    dilation)."""

    data_parallel: Optional[int] = None
    tensor_parallel: int = 1
    sequence_parallel: int = 1


@dataclasses.dataclass
class A3TTaskConfig:
    # data
    train_data_dir: str = ""
    valid_data_dir: str = ""
    token_list: str = ""  # path; built from the training text if empty
    exp_dir: str = "exp/a3t"
    speech_only: bool = False
    num_workers_prefetch: int = 2
    use_tensorboard: bool = False
    use_wandb: bool = False
    wandb_project: str = "a3t_tpu"
    num_plot_examples: int = 0
    # multi-corpus pretraining entries {name, data_dir, portion, ...}
    corpora: tuple = ()
    # "none" | "global_mvn" | "utterance_mvn"; global_mvn reads stats_file
    normalize: str = "none"
    stats_file: str = ""
    spemb_file: str = ""
    # components
    frontend: LogMelConfig = dataclasses.field(default_factory=LogMelConfig)
    model: A3TModelConfig = dataclasses.field(default_factory=A3TModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    batcher: BatcherConfig = dataclasses.field(default_factory=BatcherConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    use_fused_frontend: bool = True


def _nested_type(cls, name: str) -> Optional[type]:
    """The dataclass type of field ``name`` of ``cls`` (Optional unwrapped),
    or None."""
    t = typing.get_type_hints(cls).get(name)
    if typing.get_origin(t) is typing.Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        t = args[0] if len(args) == 1 else None
    return t if dataclasses.is_dataclass(t) else None


def _build(cls, data: Any, where: str):
    """Build the dataclass ``cls`` from a plain dict, recursively; lists
    become tuples."""
    if data is None:
        return cls()
    if not isinstance(data, dict):
        raise TypeError(f"{where}: expected a mapping, got {data!r}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        if isinstance(fields[k].default, bool) and not isinstance(v, bool):
            raise ValueError(f"{where}.{k}: expected true or false, got {v!r}")
        target = _nested_type(cls, k)
        if target is not None and isinstance(v, dict):
            v = _build(target, v, f"{where}.{k}")
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def config_from_dict(data: dict) -> A3TTaskConfig:
    return _build(A3TTaskConfig, data, "config")


def load_config(path: str, overrides: Optional[list[str]] = None
                ) -> A3TTaskConfig:
    data = yaml_subset.load_file(path) or {}
    return config_from_dict(apply_overrides(data, overrides or []))


def _to_dict(obj) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_to_dict(x) for x in obj]
    return obj


def dump_config(cfg: A3TTaskConfig) -> str:
    return yaml_subset.dump(_to_dict(cfg))


def save_config(cfg: A3TTaskConfig, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(dump_config(cfg))


def apply_overrides(data: dict, overrides: list[str]) -> dict:
    """Apply ``a.b.c=value`` overrides; each value is read as YAML."""
    for ov in overrides:
        key, sep, raw = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} is not KEY=VALUE")
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if node is None or not isinstance(node, dict):
                raise ValueError(f"override {ov!r}: {p} is not a mapping")
        node[parts[-1]] = yaml_subset.load(raw)
    return data


# -- the shipped configurations as constants ----------------------------------

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
