"""Published ESPnet A3T checkpoints on the port
(``a3t_tpu/compat/torch_import.py:228-333``).

An ESPnet experiment holds ``train.loss.ave_5best.pth`` (the
``ESPnetMLMEncAsDecoderModel`` state dict) and its ``config.yaml``.  The
port's ``A3TMLMModel`` uses ESPnet's state-dict names, so the ``.pth`` loads
onto it directly: :func:`espnet_read_keys` names the entries that the JAX
package's ``convert_model_state`` (``torch_import.py:168``) reads, and every
other entry (the front-end's filterbank, the normaliser's statistics,
BatchNorm's ``num_batches_tracked``, ...) is dropped, as that function
ignores them.  The config is read with ``tasks/yaml_subset.py``, which
raises on any construct outside its subset.  As in the JAX loader, the
config's ``normalize`` entry is not applied.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.frontend import LogMelConfig
from a3t_tpu_torch.models.conformer import EncoderConfig
from a3t_tpu_torch.models.mlm import A3TMLMModel, A3TModelConfig
from a3t_tpu_torch.tasks import yaml_subset
from a3t_tpu_torch.text import TokenIDConverter


def espnet_frontend_config(cfg: dict, n_mels_default: int = 80) -> LogMelConfig:
    """An ESPnet exp config's ``feats_extract_conf`` -> LogMelConfig."""
    fx = cfg.get("feats_extract_conf", {}) or {}
    return LogMelConfig(
        fs=int(fx.get("fs", 24000)), n_fft=int(fx.get("n_fft", 2048)),
        hop_length=int(fx.get("hop_length", 300)),
        win_length=int(fx.get("win_length") or fx.get("n_fft", 2048)),
        n_mels=int(fx.get("n_mels", n_mels_default)),
        fmin=float(fx.get("fmin") or 80.0),
        fmax=float(fx.get("fmax") or 7600.0),
    )


def _espnet_stack_config(conf: dict) -> EncoderConfig:
    """ESPnet ``encoder_conf``/``decoder_conf`` -> EncoderConfig; the fork's
    MLM task takes ``rel_selfattn`` with the legacy positional encoding as
    the legacy variant."""
    attn = conf.get("selfattention_layer_type", "rel_selfattn")
    if attn == "rel_selfattn" and conf.get(
            "rel_pos_type", "legacy") == "legacy":
        attn = "legacy_rel_selfattn"
    return EncoderConfig(
        attention_dim=int(conf.get("attention_dim", 384)),
        attention_heads=int(conf.get("attention_heads", 2)),
        linear_units=int(conf.get("linear_units", 1536)),
        num_blocks=int(conf.get("num_blocks", 4)),
        dropout_rate=float(conf.get("dropout_rate", 0.2)),
        positional_dropout_rate=float(
            conf.get("positional_dropout_rate", 0.2)),
        attention_dropout_rate=float(
            conf.get("attention_dropout_rate", 0.2)),
        normalize_before=bool(conf.get("normalize_before", True)),
        macaron_style=bool(conf.get("macaron_style", True)),
        use_cnn_module=bool(conf.get("use_cnn_module", True)),
        cnn_module_kernel=int(conf.get("cnn_module_kernel", 7)),
        positionwise_layer_type=conf.get("positionwise_layer_type", "conv1d"),
        positionwise_conv_kernel_size=int(
            conf.get("positionwise_conv_kernel_size", 3)),
        selfattention_layer_type=attn,
        attention_window=int(conf.get("attention_window", 0)),
        attention_dilation=int(conf.get("attention_dilation", 1)),
        pre_speech_layers=int(conf.get("pre_speech_layer", 0)),
    )


def espnet_model_config(cfg: dict, n_mels: int, vocab_size: int
                        ) -> A3TModelConfig:
    """The model configuration of an ESPnet A3T exp config."""
    enc_conf = dict(cfg.get("encoder_conf", {}) or {})
    dec_conf = cfg.get("decoder_conf")
    model_conf = dict(cfg.get("model_conf", {}) or {})
    return A3TModelConfig(
        odim=n_mels,
        vocab_size=vocab_size,
        encoder=_espnet_stack_config(enc_conf),
        decoder=_espnet_stack_config(dict(dec_conf)) if dec_conf else None,
        use_segment_emb=enc_conf.get("input_layer", "sega_mlm") == "sega_mlm",
        postnet_layers=int(model_conf.get("postnet_layers", 5)),
        postnet_chans=int(model_conf.get("postnet_chans", 256)),
        postnet_filts=int(model_conf.get("postnet_filts", 5)),
        use_mse_loss=float(model_conf.get("lsm_weight", 0.1)) > 50,
        mlm_prob=float(model_conf.get("mlm_prob", 0.8)),
        mean_phn_span=int(model_conf.get("mean_phn_span", 8)),
    )


def _count_blocks(sd, prefix: str) -> int:
    n = 0
    while f"{prefix}.encoders.{n}.norm_ff.weight" in sd:
        n += 1
    return n


def espnet_read_keys(sd) -> set[str]:
    """The entries of an ESPnet A3T state dict that ``convert_model_state``
    reads, found by the same walk over the same names (``encoder.embed.*``
    already renamed to ``encoder.speech_embed.*``)."""
    keys: set[str] = set()

    def take(*names):
        keys.update(names)

    def dense(prefix, bias=True):
        take(f"{prefix}.weight")
        if bias and f"{prefix}.bias" in sd:
            take(f"{prefix}.bias")

    def norm(prefix):
        take(f"{prefix}.weight", f"{prefix}.bias")

    def positionwise(prefix):
        if len(sd[f"{prefix}.w_1.weight"].shape) == 3:
            for w in ("w_1", "w_2"):
                take(f"{prefix}.{w}.weight", f"{prefix}.{w}.bias")
        else:
            dense(f"{prefix}.w_1")
            dense(f"{prefix}.w_2")

    def block(p):
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            dense(f"{p}.self_attn.{name}")
        if f"{p}.self_attn.linear_pos.weight" in sd:
            dense(f"{p}.self_attn.linear_pos", bias=False)
            take(f"{p}.self_attn.pos_bias_u", f"{p}.self_attn.pos_bias_v")
        norm(f"{p}.norm_mha")
        positionwise(f"{p}.feed_forward")
        norm(f"{p}.norm_ff")
        if f"{p}.feed_forward_macaron.w_1.weight" in sd:
            positionwise(f"{p}.feed_forward_macaron")
            norm(f"{p}.norm_ff_macaron")
        if f"{p}.conv_module.pointwise_conv1.weight" in sd:
            for name in ("pointwise_conv1", "depthwise_conv",
                         "pointwise_conv2"):
                take(f"{p}.conv_module.{name}.weight",
                     f"{p}.conv_module.{name}.bias")
            norm(f"{p}.conv_module.norm")
            take(f"{p}.conv_module.norm.running_mean",
                 f"{p}.conv_module.norm.running_var")
            norm(f"{p}.norm_conv")
            norm(f"{p}.norm_final")

    def stack(prefix, n):
        for i in range(n):
            block(f"{prefix}.encoders.{i}")
        if f"{prefix}.after_norm.weight" in sd:
            norm(f"{prefix}.after_norm")

    take("encoder.speech_embed.0.mask_feature", "encoder.text_embed.0.weight")
    dense("encoder.speech_embed.1")
    norm("encoder.speech_embed.2")
    if "encoder.segment_emb.weight" in sd:
        take("encoder.segment_emb.weight")
    stack("encoder", _count_blocks(sd, "encoder"))
    stack("decoder", _count_blocks(sd, "decoder"))
    if "sfc.weight" in sd:
        dense("sfc")
    i = 0
    while f"postnet.postnet.{i}.0.weight" in sd:
        take(f"postnet.postnet.{i}.0.weight",
             f"postnet.postnet.{i}.1.running_mean",
             f"postnet.postnet.{i}.1.running_var")
        norm(f"postnet.postnet.{i}.1")
        i += 1
    if "duration_predictor.linear.weight" in sd:
        i = 0
        while f"duration_predictor.conv.{i}.0.weight" in sd:
            take(f"duration_predictor.conv.{i}.0.weight",
                 f"duration_predictor.conv.{i}.0.bias")
            norm(f"duration_predictor.conv.{i}.2")
            i += 1
        dense("duration_predictor.linear")
    return keys


def espnet_state(sd: dict) -> dict:
    """An ESPnet A3T state dict with the old ``encoder.embed`` names
    renamed (as ESPnet's MLM task does) and the entries that
    :func:`espnet_read_keys` does not name dropped."""
    sd = {k.replace("encoder.embed.", "encoder.speech_embed.", 1)
          if k.startswith("encoder.embed.") else k: v for k, v in sd.items()}
    read = espnet_read_keys(sd)
    return {k: v for k, v in sd.items() if k in read}


def load_espnet_a3t(model_file: str, config_file: Optional[str] = None,
                    device=None):
    """A published ESPnet A3T checkpoint (``train.loss.ave_5best.pth`` with
    its exp ``config.yaml`` alongside, or ``config_file``) ->
    ``(model, frontend_config, tokens)``, the model in eval mode on
    ``device`` (cuda unless the caller asks for the CPU).

    The state loads onto the model with every parameter and running
    statistic present; only BatchNorm's ``num_batches_tracked``, which
    ESPnet's ``convert_model_state`` ignores and eval mode never reads, may
    be missing.  ``token_list`` is the config's list or a path to a file of
    tokens."""
    dev = resolve_device(device)
    if config_file is None:
        config_file = os.path.join(os.path.dirname(model_file), "config.yaml")
    cfg = yaml_subset.load_file(config_file)
    token_list = cfg["token_list"]
    if isinstance(token_list, str):
        with open(token_list, encoding="utf-8") as f:
            token_list = [ln.rstrip("\n") for ln in f if ln.strip()]
    fe_cfg = espnet_frontend_config(cfg)
    model_cfg = espnet_model_config(cfg, fe_cfg.n_mels, len(token_list))
    sd = torch.load(model_file, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    if "duration_predictor.linear.weight" in sd:
        raise NotImplementedError("the duration-aware variant "
                                  "(ESPnetMLMTTSModel) is not ported "
                                  "(ROADMAP A9)")
    model = A3TMLMModel(model_cfg)
    missing, unexpected = model.load_state_dict(espnet_state(sd), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{model_file} does not fit the A3T model of "
                         f"{config_file}: missing {missing[:8]}, unexpected "
                         f"{unexpected[:8]}")
    unk = "<unk>" if "<unk>" in token_list else token_list[0]
    return (model.to(dev).eval(), fe_cfg,
            TokenIDConverter(token_list, unk_symbol=unk))


def _espnet_stack_conf(e: EncoderConfig) -> dict:
    """The inverse of :func:`_espnet_stack_config`."""
    conf = {k: getattr(e, k) for k in (
        "attention_dim", "attention_heads", "linear_units", "num_blocks",
        "dropout_rate", "positional_dropout_rate", "attention_dropout_rate",
        "normalize_before", "macaron_style", "use_cnn_module",
        "cnn_module_kernel", "positionwise_layer_type",
        "positionwise_conv_kernel_size", "attention_window",
        "attention_dilation")}
    attn = e.selfattention_layer_type
    if attn == "legacy_rel_selfattn":
        attn, conf["rel_pos_type"] = "rel_selfattn", "legacy"
    conf["selfattention_layer_type"] = attn
    conf["pre_speech_layer"] = e.pre_speech_layers
    return conf


def save_espnet_a3t(model: A3TMLMModel, frontend_config: LogMelConfig,
                    token_list, out_dir: str) -> str:
    """Write ``model`` as an ESPnet A3T experiment that
    :func:`load_espnet_a3t` (and the JAX package's loader) reads back:
    ``model.pth`` (the state dict, on the CPU) and ``config.yaml`` with
    the token list, ``feats_extract_conf``, ``encoder_conf``,
    ``decoder_conf`` and ``model_conf``.  Returns the ``.pth`` path."""
    c = model.config
    fe = frontend_config
    enc = _espnet_stack_conf(c.encoder)
    enc["input_layer"] = "sega_mlm" if c.use_segment_emb else "mlm"
    cfg = {
        "token_list": list(token_list),
        "feats_extract": "fbank",
        "feats_extract_conf": {k: getattr(fe, k) for k in (
            "fs", "n_fft", "hop_length", "win_length", "n_mels", "fmin",
            "fmax")},
        "normalize": None,
        "encoder": "mlm",
        "encoder_conf": enc,
        "model_conf": {
            "postnet_layers": c.postnet_layers,
            "postnet_chans": c.postnet_chans,
            "postnet_filts": c.postnet_filts,
            "lsm_weight": 100.0 if c.use_mse_loss else 0.1,
            "mlm_prob": c.mlm_prob, "mean_phn_span": c.mean_phn_span},
    }
    if c.decoder is not None:
        cfg["decoder"] = "mlm"
        cfg["decoder_conf"] = _espnet_stack_conf(c.decoder)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.yaml"), "w",
              encoding="utf-8") as f:
        f.write(yaml_subset.dump(cfg))
    path = os.path.join(out_dir, "model.pth")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    return path
