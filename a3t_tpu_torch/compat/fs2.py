"""Published ESPnet FastSpeech2 checkpoints on the port
(``a3t_tpu/compat/fs2_import.py:207-327``): the duration predictors that
speech editing loads (sedit_inference.py:31-37, 391-396).

An ESPnet experiment holds a ``.pth`` state dict (``tts.``-prefixed inside
``ESPnetTTSModel``) and its ``config.yaml``, read here by
``tasks/yaml_subset.py``.  The port's ``FastSpeech2`` uses ESPnet's names,
so the state loads onto it directly (strictly: every parameter and
running statistic present, nothing left over); the transformer form's
``norm1``/``norm2`` are the port block's ``norm_mha``/``norm_ff``.
:func:`save_espnet_fs2` is the inverse, for tests and the smoke run.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.frontend import LogMelConfig
from a3t_tpu_torch.models.conformer import EncoderConfig
from a3t_tpu_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Config
from a3t_tpu_torch.tasks import yaml_subset

_ESPNET_NORMS = {"norm1": "norm_mha", "norm2": "norm_ff"}


def espnet_fs2_config(tts_conf: dict, idim: int,
                      odim: int) -> FastSpeech2Config:
    """ESPnet's ``tts_conf`` (e.g. train_gst+xvector_conformer_fastspeech2
    .yaml) -> FastSpeech2Config.  As in ESPnet, ``rel_selfattn`` with the
    default ``rel_pos_type: legacy`` is the legacy variant
    (fastspeech2.py:258-274)."""
    c = dict(tts_conf)
    adim = int(c.get("adim", 384))
    conformer = c.get("encoder_type", "transformer") == "conformer"

    def stack(side: str) -> EncoderConfig:
        n, units = ((c.get("elayers", 6), c.get("eunits", 1536))
                    if side == "enc"
                    else (c.get("dlayers", 6), c.get("dunits", 1536)))
        common = dict(
            attention_dim=adim, attention_heads=int(c.get("aheads", 4)),
            linear_units=int(units), num_blocks=int(n),
            dropout_rate=float(c.get(f"transformer_{side}_dropout_rate",
                                     0.1)),
            positional_dropout_rate=float(
                c.get(f"transformer_{side}_positional_dropout_rate", 0.1)),
            attention_dropout_rate=float(
                c.get(f"transformer_{side}_attn_dropout_rate", 0.1)),
            positionwise_layer_type=c.get("positionwise_layer_type",
                                          "conv1d"),
            positionwise_conv_kernel_size=int(
                c.get("positionwise_conv_kernel_size", 1)))
        if not conformer:
            return EncoderConfig(macaron_style=False, use_cnn_module=False,
                                 selfattention_layer_type="selfattn",
                                 **common)
        attn = c.get("conformer_self_attn_layer_type", "rel_selfattn")
        if (c.get("conformer_rel_pos_type", "legacy") == "legacy"
                and attn == "rel_selfattn"):
            attn = "legacy_rel_selfattn"
        if c.get("conformer_pos_enc_layer_type") == "legacy_rel_pos":
            attn = "legacy_rel_selfattn"
        return EncoderConfig(
            macaron_style=bool(c.get("use_macaron_style_in_conformer", True)),
            use_cnn_module=bool(c.get("use_cnn_in_conformer", True)),
            cnn_module_kernel=int(c.get(f"conformer_{side}_kernel_size", 7)),
            selfattention_layer_type=attn, **common)

    return FastSpeech2Config(
        idim=idim, odim=odim, adim=adim,
        encoder=stack("enc"), decoder=stack("dec"),
        encoder_conformer=conformer,
        use_scaled_pos_enc=bool(c.get("use_scaled_pos_enc", True)),
        postnet_layers=int(c.get("postnet_layers", 5)),
        postnet_chans=int(c.get("postnet_chans", 512)),
        postnet_filts=int(c.get("postnet_filts", 5)),
        duration_predictor_layers=int(c.get("duration_predictor_layers", 2)),
        duration_predictor_chans=int(c.get("duration_predictor_chans", 384)),
        duration_predictor_kernel=int(
            c.get("duration_predictor_kernel_size", 3)),
        pitch_predictor_layers=int(c.get("pitch_predictor_layers", 2)),
        pitch_predictor_chans=int(c.get("pitch_predictor_chans", 384)),
        pitch_predictor_kernel=int(c.get("pitch_predictor_kernel_size", 3)),
        pitch_embed_kernel=int(c.get("pitch_embed_kernel_size", 9)),
        energy_predictor_layers=int(c.get("energy_predictor_layers", 2)),
        energy_predictor_chans=int(c.get("energy_predictor_chans", 384)),
        energy_predictor_kernel=int(c.get("energy_predictor_kernel_size", 3)),
        energy_embed_kernel=int(c.get("energy_embed_kernel_size", 9)),
        use_gst=bool(c.get("use_gst", False)),
        gst_tokens=int(c.get("gst_tokens", 10)),
        gst_heads=int(c.get("gst_heads", 4)),
        gst_conv_chans_list=tuple(
            c.get("gst_conv_chans_list", (32, 32, 64, 64, 128, 128))),
        gst_gru_units=int(c.get("gst_gru_units", 128)),
        spk_embed_dim=c.get("spk_embed_dim"),
        spk_embed_integration_type=c.get("spk_embed_integration_type",
                                         "add"))


def _rename_norms(sd: dict, mapping: dict) -> dict:
    """Rename the transformer blocks' LayerNorms (``norm1`` <-> ``norm_mha``,
    ``norm2`` <-> ``norm_ff``) under ``{encoder,decoder}.encoders.{i}``."""
    pat = re.compile(r"^((?:en|de)coder\.encoders\.\d+\.)(\w+)(\..*)$")

    def rename(k):
        m = pat.match(k)
        if m and m.group(2) in mapping:
            return m.group(1) + mapping[m.group(2)] + m.group(3)
        return k

    return {rename(k): v for k, v in sd.items()}


def load_espnet_fs2(model_file: str, config_file: Optional[str] = None,
                    device=None):
    """An ESPnet FastSpeech2 checkpoint (its ``config.yaml`` alongside, or
    ``config_file``) -> ``(model, token_list)``, the model in eval mode on
    ``device`` (cuda unless the caller asks for the CPU).  Only BatchNorm's
    ``num_batches_tracked``, which eval mode never reads, may be missing."""
    dev = resolve_device(device)
    if config_file is None:
        config_file = os.path.join(os.path.dirname(model_file), "config.yaml")
    cfg = yaml_subset.load_file(config_file)
    token_list = cfg["token_list"]
    if isinstance(token_list, str):  # a path instead of an inline list
        with open(token_list, encoding="utf-8") as f:
            token_list = [ln.rstrip("\n") for ln in f if ln.strip()]
    sd = torch.load(model_file, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    if any(k.startswith("tts.") for k in sd):
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("tts.")}
    model = FastSpeech2(espnet_fs2_config(
        cfg.get("tts_conf", {}) or {}, idim=len(token_list),
        odim=int(sd["feat_out.weight"].shape[0])))
    missing, unexpected = model.load_state_dict(
        _rename_norms(sd, _ESPNET_NORMS), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{model_file} does not fit the FastSpeech2 of "
                         f"{config_file}: missing {missing[:8]}, unexpected "
                         f"{unexpected[:8]}")
    return model.to(dev).eval(), list(token_list)


def espnet_tts_conf(c: FastSpeech2Config) -> dict:
    """The inverse of :func:`espnet_fs2_config` (ESPnet's ``tts_conf``);
    the variance dropout and ``max_feat_len`` have no key there."""
    enc, dec = c.encoder, c.decoder
    conf = {
        "adim": c.adim, "aheads": enc.attention_heads,
        "elayers": enc.num_blocks, "eunits": enc.linear_units,
        "dlayers": dec.num_blocks, "dunits": dec.linear_units,
        "positionwise_layer_type": enc.positionwise_layer_type,
        "positionwise_conv_kernel_size": enc.positionwise_conv_kernel_size,
        "encoder_type": "conformer" if c.encoder_conformer else "transformer",
        "decoder_type": "conformer" if c.encoder_conformer else "transformer",
        "use_scaled_pos_enc": c.use_scaled_pos_enc,
        "postnet_layers": c.postnet_layers, "postnet_chans": c.postnet_chans,
        "postnet_filts": c.postnet_filts,
        "duration_predictor_layers": c.duration_predictor_layers,
        "duration_predictor_chans": c.duration_predictor_chans,
        "duration_predictor_kernel_size": c.duration_predictor_kernel,
        "use_gst": c.use_gst, "gst_tokens": c.gst_tokens,
        "gst_heads": c.gst_heads,
        "gst_conv_chans_list": list(c.gst_conv_chans_list),
        "gst_gru_units": c.gst_gru_units,
        "spk_embed_dim": c.spk_embed_dim,
        "spk_embed_integration_type": c.spk_embed_integration_type,
    }
    for side, e in (("enc", enc), ("dec", dec)):
        conf[f"transformer_{side}_dropout_rate"] = e.dropout_rate
        conf[f"transformer_{side}_positional_dropout_rate"] = \
            e.positional_dropout_rate
        conf[f"transformer_{side}_attn_dropout_rate"] = \
            e.attention_dropout_rate
        conf[f"conformer_{side}_kernel_size"] = e.cnn_module_kernel
    for kind in ("pitch", "energy"):
        def get(name, default):
            v = getattr(c, f"{kind}_{name}")
            return getattr(c, f"variance_{default}") if v is None else v

        conf[f"{kind}_predictor_layers"] = get("predictor_layers",
                                               "predictor_layers")
        conf[f"{kind}_predictor_chans"] = get("predictor_chans",
                                              "predictor_chans")
        conf[f"{kind}_predictor_kernel_size"] = get("predictor_kernel",
                                                    "predictor_kernel")
        conf[f"{kind}_embed_kernel_size"] = get("embed_kernel",
                                                "embed_kernel")
    if c.encoder_conformer:
        legacy = enc.selfattention_layer_type == "legacy_rel_selfattn"
        conf.update(
            use_macaron_style_in_conformer=enc.macaron_style,
            use_cnn_in_conformer=enc.use_cnn_module,
            conformer_self_attn_layer_type="rel_selfattn",
            conformer_pos_enc_layer_type="rel_pos",
            conformer_rel_pos_type="legacy" if legacy else "latest")
    return conf


def save_espnet_fs2(model: FastSpeech2, token_list,
                    frontend_config: LogMelConfig, out_dir: str) -> str:
    """Write ``model`` as an ESPnet FastSpeech2 experiment that
    :func:`load_espnet_fs2` (and the JAX package's loader) reads back:
    ``model.pth`` (the ``tts.``-prefixed state dict, on the CPU) and
    ``config.yaml`` with the token list, ``feats_extract_conf`` and
    ``tts_conf``.  ESPnet's vocabulary is ``idim`` tokens, the last the
    eos; an FS2 experiment's eos is the id past its token list
    (``tasks/fs2.py``), written as ``<eos>``.  Returns the ``.pth``
    path."""
    fe = frontend_config
    token_list = list(token_list)
    if len(token_list) == model.config.idim - 1:
        token_list.append("<eos>")
    if len(token_list) != model.config.idim:
        raise ValueError(f"{len(token_list)} tokens for a FastSpeech2 of "
                         f"idim {model.config.idim}")
    cfg = {
        "token_list": token_list,
        "feats_extract": "fbank",
        "feats_extract_conf": {k: getattr(fe, k) for k in (
            "fs", "n_fft", "hop_length", "win_length", "n_mels", "fmin",
            "fmax")},
        "tts": "fastspeech2",
        "tts_conf": espnet_tts_conf(model.config),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.yaml"), "w",
              encoding="utf-8") as f:
        f.write(yaml_subset.dump(cfg))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if not model.config.encoder_conformer:
        sd = _rename_norms(sd, {v: k for k, v in _ESPNET_NORMS.items()})
    path = os.path.join(out_dir, "model.pth")
    torch.save({f"tts.{k}": v for k, v in sd.items()}, path)
    return path
