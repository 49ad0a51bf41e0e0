"""Carry weights from the JAX package's flax trees into the port.

The inverse of ``a3t_tpu/compat/torch_import.py``,
``a3t_tpu/compat/fs2_import.py`` and ``a3t_tpu/models/pwg.py::
convert_pwg_state``: a flax Dense kernel (in, out) becomes a Linear weight
(out, in), a Conv kernel (k, in, out) a Conv1d weight (out, in, k), a 2-D
Conv kernel (kh, kw, in, out) a Conv2d weight (out, in, kh, kw),
LayerNorm/BatchNorm ``scale`` a ``weight`` and ``batch_stats`` the running
statistics.  Inputs are trees of array-likes (numpy, or anything
``np.asarray`` takes); outputs are ``{state_dict name: np.ndarray}`` with
ESPnet's names.  :func:`load_train_state` carries a whole JAX train state
(parameters, ``batch_stats``, the optax state and the step) into the port's
``TrainState``, so a run started in JAX goes on in the port.  Nothing here
imports JAX.

ESPnet has no name for the longformer model's speech-only pre-encoder
(``convert_model_state`` maps none), so it keeps the JAX tree's name:
``pre_speech_encoders.encoders.{i}...``; nor for the speaker-conditioned
A3T model's ``spemb_proj``, ``spemb_proj_mid`` and ``spemb_out``, nor for the
x-vector network (:func:`xvector_state`), which keep theirs.  Windowed
attention has the four projections of ESPnet's MHA and no positional ones.
"""

from __future__ import annotations

import numpy as np
import torch

from a3t_tpu_torch.parallel.sharding import (FlatLayout, shard_flat,
                                             shard_state)


def _np(x) -> np.ndarray:
    """float32 numpy; a bfloat16 tensor (an orbax leaf read by
    ``compat/orbax.py``) widens exactly."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x).astype(np.float32)


def dense(p, prefix: str) -> dict:
    out = {f"{prefix}.weight": _np(p["kernel"]).T.copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def conv(p, prefix: str) -> dict:
    out = {f"{prefix}.weight": _np(p["kernel"]).transpose(2, 1, 0).copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def layer_norm(p, prefix: str) -> dict:
    return {f"{prefix}.weight": _np(p["scale"]), f"{prefix}.bias": _np(p["bias"])}


def _sub(stats, key: str):
    """``stats[key]``; None (a params-only tree) stays None."""
    return None if stats is None else stats[key]


def _part(stats, key: str):
    """``stats.get(key, {})``; None (a params-only tree) stays None."""
    return None if stats is None else stats.get(key, {})


def batch_norm(p, stats, prefix: str) -> dict:
    """Scale and bias, and the running statistics unless ``stats`` is None
    (a params-only tree: the buffers keep their initial values)."""
    out = {f"{prefix}.weight": _np(p["scale"]),
           f"{prefix}.bias": _np(p["bias"])}
    if stats is not None:
        out.update({f"{prefix}.running_mean": _np(stats["mean"]),
                    f"{prefix}.running_var": _np(stats["var"]),
                    f"{prefix}.num_batches_tracked": np.zeros((), np.int64)})
    return out


def positionwise(p, prefix: str) -> dict:
    if "Conv_0" in p:
        return {**conv(p["Conv_0"], f"{prefix}.w_1"),
                **conv(p["Conv_1"], f"{prefix}.w_2")}
    return {**dense(p["Dense_0"], f"{prefix}.w_1"),
            **dense(p["Dense_1"], f"{prefix}.w_2")}


def attention(p, prefix: str) -> dict:
    """Rel-pos MHA, or windowed attention (no positional projection)."""
    out = {}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        out.update(dense(p[name], f"{prefix}.{name}"))
    if "linear_pos" in p:
        out.update(dense(p["linear_pos"], f"{prefix}.linear_pos"))
        out[f"{prefix}.pos_bias_u"] = _np(p["pos_bias_u"])
        out[f"{prefix}.pos_bias_v"] = _np(p["pos_bias_v"])
    return out


def conv_module(p, stats, prefix: str) -> dict:
    return {**conv(p["Conv_0"], f"{prefix}.pointwise_conv1"),
            **conv(p["Conv_1"], f"{prefix}.depthwise_conv"),
            **conv(p["Conv_2"], f"{prefix}.pointwise_conv2"),
            **batch_norm(p["BatchNorm_0"], _sub(stats, "BatchNorm_0"),
                         f"{prefix}.norm")}


def block(p, stats, prefix: str) -> dict:
    out = {**attention(p["self_attn"], f"{prefix}.self_attn"),
           **layer_norm(p["norm_mha"], f"{prefix}.norm_mha"),
           **positionwise(p["feed_forward"], f"{prefix}.feed_forward"),
           **layer_norm(p["norm_ff"], f"{prefix}.norm_ff")}
    if "feed_forward_macaron" in p:
        out.update(positionwise(p["feed_forward_macaron"],
                                f"{prefix}.feed_forward_macaron"))
        out.update(layer_norm(p["norm_ff_macaron"], f"{prefix}.norm_ff_macaron"))
    if "conv_module" in p:
        out.update(conv_module(p["conv_module"],
                               _sub(stats, "conv_module"),
                               f"{prefix}.conv_module"))
        out.update(layer_norm(p["norm_conv"], f"{prefix}.norm_conv"))
        out.update(layer_norm(p["norm_final"], f"{prefix}.norm_final"))
    return out


def stack(p, stats, prefix: str) -> dict:
    out = {}
    i = 0
    while f"block_{i}" in p:
        out.update(block(p[f"block_{i}"], _part(stats, f"block_{i}"),
                         f"{prefix}.encoders.{i}"))
        i += 1
    if "after_norm" in p:
        out.update(layer_norm(p["after_norm"], f"{prefix}.after_norm"))
    return out


def mlm_state(variables) -> dict:
    """A3TMLMModel variables ``{"params", "batch_stats"}`` -> port state.
    Without ``batch_stats`` (a params-only tree: an ``ave_*`` export or a
    ``bin/export_params`` stash) the BatchNorm running statistics are left
    out, so the model's buffers keep their initial values, as in JAX."""
    p, s = variables["params"], variables.get("batch_stats")
    out = {"encoder.speech_embed.0.mask_feature":
           _np(p["speech_masked_input"]["mask_feature"]),
           **dense(p["speech_proj"], "encoder.speech_embed.1"),
           **layer_norm(p["speech_norm"], "encoder.speech_embed.2"),
           "encoder.text_embed.0.weight": _np(p["text_embed"]["embedding"]),
           **stack(p["encoder"], _part(s, "encoder"), "encoder"),
           **dense(p["sfc"], "sfc")}
    if "segment_emb" in p:
        out["encoder.segment_emb.weight"] = _np(p["segment_emb"]["embedding"])
    for name in ("spemb_proj", "spemb_proj_mid", "spemb_out"):
        if name in p:
            out.update(dense(p[name], name))
    if "pre_speech_encoders" in p:
        out.update(stack(p["pre_speech_encoders"],
                         _part(s, "pre_speech_encoders"),
                         "pre_speech_encoders"))
    if "decoder" in p:
        out.update(stack(p["decoder"], _part(s, "decoder"), "decoder"))
    if "postnet" in p:
        out.update(postnet(p["postnet"], _sub(s, "postnet"), "postnet.postnet"))
    if "duration_predictor" in p:
        out.update(predictor(p["duration_predictor"], "duration_predictor"))
    return out


def postnet(p, stats, prefix: str) -> dict:
    out = {}
    i = 0
    while f"Conv_{i}" in p:
        out.update(conv(p[f"Conv_{i}"], f"{prefix}.{i}.0"))
        out.update(batch_norm(p[f"BatchNorm_{i}"],
                              _sub(stats, f"BatchNorm_{i}"), f"{prefix}.{i}.1"))
        i += 1
    return out


def predictor(p, prefix: str) -> dict:
    """Duration / variance predictor: Conv_i, LayerNorm_i, Dense_0."""
    out = dense(p["Dense_0"], f"{prefix}.linear")
    i = 0
    while f"Conv_{i}" in p:
        out.update(conv(p[f"Conv_{i}"], f"{prefix}.conv.{i}.0"))
        out.update(layer_norm(p[f"LayerNorm_{i}"], f"{prefix}.conv.{i}.2"))
        i += 1
    return out


def gru(p, prefix: str) -> dict:
    """flax GRUCell {ir, iz, in, hr, hz, hn} -> torch GRU (layer 0), the
    inverse of ``fs2_import.py::_gru_cell``: flax carries one bias per gate
    on the input side for r and z (torch's b_ir + b_hr folded), so those
    go to ``bias_ih_l0`` with zeros in ``bias_hh_l0``; the n gate keeps
    both (b_hn inside the reset product, as in torch)."""
    k = {g: _np(p[g]["kernel"]).T for g in ("ir", "iz", "in", "hr", "hz",
                                            "hn")}
    hn_b = _np(p["hn"]["bias"])
    zeros = np.zeros_like(hn_b)
    return {f"{prefix}.weight_ih_l0": np.concatenate(
                [k["ir"], k["iz"], k["in"]]),
            f"{prefix}.weight_hh_l0": np.concatenate(
                [k["hr"], k["hz"], k["hn"]]),
            f"{prefix}.bias_ih_l0": np.concatenate(
                [_np(p[g]["bias"]) for g in ("ir", "iz", "in")]),
            f"{prefix}.bias_hh_l0": np.concatenate([zeros, zeros, hn_b])}


def gst(p, stats, prefix: str) -> dict:
    """StyleEncoder: ref_enc (Conv_i + BatchNorm_i as ESPnet's Sequential
    of conv, norm and ReLU; GRUCell_0) and stl (gst_embs, four Dense)."""
    ref, ref_s = p["ref_enc"], stats["ref_enc"]
    out = gru(ref["GRUCell_0"], f"{prefix}.ref_enc.gru")
    i = 0
    while f"Conv_{i}" in ref:
        out[f"{prefix}.ref_enc.convs.{3 * i}.weight"] = _np(
            ref[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1).copy()
        out.update(batch_norm(ref[f"BatchNorm_{i}"], ref_s[f"BatchNorm_{i}"],
                              f"{prefix}.ref_enc.convs.{3 * i + 1}"))
        i += 1
    out[f"{prefix}.stl.gst_embs"] = _np(p["stl"]["gst_embs"])
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        out.update(dense(p["stl"][name], f"{prefix}.stl.mha.{name}"))
    return out


def fs2_state(variables) -> dict:
    """FastSpeech2 variables ``{"params", "batch_stats"}`` -> port state
    (ESPnet's names, the transformer blocks' norms as ``norm_mha`` /
    ``norm_ff``)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = {"encoder.embed.0.weight": _np(p["text_embed"]["embedding"]),
           **stack(p["encoder"], s.get("encoder", {}), "encoder"),
           **stack(p["decoder"], s.get("decoder", {}), "decoder"),
           **conv(p["pitch_embed"], "pitch_embed.0"),
           **conv(p["energy_embed"], "energy_embed.0"),
           **dense(p["feat_out"], "feat_out")}
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        out.update(predictor(p[name], name))
    if "alpha" in p.get("enc_posenc", {}):
        out["encoder.embed.1.alpha"] = _np(p["enc_posenc"]["alpha"])
    if "alpha" in p.get("dec_posenc", {}):
        out["decoder.embed.0.alpha"] = _np(p["dec_posenc"]["alpha"])
    if "projection" in p:
        out.update(dense(p["projection"], "projection"))
    if "gst" in p:
        out.update(gst(p["gst"], s["gst"], "gst"))
    if "postnet" in p:
        out.update(postnet(p["postnet"], s["postnet"], "postnet.postnet"))
    return out


def xvector_state(variables) -> dict:
    """XVectorNet variables ``{"params"}`` -> port state (the flax names:
    ``tdnn_i`` convolutions, ``bn_i`` LayerNorms, ``embed_a``, and the
    classification head ``bn_embed``, ``embed_b``, ``classifier`` when
    present)."""
    p = variables["params"]
    out = {}
    for name, v in p.items():
        if name.startswith("tdnn_"):
            out.update(conv(v, name))
        elif name.startswith("bn_"):
            out.update(layer_norm(v, name))
        else:
            out.update(dense(v, name))
    return out


def pwg_state(variables) -> dict:
    """ParallelWaveGANGenerator variables ``{"params"}`` -> port state.
    The scan layout of ``ParallelWaveGANGeneratorScan`` (the vocoder
    trainer's) holds the residual blocks as ``stacks/block_l`` with a
    leading stack axis; stack s's block l is the unrolled block
    ``s * layers_per_stack + l``."""
    p = variables["params"]
    up = p["upsample_net"]
    out = {**conv(p["first_conv"], "first_conv"),
           **conv(p["last_conv_1"], "last_conv_layers.1"),
           **conv(p["last_conv_2"], "last_conv_layers.3"),
           **conv(up["conv_in"], "upsample_net.conv_in")}
    i = 0
    while f"up_conv_{i}" in up:
        # flax (k, 1, 1) -> torch Conv2d (1, 1, 1, k)
        out[f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"] = \
            _np(up[f"up_conv_{i}"]["kernel"]).reshape(1, 1, 1, -1)
        i += 1
    blocks = []
    if "stacks" in p:
        per_stack = len(p["stacks"])
        n_stacks = _np(p["stacks"]["block_0"]["conv"]["kernel"]).shape[0]
        for s in range(n_stacks):
            blocks += [{name: {k: _np(v)[s] for k, v in leaf.items()}
                        for name, leaf in p["stacks"][f"block_{l}"].items()}
                       for l in range(per_stack)]
    while f"block_{len(blocks)}" in p:
        blocks.append(p[f"block_{len(blocks)}"])
    for i, blk in enumerate(blocks):
        for name in ("conv", "conv1x1_aux", "conv1x1_out"):
            out.update(conv(blk[name], f"conv_layers.{i}.{name}"))
    return out


def pwg_discriminator_state(variables) -> dict:
    """PWGDiscriminator variables ``{"params"}`` (``conv_i``,
    ``conv_out``) -> port state (``convs.i``, ``conv_out``)."""
    p = variables["params"]
    out = conv(p["conv_out"], "conv_out")
    i = 0
    while f"conv_{i}" in p:
        out.update(conv(p[f"conv_{i}"], f"convs.{i}"))
        i += 1
    return out


def load_state(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Load a ``{name: array}`` state strictly into ``module``, keeping each
    parameter's device and dtype.  A model-axis slice of a model
    (``module.shard``) takes its slices of the full ``state``
    (``parallel.sharding.shard_state``)."""
    layout = FlatLayout.of(module)
    if layout.tp > 1:
        state = shard_state({k: torch.as_tensor(np.asarray(v))
                             for k, v in state.items()}, layout.t, layout.tp)
    own = module.state_dict()
    module.load_state_dict({
        k: torch.tensor(np.asarray(v)).to(own[k].dtype) if k in own
        else torch.tensor(np.asarray(v)) for k, v in state.items()},
        strict=True)
    return module


def _inner_states(opt_state):
    """(Adam's state, the schedule's state, MultiSteps' state or None) of
    ``make_optimizer``'s ``apply_if_finite([MultiSteps(]chain(...)[)])``
    state, found by their fields."""
    inner = opt_state.inner_state
    multi = inner if hasattr(inner, "inner_opt_state") else None
    if multi is not None:
        inner = multi.inner_opt_state
    fields = [(s, getattr(s, "_fields", ())) for s in inner]
    adam = [s for s, f in fields if "mu" in f]
    sched = [s for s, f in fields if f == ("count",)]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError("not the optax state of a3t_tpu's make_optimizer")
    return adam[0], sched[0], multi


def load_train_state(state, jax_state):
    """Carry a JAX ``TrainState`` (step, params, batch_stats, opt_state of
    ``make_optimizer``) into the port's ``TrainState`` ``state``, in place:
    weights and running statistics into the model, Adam's ``mu``/``nu``
    (and MultiSteps' ``acc_grads``) mapped by the same names as the
    parameters, the chain's count, MultiSteps' counters and
    apply_if_finite's.  Returns ``state``."""
    model = state.model
    stats = jax_state.batch_stats
    load_state(model, mlm_state({"params": jax_state.params,
                                 "batch_stats": stats}))
    adam, sched, multi = _inner_states(jax_state.opt_state)
    if int(np.asarray(adam.count)) != int(np.asarray(sched.count)):
        raise ValueError("Adam's and the schedule's counts differ")
    names = [n for n, _ in model.named_parameters()]
    os_ = state.opt_state
    flats = [("mu", adam.mu), ("nu", adam.nu)]
    scalars = [("count", adam.count)]
    if multi is not None:
        flats.append(("acc_grads", multi.acc_grads))
        scalars += [("mini_step", multi.mini_step),
                    ("gradient_step", multi.gradient_step)]
    layout = FlatLayout.of(model)
    for field, tree in flats:
        mapped = mlm_state({"params": tree, "batch_stats": stats})
        mapped = shard_state({n: torch.as_tensor(np.asarray(mapped[n]))
                              for n in names}, layout.t, layout.tp)
        flat = torch.cat([mapped[n].reshape(-1).float() for n in names])
        setattr(os_, field, shard_flat(flat).to(os_.mu.device))
    jo = jax_state.opt_state
    scalars += [("notfinite_count", jo.notfinite_count),
                ("last_finite", jo.last_finite),
                ("total_notfinite", jo.total_notfinite)]
    for field, value in scalars:
        old = getattr(os_, field)
        setattr(os_, field, torch.tensor(np.asarray(value), dtype=old.dtype,
                                         device=old.device))
    state.step = int(np.asarray(jax_state.step))
    return state
