"""ParallelWaveGAN generator, the vocoder (``a3t_tpu/models/pwg.py:33-175``).

* noise (B, T_wav) -> 1x1 conv -> 30 dilated residual blocks (gated
  tanh/sigmoid, mel conditioning through a 1x1 conv, fused res+skip 1x1),
* mel (B, T_feats, C) -> context conv -> nearest stretch + smoothing conv per
  upsample scale -> (B, C, T_wav),
* skip sum * sqrt(1/layers) -> relu -> 1x1 -> relu -> 1x1 -> waveform.

Parameter names are the ``parallel_wavegan`` package's, which
``a3t_tpu/models/pwg.py::convert_pwg_state`` maps onto the flax tree.
:func:`load_pwg_checkpoint` reads that package's checkpoints (a pickle or
``.pth`` holding ``model``/``generator``), folding weight norm into plain
weights (:func:`convert_pwg_state`, ``a3t_tpu/models/pwg.py:278-341``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from a3t_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PWGConfig:
    in_channels: int = 1
    out_channels: int = 1
    kernel_size: int = 3
    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    aux_channels: int = 80
    aux_context_window: int = 2
    # hop 300 (24 kHz recipes) = 4*5*3*5
    upsample_scales: tuple = (4, 5, 3, 5)

    @property
    def upsample_factor(self) -> int:
        return int(np.prod(self.upsample_scales))


class Stretch(nn.Module):
    """Nearest-neighbour stretch along time."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return x.repeat_interleave(self.scale, dim=-1)


class PWGUpsampleNetwork(nn.Module):
    """Replication pad + context conv, then (stretch -> smoothing conv) per
    scale (ConvInUpsampleNetwork).  (B, C, T) -> (B, C, T * factor)."""

    def __init__(self, cfg: PWGConfig):
        super().__init__()
        w = cfg.aux_context_window
        self.window = w
        self.conv_in = nn.Conv1d(cfg.aux_channels, cfg.aux_channels, 2 * w + 1,
                                 bias=False)
        layers: list[nn.Module] = []
        for s in cfg.upsample_scales:
            layers += [Stretch(s), nn.Conv2d(1, 1, (1, 2 * s + 1),
                                             padding=(0, s), bias=False)]
        self.upsample = nn.Module()
        self.upsample.up_layers = nn.ModuleList(layers)

    def forward(self, c):
        c = self.conv_in(F.pad(c, (self.window, self.window), mode="replicate"))
        for stretch, conv in zip(self.upsample.up_layers[0::2],
                                 self.upsample.up_layers[1::2]):
            c = conv(stretch(c)[:, None])[:, 0]
        return c


class PWGResidualBlock(nn.Module):
    """WaveNet residual block with fused res+skip projection."""

    def __init__(self, cfg: PWGConfig, dilation: int):
        super().__init__()
        self.res = cfg.residual_channels
        self.conv = nn.Conv1d(cfg.residual_channels, cfg.gate_channels,
                              cfg.kernel_size, dilation=dilation,
                              padding=dilation * (cfg.kernel_size - 1) // 2)
        self.conv1x1_aux = nn.Conv1d(cfg.aux_channels, cfg.gate_channels, 1,
                                     bias=False)
        self.conv1x1_out = nn.Conv1d(cfg.gate_channels // 2,
                                     cfg.residual_channels + cfg.skip_channels, 1)

    def forward(self, x, c):
        xa, xb = self.conv(x).chunk(2, dim=1)
        ca, cb = self.conv1x1_aux(c).chunk(2, dim=1)
        h = self.conv1x1_out(torch.tanh(xa + ca) * torch.sigmoid(xb + cb))
        return (h[:, : self.res] + x) * math.sqrt(0.5), h[:, self.res:]


class ParallelWaveGANGenerator(nn.Module):
    """mel (B, T_feats, aux) [+ noise (B, T_wav)] -> wav (B, T_wav)."""

    def __init__(self, config: PWGConfig = PWGConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.first_conv = nn.Conv1d(cfg.in_channels, cfg.residual_channels, 1)
        self.upsample_net = PWGUpsampleNetwork(cfg)
        per_stack = cfg.layers // cfg.stacks
        self.conv_layers = nn.ModuleList(
            PWGResidualBlock(cfg, 2 ** (i % per_stack)) for i in range(cfg.layers))
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(cfg.skip_channels, cfg.skip_channels, 1),
            nn.ReLU(), nn.Conv1d(cfg.skip_channels, cfg.out_channels, 1)])

    def forward(self, c, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``z`` (B, T_wav) or (B, T_wav, 1) noise; drawn from ``generator``
        (a generator on ``c``'s device) when absent."""
        cfg = self.config
        b, t_feats, _ = c.shape
        t_wav = t_feats * cfg.upsample_factor
        if z is None:
            z = torch.randn(b, cfg.in_channels, t_wav, generator=generator,
                            device=c.device, dtype=c.dtype)
        else:
            z = z.reshape(b, t_wav, cfg.in_channels).transpose(1, 2)
        c_up = self.upsample_net(c.transpose(1, 2))
        x = self.first_conv(z)
        skips = 0.0
        for block in self.conv_layers:
            x, s = block(x, c_up)
            skips = skips + s
        x = skips * math.sqrt(1.0 / cfg.layers)
        for layer in self.last_conv_layers:
            x = layer(x)
        return x[:, 0]


def init_parameters(model: ParallelWaveGANGenerator,
                    generator: torch.Generator) -> ParallelWaveGANGenerator:
    """Seeded random weights: kaiming-normal convs, zero biases, and the
    upsample smoothing filters at 1/kernel_size (the JAX package's init)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith("upsample_net.upsample"):
                p.fill_(1.0 / p.shape[-1])
            else:
                nn.init.kaiming_normal_(p, nonlinearity="relu",
                                        generator=generator)
    return model


def build_vocoder(config: PWGConfig = PWGConfig(), device=None,
                  seed: int = 0) -> ParallelWaveGANGenerator:
    """A PWG generator with seeded random weights, in eval mode on
    ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = ParallelWaveGANGenerator(config)
    init_parameters(gen, torch.Generator().manual_seed(seed))
    return gen.to(dev).eval()


def _fold_weight_norm(sd: dict, key: str) -> np.ndarray:
    """The dense conv weight, folding ``weight_g``/``weight_v`` (norm over
    every axis but the first) if present."""
    if f"{key}.weight" in sd:
        return np.asarray(sd[f"{key}.weight"])
    g = np.asarray(sd[f"{key}.weight_g"])
    v = np.asarray(sd[f"{key}.weight_v"])
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / norm


def convert_pwg_state(state_dict: dict,
                      config: PWGConfig = PWGConfig()) -> dict:
    """A ``parallel_wavegan`` generator state dict, with or without weight
    norm, -> the state dict of :class:`ParallelWaveGANGenerator` (tensors on
    the CPU; it loads with ``strict=True``).  Reads the keys the JAX
    package's ``convert_pwg_state`` reads and no others."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach")
          else np.asarray(v) for k, v in state_dict.items()}
    out = {}

    def conv(prefix, bias=True):
        out[f"{prefix}.weight"] = _fold_weight_norm(sd, prefix)
        if bias and f"{prefix}.bias" in sd:
            out[f"{prefix}.bias"] = sd[f"{prefix}.bias"]

    conv("first_conv")
    conv("last_conv_layers.1")
    conv("last_conv_layers.3")
    conv("upsample_net.conv_in", bias=False)
    for i in range(len(config.upsample_scales)):
        # up_layers: [stretch, conv2d] per scale, the conv at 2i + 1
        conv(f"upsample_net.upsample.up_layers.{2 * i + 1}", bias=False)
    for i in range(config.layers):
        conv(f"conv_layers.{i}.conv")
        conv(f"conv_layers.{i}.conv1x1_aux", bias=False)
        conv(f"conv_layers.{i}.conv1x1_out")
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def load_pwg_checkpoint(path: str, config: PWGConfig = PWGConfig()) -> dict:
    """The generator state dict of a ``parallel_wavegan`` checkpoint (its
    ``model`` and then ``generator`` entries, where present)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "generator"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return convert_pwg_state(sd, config)

