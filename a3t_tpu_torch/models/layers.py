"""Building-block layers of the Conformer stacks (``a3t_tpu/models/layers.py``).

Public shapes are (batch, time, channels), as in the JAX package; the
convolutions transpose to PyTorch's (batch, channels, time) inside.
Parameter names are ESPnet's (``a3t_tpu/compat/torch_import.py``), so a
``state_dict`` of these modules maps onto the flax tree and back.

Train mode is the module's ``training`` flag (``model.train()``): dropout
draws its seeds from the ``generator`` passed to ``forward``, and BatchNorm
normalises with batch statistics and updates its running statistics by
flax's rule.  In eval mode dropout is the identity and BatchNorm uses its
running statistics (the JAX package's ``use_running_average=True``).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from a3t_tpu_torch.models.dropout import SeededDropout

# flax BatchNorm(momentum=0.9) keeps 0.9 of the running statistics per step
# (torch's momentum=0.1 convention is the other way round)
BN_MOMENTUM = 0.9


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTIVATIONS = {"swish": swish}


@functools.lru_cache(maxsize=4)
def sinusoidal_table(length: int, d_model: int, reverse: bool = False) -> np.ndarray:
    """Sinusoidal positional table (length, d_model); ``reverse=True`` runs
    positions length-1 .. 0 (LegacyRelPositionalEncoding).  Cached: callers
    must not write to the returned array."""
    if reverse:
        position = np.arange(length - 1, -1, -1.0, dtype=np.float64)[:, None]
    else:
        position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((length, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    pe.flags.writeable = False
    return pe


def _compute_dtype(x: torch.Tensor, dtype) -> torch.dtype:
    """flax's promotion: ``dtype`` when given, else the input promoted with
    float32 parameters."""
    return torch.promote_types(x.dtype, torch.float32) if dtype is None \
        else dtype


def dense(linear: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to the
    compute dtype (the float32 parameters stay the master copy)."""
    dt = _compute_dtype(x, dtype)
    bias = None if linear.bias is None else linear.bias.to(dt)
    return F.linear(x.to(dt), linear.weight.to(dt), bias)


def conv1d(conv: nn.Conv1d, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """flax ``Conv(dtype=dtype)`` on (B, C, T): as :func:`dense`."""
    dt = _compute_dtype(x, dtype)
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv1d(x.to(dt), conv.weight.to(dt), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def batch_norm_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm from running statistics, whatever the module's mode."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=False, eps=bn.eps)


_FROZEN = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Within this context (in this thread) BatchNorm in training mode
    normalises with batch statistics but leaves its running statistics as
    they are: the recomputation of a rematerialised block, whose update
    flax's ``nn.remat`` discards."""
    before = getattr(_FROZEN, "on", False)
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = before


def _batch_stats(bn: nn.BatchNorm1d, x: torch.Tensor):
    """flax's batch statistics of a float32 ``x`` over every axis but C,
    padding included: the mean and the variance E[x^2] - E[x]^2 (clipped at
    0, biased); the running statistics move by ``ra = 0.9 * ra + 0.1 *
    batch`` with that biased variance, where torch's own BatchNorm would use
    the unbiased one."""
    dims = (0,) + tuple(range(2, x.dim()))
    mean = x.mean(dim=dims)
    var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    if not getattr(_FROZEN, "on", False):
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            bn.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    return mean, var


def _normalize(bn: nn.BatchNorm1d, x: torch.Tensor, mean, var):
    shape = (-1,) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


def batch_norm_train(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False, momentum=0.9)`` over
    (B, C, T) or (B, C, H, W) in float32 (:func:`_batch_stats`)."""
    x = x.float()
    return _normalize(bn, x, *_batch_stats(bn, x))


def batch_norm_compute_dtype(bn: nn.BatchNorm1d, x: torch.Tensor
                             ) -> torch.Tensor:
    """flax 0.12's ``BatchNorm(dtype=x.dtype)`` on a compute-dtype ``x``
    (the JAX conv module's ``bn_compute_dtype``, layers.py:216-220): the
    statistics are reduced from one float32 copy of ``x``; the normalisation
    promotes ``x`` against the float32 mean by a second copy, runs in float32
    and rounds to ``x``'s dtype.  The values equal the float32 round trip's;
    the gradient does not, since the two copies' gradients reach ``x``
    rounded to its dtype one by one and are summed there, where the round
    trip sums them in float32 first.  Running statistics stay float32."""
    if not bn.training:
        return batch_norm_eval(bn, x.float()).to(x.dtype)
    mean, var = _batch_stats(bn, x.float())
    return _normalize(bn, x.float(), mean, var).to(x.dtype)


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm by the module's mode: batch statistics in training."""
    return batch_norm_train(bn, x) if bn.training else batch_norm_eval(bn, x)


class PositionwiseFeedForward(nn.Module):
    """Linear -> activation -> dropout -> Linear, in the compute ``dtype``
    (None: float32)."""

    def __init__(self, d: int, hidden: int, activation: str = "swish",
                 dropout_rate: float = 0.0, dtype=None):
        super().__init__()
        self.w_1 = nn.Linear(d, hidden)
        self.w_2 = nn.Linear(hidden, d)
        self.act = ACTIVATIONS[activation]
        self.dropout = SeededDropout(dropout_rate)
        self.dtype = dtype

    def forward(self, x, generator=None):
        h = self.dropout(self.act(dense(self.w_1, x, self.dtype)), generator)
        return dense(self.w_2, h, self.dtype)


class MultiLayeredConv1d(nn.Module):
    """Two same-padded Conv1d with ReLU and dropout between (FastSpeech
    position-wise layer, espnet multi_layer_conv.py), in the compute
    ``dtype`` (None: float32).  JAX's ``conv1d_shifted`` lowering has the
    same parameters and is this module."""

    def __init__(self, d: int, hidden: int, kernel_size: int,
                 dropout_rate: float = 0.0, dtype=None):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.w_1 = nn.Conv1d(d, hidden, kernel_size, padding=pad)
        self.w_2 = nn.Conv1d(hidden, d, kernel_size, padding=pad)
        self.dropout = SeededDropout(dropout_rate)
        self.dtype = dtype

    def forward(self, x, generator=None):
        h = F.relu(conv1d(self.w_1, x.transpose(1, 2), self.dtype))
        h = self.dropout(h, generator)
        return conv1d(self.w_2, h, self.dtype).transpose(1, 2)


class ConvolutionModule(nn.Module):
    """Conformer convolution module: pointwise(2d) + GLU -> depthwise ->
    BatchNorm (eps 1e-5) -> activation -> pointwise.  The convolutions, the
    GLU and the activation run in the compute ``dtype`` (None: float32);
    BatchNorm in a float32 round trip (the JAX module's shipped
    ``bn_compute_dtype=False``) or, with ``bn_compute_dtype`` and a compute
    dtype, as flax's ``BatchNorm(dtype=...)`` does
    (:func:`batch_norm_compute_dtype`).  JAX's ``shifted`` lowering of the
    depthwise convolution has the same parameters and is this module."""

    def __init__(self, d: int, kernel_size: int, activation: str = "swish",
                 dtype=None, bn_compute_dtype: bool = False):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(d, 2 * d, 1)
        self.depthwise_conv = nn.Conv1d(d, d, kernel_size,
                                        padding=(kernel_size - 1) // 2, groups=d)
        self.norm = nn.BatchNorm1d(d, eps=1e-5)
        self.pointwise_conv2 = nn.Conv1d(d, d, 1)
        self.act = ACTIVATIONS[activation]
        self.dtype = dtype
        self.bn_compute_dtype = bn_compute_dtype

    def forward(self, x):
        dt = self.dtype
        h = conv1d(self.pointwise_conv1, x.transpose(1, 2), dt)
        a, g = h.chunk(2, dim=1)
        h = conv1d(self.depthwise_conv, a * torch.sigmoid(g), dt)
        if self.bn_compute_dtype and dt is not None:
            h = batch_norm_compute_dtype(self.norm, h)
        else:
            h = batch_norm(self.norm, h.float())
            if dt is not None:
                h = h.to(dt)
        return conv1d(self.pointwise_conv2, self.act(h), dt).transpose(1, 2)


class Postnet(nn.Module):
    """Tacotron2 postnet: (n_layers-1) x [Conv(no bias) -> BN -> tanh ->
    dropout] + [Conv -> BN -> dropout]; the caller adds the residual.  The
    convolutions run in the compute ``dtype`` (None: float32) and each
    BatchNorm in a float32 round trip; the output is float32."""

    def __init__(self, odim: int, n_layers: int = 5, n_chans: int = 256,
                 n_filts: int = 5, dropout_rate: float = 0.5, dtype=None):
        super().__init__()
        pad = (n_filts - 1) // 2
        layers = []
        for i in range(n_layers):
            c_in = odim if i == 0 else n_chans
            c_out = odim if i == n_layers - 1 else n_chans
            layers.append(nn.Sequential(
                nn.Conv1d(c_in, c_out, n_filts, padding=pad, bias=False),
                nn.BatchNorm1d(c_out, eps=1e-5)))
        self.postnet = nn.ModuleList(layers)
        self.dropout = SeededDropout(dropout_rate)
        self.dtype = dtype

    def forward(self, x, generator=None):
        h = x.transpose(1, 2)
        for i, (conv, bn) in enumerate(self.postnet):
            h = batch_norm(bn, conv1d(conv, h, self.dtype).float())
            if i < len(self.postnet) - 1:
                h = torch.tanh(h if self.dtype is None else h.to(self.dtype))
            h = self.dropout(h, generator)
        return h.transpose(1, 2)


class MaskedInput(nn.Module):
    """``where(masked, mask_feature, x)`` (NewMaskInputLayer)."""

    def __init__(self, features: int):
        super().__init__()
        self.mask_feature = nn.Parameter(torch.zeros(1, 1, features))

    def forward(self, x, masked_position):
        return torch.where(masked_position[..., None],
                           self.mask_feature.to(x.dtype), x)


class VariancePredictor(nn.Module):
    """FastSpeech's predictor stack (duration_predictor.py:14-113,
    variance_predictor.py): ``n_layers`` x [same-padded Conv1d -> ReLU ->
    LayerNorm (eps 1e-5, the JAX modules') -> dropout], then a Linear to one
    value per position, zero where ``pad_mask`` is True.  Output (B, T, 1);
    ESPnet's names (``conv.{i}.0``, ``conv.{i}.2``, ``linear``)."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384,
                 kernel_size: int = 3, dropout_rate: float = 0.5):
        super().__init__()
        self.conv = nn.ModuleList(
            nn.ModuleList([
                nn.Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size,
                          padding="same"),
                nn.ReLU(), nn.LayerNorm(n_chans, eps=1e-5),
                SeededDropout(dropout_rate)])
            for i in range(n_layers))
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, x, pad_mask=None, generator=None):
        h = x
        for conv, relu, norm, drop in self.conv:
            h = conv(h.transpose(1, 2)).transpose(1, 2)
            h = drop(norm(relu(h)), generator)
        out = self.linear(h)
        if pad_mask is not None:
            out = out.masked_fill(pad_mask[..., None], 0.0)
        return out


class DurationPredictor(VariancePredictor):
    """The duration predictor (layers.py:291-322): log-domain durations
    (B, T), trained against log(d + 1) and rounded to frames at
    inference by :meth:`to_durations`; dropout 0.1, as in JAX."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 256,
                 kernel_size: int = 3, dropout_rate: float = 0.1):
        super().__init__(idim, n_layers, n_chans, kernel_size, dropout_rate)

    def forward(self, x, pad_mask=None, generator=None):
        return super().forward(x, pad_mask, generator)[..., 0]

    @staticmethod
    def to_durations(log_durations: torch.Tensor, offset: float = 1.0
                     ) -> torch.Tensor:
        """max(round(exp(x) - offset), 0) as int64; ``torch.round`` rounds
        half to even, as ``jnp.round`` does."""
        return torch.clamp(torch.round(torch.exp(log_durations) - offset),
                           min=0.0).to(torch.int64)


def duration_loss(log_pred: torch.Tensor, target_durations: torch.Tensor,
                  offset: float = 1.0) -> torch.Tensor:
    """Per-position squared error in the log domain (layers.py:325-330)."""
    t = torch.log(target_durations.float() + offset)
    return (log_pred - t) ** 2


def length_regulate(hs: torch.Tensor, durations: torch.Tensor, max_len: int):
    """(B, T, D) states and (B, T) integer durations -> ((B, max_len, D),
    (B, max_len) valid): frame t copies phone i where cum[i-1] <= t <
    cum[i]; frames at or past the total are zero and invalid, so a total
    past ``max_len`` is cut."""
    cum = torch.cumsum(durations.to(torch.int64), dim=1)
    t_idx = torch.arange(max_len, device=hs.device)
    # phone covering frame t = the number of cumulative ends <= t
    src = torch.searchsorted(cum.contiguous(),
                             t_idx.expand(cum.shape[0], -1).contiguous(),
                             right=True)
    valid = t_idx[None, :] < cum[:, -1:]
    src = src.clamp(0, hs.shape[1] - 1)
    out = torch.gather(hs, 1, src[..., None].expand(-1, -1, hs.shape[2]))
    return out.masked_fill(~valid[..., None], 0.0), valid
