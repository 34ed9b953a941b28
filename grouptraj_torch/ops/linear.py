"""Linear layers and make_mlp stacks on JAX-shaped parameter trees
(counterpart of ``grouptraj/ops/linear.py``), and the seam dropout's
keep-masks come through.

Weights are ``[in, out]`` as in the JAX package, so forward is
``x @ w + b``. Each use casts the weight to the input's dtype: a
``Predictor`` may hold its weights in bfloat16 while activations stay
float32. Differentiable by plain autograd.

``make_mlp`` semantics (reference ``sgan/models.py:7-20``): for every layer
Linear, optional BatchNorm, activation, optional dropout; the activation
follows EVERY Linear including the last one. The quirk is load-bearing for
checkpoint parity and is preserved. BatchNorm always normalises with the
batch's statistics, in training and in evaluation alike, and keeps no
running averages (the JAX package's semantics).

Keep-masks are draws. Every function that applies dropout takes a
:class:`KeepMasks` and asks it for one boolean mask at a time, in the order
the JAX package calls ``jax.random.bernoulli``: :class:`DrawnMasks` draws
them from a ``torch.Generator``, :class:`InjectedMasks` hands out given
ones (a test's JAX masks) and checks each one's shape. ``masks=None`` means
evaluation: no dropout.
"""

from __future__ import annotations

import abc
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


class KeepMasks(abc.ABC):
    """The source of dropout's keep-masks, asked once per mask."""

    @abc.abstractmethod
    def keep(self, shape: Sequence[int], keep: float,
             device) -> torch.Tensor:
        """A boolean mask of ``shape``, True with probability ``keep``."""


class DrawnMasks(KeepMasks):
    """Masks drawn from ``generator`` (a generator of the tensors' device;
    None: that device's default generator), ``uniform < keep`` as
    ``jax.random.bernoulli`` draws them."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator

    def keep(self, shape, keep, device):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=device) < keep


class InjectedMasks(KeepMasks):
    """Given masks (arrays or tensors, nonzero = kept) handed out in
    order; a mask whose shape differs from the one asked for, or a request
    past the last mask, raises."""

    def __init__(self, masks: Iterable):
        self._masks = iter(masks)
        self.used = 0

    def keep(self, shape, keep, device):
        try:
            m = next(self._masks)
        except StopIteration:
            raise ValueError(f"mask {self.used} of shape {tuple(shape)} "
                             f"was asked for, but only {self.used} were "
                             f"injected") from None
        if tuple(m.shape) != tuple(shape):
            raise ValueError(f"injected mask {self.used} has shape "
                             f"{tuple(m.shape)}, the forward asks for "
                             f"{tuple(shape)}")
        self.used += 1
        return as_mask(m, device)


def as_mask(m, device) -> torch.Tensor:
    """A given mask (an array or a tensor of any device; nonzero = kept)
    as a boolean tensor on ``device``."""
    if not isinstance(m, torch.Tensor):
        m = torch.from_numpy(np.array(m))
    return m.to(device) != 0


class ShapeRecorder(KeepMasks):
    """Keeps everything and records what was asked for: the (shape, keep)
    of every mask of a forward, in order."""

    def __init__(self):
        self.asked: List[Tuple[Tuple[int, ...], float]] = []

    def keep(self, shape, keep, device):
        self.asked.append((tuple(shape), keep))
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)


def apply_dropout(x: torch.Tensor, p: float,
                  masks: Optional[KeepMasks]) -> torch.Tensor:
    """Inverted dropout: kept entries scaled by ``1/(1-p)``, the rest 0;
    ``x`` itself without a mask source (evaluation) or with ``p == 0``."""
    if not p or masks is None:
        return x
    keep = masks.keep(x.shape, 1.0 - p, x.device)
    return torch.where(keep, x / (1.0 - p), 0.0)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(x)
    if activation == "leakyrelu":
        return F.leaky_relu(x, negative_slope=0.01)   # torch default slope
    if activation in (None, "none"):
        return x
    raise ValueError(activation)


def normalize(layer: dict, x: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BatchNorm over every axis but the last, on the batch's statistics:
    with ``mask`` (broadcastable to ``x[..., 0]``) the mean and biased
    variance of the masked rows, ``max(Σmask, 1)`` of them; then
    ``bn_scale``/``bn_bias``."""
    red = tuple(range(x.dim() - 1))
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(dim=red) / cnt
        var = (m * (x - mean) ** 2).sum(dim=red) / cnt
    else:
        mean = x.mean(dim=red)
        var = x.var(dim=red, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + BN_EPS)
    return x * layer["bn_scale"].to(x.dtype) + layer["bn_bias"].to(x.dtype)


def mlp_forward(params: dict, x: torch.Tensor, activation: str = "relu",
                batch_norm: bool = False, dropout: float = 0.0,
                mask: Optional[torch.Tensor] = None,
                masks: Optional[KeepMasks] = None) -> torch.Tensor:
    """The Linear(+BN)(+activation)(+dropout) stack. ``mask`` marks the
    valid rows of BatchNorm's statistics; dropout (one mask a layer, the
    last included) applies only with a mask source ``masks``."""
    for layer in params["layers"]:
        x = linear(layer["linear"], x)
        if batch_norm:
            x = normalize(layer, x, mask)
        x = apply_dropout(activate(x, activation), dropout, masks)
    return x
