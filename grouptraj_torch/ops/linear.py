"""Linear layers and make_mlp stacks on JAX-shaped parameter trees
(counterpart of ``grouptraj/ops/linear.py``).

Weights are ``[in, out]`` as in the JAX package, so forward is
``x @ w + b``. Each use casts the weight to the input's dtype: a
``Predictor`` may hold its weights in bfloat16 while activations stay
float32. Differentiable by plain autograd.

``make_mlp`` semantics (reference ``sgan/models.py:7-20``): the activation
follows EVERY Linear including the last one. The quirk is load-bearing for
checkpoint parity and is preserved.
"""

from __future__ import annotations

from typing import Optional

import torch


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


def mlp_forward(params: dict, x: torch.Tensor, activation: str = "relu",
                batch_norm: bool = False, dropout: float = 0.0,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Linear+ReLU stack. ``mask`` (valid rows, as the discriminator's
    classifier passes it) only feeds BatchNorm's masked statistics in the
    JAX package, so without batch_norm it changes nothing. batch_norm,
    dropout and the other activations are not ported yet and raise."""
    if activation != "relu" or batch_norm or dropout:
        raise NotImplementedError(
            f"mlp_forward supports relu without batch_norm or dropout (got "
            f"activation={activation!r}, batch_norm={batch_norm}, "
            f"dropout={dropout}); the other variants are not ported yet")
    for layer in params["layers"]:
        x = torch.relu(linear(layer["linear"], x))
    return x
