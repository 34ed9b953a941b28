"""Dense GCN layers batched over scenes (counterpart of
``grouptraj/ops/gcn.py``; reference ``sgan/models.py:552-580``):
``H <- relu(A @ H @ W_i)`` per layer."""

from __future__ import annotations

import torch


def gcn(params: dict, adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """- adj: [S, N, N], already normalised, zero rows at padding
    - x: [S, N, F]
    ``params["W"]`` is the list of ``[in, out]`` layer weights."""
    h = x
    for w in params["W"]:
        h = torch.relu(adj @ h @ w.to(h.dtype))
    return h
