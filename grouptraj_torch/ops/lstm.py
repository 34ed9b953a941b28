"""Single-layer LSTM recurrences with hand-written backwards (counterpart
of ``grouptraj/ops/lstm.py``).

Plain Python loops over time with fused-gate matmuls, torch gate order
(i, f, g, o), weights ``[in, 4H]`` / ``[H, 4H]`` as in the JAX package.
These are the folded forms the JAX scan path runs, so parity is against
the same algebra: the encoder's spatial embedding is folded into the input
gates (``models/generator.py:_encode``) and the decoder's embedding and
hidden2pos into one recurrent matrix (``_decode_folded``).

Each recurrence is a ``torch.autograd.Function`` with the JAX package's
backward algebra: the forward saves only the per-step ``(h_prev, c_prev)``
(and the inputs), the reverse loop recomputes the gates from them and
accumulates every weight gradient as it goes, so no ``[T, B, 4H]`` gate
slab is ever kept. When no argument needs a gradient (``torch.no_grad()``:
the best-of-k probe decode, the d-step's generator forward, serving) the
plain loop runs and nothing is saved. These function boundaries are where
the whole-loop kernels (K3/K4) will slot in.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable


def _gate_acts(z: torch.Tensor, H: int):
    return (torch.sigmoid(z[..., 0 * H:1 * H]),
            torch.sigmoid(z[..., 1 * H:2 * H]),
            torch.tanh(z[..., 2 * H:3 * H]),
            torch.sigmoid(z[..., 3 * H:4 * H]))


def lstm_gates(z: torch.Tensor, c: torch.Tensor, H: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-activation gates z [..., 4H] and cell c [..., H] -> (h', c')."""
    i, f, g, o = _gate_acts(z, H)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _gates_bwd(z, c_prev, dh, dc_in, H):
    """One step of the gate backward, gates recomputed from z: returns
    (dz [B, 4H], dc chained to c_prev, h of this step)."""
    i, f, g, o = _gate_acts(z, H)
    tc = torch.tanh(f * c_prev + i * g)
    do = dh * tc
    dc = dc_in + dh * o * (1.0 - tc * tc)
    dz = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                    dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
    return dz, dc * f, o * tc


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ------------------------------------------------------------------ encoder

def _encoder_loop(w_comp, b_comp, w_hh, xs, keep):
    H = w_hh.shape[0]
    h = xs.new_zeros((xs.shape[1], H))
    c = h
    for x in xs:
        if keep is not None:
            keep.append((h, c))
        h, c = lstm_gates(x @ w_comp + b_comp + h @ w_hh, c, H)
    return h, c


class _EncoderRecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_comp, b_comp, w_hh, xs):
        keep = []
        hT, cT = _encoder_loop(w_comp, b_comp, w_hh, xs, keep)
        ctx.save_for_backward(w_comp, b_comp, w_hh, xs,
                              *[h for h, _ in keep], *[c for _, c in keep])
        return hT, cT

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dc):
        w_comp, b_comp, w_hh, xs, *states = ctx.saved_tensors
        T, H = xs.shape[0], w_hh.shape[0]
        hs, cs = states[:T], states[T:]
        dwc, dwh = torch.zeros_like(w_comp), torch.zeros_like(w_hh)
        db = torch.zeros_like(b_comp)
        dxs = torch.empty_like(xs)
        for t in reversed(range(T)):
            z = xs[t] @ w_comp + b_comp + hs[t] @ w_hh    # recompute
            dz, dc, _ = _gates_bwd(z, cs[t], dh, dc, H)
            dh = dz @ w_hh.t()
            dwh += hs[t].t() @ dz
            dwc += xs[t].t() @ dz
            db += dz.sum(dim=0)
            dxs[t] = dz @ w_comp.t()
        return dwc, db, dwh, dxs


def encoder_recurrence(w_comp: torch.Tensor, b_comp: torch.Tensor,
                       w_hh: torch.Tensor, xs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder leg with the folded embedding: ``z_t = x_t @ w_comp + b_comp
    + h @ w_hh`` from zero state over raw xs [T, B, 2] -> (hT, cT)."""
    if _wants_grad(w_comp, b_comp, w_hh, xs):
        return _EncoderRecurrence.apply(w_comp, b_comp, w_hh, xs)
    return _encoder_loop(w_comp, b_comp, w_hh, xs, None)


# ------------------------------------------------------- decoder, first step

def _first_step(w_r, b1c, w_hh, w_p, b_p, x0, h0):
    H = h0.shape[-1]
    z = x0 @ w_r + h0 @ w_hh + b1c
    h1, c1 = lstm_gates(z, torch.zeros_like(h0), H)
    return h1, c1, h1 @ w_p + b_p


class _DecoderFirstStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_r, b1c, w_hh, w_p, b_p, x0, h0):
        ctx.save_for_backward(w_r, b1c, w_hh, w_p, x0, h0)
        return _first_step(w_r, b1c, w_hh, w_p, b_p, x0, h0)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh1, dc1, dy1):
        w_r, b1c, w_hh, w_p, x0, h0 = ctx.saved_tensors
        H = h0.shape[-1]
        z = x0 @ w_r + h0 @ w_hh + b1c                    # recompute
        dh = dh1 + dy1 @ w_p.t()
        # c_prev = 0 kills the forget gate's term
        dz, _, h1 = _gates_bwd(z, torch.zeros_like(h0), dh, dc1, H)
        return (x0.t() @ dz, dz.sum(dim=0), h0.t() @ dz, h1.t() @ dy1,
                dy1.sum(dim=0), dz @ w_r.t(), dz @ w_hh.t())


def decoder_first_step(w_r, b1c, w_hh, w_p, b_p, x0, h0):
    """One step from a zero cell with a distinct input path, plus the
    hidden2pos projection: ``z = x0 @ w_r + h0 @ w_hh + b1c``,
    ``(h1, c1) = gates(z, 0)``, ``y1 = h1 @ w_p + b_p`` -> (h1, c1, y1)."""
    args = (w_r, b1c, w_hh, w_p, b_p, x0, h0)
    if _wants_grad(*args):
        return _DecoderFirstStep.apply(*args)
    return _first_step(*args)


# -------------------------------------------------- decoder, folded recurrence

def _proj_loop(w_eff, b_eff, w_p, b_p, h, c, T, keep):
    H = h.shape[-1]
    ys = []
    for _ in range(T):
        if keep is not None:
            keep.append((h, c))
        h, c = lstm_gates(h @ w_eff + b_eff, c, H)
        ys.append(h @ w_p + b_p)
    return torch.stack(ys)


class _DecoderProjRecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_eff, b_eff, w_p, b_p, h1, c1, T):
        keep = []
        ys = _proj_loop(w_eff, b_eff, w_p, b_p, h1, c1, T, keep)
        ctx.save_for_backward(w_eff, b_eff, w_p,
                              *[h for h, _ in keep], *[c for _, c in keep])
        ctx.T = T
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        w_eff, b_eff, w_p, *states = ctx.saved_tensors
        T, H = ctx.T, w_eff.shape[0]
        hs, cs = states[:T], states[T:]
        dw, db = torch.zeros_like(w_eff), torch.zeros_like(b_eff)
        dwp = torch.zeros_like(w_p)
        dbp = dys.new_zeros(w_p.shape[1])
        dh, dc = torch.zeros_like(hs[0]), torch.zeros_like(cs[0])
        for t in reversed(range(T)):
            z = hs[t] @ w_eff + b_eff                     # recompute
            dh = dh + dys[t] @ w_p.t()
            dz, dc, h2 = _gates_bwd(z, cs[t], dh, dc, H)
            dwp += h2.t() @ dys[t]
            dbp += dys[t].sum(dim=0)
            dh = dz @ w_eff.t()
            dw += hs[t].t() @ dz
            db += dz.sum(dim=0)
        return dw, db, dwp, dbp, dh, dc, None


def decoder_proj_recurrence(w_eff, b_eff, w_p, b_p, h1, c1, T: int
                            ) -> torch.Tensor:
    """T steps of the folded decoder (``gates = h @ w_eff + b_eff``) with
    hidden2pos fused into each step -> ys [T, B, 2]."""
    if _wants_grad(w_eff, b_eff, w_p, b_p, h1, c1):
        return _DecoderProjRecurrence.apply(w_eff, b_eff, w_p, b_p, h1, c1, T)
    return _proj_loop(w_eff, b_eff, w_p, b_p, h1, c1, T, None)
