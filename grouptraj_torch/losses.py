"""GAN losses and displacement metrics as masked tensor functions
(counterpart of ``grouptraj/losses.py``; reference ``sgan/losses.py``).

Everything is scene-padded dense: trajectories are ``[S, N, T, 2]`` with a
validity mask ``[S, N]`` (and a per-step ``loss_mask [S, N, T]``). The
reference's normalisers are kept as they are. The one random draw of the
reference — the label-smoothing scalar y ~ U(0.7, 1.2) — is an argument
here, so a caller (or a parity test) supplies it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def bce_loss(logits: torch.Tensor, target: Union[Scalar, torch.Tensor],
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically-stable logits BCE, mean over (valid) entries:
    ``max(x,0) - x*y + log(1 + exp(-|x|))`` (reference
    ``sgan/losses.py:5-21``)."""
    loss = torch.clamp(logits, min=0) - logits * target + torch.log1p(
        torch.exp(-torch.abs(logits)))
    if mask is None:
        return loss.mean()
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def gan_g_loss(scores_fake: torch.Tensor, y: Scalar,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generator adversarial loss with one-sided label smoothing: BCE of
    the fake scores against the scalar ``y`` ~ U(0.7, 1.2)."""
    return bce_loss(scores_fake, y, mask)


def gan_d_loss(scores_real: torch.Tensor, scores_fake: torch.Tensor,
               y_real: Scalar, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Discriminator loss: BCE(real, ``y_real`` ~ U(0.7, 1.2)) +
    BCE(fake, 0) (the reference's ``zeros * U(0, 0.3)`` fake label is
    exactly 0)."""
    return bce_loss(scores_real, y_real, mask) + bce_loss(scores_fake, 0.0,
                                                          mask)


def l2_loss(pred: torch.Tensor, gt: torch.Tensor, loss_mask: torch.Tensor,
            mode: str = "average") -> torch.Tensor:
    """Masked squared error (reference ``sgan/losses.py:52-71``): pred, gt
    ``[..., N, T, 2]``, loss_mask ``[..., N, T]``; mode 'sum' | 'average' |
    'raw' ('raw' returns per-ped ``[..., N]``). 'average' divides by
    numel(loss_mask) like the reference (the count of mask entries, not of
    ones)."""
    sq = loss_mask[..., None] * (gt - pred) ** 2
    if mode == "sum":
        return sq.sum()
    if mode == "average":
        return sq.sum() / loss_mask.numel()
    if mode == "raw":
        return sq.sum(dim=(-2, -1))
    raise ValueError(mode)


def displacement_error(pred: torch.Tensor, gt: torch.Tensor,
                       consider_ped: Optional[torch.Tensor] = None,
                       mode: str = "sum") -> torch.Tensor:
    """ADE numerator: per-ped sum over T of the euclidean error (reference
    ``sgan/losses.py:74-95``); pred, gt ``[..., N, T, 2]``."""
    per_ped = torch.sqrt(((gt - pred) ** 2).sum(dim=-1)).sum(dim=-1)
    if consider_ped is not None:
        per_ped = per_ped * consider_ped
    if mode == "sum":
        return per_ped.sum()
    if mode == "raw":
        return per_ped
    raise ValueError(mode)


def final_displacement_error(pred_last: torch.Tensor, gt_last: torch.Tensor,
                             consider_ped: Optional[torch.Tensor] = None,
                             mode: str = "sum") -> torch.Tensor:
    """FDE numerator (reference ``sgan/losses.py:98-119``); ``[..., N, 2]``."""
    per_ped = torch.sqrt(((gt_last - pred_last) ** 2).sum(dim=-1))
    if consider_ped is not None:
        per_ped = per_ped * consider_ped
    if mode == "raw":
        return per_ped
    return per_ped.sum()


def variety_l2_loss(pred_rel_k: torch.Tensor, gt_rel: torch.Tensor,
                    loss_mask: torch.Tensor, valid: torch.Tensor,
                    l2_loss_weight: float = 1.0) -> torch.Tensor:
    """Best-of-k "variety" loss over the sample axis of pred_rel_k
    ``[K, S, N, T, 2]``: per scene, the raw l2 summed over its pedestrians
    per sample, min over k, normalised by the scene's loss-mask sum, summed
    over scenes. ``amin`` splits its cotangent evenly among tying samples,
    as ``jnp.min`` does."""
    per_scene, denom = variety_l2_parts(pred_rel_k, gt_rel, loss_mask, valid,
                                        l2_loss_weight)
    return variety_from_scene_l2(per_scene.amin(dim=0), denom)


def variety_l2_parts(pred_rel_k: torch.Tensor, gt_rel: torch.Tensor,
                     loss_mask: torch.Tensor, valid: torch.Tensor,
                     l2_loss_weight: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, scene) raw l2 sums ``[K, S]`` and the per-scene
    normaliser ``[S]`` — the pieces of :func:`variety_l2_loss` before the
    min over k, for the sparse best-of-k backward."""
    raw = l2_loss_weight * l2_loss(pred_rel_k, gt_rel[None], loss_mask[None],
                                   mode="raw")                  # [K, S, N]
    return (raw * valid[None]).sum(dim=-1), loss_mask.sum(dim=(-2, -1))


def variety_scene_l2(pred_rel: torch.Tensor, gt_rel: torch.Tensor,
                     loss_mask: torch.Tensor, valid: torch.Tensor,
                     l2_loss_weight: float = 1.0) -> torch.Tensor:
    """Per-scene raw l2 sums for ONE sample ``[S, N, T, 2]`` -> ``[S]``."""
    raw = l2_loss_weight * l2_loss(pred_rel, gt_rel, loss_mask, mode="raw")
    return (raw * valid).sum(dim=-1)


def variety_from_scene_l2(best: torch.Tensor, denom: torch.Tensor
                          ) -> torch.Tensor:
    """Final variety reduction from the per-scene best l2 ``[S]`` and the
    scene loss-mask sums ``[S]`` (empty scenes contribute exactly zero)."""
    return torch.where(denom > 0, best / torch.clamp(denom, min=1.0),
                       0.0).sum()
