"""TrajectoryDiscriminator (counterpart of
``grouptraj/models/discriminator.py``; reference ``sgan/models.py:930-991``),
scene-padded dense.

LSTM-encodes the full (obs+pred) relative trajectory; for
``d_type='global'`` pools with PoolHiddenNet keyed on the trajectory START
position, with the pool bottleneck = h_dim; any other ``d_type`` is the
``'local'`` discriminator (upstream Social-GAN's), which classifies the
encoder's final state itself and has no ``pool_net``. The classifier is an
MLP whose trailing ReLU (make_mlp quirk) is kept — scores are ≥ 0 (with
ReLU; the config's activation, batch_norm and dropout apply to the pool's
and the classifier's MLPs as in the generator, dropout in training mode
only). The parameters
carry the reference's torch state-dict names (``encoder.encoder.*``,
``real_classifier.0.weight``, ``pool_net.mlp_pre_pool.2.weight``, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.generator import (
    _check_supported, _encode, _Encoder, _mlp, _mlp_tree, _PoolHiddenNet,
    keep_masks,
)
from grouptraj_torch.ops.linear import KeepMasks, mlp_forward
from grouptraj_torch.ops.pooling import pool_hidden_net


class TrajectoryDiscriminator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        h = cfg.encoder_h_dim_d
        self.encoder = _Encoder(cfg.embedding_dim, h)
        self.real_classifier = _mlp([h, cfg.mlp_dim, 1], cfg.batch_norm,
                                    cfg.activation)
        if cfg.d_type == "global":
            self.pool_net = _PoolHiddenNet(cfg.embedding_dim, h, h,
                                           cfg.batch_norm, cfg.activation)

    def tree(self) -> dict:
        """The parameters as the JAX package's tree (views, no copies)."""
        p = {"encoder": self.encoder.tree(),
             "real_classifier": _mlp_tree(self.real_classifier)}
        if hasattr(self, "pool_net"):
            p["pool_net"] = self.pool_net.tree()
        return p

    def forward(self, traj: torch.Tensor, traj_rel: torch.Tensor,
                valid: torch.Tensor, impl: str = "scan",
                masks: Optional[KeepMasks] = None) -> torch.Tensor:
        """traj and traj_rel [S, N, To+Tp, 2] (absolute, relative), valid
        [S, N] -> scores [S, N]; masked entries are scored but invalid —
        callers reduce with the validity mask. ``impl`` is the encoder's
        LSTM route (``ops/lstm.py``); ``masks`` the training mask source of
        the pool's, then the classifier's dropout."""
        cfg, p = self.cfg, self.tree()
        masks = keep_masks(self, cfg, masks)
        final_h = _encode(p["encoder"], traj_rel, impl)       # [S, N, Hd]
        classifier_input = final_h
        if "pool_net" in p:
            classifier_input = pool_hidden_net(
                p["pool_net"], final_h, traj[:, :, 0, :], valid,
                cfg.activation, cfg.batch_norm, cfg.dropout, masks,
                impl=cfg.pool_impl)
        scores = mlp_forward(p["real_classifier"], classifier_input,
                             cfg.activation, cfg.batch_norm, cfg.dropout,
                             mask=valid, masks=masks)
        return scores[..., 0]
