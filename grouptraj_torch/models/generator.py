"""TrajectoryGenerator: LSTM encoder → social pooling → group GAT → noise →
folded LSTM decoder, scene-padded dense (counterpart of
``grouptraj/models/generator.py``; reference ``sgan/models.py:715-927``).

The module's parameters carry the reference's torch state-dict names and
layouts, so a zoo ``g_state`` loads with ``load_state_dict``. The forward
functions work on the JAX-shaped tree :meth:`TrajectoryGenerator.tree`
returns (``[in, out]`` views of the same tensors) and cast each weight to
the activations' dtype where it is used. The context phase always runs in
float32; the decoder runs in the dtype of the context it is handed, so a
serving ``Predictor`` may hold bfloat16 weights under float32 activations
and the training step's no-grad legs may decode entirely in bfloat16.

Every function is differentiable (serving wraps its calls in
``torch.inference_mode``, training does not) and takes ``impl``, the LSTM
route of ``ops/lstm.py``: ``'scan'`` (default), ``'fused'``, the
whole-loop kernels for the encoder and the folded decoder, or ``'pallas'``,
the projection-in-kernel LSTM for the encoder only (the decoder stays on
the scan route's folded recurrence, as in the JAX package). Covered:
pool_net or gcn pooling; the ``gat`` or ``gat-mh`` graph module (the latter
followed by ``mlp_decoder_context``), or none with ``mlp_decoder_context``
after gcn pooling (the ``gcn-pool`` preset); no per-step re-pooling. So
every zoo checkpoint builds. The other presets (``gcn``, ``sgan``,
``sgan-p``), ``pool_every_timestep`` and batch_norm raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.modules import (
    GATEncoder, GATEncoderMH, GCNPooling, gat_encoder, gat_encoder_mh,
    gcn_pooling,
)
from grouptraj_torch.ops.cuda_lstm import decoder_recurrence_fused
from grouptraj_torch.ops.linear import linear, mlp_forward
from grouptraj_torch.ops.lstm import (
    decoder_first_step, decoder_proj_recurrence, encoder_recurrence,
    lstm_scan,
)
from grouptraj_torch.ops.noise import get_noise
from grouptraj_torch.ops.pooling import pool_hidden_net


class LSTMWeights(nn.Module):
    """The four tensors of a single-layer ``nn.LSTM`` under its own names
    (``weight_ih_l0`` [4H, in], ...); the recurrences live in ops/lstm.py."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * hidden, d_in))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih_l0 = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * hidden))
        bound = 1.0 / math.sqrt(hidden)          # torch nn.LSTM default init
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def tree(self) -> dict:
        return {"w_ih": self.weight_ih_l0.t(), "w_hh": self.weight_hh_l0.t(),
                "b_ih": self.bias_ih_l0, "b_hh": self.bias_hh_l0}


def _lin(m: nn.Linear) -> dict:
    return {"w": m.weight.t(), "b": m.bias}


class _Encoder(nn.Module):
    def __init__(self, embedding_dim: int, h_dim: int):
        super().__init__()
        self.spatial_embedding = nn.Linear(2, embedding_dim)
        self.encoder = LSTMWeights(embedding_dim, h_dim)

    def tree(self) -> dict:
        return {"spatial_embedding": _lin(self.spatial_embedding),
                "lstm": self.encoder.tree()}


class _Decoder(nn.Module):
    def __init__(self, embedding_dim: int, h_dim: int):
        super().__init__()
        self.spatial_embedding = nn.Linear(2, embedding_dim)
        self.decoder = LSTMWeights(embedding_dim, h_dim)
        self.hidden2pos = nn.Linear(h_dim, 2)

    def tree(self) -> dict:
        return {"spatial_embedding": _lin(self.spatial_embedding),
                "lstm": self.decoder.tree(),
                "hidden2pos": _lin(self.hidden2pos)}


def _mlp(dims) -> nn.Sequential:
    """make_mlp layout: Linear, ReLU pairs (Linear keys .0, .2, ...)."""
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        layers += [nn.Linear(d_in, d_out), nn.ReLU()]
    return nn.Sequential(*layers)


def _mlp_tree(seq: nn.Sequential) -> dict:
    return {"layers": [{"linear": _lin(m)} for m in seq
                       if isinstance(m, nn.Linear)]}


class _PoolHiddenNet(nn.Module):
    def __init__(self, embedding_dim: int, h_dim: int, bottleneck_dim: int):
        super().__init__()
        self.spatial_embedding = nn.Linear(2, embedding_dim)
        self.mlp_pre_pool = _mlp([embedding_dim + h_dim, 512, bottleneck_dim])

    def tree(self) -> dict:
        return {"spatial_embedding": _lin(self.spatial_embedding),
                "mlp_pre_pool": _mlp_tree(self.mlp_pre_pool)}


def _check_supported(cfg: ModelConfig) -> None:
    gcn_pool = (cfg.pooling_type == "gcn" and cfg.graph_module == "none"
                and cfg.mlp_decoder_context)
    later = [
        (cfg.pool_every_timestep, "pool_every_timestep (per-step pooling)"),
        (cfg.pooling_type in (None, "none"), "pooling_type='none' (sgan)"),
        (cfg.graph_module not in ("gat", "gat-mh") and not gcn_pool,
         f"graph_module={cfg.graph_module!r} with pooling_type="
         f"{cfg.pooling_type!r} (gcn, sgan-p presets)"),
        (cfg.batch_norm or cfg.activation != "relu",
         "batch_norm or a non-relu activation"),
    ]
    for flag, what in later:
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet: it comes with the slice for "
                "the other presets and paths (ROADMAP.md queue 1); the "
                "port covers the 'gat', 'gat-mh' and 'gcn-pool' models")


class TrajectoryGenerator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.encoder = _Encoder(cfg.embedding_dim, cfg.encoder_h_dim_g)
        self.decoder = _Decoder(cfg.embedding_dim, cfg.decoder_h_dim_g)
        if cfg.pooling_type == "gcn":
            self.pool_net = GCNPooling(cfg.embedding_dim, cfg.encoder_h_dim_g,
                                       cfg.gcn_hidden_dim, cfg.bottleneck_dim,
                                       cfg.gcn_layers)
        else:
            self.pool_net = _PoolHiddenNet(cfg.embedding_dim,
                                           cfg.encoder_h_dim_g,
                                           cfg.bottleneck_dim)
        if cfg.graph_module == "gat":
            self.gatencoder = GATEncoder(cfg.context_dim, cfg.hidden_units,
                                         cfg.graph_out_dim,
                                         cfg.decoder_context_dim, cfg.n_heads)
        elif cfg.graph_module == "gat-mh":
            self.gatencoder = GATEncoderMH(cfg.mh_n_units, cfg.mh_n_heads)
            self.mlp_decoder_context = _mlp(
                [cfg.mh_n_units[-1], cfg.mlp_dim, cfg.decoder_context_dim])
        else:                                   # gcn-pool: the context MLP
            self.mlp_decoder_context = _mlp(
                [cfg.context_dim, cfg.mlp_dim, cfg.decoder_context_dim])

    def tree(self) -> dict:
        """The parameters as the JAX package's tree (views, no copies)."""
        p = {"encoder": self.encoder.tree(),
             "decoder": self.decoder.tree(),
             "pool_net": self.pool_net.tree()}
        if hasattr(self, "gatencoder"):
            p["gatencoder"] = self.gatencoder.tree()
        if hasattr(self, "mlp_decoder_context"):
            p["mlp_decoder_context"] = _mlp_tree(self.mlp_decoder_context)
        return p

    def generator_context(self, obs: torch.Tensor, obs_rel: torch.Tensor,
                          group_end: torch.Tensor, valid: torch.Tensor,
                          impl: str = "scan") -> torch.Tensor:
        """Encoder → pooling → graph module -> noise_input [S, N,
        decoder_h − noise]; computed once and shared by all best-of-k
        samples. obs and obs_rel are [S, N, To, 2], group_end and valid
        [S, N]."""
        cfg, p = self.cfg, self.tree()
        final_h = _encode(p["encoder"], obs_rel, impl)        # [S, N, He]
        if cfg.pooling_type == "gcn":
            pool_h = gcn_pooling(p["pool_net"], final_h, obs_rel[:, :, -1, :],
                                 group_end, valid)
        else:
            pool_h = pool_hidden_net(p["pool_net"], final_h, obs[:, :, -1, :],
                                     valid, cfg.activation, cfg.batch_norm,
                                     impl=cfg.pool_impl)
        ctx = torch.cat([final_h, pool_h], dim=-1)            # [S, N, He+B]
        if cfg.graph_module == "gat":
            return gat_encoder(p["gatencoder"], ctx, group_end, valid,
                               cfg.alpha)
        if cfg.graph_module == "gat-mh":
            ctx = gat_encoder_mh(p["gatencoder"], ctx, group_end, valid,
                                 cfg.alpha, cfg.mh_adj, cfg.mh_concat,
                                 cfg.mh_norm)
        return mlp_forward(p["mlp_decoder_context"], ctx, cfg.activation,
                           cfg.batch_norm, cfg.dropout, mask=valid)

    def generator_sample(self, noise_input: torch.Tensor,
                         obs_rel: torch.Tensor, valid: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         user_noise: Optional[torch.Tensor] = None,
                         impl: str = "scan") -> torch.Tensor:
        """One sample: noise concat + decode -> pred_rel [S, N, Tp, 2] in
        ``noise_input``'s dtype (float32 with ``impl='fused'``), × valid.
        ``user_noise`` ``[S, N, nd]`` replaces the internal draw."""
        cfg = self.cfg
        S, N = valid.shape
        h = noise_input
        if cfg.noise_first_dim:
            z = user_noise
            if z is None:
                z = sample_noises(cfg, 1, S, N, generator,
                                  noise_input.device)[0]
            h = torch.cat([h, z.to(noise_input.dtype)], dim=-1)
        return _decode_folded(self.decoder.tree(), cfg, h,
                              obs_rel[:, :, -1, :], valid, impl)

    def generator_forward(self, obs: torch.Tensor, obs_rel: torch.Tensor,
                          group_end: torch.Tensor, valid: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          user_noise: Optional[torch.Tensor] = None,
                          impl: str = "scan") -> torch.Tensor:
        """One stochastic forward pass -> pred_rel [S, N, Tp, 2]:
        :meth:`generator_context` then :meth:`generator_sample`."""
        ctx = self.generator_context(obs, obs_rel, group_end, valid, impl)
        return self.generator_sample(ctx, obs_rel, valid, generator,
                                     user_noise, impl)

    def generator_sample_many(self, noise_input: torch.Tensor,
                              obs_rel: torch.Tensor, valid: torch.Tensor,
                              num_samples: int,
                              generator: Optional[torch.Generator] = None,
                              user_noises: Optional[torch.Tensor] = None,
                              impl: str = "scan") -> torch.Tensor:
        """All K best-of-k samples in ONE decoder pass -> rel predictions
        [K, S, N, Tp, 2]: each sample's noise is concatenated to the shared
        context, then the scene axis is tiled K-fold into ``[K·S, N]`` rows
        (scenes are independent in the decoder). ``user_noises``
        ``[K, S, N, nd]`` replaces the internal draws."""
        cfg = self.cfg
        K = num_samples
        S, N = valid.shape
        h = noise_input[None].expand(K, *noise_input.shape)
        if cfg.noise_first_dim:
            z = user_noises
            if z is None:
                z = sample_noises(cfg, K, S, N, generator, noise_input.device)
            h = torch.cat([h, z.to(noise_input.dtype)], dim=-1)

        def tile(t):
            return t[None].expand(K, *t.shape).reshape(K * S, *t.shape[1:])

        pred = _decode_folded(self.decoder.tree(), cfg,
                              h.reshape(K * S, N, -1),
                              tile(obs_rel[:, :, -1, :]), tile(valid), impl)
        return pred.reshape(K, S, N, cfg.pred_len, 2)


def sample_noises(cfg: ModelConfig, K: int, S: int, N: int,
                  generator: Optional[torch.Generator] = None, device=None,
                  dtype=torch.float32) -> Optional[torch.Tensor]:
    """The noise all K samples decode with -> [K, S, N, nd] (None when
    noise_dim is 0): one vector per scene repeated over its peds
    ('global'), or one per ped ('ped')."""
    nd = cfg.noise_first_dim
    if not nd:
        return None
    if cfg.noise_mix_type == "global":
        z = get_noise((K, S, nd), cfg.noise_type, generator, device, dtype)
        return z[:, :, None, :].expand(K, S, N, nd)
    return get_noise((K, S, N, nd), cfg.noise_type, generator, device, dtype)


def _encode(enc: dict, traj_rel: torch.Tensor, impl: str = "scan"
            ) -> torch.Tensor:
    """Linear(2→emb) then the LSTM over time; returns the final h
    [S, N, H] (reference Encoder, models.py:32-92). On the scan route the
    embedding is folded into the LSTM's input gates (exact algebra, no
    embedded-input or gx slab); on the other routes it is a Linear and the
    recurrence is :func:`lstm_scan` with that ``impl``, as in the JAX
    package, so the two routes differ in the last bits."""
    S, N, T, _ = traj_rel.shape
    se, lstm = enc["spatial_embedding"], enc["lstm"]
    if impl != "scan":
        emb = linear(se, traj_rel)                            # [S, N, T, E]
        xs = emb.reshape(S * N, T, -1).transpose(0, 1)        # [T, S·N, E]
        _, (h_t, _) = lstm_scan({k: v.float() for k, v in lstm.items()}, xs,
                                impl=impl)
        return h_t.reshape(S, N, -1)
    w_ih = lstm["w_ih"].float()
    w_comp = se["w"].float() @ w_ih                          # [2, 4H]
    b_comp = (se["b"].float() @ w_ih + lstm["b_ih"].float()
              + lstm["b_hh"].float())
    xs = traj_rel.reshape(S * N, T, 2).transpose(0, 1)        # [T, S·N, 2]
    h_t, _ = encoder_recurrence(w_comp, b_comp, lstm["w_hh"].float(), xs)
    return h_t.reshape(S, N, -1)


def _decode_folded(dec: dict, cfg: ModelConfig, h0: torch.Tensor,
                   last_pos_rel: torch.Tensor, valid: torch.Tensor,
                   impl: str = "scan") -> torch.Tensor:
    """The decoder with its sequential depth collapsed (exact algebra):

        gates_t = h_{t-1} @ W_eff + b_eff
        W_eff   = W_hh + W_p W_e W_ih
        b_eff   = (b_p W_e + b_e) W_ih + b_ih + b_hh

    composed fresh on each call (so autograd reaches the original
    parameters), in ``h0``'s dtype. Step 1 uses the observed last relative
    displacement. With ``impl='fused'`` steps 2..T run in the whole-loop
    kernel, which works and answers in float32 whatever ``h0``'s dtype
    (state and bias are upcast, as the JAX package's kernel does), and
    hidden2pos is one matmul over the stacked states. Returns pred_rel
    [S, N, T, 2], zero at invalid peds."""
    S, N, H = h0.shape
    T = cfg.pred_len
    dt = h0.dtype
    w_e = dec["spatial_embedding"]["w"].to(dt)
    b_e = dec["spatial_embedding"]["b"].to(dt)
    w_p = dec["hidden2pos"]["w"].to(dt)
    b_p = dec["hidden2pos"]["b"].to(dt)
    lstm = dec["lstm"]
    w_ih, w_hh = lstm["w_ih"].to(dt), lstm["w_hh"].to(dt)
    w_r = w_e @ w_ih                                          # [2, 4H]
    b_1 = b_e @ w_ih + lstm["b_ih"].to(dt) + lstm["b_hh"].to(dt)
    w_eff = w_hh + w_p @ w_r                                  # [H, 4H]
    b_eff = b_p @ w_r + b_1
    h1, c1, rel1 = decoder_first_step(w_r, b_1, w_hh, w_p, b_p,
                                      last_pos_rel.to(dt).reshape(S * N, 2),
                                      h0.reshape(S * N, H))
    rels = rel1[None]                                         # [1, S·N, 2]
    if T > 1 and impl == "fused":
        ys = decoder_recurrence_fused(w_eff, b_eff, h1, c1, T - 1)
        rest = ys @ w_p.float() + b_p.float()                 # float32
        rels = torch.cat([rels.float(), rest], dim=0)         # [T, S·N, 2]
    elif T > 1:
        rest = decoder_proj_recurrence(w_eff, b_eff, w_p, b_p, h1, c1, T - 1)
        rels = torch.cat([rels, rest], dim=0)                 # [T, S·N, 2]
    pred_rel = rels.transpose(0, 1).reshape(S, N, T, 2)
    return pred_rel * valid[..., None, None]
