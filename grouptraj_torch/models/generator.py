"""TrajectoryGenerator: LSTM encoder → social pooling → group graph module
→ noise → LSTM decoder, scene-padded dense (counterpart of
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
the scan route's folded recurrence, as in the JAX package). Covered: all
five presets — pool_net, gcn or no pooling; the ``gat``, ``gat-mh`` or
``gcn`` graph module, or none with ``mlp_decoder_context``; and the
``pool_every_timestep`` decoder, which re-pools the decoder's state at
every step (:func:`_decode_stepwise`, on every route); and every MLP
option: batch_norm (on the batch's statistics, in evaluation too), the
``'leakyrelu'`` and ``'none'`` activations, ``dropout`` and the GAT's
``dropout1``.

``nn.Module.train()``/``.eval()`` is the JAX package's ``train=`` flag: in
training mode dropout takes its keep-masks from the ``masks`` argument of
the forward functions (an :class:`~grouptraj_torch.ops.linear.KeepMasks`;
left None, they are drawn from the device's default generator), in eval
mode nothing is dropped. One forward asks for its masks in the JAX
package's order of ``jax.random.bernoulli`` calls.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.modules import (
    GATEncoder, GATEncoderMH, GCNModule, GCNPooling, gat_encoder,
    gat_encoder_mh, gcn_module, gcn_pooling,
)
from grouptraj_torch.ops.cuda_lstm import decoder_recurrence_fused
from grouptraj_torch.ops.linear import (
    DrawnMasks, KeepMasks, linear, mlp_forward,
)
from grouptraj_torch.ops.lstm import (
    decoder_first_step, decoder_proj_recurrence, encoder_recurrence,
    lstm_cell, lstm_scan,
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
    """The decoder's weights; with ``pool_every_timestep`` also its own
    ``pool_net`` over the decoder state and the ``mlp`` that mixes the
    pooled vector back into it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, H = cfg.embedding_dim, cfg.decoder_h_dim_g
        self.spatial_embedding = nn.Linear(2, E)
        self.decoder = LSTMWeights(E, H)
        self.hidden2pos = nn.Linear(H, 2)
        if cfg.pool_every_timestep:
            self.pool_net = _pool_net(cfg, H)
            self.mlp = _mlp([H + cfg.bottleneck_dim, cfg.mlp_dim, H],
                            cfg.batch_norm, cfg.activation)

    def tree(self) -> dict:
        p = {"spatial_embedding": _lin(self.spatial_embedding),
             "lstm": self.decoder.tree(),
             "hidden2pos": _lin(self.hidden2pos)}
        if hasattr(self, "pool_net"):
            p["pool_net"] = self.pool_net.tree()
            p["mlp"] = _mlp_tree(self.mlp)
        return p


class BatchNormWeights(nn.Module):
    """The four tensors of a ``BatchNorm1d`` under its own names: ``weight``
    (the JAX package's ``bn_scale``, ones) and ``bias`` (``bn_bias``,
    zeros), and the buffers ``running_mean``/``running_var``, which stay 0
    and 1 and are never read (BatchNorm runs on the batch's statistics)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))


_ACTIVATIONS = {"relu": nn.ReLU, "leakyrelu": nn.LeakyReLU, "none": nn.Identity}


def _mlp(dims, batch_norm: bool = False, activation: str = "relu"
         ) -> nn.Sequential:
    """make_mlp layout as the JAX package exports it: Linear, BatchNorm1d
    (with batch_norm), activation a layer, so the Linear keys are .0, .2,
    ... or with batch_norm .0, .3, ... and the BatchNorm keys .1, .4, ...
    Dropout adds no entry."""
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        layers.append(nn.Linear(d_in, d_out))
        if batch_norm:
            layers.append(BatchNormWeights(d_out))
        layers.append(_ACTIVATIONS[activation]())
    return nn.Sequential(*layers)


def _mlp_tree(seq: nn.Sequential) -> dict:
    layers = []
    for m in seq:
        if isinstance(m, nn.Linear):
            layers.append({"linear": _lin(m)})
        elif isinstance(m, BatchNormWeights):
            layers[-1]["bn_scale"], layers[-1]["bn_bias"] = m.weight, m.bias
    return {"layers": layers}


def keep_masks(module: nn.Module, cfg: ModelConfig,
               masks: Optional[KeepMasks]) -> Optional[KeepMasks]:
    """The mask source a forward of ``module`` uses: None in eval mode or
    without dropout, else ``masks`` or, left None, draws from the device's
    default generator."""
    if not module.training or not (cfg.dropout or cfg.dropout1):
        return None
    return DrawnMasks() if masks is None else masks


class _PoolHiddenNet(nn.Module):
    def __init__(self, embedding_dim: int, h_dim: int, bottleneck_dim: int,
                 batch_norm: bool = False, activation: str = "relu"):
        super().__init__()
        self.spatial_embedding = nn.Linear(2, embedding_dim)
        self.mlp_pre_pool = _mlp([embedding_dim + h_dim, 512, bottleneck_dim],
                                 batch_norm, activation)

    def tree(self) -> dict:
        return {"spatial_embedding": _lin(self.spatial_embedding),
                "mlp_pre_pool": _mlp_tree(self.mlp_pre_pool)}


def _pool_net(cfg: ModelConfig, h_dim: int) -> nn.Module:
    """The pool-net of ``cfg.pooling_type`` over states of width h_dim."""
    if cfg.pooling_type == "gcn":
        return GCNPooling(cfg.embedding_dim, h_dim, cfg.gcn_hidden_dim,
                          cfg.bottleneck_dim, cfg.gcn_layers)
    return _PoolHiddenNet(cfg.embedding_dim, h_dim, cfg.bottleneck_dim,
                          cfg.batch_norm, cfg.activation)


def _pooling(cfg: ModelConfig) -> bool:
    return cfg.pooling_type not in (None, "none")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.activation not in _ACTIVATIONS:
        raise ValueError(f"activation={cfg.activation!r}")
    if cfg.pooling_type not in (None, "none", "pool_net", "gcn"):
        raise ValueError(f"pooling_type={cfg.pooling_type!r}")
    if cfg.pool_every_timestep and not _pooling(cfg):
        raise ValueError("pool_every_timestep needs a pooling_type "
                         "('pool_net' or 'gcn'), got 'none'")
    if cfg.graph_module not in ("gat", "gat-mh", "gcn", "none"):
        raise ValueError(f"graph_module={cfg.graph_module!r}")


def _mlp_decoder_needed(cfg: ModelConfig) -> bool:
    """reference models.py:852-859."""
    return bool(cfg.noise_first_dim) or _pooling(cfg) or (
        cfg.encoder_h_dim_g != cfg.decoder_h_dim_g)


class TrajectoryGenerator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.encoder = _Encoder(cfg.embedding_dim, cfg.encoder_h_dim_g)
        self.decoder = _Decoder(cfg)
        if _pooling(cfg):
            self.pool_net = _pool_net(cfg, cfg.encoder_h_dim_g)
        if cfg.graph_module == "gat":
            self.gatencoder = GATEncoder(cfg.context_dim, cfg.hidden_units,
                                         cfg.graph_out_dim,
                                         cfg.decoder_context_dim, cfg.n_heads)
        elif cfg.graph_module == "gcn":
            self.gcn_module = GCNModule(cfg.context_dim, cfg.gcn_hidden_dim,
                                        cfg.graph_out_dim, cfg.gcn_layers,
                                        cfg.decoder_context_dim)
        elif cfg.graph_module == "gat-mh":
            self.gatencoder = GATEncoderMH(cfg.mh_n_units, cfg.mh_n_heads)
            self.mlp_decoder_context = _mlp(
                [cfg.mh_n_units[-1], cfg.mlp_dim, cfg.decoder_context_dim],
                cfg.batch_norm, cfg.activation)
        elif cfg.mlp_decoder_context:   # gcn-pool, sgan-p, sgan
            self.mlp_decoder_context = _mlp(
                [cfg.context_dim, cfg.mlp_dim, cfg.decoder_context_dim],
                cfg.batch_norm, cfg.activation)

    def tree(self) -> dict:
        """The parameters as the JAX package's tree (views, no copies)."""
        p = {"encoder": self.encoder.tree(),
             "decoder": self.decoder.tree()}
        for name in ("pool_net", "gatencoder", "gcn_module"):
            if hasattr(self, name):
                p[name] = getattr(self, name).tree()
        if hasattr(self, "mlp_decoder_context"):
            p["mlp_decoder_context"] = _mlp_tree(self.mlp_decoder_context)
        return p

    def generator_context(self, obs: torch.Tensor, obs_rel: torch.Tensor,
                          group_end: torch.Tensor, valid: torch.Tensor,
                          impl: str = "scan",
                          masks: Optional[KeepMasks] = None) -> torch.Tensor:
        """Encoder → pooling → graph module -> noise_input [S, N,
        decoder_h − noise]; without dropout in training computed once and
        shared by all best-of-k samples. obs and obs_rel are [S, N, To, 2],
        group_end and valid [S, N]. ``masks``: the training mask source
        (:func:`keep_masks`)."""
        cfg, p = self.cfg, self.tree()
        masks = keep_masks(self, cfg, masks)
        final_h = _encode(p["encoder"], obs_rel, impl)        # [S, N, He]
        ctx = final_h
        if _pooling(cfg):
            pool_h = _pool(p["pool_net"], cfg, final_h, obs[:, :, -1, :],
                           obs_rel[:, :, -1, :], group_end, valid, masks)
            ctx = torch.cat([final_h, pool_h], dim=-1)        # [S, N, He+B]
        if not _mlp_decoder_needed(cfg):
            return ctx
        if cfg.graph_module == "gat":
            return gat_encoder(p["gatencoder"], ctx, group_end, valid,
                               cfg.alpha, cfg.dropout1, masks)
        if cfg.graph_module == "gcn":
            return gcn_module(p["gcn_module"], ctx, group_end, valid)
        if cfg.graph_module == "gat-mh":
            ctx = gat_encoder_mh(p["gatencoder"], ctx, group_end, valid,
                                 cfg.alpha, cfg.mh_adj, cfg.mh_concat,
                                 cfg.mh_norm, cfg.dropout1, masks)
        elif not cfg.mlp_decoder_context:
            return ctx
        return mlp_forward(p["mlp_decoder_context"], ctx, cfg.activation,
                           cfg.batch_norm, cfg.dropout, mask=valid,
                           masks=masks)

    def generator_sample(self, noise_input: torch.Tensor,
                         obs_rel: torch.Tensor, valid: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         user_noise: Optional[torch.Tensor] = None,
                         impl: str = "scan", *,
                         obs: Optional[torch.Tensor] = None,
                         group_end: Optional[torch.Tensor] = None,
                         masks: Optional[KeepMasks] = None
                         ) -> torch.Tensor:
        """One sample: noise concat + decode -> pred_rel [S, N, Tp, 2] in
        ``noise_input``'s dtype (float32 with ``impl='fused'``), × valid.
        ``user_noise`` ``[S, N, nd]`` replaces the internal draw. ``obs``
        [S, N, To, 2] and ``group_end`` [S, N] are what the
        ``pool_every_timestep`` decoder pools on (required there, unused
        otherwise); ``masks`` feeds that decoder's dropout."""
        cfg = self.cfg
        S, N = valid.shape
        h = noise_input
        if cfg.noise_first_dim:
            z = user_noise
            if z is None:
                z = sample_noises(cfg, 1, S, N, generator,
                                  noise_input.device)[0]
            h = torch.cat([h, z.to(noise_input.dtype)], dim=-1)
        return _decode(self.decoder.tree(), cfg, h, obs_rel[:, :, -1, :],
                       valid, impl, _last(obs), group_end,
                       keep_masks(self, cfg, masks))

    def generator_forward(self, obs: torch.Tensor, obs_rel: torch.Tensor,
                          group_end: torch.Tensor, valid: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          user_noise: Optional[torch.Tensor] = None,
                          impl: str = "scan",
                          masks: Optional[KeepMasks] = None) -> torch.Tensor:
        """One stochastic forward pass -> pred_rel [S, N, Tp, 2]:
        :meth:`generator_context` then :meth:`generator_sample`, one mask
        source for both."""
        masks = keep_masks(self, self.cfg, masks)
        ctx = self.generator_context(obs, obs_rel, group_end, valid, impl,
                                     masks)
        return self.generator_sample(ctx, obs_rel, valid, generator,
                                     user_noise, impl, obs=obs,
                                     group_end=group_end, masks=masks)

    def generator_sample_many(self, noise_input: torch.Tensor,
                              obs_rel: torch.Tensor, valid: torch.Tensor,
                              num_samples: int,
                              generator: Optional[torch.Generator] = None,
                              user_noises: Optional[torch.Tensor] = None,
                              impl: str = "scan", *,
                              obs: Optional[torch.Tensor] = None,
                              group_end: Optional[torch.Tensor] = None,
                              masks: Optional[KeepMasks] = None
                              ) -> torch.Tensor:
        """All K best-of-k samples in ONE decoder pass -> rel predictions
        [K, S, N, Tp, 2]: each sample's noise is concatenated to the shared
        context, then the scene axis is tiled K-fold into ``[K·S, N]`` rows
        (scenes are independent in the decoder but for BatchNorm, whose
        statistics then span all K samples, as in the JAX package).
        ``user_noises`` ``[K, S, N, nd]`` replaces the internal draws.
        ``obs`` and ``group_end`` as in :meth:`generator_sample`, tiled
        K-fold like ``valid``; the per-step decoder's dropout masks (from
        ``masks``) are drawn at the tiled shape, shared by the samples as
        the JAX package shares their keys."""
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
            if t is None:
                return None
            return t[None].expand(K, *t.shape).reshape(K * S, *t.shape[1:])

        pred = _decode(self.decoder.tree(), cfg, h.reshape(K * S, N, -1),
                       tile(obs_rel[:, :, -1, :]), tile(valid), impl,
                       tile(_last(obs)), tile(group_end),
                       keep_masks(self, cfg, masks))
        return pred.reshape(K, S, N, cfg.pred_len, 2)


def _last(obs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if obs is None else obs[:, :, -1, :]


def _pool(params: dict, cfg: ModelConfig, h: torch.Tensor,
          end_pos: torch.Tensor, last_rel: torch.Tensor,
          labels: torch.Tensor, valid: torch.Tensor,
          masks: Optional[KeepMasks] = None) -> torch.Tensor:
    """The pool-net of ``cfg.pooling_type``: PoolHiddenNet anchored at the
    absolute positions ``end_pos`` (through kernel K1 on CUDA tensors with
    ``pool_impl='auto'``), or GCNPooling on the relative step ``last_rel``
    and the group labels -> [S, N, bottleneck]."""
    if cfg.pooling_type == "gcn":
        return gcn_pooling(params, h, last_rel, labels, valid)
    return pool_hidden_net(params, h, end_pos, valid, cfg.activation,
                           cfg.batch_norm, cfg.dropout, masks,
                           impl=cfg.pool_impl)


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


def _decode(dec: dict, cfg: ModelConfig, h0: torch.Tensor,
            last_pos_rel: torch.Tensor, valid: torch.Tensor, impl: str,
            last_pos: Optional[torch.Tensor],
            group_end: Optional[torch.Tensor],
            masks: Optional[KeepMasks] = None) -> torch.Tensor:
    """The decoder (reference Decoder, models.py:95-178): folded without
    per-step re-pooling, stepwise with it (``impl`` then changes nothing,
    as in the JAX package)."""
    if not cfg.pool_every_timestep:
        return _decode_folded(dec, cfg, h0, last_pos_rel, valid, impl)
    if last_pos is None or group_end is None:
        raise ValueError("pool_every_timestep decodes from the last "
                         "absolute positions and the group labels: pass "
                         "obs= and group_end=")
    return _decode_stepwise(dec, cfg, h0, last_pos, last_pos_rel, group_end,
                            valid, masks)


def _decode_stepwise(dec: dict, cfg: ModelConfig, h0: torch.Tensor,
                     last_pos: torch.Tensor, last_pos_rel: torch.Tensor,
                     group_end: torch.Tensor, valid: torch.Tensor,
                     masks: Optional[KeepMasks] = None) -> torch.Tensor:
    """The ``pool_every_timestep`` decoder, one step at a time in ``h0``'s
    dtype (``grouptraj/models/generator.py:_decode``). Carry (h, c, pos,
    rel); a step embeds rel, runs the LSTM cell, projects h to the new rel,
    moves pos by it, pools the ``[S, N, H]`` state at the NEW absolute
    positions (GCNPooling: at the new rel, with the group labels) and
    replaces h — not c — by ``decoder.mlp(h ‖ pool_h)``, the MLP's trailing
    ReLU kept; with ``masks`` each step's pool, then its MLP, draw their
    dropout masks. The pool runs in float32 whatever the decoder's dtype (its
    kernel K1 takes float32 a/u) and its result is cast back. Returns
    pred_rel [S, N, T, 2], zero at invalid peds."""
    S, N, H = h0.shape
    dt = h0.dtype
    lstm = {k: v.to(dt) for k, v in dec["lstm"].items()}
    h = h0.reshape(S * N, H)
    c = torch.zeros_like(h)
    pos = last_pos.to(dt).reshape(S * N, 2)
    rel = last_pos_rel.to(dt).reshape(S * N, 2)
    rels = []
    for _ in range(cfg.pred_len):
        h, c = lstm_cell(lstm, linear(dec["spatial_embedding"], rel), h, c)
        rel = linear(dec["hidden2pos"], h)
        pos = pos + rel
        hs = h.reshape(S, N, H)
        pool_h = _pool(dec["pool_net"], cfg, hs.float(),
                       pos.reshape(S, N, 2).float(),
                       rel.reshape(S, N, 2).float(), group_end, valid, masks)
        h = mlp_forward(dec["mlp"], torch.cat([hs, pool_h.to(dt)], dim=-1),
                        cfg.activation, cfg.batch_norm, cfg.dropout,
                        mask=valid, masks=masks).reshape(S * N, H)
        rels.append(rel)
    pred_rel = torch.stack(rels, dim=1).reshape(S, N, cfg.pred_len, 2)
    return pred_rel * valid[..., None, None]


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
