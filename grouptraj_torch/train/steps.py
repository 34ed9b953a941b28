"""GAN training steps: alternating discriminator / generator updates
(counterpart of ``grouptraj/train/steps.py``; reference
``scripts/train.py:395-484``).

- the best-of-k variety loss decodes all k samples in one scene-tiled pass
  and, on the sparse path, re-decodes with grad only the per-scene argmin
  sample and the last sample;
- like the reference, the g-step feeds the discriminator the LAST of the k
  samples;
- the optimizer is clip-by-global-norm then Adam, with the clip written as
  optax writes it (``g / norm * clip`` when ``norm >= clip``), not as
  ``torch.nn.utils.clip_grad_norm_`` does (it divides by ``norm + 1e-6``);
- every random draw can be injected: the sample noise, the U(0.7, 1.2)
  label-smoothing scalar and dropout's keep-masks (in the JAX package's
  order of ``jax.random.bernoulli`` calls). Without an injected value a
  step draws from the ``torch.Generator`` it is given;
- with dropout (``dropout`` or ``dropout1``) the g-step runs the
  per-sample forward, as the JAX package does: each of the k samples its
  own context, ``generator_forward`` under ``torch.func.vmap`` over the
  samples' noise and masks, every draw made outside the vmap;
- with batch_norm the d-step scores fake and real in two discriminator
  calls (their batch statistics apart), else in one stacked call;
- the steps run G and D in training mode and the metric pass in eval
  mode (``nn.Module.train()``/``.eval()``, the JAX package's ``train=``),
  whatever mode the modules were in;
- every step takes ``impl``, the LSTM route of all its recurrences
  (``ops/lstm.py``: ``'scan'``, ``'fused'``, the whole-loop kernels, or
  ``'pallas'``, the projection-in-kernel encoders);
  left None it is ``select_impl(cfg, tcfg)``, i.e. ``tcfg.lstm_impl``;
- under data parallelism (a group installed, ``parallel/mesh.py``) a step
  runs on this rank's scenes: every draw is made (or injected) at the
  global batch's shape and sliced to them, the losses' normalisers and
  BatchNorm's statistics are global, and the gradients and loss values are
  summed over the ranks in one all-reduce before the clip; the metric
  sweep sums its sums over the ranks. The seed-stacked steps of
  ``train_many`` do the same on each rank's shard: the all-reduce sums the
  stacked gradients ``[N, ...]`` outside the seed vmap, before each
  replica's clip.

A step mutates the models and optimizers of its :class:`TrainState` in
place and returns the losses as device tensors under the JAX package's
names; nothing inside a step reads a value back to the host.

The metric pass (reference ``train.py:487-568``) is
:func:`make_check_accuracy_step` — one sample of the generator and the
discriminator's scores on real and fake, as raw sums — its sweep over a
device-resident dataset (:func:`make_check_accuracy_sweep`, the sums
accumulated on the device), :func:`summarize_check_accuracy`, the
reference's normalisers, and :func:`check_accuracy`, the loader variant.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from grouptraj_torch import losses as L
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import (
    LSTMWeights, TrajectoryGenerator, sample_noises,
)
from grouptraj_torch.models.modules import GCN, GATLayer
from grouptraj_torch.ops.linear import (
    DrawnMasks, InjectedMasks, KeepMasks, ShapeRecorder, as_mask,
    sharded_masks,
)
from grouptraj_torch.ops.lstm import select_impl
from grouptraj_torch.parallel.mesh import (
    all_reduce_grads, global_scenes, set_dp_group, shard_draw,
)
from grouptraj_torch.train.device_data import gather_batch
from grouptraj_torch.utils import relative_to_abs, resolve_device

Batch = Dict[str, torch.Tensor]
Label = Union[float, torch.Tensor, None]
# injected keep-masks: a KeepMasks, or the masks (arrays or tensors) in the
# order a forward asks for them
Masks = Union[KeepMasks, Sequence, None]
# a sweep's injected draws: (batch index, S, N) -> (noise [S, N, nd] or
# None, label-smoothing scalar)
SweepDraws = Callable[[int, int, int], Tuple[Optional[torch.Tensor], Label]]


@dataclasses.dataclass
class TrainState:
    g: TrajectoryGenerator
    d: TrajectoryDiscriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    # EMA of the generator's parameters (by state-dict name) when
    # TrainConfig.g_ema_decay > 0, else None
    ema_g: Optional[Dict[str, torch.Tensor]] = None


def make_optimizers(g: nn.Module, d: nn.Module, tcfg: TrainConfig):
    """Adam with torch's defaults (betas 0.9/0.999, eps 1e-8 outside the
    root: the same update as ``optax.adam``); the clip is applied to the
    gradients by :func:`clip_by_global_norm` before each step."""
    return (torch.optim.Adam(g.parameters(), lr=tcfg.g_learning_rate),
            torch.optim.Adam(d.parameters(), lr=tcfg.d_learning_rate))


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation drawn from ``generator``: every
    Linear weight Kaiming-normal with torch's default bias, every LSTM
    tensor U(±1/√H), GAT tensors Xavier-uniform with gain 1.414, GCN
    weights standard normal."""
    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator, device=p.device)
                 * 2.0 - 1.0) * bound)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                d_in = m.in_features
                m.weight.copy_(torch.randn(
                    m.weight.shape, generator=generator,
                    device=m.weight.device) * math.sqrt(2.0 / d_in))
                uniform_(m.bias, 1.0 / math.sqrt(d_in))
            elif isinstance(m, LSTMWeights):
                for p in m.parameters():
                    uniform_(p, 1.0 / math.sqrt(m.weight_hh_l0.shape[1]))
            elif isinstance(m, GATLayer):
                for p in (m.W, m.a):
                    uniform_(p, 1.414 * math.sqrt(6.0 / sum(p.shape)))
            elif isinstance(m, GCN):
                for p in m.W:
                    p.copy_(torch.randn(p.shape, generator=generator,
                                        device=p.device))


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device: Union[str, torch.device, None] = None
                     ) -> TrainState:
    """Fresh G, D and optimizers on ``device`` (default ``cuda``), the
    weights drawn from ``generator`` (a generator of that device; default a
    new one seeded with ``tcfg.seed``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(tcfg.seed)
    g = TrajectoryGenerator(cfg).to(dev)
    d = TrajectoryDiscriminator(cfg).to(dev)
    init_parameters(g, generator)
    init_parameters(d, generator)
    return train_state_from_modules(g, d, tcfg)


def train_state_from_modules(g: TrajectoryGenerator,
                             d: TrajectoryDiscriminator, tcfg: TrainConfig
                             ) -> TrainState:
    """A state around existing modules with fresh (zero) Adam moments."""
    g_opt, d_opt = make_optimizers(g, d, tcfg)
    ema = None
    if tcfg.g_ema_decay > 0:
        ema = {k: v.detach().clone() for k, v in g.named_parameters()}
    return TrainState(g, d, g_opt, d_opt, ema)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g * g).sum() for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                        clip: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: unchanged while ``norm < clip``, else
    ``g / norm * clip``. Decided on the device."""
    if not clip or clip <= 0:
        return list(grads)
    return [torch.where(norm < clip, g, g / norm * clip) for g in grads]


def _apply(opt: torch.optim.Optimizer, params: Sequence[nn.Parameter],
           grads: Sequence[torch.Tensor], clip: float) -> torch.Tensor:
    """Clip, hand the gradients to the optimizer, step. Returns the
    unclipped global norm."""
    norm = global_norm(grads)
    for p, g in zip(params, clip_by_global_norm(grads, norm, clip)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)
    return norm


def _label(label: Label, generator, device) -> Union[float, torch.Tensor]:
    """The label-smoothing scalar y ~ U(0.7, 1.2), drawn unless injected."""
    if label is not None:
        return label
    return 0.7 + 0.5 * torch.rand((), generator=generator, device=device)


def _trajs(b: Batch, pred_rel_fake: torch.Tensor):
    """Full real/fake (abs, rel) trajectories [S, N, To+Tp, 2]."""
    pred_abs_fake = relative_to_abs(pred_rel_fake, b["obs"][:, :, -1, :])
    return (torch.cat([b["obs"], b["pred"]], dim=2),
            torch.cat([b["obs_rel"], b["pred_rel"]], dim=2),
            torch.cat([b["obs"], pred_abs_fake], dim=2),
            torch.cat([b["obs_rel"], pred_rel_fake], dim=2))


@contextlib.contextmanager
def _mode(training: bool, *modules: nn.Module):
    """Run with ``modules`` in training (or eval) mode, then restore."""
    was = [m.training for m in modules]
    for m in modules:
        m.train(training)
    try:
        yield
    finally:
        for m, w in zip(modules, was):
            m.train(w)


def _dropout(cfg: ModelConfig) -> bool:
    return bool(cfg.dropout or cfg.dropout1)


def mask_source(cfg: ModelConfig, generator: Optional[torch.Generator],
                masks: Masks = None) -> Optional[KeepMasks]:
    """The keep-mask source of a training forward: injected masks (a
    sequence, in the order the forward asks) or a :class:`KeepMasks` as
    given, else draws from ``generator``; None without dropout."""
    if not _dropout(cfg):
        return None
    if masks is None:
        return DrawnMasks(generator)
    return masks if isinstance(masks, KeepMasks) else InjectedMasks(masks)


def d_step(state: TrainState, batch: Batch, cfg: ModelConfig,
           tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None, label: Label = None,
           impl: Optional[str] = None, masks: Masks = None
           ) -> Dict[str, torch.Tensor]:
    """Discriminator step (reference ``train.py:395-429``): the loss and
    gradients of :func:`d_gradients`, then clip and Adam on D."""
    losses, grads = d_gradients(state, batch, cfg, tcfg, generator, noise,
                                label, impl, masks)
    losses["norm_d"] = _apply(state.d_opt, list(state.d.parameters()), grads,
                              tcfg.clipping_threshold_d)
    return losses


def d_gradients(state: TrainState, batch: Batch, cfg: ModelConfig,
                tcfg: TrainConfig,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, label: Label = None,
                impl: Optional[str] = None, masks: Masks = None):
    """The d-step's losses and the gradient of each of D's parameters (in
    ``state.d.parameters()`` order), nothing updated. ``noise``
    ``[S, N, noise_dim]``, ``label`` (the U(0.7, 1.2) scalar) and
    ``masks`` (the keep-masks of the generator leg, then of D's calls)
    replace the draws from ``generator``."""
    impl = select_impl(cfg, tcfg) if impl is None else impl
    kw = d_draws(cfg, *batch["valid"].shape, generator, batch["valid"].device,
                 noise, label)
    data_loss = d_loss(state.g, state.d, batch, cfg, tcfg, impl=impl,
                       masks=mask_source(cfg, generator, masks), **kw)
    grads = torch.autograd.grad(data_loss, list(state.d.parameters()))
    *grads, data_loss = all_reduce_grads([*grads, data_loss.detach()])
    return {"D_data_loss": data_loss, "D_total_loss": data_loss}, grads


def d_draws(cfg: ModelConfig, S: int, N: int,
            generator: Optional[torch.Generator], device,
            noise: Optional[torch.Tensor] = None, label: Label = None
            ) -> dict:
    """A d-step's draws, in the order a step takes them from ``generator``
    (the sample noise ``[S, N, nd]``, then the label-smoothing scalar);
    an injected value is kept and draws nothing. Under data parallelism the
    noise is drawn (or injected) at the global batch's scene count and
    sliced to this rank's ``S``."""
    if noise is None and cfg.noise_first_dim:
        noise = sample_noises(cfg, 1, global_scenes(S), N, generator,
                              device)[0]
    return dict(noise=shard_draw(noise),
                label=_label(label, generator, device))


def d_loss(g: TrajectoryGenerator, d: TrajectoryDiscriminator, b: Batch,
           cfg: ModelConfig, tcfg: TrainConfig,
           noise: Optional[torch.Tensor], label: Union[float, torch.Tensor],
           impl: str, masks: Optional[KeepMasks] = None) -> torch.Tensor:
    """The d-step's loss from its draws (:func:`d_draws`) and its mask
    source (the generator leg's masks, then D's); without dropout it draws
    nothing, so it runs under ``torch.func.vmap``."""
    with _mode(True, g, d):
        return _d_loss(g, d, b, cfg, tcfg, noise, label, impl, masks)


def _d_loss(g, d, b, cfg, tcfg, noise, label, impl, masks):
    S = b["valid"].shape[0]
    g_masks = sharded_masks(masks)
    with torch.no_grad():
        # no gradient flows through the generator here; with bf16_nograd
        # the decode leg runs in bfloat16 (the context stays float32: it
        # feeds the pool kernel; the decode is where the rows are) on the
        # same float32-drawn noise
        ctx = g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                  b["valid"], impl, g_masks)
        at = dict(obs=b["obs"], group_end=b["group"], masks=g_masks)
        if tcfg.bf16_nograd:
            pred_rel_fake = g.generator_sample(
                ctx.bfloat16(), b["obs_rel"].bfloat16(), b["valid"],
                user_noise=noise, impl=impl, **at).float()
        else:
            pred_rel_fake = g.generator_sample(
                ctx, b["obs_rel"], b["valid"], user_noise=noise, impl=impl,
                **at)
    tr, trr, tf, tfr = _trajs(b, pred_rel_fake)
    if cfg.batch_norm:
        # batch statistics couple the scenes of a call: fake, then real
        scores_fake = d(tf, tfr, b["valid"], impl, g_masks)
        scores_real = d(tr, trr, b["valid"], impl, g_masks)
        return L.gan_d_loss(scores_real, scores_fake, label, b["valid"])
    # real and fake scored in ONE stacked forward: scenes are independent
    # rows, so this halves the discriminator's sequential depth; its masks
    # hold a real and a fake block of scenes
    scores = d(torch.cat([tr, tf], dim=0), torch.cat([trr, tfr], dim=0),
               torch.cat([b["valid"], b["valid"]], dim=0), impl,
               sharded_masks(masks, blocks=2))
    return L.gan_d_loss(scores[:S], scores[S:], label, b["valid"])


def g_step(state: TrainState, batch: Batch, cfg: ModelConfig,
           tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
           noises: Optional[torch.Tensor] = None, label: Label = None,
           impl: Optional[str] = None, sample_masks: Optional[Sequence] = None,
           d_masks: Masks = None) -> Dict[str, torch.Tensor]:
    """Generator step (reference ``train.py:432-484``): the losses and
    gradients of :func:`g_gradients`, then clip and Adam on G, then the
    EMA when ``g_ema_decay > 0``."""
    losses, grads = g_gradients(state, batch, cfg, tcfg, generator, noises,
                                label, impl, sample_masks, d_masks)
    losses["norm_g"] = _apply(state.g_opt, list(state.g.parameters()), grads,
                              tcfg.clipping_threshold_g)
    if state.ema_g is not None and tcfg.g_ema_decay > 0:
        decay = tcfg.g_ema_decay
        with torch.no_grad():
            for name, p in state.g.named_parameters():
                state.ema_g[name].mul_(decay).add_(p, alpha=1.0 - decay)
    return losses


def g_gradients(state: TrainState, batch: Batch, cfg: ModelConfig,
                tcfg: TrainConfig,
                generator: Optional[torch.Generator] = None,
                noises: Optional[torch.Tensor] = None, label: Label = None,
                impl: Optional[str] = None,
                sample_masks: Optional[Sequence] = None,
                d_masks: Masks = None):
    """The g-step's losses (best-of-k variety + adversarial) and the
    gradient of each of G's parameters (in ``state.g.parameters()`` order),
    nothing updated. ``noises`` ``[best_k, S, N, noise_dim]``, ``label``,
    ``sample_masks`` (with dropout: per sample, the masks of its
    ``generator_forward`` in order) and ``d_masks`` (D's) replace the
    draws from ``generator``. The losses are :func:`g_loss`'s."""
    impl = select_impl(cfg, tcfg) if impl is None else impl
    S, N = batch["valid"].shape
    dev = batch["valid"].device
    kw = g_draws(cfg, tcfg, S, N, generator, dev, noises, label)
    if _dropout(cfg):
        kw["sample_masks"] = stacked_sample_masks(
            cfg, tcfg.best_k, S, N, generator, dev, sample_masks)
    variety, adv, total = g_loss(
        state.g, state.d, batch, cfg, tcfg, impl=impl,
        d_masks=sharded_masks(mask_source(cfg, generator, d_masks)), **kw)
    # gradients with respect to G only: D's parameters are constants here
    # and their .grad is never touched
    grads = torch.autograd.grad(total, list(state.g.parameters()))
    *grads, variety, adv, total = all_reduce_grads(
        [*grads, variety.detach(), adv.detach(), total.detach()])
    return {"G_l2_loss_rel": variety, "G_discriminator_loss": adv,
            "G_total_loss": total}, grads


def g_draws(cfg: ModelConfig, tcfg: TrainConfig, S: int, N: int,
            generator: Optional[torch.Generator], device,
            noises: Optional[torch.Tensor] = None, label: Label = None
            ) -> dict:
    """A g-step's draws in a step's order: the best-of-k noises
    ``[best_k, S, N, nd]``, then the label-smoothing scalar; under data
    parallelism global and sliced, as :func:`d_draws`'s."""
    if noises is None and cfg.noise_first_dim:
        noises = sample_noises(cfg, tcfg.best_k, global_scenes(S), N,
                               generator, device)
    return dict(noises=shard_draw(noises, axis=1),
                label=_label(label, generator, device))


@contextlib.contextmanager
def _one_device():
    """No data-parallel group within the block: a mask-shape dry run finds
    the shapes of one process's forward on the scenes it is given, whatever
    group is in force (under one, ``ShardedMasks`` would ask for ``world``
    times as many), so its cached answer holds in and out of a group."""
    prev = set_dp_group(None)
    try:
        yield
    finally:
        set_dp_group(prev)


@functools.lru_cache(maxsize=64)
def sample_mask_shapes(cfg: ModelConfig, S: int, N: int
                       ) -> Tuple[Tuple[Tuple[int, ...], float], ...]:
    """The (shape, keep probability) of every keep-mask one training
    ``generator_forward`` of ``cfg`` asks for on ``[S, N]`` scenes, in
    order: a dry run on the ``meta`` device, which computes nothing, with
    no group in force (a rank passes the global batch's ``S``)."""
    with torch.device("meta"):
        g = TrajectoryGenerator(cfg)
        To, nd = cfg.obs_len, cfg.noise_first_dim
        obs = torch.zeros(S, N, To, 2)
        lab, valid = torch.zeros(S, N), torch.ones(S, N)
        z = torch.zeros(S, N, nd) if nd else None
    rec = ShapeRecorder()
    with torch.no_grad(), _one_device():
        g.generator_forward(obs, obs, lab, valid, user_noise=z, masks=rec)
    return tuple(rec.asked)


def _meta_batch(cfg: ModelConfig, S: int, N: int) -> Batch:
    """A training batch of ``[S, N]`` scenes on the ``meta`` device."""
    To, Tp = cfg.obs_len, cfg.pred_len
    with torch.device("meta"):
        obs, pred = torch.zeros(S, N, To, 2), torch.zeros(S, N, Tp, 2)
        return dict(obs=obs, obs_rel=obs, pred=pred, pred_rel=pred,
                    group=torch.zeros(S, N), valid=torch.ones(S, N))


@functools.lru_cache(maxsize=64)
def d_mask_shapes(cfg: ModelConfig, S: int, N: int
                  ) -> Tuple[Tuple[Tuple[int, ...], float], ...]:
    """The (shape, keep probability) of every keep-mask one d-step of
    ``cfg`` asks for on ``[S, N]`` scenes, in order: the generator leg's,
    then D's calls (two with batch_norm, fake then real; else one stacked
    call). A ``meta``-device dry run of :func:`d_loss` with no group in
    force."""
    with torch.device("meta"):
        g, d = TrajectoryGenerator(cfg), TrajectoryDiscriminator(cfg)
        z = (torch.zeros(S, N, cfg.noise_first_dim)
             if cfg.noise_first_dim else None)
    rec = ShapeRecorder()
    with torch.no_grad(), _one_device():
        d_loss(g, d, _meta_batch(cfg, S, N), cfg,
               TrainConfig(bf16_nograd=False), z, 1.0, "scan", rec)
    return tuple(rec.asked)


@functools.lru_cache(maxsize=64)
def disc_mask_shapes(cfg: ModelConfig, S: int, N: int
                     ) -> Tuple[Tuple[Tuple[int, ...], float], ...]:
    """The (shape, keep) of every keep-mask of one training discriminator
    call on ``[S, N]`` scenes (the g-step's), in order; a ``meta`` dry
    run with no group in force."""
    with torch.device("meta"):
        d = TrajectoryDiscriminator(cfg)
    b = _meta_batch(cfg, S, N)
    traj = torch.cat([b["obs"], b["pred"]], dim=2)
    rec = ShapeRecorder()
    with torch.no_grad(), _mode(True, d), _one_device():
        d(traj, traj, b["valid"], "scan", rec)
    return tuple(rec.asked)


def draw_masks(shapes: Sequence[Tuple[Tuple[int, ...], float]],
               generator: Optional[torch.Generator], device,
               masks: Optional[Sequence] = None) -> List[torch.Tensor]:
    """Boolean keep-masks at ``shapes`` ((shape, keep) pairs in a forward's
    order): drawn from ``generator`` mask by mask, as that forward's
    :class:`DrawnMasks` would draw them, or the injected ``masks`` checked
    against the shapes."""
    if masks is not None:
        masks = list(masks)
        if len(masks) != len(shapes):
            raise ValueError(f"{len(masks)} masks injected, the forward "
                             f"asks for {len(shapes)}")
    src = DrawnMasks(generator) if masks is None else InjectedMasks(masks)
    return [src.keep(shape, keep, device) for shape, keep in shapes]


def stacked_sample_masks(cfg: ModelConfig, K: int, S: int, N: int,
                         generator: Optional[torch.Generator], device,
                         sample_masks: Optional[Sequence] = None
                         ) -> List[torch.Tensor]:
    """The per-sample g-step's keep-masks, one ``[K, ...]`` bool tensor a
    mask of the forward: ``sample_masks`` (K sequences of masks, sample by
    sample) stacked, or drawn from ``generator`` at the shapes
    :func:`sample_mask_shapes` finds, mask by mask. Under data parallelism
    both are the global batch's, sliced to this rank's scenes."""
    if sample_masks is not None:
        if len(sample_masks) != K:
            raise ValueError(f"{len(sample_masks)} samples' masks for "
                             f"best_k={K}")
        per = [list(ms) for ms in sample_masks]
        if len({len(ms) for ms in per}) != 1:
            raise ValueError("the samples were given different numbers of "
                             "masks")
        stacked = [torch.stack([as_mask(ms[i], device) for ms in per])
                   for i in range(len(per[0]))]
    else:
        stacked = [torch.rand((K, *shape), generator=generator,
                              device=device) < keep
                   for shape, keep in sample_mask_shapes(
                       cfg, global_scenes(S), N)]
    return [shard_draw(m, axis=1) for m in stacked]


def _per_sample_preds(g: TrajectoryGenerator, b: Batch,
                      noises: Optional[torch.Tensor],
                      sample_masks: List[torch.Tensor], impl: str
                      ) -> torch.Tensor:
    """k training forwards, one context each (the JAX package's vmap of
    ``generator_forward`` over the sample keys): ``torch.func.vmap`` over
    the samples' noise and keep-masks -> [k, S, N, Tp, 2]. K1/K2 run at
    R = k through ``PoolCore.vmap``, the decoder's K3/K4 at k·S·N rows."""
    def one(z, ms):
        return g.generator_forward(b["obs"], b["obs_rel"], b["group"],
                                   b["valid"], user_noise=z, impl=impl,
                                   masks=InjectedMasks(ms))

    return torch.func.vmap(one, in_dims=(None if noises is None else 0, 0))(
        noises, sample_masks)


def g_loss(g: TrajectoryGenerator, d: TrajectoryDiscriminator, b: Batch,
           cfg: ModelConfig, tcfg: TrainConfig,
           noises: Optional[torch.Tensor], label: Union[float, torch.Tensor],
           impl: str, sample_masks: Optional[List[torch.Tensor]] = None,
           d_masks: Optional[KeepMasks] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The g-step's (variety, adversarial, total) losses from its draws
    (:func:`g_draws`, :func:`stacked_sample_masks`) and D's mask source;
    without dropout it draws nothing, so it runs under ``torch.func.vmap``.

    With dropout each sample runs its own forward
    (:func:`_per_sample_preds`) and the variety loss takes all k with
    grad.

    Sparse path (``tcfg.sparse_best_k``): the variety min only propagates
    through the per-scene ARGMIN sample and the adversarial term through
    the last sample, so all k samples decode without grad (in bfloat16 with
    ``bf16_nograd``), then only those two decode again with grad as one
    stacked ``[2S, N]`` batch. The loss value is unchanged and the
    gradients equal the dense path's except at exact per-scene ties. The
    dense path decodes all k with grad; it is taken whenever the decoder
    re-pools at every step (``pool_every_timestep``), as in the JAX
    package."""
    with _mode(True, g, d):
        return _g_loss(g, d, b, cfg, tcfg, noises, label, impl,
                       sample_masks, d_masks)


def _g_loss(g, d, b, cfg, tcfg, noises, label, impl, sample_masks,
            d_masks):
    k = tcfg.best_k
    S, N = b["valid"].shape
    dev = b["valid"].device
    pred_loss_mask = b["loss_mask"][..., cfg.obs_len:]
    share_ctx = not _dropout(cfg)
    sparse = (share_ctx and tcfg.sparse_best_k and tcfg.l2_loss_weight > 0
              and k > 1 and not cfg.pool_every_timestep)

    if share_ctx:
        ctx = g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                  b["valid"], impl)
    if sparse:
        with torch.no_grad():
            if tcfg.bf16_nograd:
                preds_all = g.generator_sample_many(
                    ctx.bfloat16(), b["obs_rel"].bfloat16(), b["valid"], k,
                    user_noises=noises, impl=impl).float()
            else:
                preds_all = g.generator_sample_many(
                    ctx, b["obs_rel"], b["valid"], k, user_noises=noises,
                    impl=impl)
            per_scene, denom = L.variety_l2_parts(
                preds_all, b["pred_rel"], pred_loss_mask, b["valid"],
                tcfg.l2_loss_weight)
            k_star = per_scene.argmin(dim=0)                      # [S]
        cat2 = lambda t: torch.cat([t, t], dim=0)
        z2 = None
        if noises is not None:
            z2 = torch.cat([noises[k_star, torch.arange(S, device=dev)],
                            noises[-1]], dim=0)
        preds2 = g.generator_sample(cat2(ctx), cat2(b["obs_rel"]),
                                    cat2(b["valid"]), user_noise=z2,
                                    impl=impl)
        pred_sel, pred_last = preds2[:S], preds2[S:]
        variety = L.variety_from_scene_l2(
            L.variety_scene_l2(pred_sel, b["pred_rel"], pred_loss_mask,
                               b["valid"], tcfg.l2_loss_weight), denom)
    else:
        if share_ctx:
            preds = g.generator_sample_many(ctx, b["obs_rel"], b["valid"], k,
                                            user_noises=noises, impl=impl,
                                            obs=b["obs"],
                                            group_end=b["group"])
        else:
            preds = _per_sample_preds(g, b, noises, sample_masks, impl)
        variety = L.variety_l2_loss(
            preds, b["pred_rel"], pred_loss_mask, b["valid"],
            tcfg.l2_loss_weight) if tcfg.l2_loss_weight > 0 \
            else preds.new_zeros(())
        pred_last = preds[-1]
    _, _, tf, tfr = _trajs(b, pred_last)
    adv = L.gan_g_loss(d(tf, tfr, b["valid"], impl, d_masks), label,
                       b["valid"])
    return variety, adv, variety + adv


def train_iterations(state: TrainState, data: Dict[str, torch.Tensor],
                     idx: torch.Tensor, cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[dict]] = None,
                     impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Training iterations over a device-resident dataset: ``idx``
    ``[iterations, d_steps + g_steps, S]`` integer scene indices on the
    device; each iteration gathers its batches there and alternates the
    reference's d/g schedule. Returns every loss stacked ``[iterations]``
    (the last step's where ``d_steps`` or ``g_steps`` exceeds one), still
    on the device.

    ``draws``, when given, holds per iteration ``{"d": [...], "g": [...]}``
    with one ``dict(noise=, label=)`` per d-step and one
    ``dict(noises=, label=)`` per g-step — the injected randomness, with
    dropout also the d-step's ``masks`` and the g-step's ``sample_masks``
    and ``d_masks``; else every draw comes from ``generator``."""
    impl = select_impl(cfg, tcfg) if impl is None else impl
    history: List[Dict[str, torch.Tensor]] = []
    for it, bidx in enumerate(idx):
        losses: Dict[str, torch.Tensor] = {}
        for j in range(tcfg.d_steps):
            kw = draws[it]["d"][j] if draws is not None else {}
            losses.update(d_step(state, gather_batch(data, bidx[j],
                                                     cfg.obs_len),
                                 cfg, tcfg, generator, impl=impl, **kw))
        for j in range(tcfg.g_steps):
            kw = draws[it]["g"][j] if draws is not None else {}
            losses.update(g_step(
                state, gather_batch(data, bidx[tcfg.d_steps + j],
                                    cfg.obs_len), cfg, tcfg, generator,
                impl=impl, **kw))
        history.append(losses)
    return {k: torch.stack([h[k] for h in history]) for k in history[0]}


def make_check_accuracy_step(cfg: ModelConfig, impl: str = "scan"
                             ) -> Callable:
    """Per-batch raw sums of the metric pass (reference
    ``train.py:487-568``): ``(state, batch, generator=None, noise=None,
    label=None) -> {name: 0-d device tensor}``. One generator sample (the
    noise ``[S, N, nd]`` and the U(0.7, 1.2) scalar of the D loss drawn
    from ``generator`` unless injected), D's scores on fake and real; the
    caller accumulates the sums and normalises them with
    :func:`summarize_check_accuracy`."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             label: Label = None) -> Dict[str, torch.Tensor]:
        kw = d_draws(cfg, *batch["valid"].shape, generator,
                     batch["valid"].device, noise, label)
        return accuracy_sums(state.g, state.d, batch, cfg, impl=impl, **kw)

    return step


@torch.no_grad()
def accuracy_sums(g: TrajectoryGenerator, d: TrajectoryDiscriminator,
                  b: Batch, cfg: ModelConfig,
                  noise: Optional[torch.Tensor],
                  label: Union[float, torch.Tensor], impl: str
                  ) -> Dict[str, torch.Tensor]:
    """One batch's raw metric sums from its draws (the noise, then the
    label: a d-step's, :func:`d_draws`), G and D in eval mode (no
    dropout); draws nothing, so it runs under ``torch.func.vmap``."""
    with _mode(False, g, d):
        return _accuracy_sums(g, d, b, cfg, noise, label, impl)


def _accuracy_sums(g, d, b, cfg, noise, label, impl):
    valid = b["valid"]
    linear = (1.0 - b["non_linear"]) * valid
    non_linear = b["non_linear"] * valid
    pred_loss_mask = b["loss_mask"][..., cfg.obs_len:]
    pred_rel_fake = g.generator_forward(b["obs"], b["obs_rel"], b["group"],
                                        valid, None, noise, impl)
    pred_abs_fake = relative_to_abs(pred_rel_fake, b["obs"][:, :, -1, :])
    tr, trr, tf, tfr = _trajs(b, pred_rel_fake)
    scores_fake = d(tf, tfr, valid, impl)
    scores_real = d(tr, trr, valid, impl)
    last, gt_last = pred_abs_fake[:, :, -1], b["pred"][:, :, -1]
    return {
        "d_loss": L.gan_d_loss(scores_real, scores_fake, label, valid),
        "g_l2_loss_abs": L.l2_loss(pred_abs_fake, b["pred"], pred_loss_mask,
                                   "sum"),
        "g_l2_loss_rel": L.l2_loss(pred_rel_fake, b["pred_rel"],
                                   pred_loss_mask, "sum"),
        "disp_error": L.displacement_error(pred_abs_fake, b["pred"], valid),
        "disp_error_l": L.displacement_error(pred_abs_fake, b["pred"],
                                             linear),
        "disp_error_nl": L.displacement_error(pred_abs_fake, b["pred"],
                                              non_linear),
        "f_disp_error": L.final_displacement_error(last, gt_last, valid),
        "f_disp_error_l": L.final_displacement_error(last, gt_last, linear),
        "f_disp_error_nl": L.final_displacement_error(last, gt_last,
                                                      non_linear),
        "loss_mask_sum": pred_loss_mask.sum(),
        "total_traj": valid.sum(),
        "total_traj_l": linear.sum(),
        "total_traj_nl": non_linear.sum(),
    }


def make_check_accuracy_sweep(cfg: ModelConfig, impl: str = "scan"
                              ) -> Callable:
    """The whole metric pass over a device-resident dataset: ``(state,
    data, idx, generator=None, draws=None) -> sums``, ``data`` a
    :func:`device_data.device_dataset` dict and ``idx`` ``[n_batches, S]``
    scene indices on the device (tails padded with the null scene, which
    adds exactly zero to every sum). The per-batch sums are added on the
    device in batch order; the caller reads them back once. ``draws``, when
    given, is a :data:`SweepDraws` that replaces batch ``i``'s draws.
    Under data parallelism ``idx`` holds this rank's scenes of each batch,
    ``draws`` is asked for the global batch's and the sums are summed over
    the ranks."""
    raw = make_check_accuracy_step(cfg, impl)

    def sweep(state: TrainState, data: Dict[str, torch.Tensor],
              idx: torch.Tensor, generator: Optional[torch.Generator] = None,
              draws: Optional[SweepDraws] = None) -> Dict[str, torch.Tensor]:
        acc = None
        S, N = idx.shape[1], data["valid"].shape[1]
        for i, bidx in enumerate(idx):
            noise, label = (draws(i, global_scenes(S), N)
                            if draws is not None else (None, None))
            out = raw(state, gather_batch(data, bidx, cfg.obs_len),
                      generator, noise, label)
            acc = out if acc is None else {k: acc[k] + v
                                           for k, v in out.items()}
        return dict(zip(acc, all_reduce_grads(list(acc.values()))))

    return sweep


def summarize_check_accuracy(sums: Dict[str, float], n_batches: int,
                             pred_len: int) -> Dict[str, float]:
    """Normalise raw metric sums as the reference does: d_loss averaged
    per batch; ADE = Σ/(total_traj·pred_len), FDE = Σ/total_traj; the
    linear / non-linear variants 0 for an empty class."""
    d_loss_mean = sums.pop("d_loss") / max(n_batches, 1)
    tt, tl, tnl = (sums["total_traj"], sums["total_traj_l"],
                   sums["total_traj_nl"])
    return {
        "d_loss": d_loss_mean,
        "g_l2_loss_abs": sums["g_l2_loss_abs"] / max(sums["loss_mask_sum"], 1),
        "g_l2_loss_rel": sums["g_l2_loss_rel"] / max(sums["loss_mask_sum"], 1),
        "ade": sums["disp_error"] / max(tt * pred_len, 1),
        "fde": sums["f_disp_error"] / max(tt, 1),
        "ade_l": sums["disp_error_l"] / (tl * pred_len) if tl else 0,
        "fde_l": sums["f_disp_error_l"] / tl if tl else 0,
        "ade_nl": sums["disp_error_nl"] / (tnl * pred_len) if tnl else 0,
        "fde_nl": sums["f_disp_error_nl"] / tnl if tnl else 0,
    }


def read_sums(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device sums -> host floats in one read-back."""
    keys = list(sums)
    return dict(zip(keys, torch.stack([sums[k] for k in keys]).tolist()))


def check_accuracy(args, loader, state: TrainState, step_fn: Callable,
                   device: Union[str, torch.device, None] = None,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[SweepDraws] = None, limit: bool = False
                   ) -> Dict[str, float]:
    """The metric pass over a DenseLoader's batches (``step_fn`` from
    :func:`make_check_accuracy_step`): the sums accumulate on ``device``
    (default ``cuda``) and are read back once. With ``limit`` the pass
    stops after the batch that reaches ``args.num_samples_check`` valid
    trajectories (counted on the host's copy of the batch)."""
    dev = resolve_device(device)
    acc = None
    n_batches = 0
    seen_traj = 0.0
    for batch in loader:
        b = {k: torch.as_tensor(v, device=dev) for k, v in dict(
            obs=batch.obs, pred=batch.pred, obs_rel=batch.obs_rel,
            pred_rel=batch.pred_rel, group=batch.end_group,
            valid=batch.valid, loss_mask=batch.loss_mask,
            non_linear=batch.non_linear).items()}
        S, N = batch.valid.shape
        noise, label = (draws(n_batches, S, N) if draws is not None
                        else (None, None))
        out = step_fn(state, b, generator, noise, label)
        acc = out if acc is None else {k: acc[k] + v for k, v in out.items()}
        n_batches += 1
        seen_traj += float(batch.valid.sum())
        if limit and seen_traj >= args.num_samples_check:
            break
    return summarize_check_accuracy(read_sums(acc), n_batches,
                                    loader.dense.pred_len)


# ------------------------------------------------- seed-stacked replicas

@dataclasses.dataclass
class StackedState:
    """N replicas' TrainStates as one (``train/multi.py``): every
    parameter, Adam moment and EMA tensor carries a leading seed axis
    ``[N, ...]``. ``g`` and ``d`` hold the models' structure on the
    ``meta`` device; the steps run them by ``torch.func.functional_call``
    on one replica's slice under ``torch.func.vmap``. One Adam over the
    stacked leaves is N per-seed Adams: its update is elementwise and all
    seeds share the step count."""
    g: TrajectoryGenerator
    d: TrajectoryDiscriminator
    g_params: Dict[str, torch.Tensor]
    d_params: Dict[str, torch.Tensor]
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    ema_g: Optional[Dict[str, torch.Tensor]] = None


class _Replica(nn.Module):
    """One replica's G and D under one root, so ``functional_call`` swaps
    both in from one flat dict; ``forward`` runs ``fn(g, d, *args)``."""

    def __init__(self, g: nn.Module, d: nn.Module):
        super().__init__()
        self.g, self.d = g, d

    def forward(self, fn: Callable, *args):
        return fn(self.g, self.d, *args)


def _stack_adam(opts: Sequence[torch.optim.Optimizer],
                modules: Sequence[nn.Module],
                leaves: Dict[str, torch.Tensor], lr: float
                ) -> torch.optim.Optimizer:
    opt = torch.optim.Adam(list(leaves.values()), lr=lr)
    named = [dict(m.named_parameters()) for m in modules]
    for name, leaf in leaves.items():
        states = [o.state.get(p[name]) for o, p in zip(opts, named)]
        if not any(states):
            continue
        steps = {float(s["step"]) if s else None for s in states}
        if len(steps) != 1:
            raise ValueError(f"{name}: the replicas' Adam states are at "
                             f"different steps {sorted(map(str, steps))}")
        opt.state[leaf] = {
            "step": states[0]["step"].clone(),
            "exp_avg": torch.stack([s["exp_avg"] for s in states]),
            "exp_avg_sq": torch.stack([s["exp_avg_sq"] for s in states])}
    return opt


def stack_states(states: Sequence[TrainState], tcfg: TrainConfig
                 ) -> StackedState:
    """TrainStates of one configuration -> one :class:`StackedState`
    (weights, Adam moments and EMA stacked in the given order)."""
    gs, ds = [s.g for s in states], [s.d for s in states]
    g_params, _ = torch.func.stack_module_state(gs)
    d_params, _ = torch.func.stack_module_state(ds)
    ema = None
    if all(s.ema_g is not None for s in states):
        ema = {k: torch.stack([s.ema_g[k] for s in states])
               for k in states[0].ema_g}
    return StackedState(
        copy.deepcopy(gs[0]).to("meta"), copy.deepcopy(ds[0]).to("meta"),
        g_params, d_params,
        _stack_adam([s.g_opt for s in states], gs, g_params,
                    tcfg.g_learning_rate),
        _stack_adam([s.d_opt for s in states], ds, d_params,
                    tcfg.d_learning_rate), ema)


def unstack_state(st: StackedState, i: int, tcfg: TrainConfig,
                  device: Union[str, torch.device]) -> TrainState:
    """Replica ``i`` of ``st`` as a TrainState of its own on ``device``:
    copies of its weights, Adam moments and EMA (BatchNorm's buffers, which
    are never read, at their initial values)."""
    dev = torch.device(device)
    mods = []
    for base, params in ((st.g, st.g_params), (st.d, st.d_params)):
        m = type(base)(base.cfg).to(dev)
        m.load_state_dict({**m.state_dict(),
                           **{k: v[i].detach() for k, v in params.items()}})
        mods.append(m)
    state = train_state_from_modules(*mods, tcfg)
    for opt, stacked, m, params in ((state.g_opt, st.g_opt, mods[0],
                                     st.g_params),
                                    (state.d_opt, st.d_opt, mods[1],
                                     st.d_params)):
        for name, p in m.named_parameters():
            s = stacked.state.get(params[name])
            if s:
                opt.state[p] = {"step": s["step"].clone(),
                                "exp_avg": s["exp_avg"][i].to(dev),
                                "exp_avg_sq": s["exp_avg_sq"][i].to(dev)}
    if st.ema_g is not None:
        state.ema_g = {k: v[i].to(dev, copy=True) for k, v in st.ema_g.items()}
    return state


def replica_map(st: StackedState, fn: Callable, *args) -> object:
    """``fn(g, d, *args)`` for every replica at once: ``torch.func.vmap``
    over the seed axis of the weights and of every tensor in ``args``
    (each ``[N, ...]``), and of every tensor of a list argument (a list of
    keep-masks, each ``[N, ...]``); None and other arguments are shared.
    ``fn`` must draw nothing."""
    root = _Replica(st.g, st.d)

    def one(gp, dp, *a):
        params = {**{"g." + k: v for k, v in gp.items()},
                  **{"d." + k: v for k, v in dp.items()}}
        return torch.func.functional_call(root, params, (fn, *a))

    dims = tuple(0 if isinstance(a, torch.Tensor)
                 or (isinstance(a, list) and a) else None for a in args)
    return torch.func.vmap(one, in_dims=(0, 0, *dims))(
        st.g_params, st.d_params, *args)


def _apply_many(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], clip: float) -> torch.Tensor:
    """:func:`_apply` per replica: each seed's global norm clips its own
    stacked gradients, then one Adam step. -> the norms ``[N]``."""
    norms = torch.sqrt(sum((g * g).reshape(g.shape[0], -1).sum(dim=1)
                           for g in grads))
    for p, g in zip(params, grads):
        p.grad, = clip_by_global_norm(
            [g], norms.view(-1, *([1] * (g.dim() - 1))), clip)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return norms


def _stack_draws(per_seed: Sequence[dict], device) -> dict:
    """One draw dict per seed -> one dict of ``[N, ...]`` tensors on
    ``device``: noise and labels as float32, a list of keep-masks as a list
    of boolean ``[N, ...]`` masks (None stays None)."""
    out = {}
    for k in per_seed[0]:
        vals = [d[k] for d in per_seed]
        if vals[0] is None:
            out[k] = None
        elif isinstance(vals[0], (list, tuple)):
            if len({len(v) for v in vals}) != 1:
                raise ValueError(f"{k}: the seeds were given different "
                                 "numbers of masks")
            out[k] = [torch.stack([as_mask(v[i], device) for v in vals])
                      for i in range(len(vals[0]))]
        else:
            out[k] = torch.stack([
                torch.as_tensor(v, dtype=torch.float32, device=device)
                for v in vals])
    return out


def _injected(masks: Optional[List[torch.Tensor]]) -> Optional[KeepMasks]:
    return None if masks is None else InjectedMasks(masks)


def d_step_many(st: StackedState, batch: Batch, cfg: ModelConfig,
                tcfg: TrainConfig, noise: Optional[torch.Tensor],
                label: torch.Tensor, impl: str,
                masks: Optional[List[torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """:func:`d_step` for every replica on one shared batch: the losses and
    stacked gradients of :func:`d_gradients_many`, then each replica's clip
    and one Adam step."""
    losses, grads = d_gradients_many(st, batch, cfg, tcfg, noise, label,
                                     impl, masks)
    losses["norm_d"] = _apply_many(st.d_opt, list(st.d_params.values()),
                                   grads, tcfg.clipping_threshold_d)
    return losses


def d_gradients_many(st: StackedState, batch: Batch, cfg: ModelConfig,
                     tcfg: TrainConfig, noise: Optional[torch.Tensor],
                     label: torch.Tensor, impl: str,
                     masks: Optional[List[torch.Tensor]] = None):
    """The d-step's losses ``[N]`` and stacked gradients ``[N, ...]`` (in
    ``st.d_params`` order) of every replica, nothing updated: ``noise``
    ``[N, S, N, nd]`` (or None), ``label`` ``[N]`` and, with dropout,
    ``masks`` (each keep-mask of :func:`d_mask_shapes` stacked ``[N, ...]``;
    under data parallelism at the global batch's shapes, sliced by
    :func:`d_loss`) are the replicas' draws. The forward runs under vmap;
    the gradient of the sum of the replicas' losses is each replica's own
    (they share no parameter). Under data parallelism the gradients and
    losses are summed over the ranks in one all-reduce, outside the vmap."""
    loss = replica_map(st, lambda g, d, z, y, ms: d_loss(
        g, d, batch, cfg, tcfg, z, y, impl, _injected(ms)), noise, label,
        masks)
    grads = torch.autograd.grad(loss.sum(), list(st.d_params.values()))
    *grads, loss = all_reduce_grads([*grads, loss.detach()])
    return {"D_data_loss": loss, "D_total_loss": loss}, grads


def g_step_many(st: StackedState, batch: Batch, cfg: ModelConfig,
                tcfg: TrainConfig, noises: Optional[torch.Tensor],
                label: torch.Tensor, impl: str,
                sample_masks: Optional[List[torch.Tensor]] = None,
                d_masks: Optional[List[torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """:func:`g_step` for every replica on one shared batch: the losses and
    stacked gradients of :func:`g_gradients_many`, each replica's clip and
    one Adam step, then the EMA per replica."""
    losses, grads = g_gradients_many(st, batch, cfg, tcfg, noises, label,
                                     impl, sample_masks, d_masks)
    losses["norm_g"] = _apply_many(st.g_opt, list(st.g_params.values()),
                                   grads, tcfg.clipping_threshold_g)
    if st.ema_g is not None and tcfg.g_ema_decay > 0:
        decay = tcfg.g_ema_decay
        with torch.no_grad():
            for name, p in st.g_params.items():
                st.ema_g[name].mul_(decay).add_(p, alpha=1.0 - decay)
    return losses


def g_gradients_many(st: StackedState, batch: Batch, cfg: ModelConfig,
                     tcfg: TrainConfig, noises: Optional[torch.Tensor],
                     label: torch.Tensor, impl: str,
                     sample_masks: Optional[List[torch.Tensor]] = None,
                     d_masks: Optional[List[torch.Tensor]] = None):
    """The g-step's losses ``[N]`` and stacked gradients (in
    ``st.g_params`` order) of every replica, nothing updated: ``noises``
    ``[N, best_k, S, N, nd]``, ``label`` ``[N]``; with dropout the
    per-sample keep-masks ``[N, best_k, ...]`` (this rank's scenes) and D's
    ``[N, ...]`` (at the global batch's shapes, sliced here). With dropout
    each replica's per-sample forward is a vmap over the samples nested in
    the seed vmap. Under data parallelism the gradients and losses are
    summed over the ranks in one all-reduce."""
    variety, adv, total = replica_map(st, lambda g, d, z, y, sm, dm: g_loss(
        g, d, batch, cfg, tcfg, z, y, impl, sm,
        sharded_masks(_injected(dm))), noises, label, sample_masks, d_masks)
    grads = torch.autograd.grad(total.sum(), list(st.g_params.values()))
    *grads, variety, adv, total = all_reduce_grads(
        [*grads, variety.detach(), adv.detach(), total.detach()])
    return {"G_l2_loss_rel": variety, "G_discriminator_loss": adv,
            "G_total_loss": total}, grads


def replica_draws(kind: str, cfg: ModelConfig, tcfg: TrainConfig, S: int,
                  N: int, generator: Optional[torch.Generator], device,
                  **injected) -> dict:
    """One replica's draws for a d-step (``kind`` ``'d'``) or a g-step
    (``'g'``), in the order :func:`d_step` / :func:`g_step` take them from
    ``generator``: the noise, the label, then with dropout the keep-masks
    (the d-step's generator leg and D's; the g-step's per-sample masks,
    then D's). ``injected`` holds :func:`train_iterations`' per-step dict;
    an injected value draws nothing. Under data parallelism ``S`` is this
    rank's scene count and every draw is the global batch's: the noise and
    the per-sample masks sliced here, as :func:`d_step` / :func:`g_step`
    slice them; the d-step's and D's keep-masks whole, sliced where the
    steps use them (:func:`d_loss`, :func:`g_gradients_many`)."""
    masks = {k: injected.pop(k, None)
             for k in ("masks", "sample_masks", "d_masks")}
    S_all = global_scenes(S)
    if kind == "d":
        out = d_draws(cfg, S, N, generator, device, **injected)
        if _dropout(cfg):
            out["masks"] = draw_masks(d_mask_shapes(cfg, S_all, N),
                                      generator, device, masks["masks"])
        return out
    out = g_draws(cfg, tcfg, S, N, generator, device, **injected)
    if _dropout(cfg):
        out["sample_masks"] = stacked_sample_masks(
            cfg, tcfg.best_k, S, N, generator, device, masks["sample_masks"])
        out["d_masks"] = draw_masks(disc_mask_shapes(cfg, S_all, N),
                                    generator, device, masks["d_masks"])
    return out


def train_iterations_many(st: StackedState, data: Dict[str, torch.Tensor],
                          idx: torch.Tensor, cfg: ModelConfig,
                          tcfg: TrainConfig,
                          generators: Sequence[torch.Generator],
                          draws: Optional[Sequence[Sequence[dict]]] = None,
                          impl: str = "scan") -> Dict[str, torch.Tensor]:
    """:func:`train_iterations` for every replica on one shared index
    schedule ``idx`` ``[iterations, d_steps + g_steps, S]``. Replica i
    draws from ``generators[i]`` in a step's order
    (:func:`replica_draws`), or takes ``draws[i][it]`` (the per-iteration
    dicts of :func:`train_iterations`, keep-masks included). Returns every
    loss and norm stacked ``[N, iterations]``. With batch_norm the d-step
    scores fake and real in two calls, as :func:`d_step` does."""
    dev = data["valid"].device
    history: List[Dict[str, torch.Tensor]] = []
    for it, bidx in enumerate(idx):
        losses: Dict[str, torch.Tensor] = {}
        for j in range(tcfg.d_steps + tcfg.g_steps):
            kind = "d" if j < tcfg.d_steps else "g"
            b = gather_batch(data, bidx[j], cfg.obs_len)
            S, N = b["valid"].shape
            j_kind = j if kind == "d" else j - tcfg.d_steps
            per_seed = [replica_draws(
                kind, cfg, tcfg, S, N, gen, dev,
                **(draws[i][it][kind][j_kind] if draws is not None else {}))
                for i, gen in enumerate(generators)]
            step = d_step_many if kind == "d" else g_step_many
            losses.update(step(st, b, cfg, tcfg, impl=impl,
                               **_stack_draws(per_seed, dev)))
        history.append(losses)
    return {k: torch.stack([h[k] for h in history], dim=1)
            for k in history[0]}


def check_accuracy_sweep_many(st: StackedState, data: Dict[str, torch.Tensor],
                              idx: torch.Tensor, cfg: ModelConfig,
                              generators: Sequence[torch.Generator],
                              draws: Optional[Sequence[SweepDraws]] = None,
                              impl: str = "scan"
                              ) -> Dict[str, torch.Tensor]:
    """:func:`make_check_accuracy_sweep`'s pass for every replica: the raw
    sums ``[N]`` each, replica i's draws from ``generators[i]`` or
    ``draws[i]``. Under data parallelism ``idx`` holds this rank's scenes
    of each batch, the draws are the global batch's and the sums are
    summed over the ranks."""
    dev = data["valid"].device
    S, N = idx.shape[1], data["valid"].shape[1]
    acc = None
    for bi, bidx in enumerate(idx):
        per_seed = []
        for i, gen in enumerate(generators):
            noise, label = (draws[i](bi, global_scenes(S), N)
                            if draws is not None else (None, None))
            per_seed.append(d_draws(cfg, S, N, gen, dev, noise, label))
        kw = _stack_draws(per_seed, dev)
        b = gather_batch(data, bidx, cfg.obs_len)
        out = replica_map(st, lambda g, d, z, y: accuracy_sums(
            g, d, b, cfg, z, y, impl), kw["noise"], kw["label"])
        acc = out if acc is None else {k: acc[k] + v for k, v in out.items()}
    return dict(zip(acc, all_reduce_grads(list(acc.values()))))
