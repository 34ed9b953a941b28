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
- every random draw can be injected: the sample noise and the U(0.7, 1.2)
  label-smoothing scalar. Without an injected value a step draws from the
  ``torch.Generator`` it is given;
- every step takes ``impl``, the LSTM route of all its recurrences
  (``ops/lstm.py``: ``'scan'``, ``'fused'``, the whole-loop kernels, or
  ``'pallas'``, the projection-in-kernel encoders);
  left None it is ``select_impl(cfg, tcfg)``, i.e. ``tcfg.lstm_impl``.

A step mutates the models and optimizers of its :class:`TrainState` in
place and returns the losses as device tensors under the JAX package's
names; nothing inside a step reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from grouptraj_torch import losses as L
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import (
    LSTMWeights, TrajectoryGenerator, sample_noises,
)
from grouptraj_torch.models.modules import GATLayer
from grouptraj_torch.ops.lstm import select_impl
from grouptraj_torch.train.device_data import gather_batch
from grouptraj_torch.utils import relative_to_abs, resolve_device

Batch = Dict[str, torch.Tensor]
Label = Union[float, torch.Tensor, None]


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
    tensor U(±1/√H), GAT tensors Xavier-uniform with gain 1.414."""
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


def _check_trainable(cfg: ModelConfig) -> None:
    if cfg.dropout or cfg.dropout1:
        raise NotImplementedError(
            "dropout is not ported yet: it needs one context per "
            "best-of-k sample, the per-sample forward")


def d_step(state: TrainState, batch: Batch, cfg: ModelConfig,
           tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None, label: Label = None,
           impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Discriminator step (reference ``train.py:395-429``): the loss and
    gradients of :func:`d_gradients`, then clip and Adam on D."""
    losses, grads = d_gradients(state, batch, cfg, tcfg, generator, noise,
                                label, impl)
    losses["norm_d"] = _apply(state.d_opt, list(state.d.parameters()), grads,
                              tcfg.clipping_threshold_d)
    return losses


def d_gradients(state: TrainState, batch: Batch, cfg: ModelConfig,
                tcfg: TrainConfig,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, label: Label = None,
                impl: Optional[str] = None):
    """The d-step's losses and the gradient of each of D's parameters (in
    ``state.d.parameters()`` order), nothing updated. ``noise``
    ``[S, N, noise_dim]`` and ``label`` (the U(0.7, 1.2) scalar) replace
    the draws from ``generator``."""
    _check_trainable(cfg)
    impl = select_impl(cfg, tcfg) if impl is None else impl
    b = batch
    S = b["valid"].shape[0]
    dev = b["valid"].device
    with torch.no_grad():
        # no gradient flows through the generator here; with bf16_nograd
        # the decode leg runs in bfloat16 (the context stays float32: it
        # feeds the pool kernel; the decode is where the rows are) on the
        # same float32-drawn noise
        ctx = state.g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                        b["valid"], impl)
        if noise is None and cfg.noise_first_dim:
            noise = sample_noises(cfg, 1, *b["valid"].shape, generator,
                                  dev)[0]
        if tcfg.bf16_nograd:
            pred_rel_fake = state.g.generator_sample(
                ctx.bfloat16(), b["obs_rel"].bfloat16(), b["valid"],
                user_noise=noise, impl=impl).float()
        else:
            pred_rel_fake = state.g.generator_sample(
                ctx, b["obs_rel"], b["valid"], user_noise=noise, impl=impl)
    tr, trr, tf, tfr = _trajs(b, pred_rel_fake)
    # real and fake scored in ONE stacked forward: scenes are independent
    # rows, so this halves the discriminator's sequential depth
    scores = state.d(torch.cat([tr, tf], dim=0), torch.cat([trr, tfr], dim=0),
                     torch.cat([b["valid"], b["valid"]], dim=0), impl)
    data_loss = L.gan_d_loss(scores[:S], scores[S:],
                             _label(label, generator, dev), b["valid"])
    grads = torch.autograd.grad(data_loss, list(state.d.parameters()))
    data_loss = data_loss.detach()
    return {"D_data_loss": data_loss, "D_total_loss": data_loss}, grads


def g_step(state: TrainState, batch: Batch, cfg: ModelConfig,
           tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
           noises: Optional[torch.Tensor] = None, label: Label = None,
           impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Generator step (reference ``train.py:432-484``): the losses and
    gradients of :func:`g_gradients`, then clip and Adam on G, then the
    EMA when ``g_ema_decay > 0``."""
    losses, grads = g_gradients(state, batch, cfg, tcfg, generator, noises,
                                label, impl)
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
                impl: Optional[str] = None):
    """The g-step's losses (best-of-k variety + adversarial) and the
    gradient of each of G's parameters (in ``state.g.parameters()`` order),
    nothing updated. ``noises`` ``[best_k, S, N, noise_dim]`` and ``label``
    replace the draws from ``generator``.

    Sparse path (``tcfg.sparse_best_k``): the variety min only propagates
    through the per-scene ARGMIN sample and the adversarial term through
    the last sample, so all k samples decode without grad (in bfloat16 with
    ``bf16_nograd``), then only those two decode again with grad as one
    stacked ``[2S, N]`` batch. The loss value is unchanged and the
    gradients equal the dense path's except at exact per-scene ties. The
    dense path decodes all k with grad."""
    _check_trainable(cfg)
    impl = select_impl(cfg, tcfg) if impl is None else impl
    b, g = batch, state.g
    k = tcfg.best_k
    S, N = b["valid"].shape
    dev = b["valid"].device
    pred_loss_mask = b["loss_mask"][..., cfg.obs_len:]
    sparse = tcfg.sparse_best_k and tcfg.l2_loss_weight > 0 and k > 1

    ctx = g.generator_context(b["obs"], b["obs_rel"], b["group"], b["valid"],
                              impl)
    if noises is None and cfg.noise_first_dim:
        noises = sample_noises(cfg, k, S, N, generator, dev)
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
        preds = g.generator_sample_many(ctx, b["obs_rel"], b["valid"], k,
                                        user_noises=noises, impl=impl)
        variety = L.variety_l2_loss(
            preds, b["pred_rel"], pred_loss_mask, b["valid"],
            tcfg.l2_loss_weight) if tcfg.l2_loss_weight > 0 \
            else ctx.new_zeros(())
        pred_last = preds[-1]
    _, _, tf, tfr = _trajs(b, pred_last)
    adv = L.gan_g_loss(state.d(tf, tfr, b["valid"], impl),
                       _label(label, generator, dev), b["valid"])
    total = variety + adv

    # gradients with respect to G only: D's parameters are constants here
    # and their .grad is never touched
    grads = torch.autograd.grad(total, list(g.parameters()))
    return {"G_l2_loss_rel": variety.detach(),
            "G_discriminator_loss": adv.detach(),
            "G_total_loss": total.detach()}, grads


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
    ``dict(noises=, label=)`` per g-step — the injected randomness; else
    every draw comes from ``generator``."""
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
