"""Best-of-N ADE/FDE evaluation (counterpart of
``grouptraj/eval/evaluate.py``; reference ``scripts/evaluate_model.py``).

Per batch: the generator's context once, all ``num_samples`` samples in one
K-tiled decode, absolute positions, the raw per-pedestrian ADE/FDE summed
per scene, the min over samples, summed. The sums stay on the device and
are read back once per pass; the totals are normalised as the reference
does, ADE by ``traj_total * pred_len`` and FDE by ``traj_total``.

Randomness goes through a seam: by default the noise is drawn from an
explicit ``torch.Generator`` (seeded from ``seed``) on the device;
``noises`` — a callable ``(batch_index, S, N) -> [K, S, N, noise_dim]`` —
replaces the draw of each batch, so a test can inject the JAX package's
exact draws. Batches are numbered in the order they are evaluated.

Runs on ``cuda`` unless ``device`` names another device; the LSTM route
is ``impl`` (``'scan'``, ``'fused'`` or ``'pallas'``, ``ops/lstm.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from grouptraj_torch import losses as L
from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.utils import relative_to_abs, resolve_device

NoiseFn = Callable[[int, int, int], Optional[torch.Tensor]]


@torch.inference_mode()
def eval_step(model: TrajectoryGenerator, batch, num_samples: int,
              device: torch.device, generator: Optional[torch.Generator] = None,
              user_noises: Optional[torch.Tensor] = None,
              impl: str = "scan") -> torch.Tensor:
    """One DenseBatch -> the device tensor ``[ade_sum, fde_sum,
    traj_count]`` of its best-of-``num_samples`` errors."""
    t = lambda a: torch.as_tensor(a, device=device)
    obs, obs_rel = t(batch.obs), t(batch.obs_rel)
    group, valid, pred_gt = t(batch.end_group), t(batch.valid), t(batch.pred)
    if user_noises is not None:
        user_noises = torch.as_tensor(user_noises, dtype=torch.float32,
                                      device=device)
    ctx = model.generator_context(obs, obs_rel, group, valid, impl)
    preds = model.generator_sample_many(ctx, obs_rel, valid, num_samples,
                                        generator, user_noises, impl,
                                        obs=obs, group_end=group)
    pred_abs = relative_to_abs(preds.float(), obs[None, :, :, -1, :])
    ade_raw = L.displacement_error(pred_abs, pred_gt[None], valid[None],
                                   mode="raw")                # [K, S, N]
    fde_raw = L.final_displacement_error(pred_abs[..., -1, :],
                                         pred_gt[None, ..., -1, :],
                                         valid[None], mode="raw")
    # per-scene sum over peds, min over samples
    return torch.stack([ade_raw.sum(-1).amin(0).sum(),
                        fde_raw.sum(-1).amin(0).sum(), valid.sum()])


@torch.inference_mode()
def _run(model, batches, num_samples, device, seed, noises, impl
         ) -> Tuple[float, float]:
    cfg: ModelConfig = model.cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    acc = torch.zeros(3, dtype=torch.float32, device=device)
    for i, batch in enumerate(batches):
        S, N = batch.valid.shape
        z = None if noises is None else noises(i, S, N)
        acc += eval_step(model, batch, num_samples, device, gen, z, impl)
    # one host readback per pass
    ade_total, fde_total, traj_total = acc.tolist()
    return (ade_total / (traj_total * cfg.pred_len),
            fde_total / traj_total)


def evaluate(model: TrajectoryGenerator, loader, num_samples: int = 20,
             seed: int = 0, noises: Optional[NoiseFn] = None,
             impl: str = "scan",
             device: Union[str, torch.device, None] = None
             ) -> Tuple[float, float]:
    """Best-of-``num_samples`` (ADE, FDE) over the batches of ``loader``
    (a DenseLoader). ``model`` is a TrajectoryGenerator; it is moved to
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return _run(model.to(dev).eval(), loader, num_samples, dev, seed, noises,
                impl)


def evaluate_bucketed(model: TrajectoryGenerator, dset,
                      num_samples: int = 20, batch_size: int = 64,
                      n_buckets: int = 3, seed: int = 0,
                      noises: Optional[NoiseFn] = None, impl: str = "scan",
                      device: Union[str, torch.device, None] = None
                      ) -> Tuple[float, float]:
    """Best-of-N (ADE, FDE) with scene-size buckets: the windows of
    ``dset`` (a TrajectoryDataset) in ``make_buckets`` order, each bucket
    padded to its own width and batched without shuffling, as the JAX
    package does. The estimator equals :func:`evaluate`'s; the noise of
    each batch follows the bucket order."""
    from grouptraj_torch.data.batching import DenseDataset, DenseLoader
    from grouptraj_torch.train.device_data import make_buckets

    dev = resolve_device(device)

    def batches():
        for width, idx in make_buckets(dset, n_buckets, batch_size):
            dense = DenseDataset(dset, width, indices=idx)
            yield from DenseLoader(dense, batch_size, shuffle=False)

    return _run(model.to(dev).eval(), batches(), num_samples, dev, seed,
                noises, impl)
