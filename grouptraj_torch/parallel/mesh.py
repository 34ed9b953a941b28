"""Process groups, scene shards and global sums: the data-parallel layer
(counterpart of ``grouptraj/parallel/mesh.py``).

In the JAX package data parallelism is a sharding annotation: GSPMD splits
the scene axis of every batch over a 1-D mesh and keeps every reduction
global. The port does the same with ``torch.distributed``: n ranks, one
process each, every rank holding the whole model and its Adam state and
running the training step on its contiguous block of each batch's scenes,
``[r·S/n, (r+1)·S/n)`` (:func:`shard_scenes`; the JAX package's
``P(None, None, DATA)``). Together they compute what one process computes
on the whole batch:

- a normaliser or a statistic over the scene axis is global: the masked
  BCE's count, ``l2_loss``'s numel and BatchNorm's batch statistics
  (:func:`global_sum`, inside autograd where the gradient of a global mean
  reaches every rank);
- each rank's loss is its scenes' share of the global loss, so the sum of
  the ranks' gradients is the global gradient (:func:`all_reduce_grads`:
  one flat buffer and one ``all_reduce`` a step, the loss values in the
  same buffer); every rank clips and steps on the same sum;
- every draw is made at its global shape from a generator that every rank
  seeds alike, then sliced (:func:`shard_draw`; the keep-masks by
  ``ops/linear.py:ShardedMasks``), as
  the JAX package's partitionable threefry gives the same bits sharded or
  not;
- parameters and Adam state start equal (:func:`replicate_state`) and stay
  equal.

``DistributedDataParallel`` is not used: it averages the gradients (divides
by the world size) and hooks ``backward()``, while the steps take
``torch.autograd.grad`` of losses whose normalisers are already global, so
the sum is the gradient. Nor is ``torch.distributed.nn.functional.
all_reduce``: it is deprecated and, having no ``setup_context``, cannot run
under ``torch.func.vmap`` (the per-sample g-step of a batch_norm model with
dropout); :class:`_AllReduceSum` is the same sum with a vmap rule.

The group in force is installed by ``train()`` (:func:`set_dp_group`) and
cleared in its ``finally``, as the JAX package's ``train()`` installs its
mesh for the pool kernel (``grouptraj/ops/pooling.py:set_spmd_mesh``).
With no group installed every function here is the identity, and the steps
compute what they compute on one device, bit for bit.

The backend is the caller's to name, never inferred or swapped: ``nccl``
for ranks on distinct cards, ``gloo`` for the CPU and for ranks that share
one card. NCCL refuses two ranks on one device; :func:`check_backend` says
so before a group is made.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class DPGroup:
    """The default process group as this process sees it: its rank, the
    world size, and the calls and bytes :func:`all_reduce_grads` has summed
    in it."""
    rank: int
    world: int
    calls: int = 0
    bytes: int = 0


_GROUP: Optional[DPGroup] = None


def set_dp_group(dp: Optional[DPGroup]) -> Optional[DPGroup]:
    """Install ``dp`` as the group the steps shard over (None: one device)
    -> the group it replaces."""
    global _GROUP
    prev, _GROUP = _GROUP, dp
    return prev


def get_dp_group() -> Optional[DPGroup]:
    return _GROUP


def check_backend(backend: str, devices: Sequence) -> None:
    """Refuse a backend the ranks' ``devices`` (one a rank) cannot run:
    an unknown name, ``nccl`` off CUDA or with two ranks on one card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend != "nccl":
        return
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"backend 'nccl' runs ranks on CUDA devices, got "
                         f"{[str(d) for d in devs]}; use 'gloo' on the CPU")
    cards = [d.index or 0 for d in devs]
    if len(set(cards)) < len(cards):
        raise ValueError(
            f"backend 'nccl' with {len(cards)} ranks on the cards "
            f"{cards}: NCCL refuses two ranks on one device; use 'gloo' for "
            f"ranks that share a card")


def init_data_parallel(world_size: Optional[int] = None,
                       rank: Optional[int] = None, backend: str = "nccl",
                       init_method: str = "env://", device=None) -> DPGroup:
    """Make the default process group, or join the one already made (under
    ``torchrun``, or by an earlier call), -> its :class:`DPGroup`. A made
    group takes ``backend``, ``init_method``, ``world_size`` and ``rank``
    (``env://`` reads ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, as torchrun sets them); a joined one must match what
    is given. A CUDA ``device`` becomes the current device first (NCCL
    reads it)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    dp = world_group()
    if dist.get_backend() != backend or world_size not in (None, dp.world) \
            or rank not in (None, dp.rank):
        raise ValueError(
            f"the process group is already made with backend "
            f"{dist.get_backend()!r}, world {dp.world}, rank {dp.rank}; "
            f"asked for {backend!r}, world {world_size}, rank {rank}")
    return dp


def world_group() -> Optional[DPGroup]:
    """The default process group as a :class:`DPGroup`; None when
    ``torch.distributed`` is not initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return DPGroup(dist.get_rank(), dist.get_world_size())


def shard_scenes(x, rank: int, world: int, axis: int = -1, blocks: int = 1):
    """Rank ``rank``'s contiguous block of the scene axis ``axis`` of ``x``
    (a numpy array or a tensor): ``[r·L, (r+1)·L)``, L = size / world.
    With ``blocks`` > 1 the axis holds that many scene axes one after the
    other (the discriminator's real | fake batch) and the rank takes its
    block of each."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if n % (world * blocks):
        raise ValueError(f"{n} scenes do not split into {world} ranks"
                         + (f" x {blocks} blocks" if blocks > 1 else "")
                         + " (batch_size must be divisible by num_devices)")
    L = n // (world * blocks)
    head, tail = tuple(x.shape[:ax]), tuple(x.shape[ax + 1:])
    if blocks == 1:
        return x[(slice(None),) * ax + (slice(rank * L, (rank + 1) * L),)]
    y = x.reshape(head + (blocks, world, L) + tail)
    return y[(slice(None),) * (ax + 1) + (rank,)].reshape(
        head + (blocks * L,) + tail)


def shard_draw(x, axis: int = 0, blocks: int = 1):
    """A draw made at its global shape -> this rank's block of it; the
    draw itself without a group (None stays None)."""
    dp = _GROUP
    if dp is None or x is None:
        return x
    return shard_scenes(x, dp.rank, dp.world, axis, blocks)


def global_scenes(S: int) -> int:
    """The global batch's scene count for a rank's ``S``."""
    return S if _GROUP is None else S * _GROUP.world


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks (in float32). Every rank's loss reads
    the sum, so the gradient is the ranks' cotangents summed, the same
    all-reduce. Under vmap the batched axis rides along."""

    @staticmethod
    def forward(x):
        y = x.detach().to(torch.float32, copy=True,
                          memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y.to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)

    @staticmethod
    def vmap(info, in_dims, x):
        return _AllReduceSum.apply(x), in_dims[0]


def global_sum(x: torch.Tensor, differentiable: bool = False
               ) -> torch.Tensor:
    """``x`` summed over the ranks; ``x`` itself without a group (and on
    the ``meta`` device, where dry runs find mask shapes). With
    ``differentiable`` the gradient crosses the ranks (a global mean's
    reaches every rank's inputs); else the sum is a constant."""
    dp = _GROUP
    if dp is None or x.is_meta:
        return x
    return _AllReduceSum.apply(x if differentiable else x.detach())


def global_count(n: int, device) -> Union[int, torch.Tensor]:
    """A count of entries summed over the ranks (a tensor on ``device``);
    ``n`` itself without a group."""
    if _GROUP is None:
        return n
    return global_sum(torch.tensor(float(n), device=device))


def all_reduce_grads(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The ranks' tensors (a step's gradients, with its loss values; a
    sweep's metric sums) summed in one flat float32 buffer and one
    ``all_reduce`` -> new tensors of the given shapes and dtypes; the list
    unchanged without a group."""
    dp = _GROUP
    if dp is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    dist.all_reduce(flat)
    dp.calls += 1
    dp.bytes += flat.numel() * flat.element_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _state_tensors(state) -> Iterable[Tuple[str, torch.Tensor]]:
    """A TrainState's weights, Adam state and EMA, named, in one order."""
    for part, module, opt in (("g", state.g, state.g_opt),
                              ("d", state.d, state.d_opt)):
        for name, p in module.named_parameters():
            yield f"{part}.{name}", p.detach()
            for key, v in sorted(opt.state.get(p, {}).items()):
                yield f"{part}.{name}.adam.{key}", torch.as_tensor(v)
    for name, v in sorted((state.ema_g or {}).items()):
        yield f"ema.{name}", v


def replicate_state(state) -> object:
    """Rank 0's weights, Adam moments and steps and EMA broadcast to every
    rank, which must hold the same already: the ranks build their state
    alike, from one seed or one file, and a rank that differs raises (on
    every rank). -> ``state``; without a group, ``state`` untouched."""
    dp = _GROUP
    if dp is None:
        return state
    named = list(_state_tensors(state))
    dev = named[0][1].device
    flat = torch.cat([t.reshape(-1).to(dev, torch.float64)
                      for _, t in named])
    size = torch.tensor([flat.numel(), -flat.numel()], dtype=torch.float64,
                        device=dev)
    dist.all_reduce(size, op=dist.ReduceOp.MAX)
    if size[0] != -size[1]:
        raise RuntimeError(
            f"rank {dp.rank}: the ranks' training states differ in size "
            f"({flat.numel()} values here, {int(size[0])} on another rank)")
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    differs = torch.tensor([float((ref != flat).any())], device=dev)
    dist.all_reduce(differs, op=dist.ReduceOp.MAX)
    if differs.item():
        i, first = 0, "another rank's"
        for name, t in named:
            if (ref[i:i + t.numel()] != flat[i:i + t.numel()]).any():
                first = name
                break
            i += t.numel()
        raise RuntimeError(f"rank {dp.rank}: the ranks' training states "
                           f"differ from rank 0's (first: {first}); every "
                           f"rank must build it alike")
    return state


def barrier() -> None:
    if _GROUP is not None:
        dist.barrier()


def is_writer() -> bool:
    """True on rank 0 and without a group: the process that writes files."""
    return _GROUP is None or _GROUP.rank == 0
