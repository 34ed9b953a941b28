"""Model / training configuration.

The port's own copy of ``grouptraj/config.py`` (the JAX package cannot be
imported without JAX). Field names, defaults, presets and the
``num_layers`` guard are identical, so a checkpoint's resolved config
compares equal across the two packages (tests/test_torch_compat.py).

One dataclass config with per-variant presets replacing the reference's ~45
argparse flags duplicated across ``scripts/train.py`` (reference
``scripts/train.py:25-124``) and ``scripts/train_GCN.py:24-110``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture config for generator + discriminator.

    Defaults mirror the retuned reference defaults (reference
    ``scripts/train.py:31-124``), not the upstream-sgan docs.
    """

    obs_len: int = 8
    pred_len: int = 12
    embedding_dim: int = 16
    num_layers: int = 1
    dropout: float = 0.0
    batch_norm: bool = False
    mlp_dim: int = 64

    # Generator
    encoder_h_dim_g: int = 32
    decoder_h_dim_g: int = 32
    noise_dim: Tuple[int, ...] = (8,)
    noise_type: str = "gaussian"          # gaussian | uniform
    noise_mix_type: str = "global"        # global | ped

    # Pooling between encoder and graph module
    # 'pool_net' = PoolHiddenNet max-pool (reference models.py:458-549)
    # 'gcn'      = GCNPooling reconstruction (reference train_GCN.py:617-631)
    # 'none'     = no pooling
    pooling_type: str = "pool_net"
    pool_every_timestep: bool = False
    bottleneck_dim: int = 8

    # Graph module between pooling and noise
    # 'gat'    = GATEncoder two-level group GAT (reference models.py:239-294, live)
    # 'gcn'    = GCNModule two-level group GCN (reference models.py:583-712, era-b)
    # 'gat-mh' = batched multi-head group GAT + mlp_decoder_context
    #            ("sgangat-g-*" era; reference models.py:296-388,890-898)
    # 'none'   = plain MLP decoder-context (upstream-sgan path)
    graph_module: str = "gat"
    # gat-mh stack shape (the reference CLI's [40]+hidden_units+[40],
    # train.py:166-170, with the checkpoints' head counts)
    mh_n_units: Tuple[int, ...] = (40, 16, 40)
    mh_n_heads: Tuple[int, ...] = (4, 1)
    # gat-mh semantic quirks (the era's training code is lost; these select
    # between the reference's commented code and the upstream-STGAT form —
    # defaults chosen by the checkpoint-fitness probe, tools/gatmh_probe.py):
    # mh_adj: 'mix' = post-softmax attn @ adjacency (commented models.py:332)
    #         'none' = pure attention over scene peds (upstream STGAT)
    # mh_concat: 'transpose' = per-ped head concat (upstream STGAT)
    #            'view' = untransposed reshape (commented models.py:384)
    # mh_norm: masked per-scene InstanceNorm before each layer (upstream
    #          STGAT's norm_list; constructed-but-commented in the reference)
    mh_adj: str = "mix"
    mh_concat: str = "transpose"
    mh_norm: bool = False
    # Whether an mlp_decoder_context MLP maps context -> decoder_h - noise_dim
    # (only used when graph_module == 'none'; reference models.py:796-804)
    mlp_decoder_context: bool = False

    # GAT options (reference scripts/train.py:116-124)
    n_heads: int = 1
    hidden_units: int = 72               # GAT hidden per head (hardcoded 72 in reference)
    dropout1: float = 0.0                # GAT dropout
    alpha: float = 0.2                   # LeakyReLU slope in GAT

    # Graph-module internal dims (hardcoded in reference models.py:242-244,592-605)
    graph_out_dim: int = 16              # per-level output features
    gcn_hidden_dim: int = 72
    gcn_layers: int = 2

    # Discriminator
    d_type: str = "global"               # local | global
    encoder_h_dim_d: int = 48

    # Social-pooling grid options (parsed but unused by the live reference path)
    neighborhood_size: float = 2.0
    grid_size: int = 8

    # Dense-batching (TPU) options — no reference equivalent
    activation: str = "relu"
    # PoolHiddenNet implementation (ops/pooling.py): 'pair' = the
    # reference-shaped [S, N, N, 512] path, 'fast' = the decomposed form
    # with the plain PyTorch pair core, 'kernel' = the decomposed form with
    # the hand-written CUDA pair core (ops/cuda_pool.py), 'auto' = kernel
    # for CUDA tensors, fast otherwise. Execution detail only — all four
    # compute the same function (tested).
    pool_impl: str = "auto"

    def __post_init__(self):
        if self.num_layers != 1:
            raise ValueError(
                f"num_layers={self.num_layers} is not supported: the "
                "reference's live path itself crashes for num_layers > 1 "
                "(TrajectoryGenerator hands the decoder LSTM a [1, B, H] "
                "hidden state against a [num_layers, B, H] cell state, "
                "reference sgan/models.py:908-912, and flattens the "
                "multi-layer encoder state into the batch axis at "
                "models.py:885). grouptraj's LSTMs are single-layer; fail "
                "fast instead of silently training a different model.")

    @property
    def noise_first_dim(self) -> int:
        if not self.noise_dim or self.noise_dim[0] == 0:
            return 0
        return self.noise_dim[0]

    @property
    def context_dim(self) -> int:
        """encoder_h (+ bottleneck if pooling) — reference models.py:791-794."""
        if self.pooling_type and self.pooling_type != "none":
            return self.encoder_h_dim_g + self.bottleneck_dim
        return self.encoder_h_dim_g

    @property
    def decoder_context_dim(self) -> int:
        """What the graph module / context MLP must emit: decoder_h − noise."""
        return self.decoder_h_dim_g - self.noise_first_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization / loop configuration (reference scripts/train.py:40-113)."""

    dataset_name: str = "zara2"
    delim: str = "tab"
    loader_num_workers: int = 4
    skip: int = 1

    batch_size: int = 64                  # scenes per batch
    num_iterations: int = 10000
    num_epochs: int = 200

    g_learning_rate: float = 1e-4
    g_steps: int = 1
    clipping_threshold_g: float = 2.0
    d_learning_rate: float = 1e-3
    d_steps: int = 1
    clipping_threshold_d: float = 0.0

    l2_loss_weight: float = 1.0
    best_k: int = 20
    # grouptraj extension (no reference equivalent): exponential moving
    # average of the generator weights, the standard GAN smoothing trick.
    # 0 = off (reference semantics). When on, the g-step maintains
    # ema <- d*ema + (1-d)*g and checkpoints add a 'g_ema_state' entry
    # (evaluate_model --use_ema evaluates it).
    g_ema_decay: float = 0.0
    # grouptraj extensions of the training step (sparse best-of-k backward,
    # bf16 no-grad forwards); semantics in grouptraj/config.py, honoured by
    # the port's training step (train/steps.py).
    sparse_best_k: bool = True
    bf16_nograd: bool = True

    output_dir: str = "."
    print_every: int = 100
    checkpoint_every: int = 300
    checkpoint_name: str = "checkpoint"
    checkpoint_start_from: Optional[str] = None
    restore_from_checkpoint: bool = True
    num_samples_check: int = 5000

    timing: bool = False
    profile_dir: str = ""                 # emit a jax.profiler trace of
                                          # iterations [50, 60) when set
    seed: int = 0

    # Execution options of the JAX package's training loop (dispatch
    # fusion, scene-size buckets, data parallelism, LSTM implementation);
    # semantics in grouptraj/config.py. Carried for config parity.
    steps_per_dispatch: int = 100
    n_max: int = 0                        # 0 = derive from dataset (rounded up to 8)
    n_buckets: int = 3
    num_devices: int = 1
    lstm_impl: str = "auto"
    use_pallas: bool = False


# Per-variant presets matching the reference model families (SURVEY.md §6).
MODEL_PRESETS = {
    # scripts/train.py defaults — the live GAT path ("sgan-gat" family)
    "gat": ModelConfig(),
    # scripts/train_GCN.py working intent — GCNPooling pool-net, no graph module,
    # mlp_decoder_context (models/01 & sgan-models checkpoint family)
    "gcn-pool": ModelConfig(
        pooling_type="gcn", graph_module="none", mlp_decoder_context=True,
        bottleneck_dim=16,
    ),
    # era-b "sgan-g-p": PoolHiddenNet + GCNModule graph module
    "gcn": ModelConfig(graph_module="gcn"),
    # upstream-style sgan-p: pool only, plain decoder-context MLP
    "sgan-p": ModelConfig(graph_module="none", mlp_decoder_context=True),
    # upstream-style sgan: no pooling
    "sgan": ModelConfig(pooling_type="none", graph_module="none",
                        mlp_decoder_context=True),
}

TRAIN_PRESETS = {
    "gat": TrainConfig(),
    # train_GCN.py default divergences (reference train_GCN.py:69,75,88,94)
    "gcn-pool": TrainConfig(d_steps=2, best_k=1),
}
