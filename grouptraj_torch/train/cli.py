"""Train the group-aware GAT Social-GAN with the port (counterpart of
``scripts/train.py`` and ``scripts/train_GCN.py``):

    python -m grouptraj_torch.train.cli --dataset_name zara1 [--device cpu]

The reference's flags and defaults, as the JAX package's scripts take them
(``--gcn_variant 1`` gives ``train_GCN.py``'s), plus ``--device`` (default
``cuda``). Datasets resolve through ``utils.get_dset_path`` (set
``GROUPTRAJ_DATA_DIR``); checkpoints go to ``--output_dir`` and a run
resumes from ``<checkpoint_name>_with_model.pt`` there.

Data parallelism over scenes, one process a rank (``--batch_size`` divisible
by the rank count):

    torchrun --nproc_per_node 2 -m grouptraj_torch.train.cli --num_devices 2 \
        --dataset_name zara1

Under ``torchrun`` the process group is made from its environment with
``--dist_backend`` (default ``nccl``: one card a rank, rank i on
``cuda:LOCAL_RANK`` unless ``--device`` names one; ``gloo`` for the CPU or
ranks that share a card).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.utils import bool_flag, int_tuple

FORMAT = "[%(levelname)s: %(filename)s: %(lineno)4d]: %(message)s"


def build_parser(gcn_variant: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # Dataset options
    p.add_argument("--dataset_name", default="zara2", type=str)
    p.add_argument("--delim", default="tab")
    p.add_argument("--loader_num_workers", default=4, type=int)
    p.add_argument("--obs_len", default=8, type=int)
    p.add_argument("--pred_len", default=12, type=int)
    p.add_argument("--skip", default=1, type=int)
    # Optimization
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--num_iterations", default=10000, type=int)
    p.add_argument("--num_epochs", default=200, type=int)
    # Model options
    p.add_argument("--embedding_dim", default=16, type=int)
    p.add_argument("--num_layers", default=1, type=int)
    p.add_argument("--dropout", default=0, type=float)
    p.add_argument("--batch_norm", default=0, type=bool_flag)
    p.add_argument("--mlp_dim", default=64, type=int)
    # Generator options
    p.add_argument("--encoder_h_dim_g", default=32, type=int)
    p.add_argument("--decoder_h_dim_g", default=32, type=int)
    p.add_argument("--noise_dim", default=(8,), type=int_tuple)
    p.add_argument("--noise_type", default="gaussian")
    p.add_argument("--noise_mix_type", default="global")
    p.add_argument("--clipping_threshold_g", default=2.0, type=float)
    p.add_argument("--g_learning_rate", default=1e-4, type=float)
    p.add_argument("--g_steps", default=1, type=int)
    # Pooling options
    p.add_argument("--pooling_type",
                   default="gcn" if gcn_variant else "pool_net")
    p.add_argument("--pool_every_timestep", default=0, type=bool_flag)
    p.add_argument("--bottleneck_dim", default=16 if gcn_variant else 8,
                   type=int)
    # Social pooling options (parsed for compatibility; grid pooling is not a
    # live path in the reference either)
    p.add_argument("--neighborhood_size", default=2.0, type=float)
    p.add_argument("--grid_size", default=8, type=int)
    # Discriminator options
    p.add_argument("--d_type", default="global", type=str)
    p.add_argument("--encoder_h_dim_d", default=48, type=int)
    p.add_argument("--d_learning_rate", default=1e-3, type=float)
    p.add_argument("--d_steps", default=2 if gcn_variant else 1, type=int)
    p.add_argument("--clipping_threshold_d", default=0, type=float)
    # Loss options
    p.add_argument("--l2_loss_weight", default=1, type=float)
    p.add_argument("--best_k", default=1 if gcn_variant else 20, type=int)
    # grouptraj extension: generator weight EMA (0 = off, reference
    # semantics; see TrainConfig.g_ema_decay)
    p.add_argument("--g_ema_decay", default=0.0, type=float)
    # grouptraj extension: sparse best-of-k backward (1 = on; gradients
    # equal the dense path except on exact ties — TrainConfig.sparse_best_k)
    p.add_argument("--sparse_best_k", default=1, type=int)
    # grouptraj extension (perf): bf16 no-gradient generator forwards in the
    # training step (probe decode + d-step sample; TrainConfig.bf16_nograd)
    p.add_argument("--bf16_nograd", default=1, type=int)
    # Output
    p.add_argument("--output_dir", default=os.getcwd())
    p.add_argument("--print_every", default=100, type=int)
    p.add_argument("--checkpoint_every", default=300, type=int)
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--checkpoint_start_from", default=None)
    p.add_argument("--restore_from_checkpoint", default=1, type=int)
    p.add_argument("--num_samples_check", default=5000, type=int)
    # Misc (the reference's GPU flags, accepted for CLI compatibility and
    # ignored: --device picks the device)
    p.add_argument("--use_gpu", default=1, type=int)
    p.add_argument("--timing", default=0, type=int)
    p.add_argument("--gpu_num", default="0", type=str)
    if not gcn_variant:
        # GAT options
        p.add_argument("--n_heads", type=int, default=1)
        p.add_argument("--hidden_units", type=str, default="16")
        p.add_argument("--dropout1", type=float, default=0)
        p.add_argument("--alpha", type=float, default=0.2)
    # grouptraj extensions
    p.add_argument("--graph_module", default=None, type=str,
                   choices=["gat", "gcn", "gat-mh", "none"],
                   help="override the group graph module "
                        "(default: gat, none with --gcn_variant 1)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--steps_per_dispatch", default=100, type=int,
                   help="training iterations per dispatch (one "
                        "train_iterations call; losses read back at "
                        "print events)")
    p.add_argument("--n_max", default=0, type=int,
                   help="pad scenes to this many peds (0 = derive)")
    p.add_argument("--n_buckets", default=3, type=int,
                   help="scene-size buckets for training dispatches "
                        "(1 = one global pad width)")
    p.add_argument("--use_pallas", default=0, type=bool_flag,
                   help="alias for --lstm_impl pallas (kernels K5/K6)")
    p.add_argument("--lstm_impl", default="auto",
                   choices=["auto", "scan", "pallas", "fused"],
                   help="LSTM route (scan = plain PyTorch recurrences, "
                        "fused = whole-loop kernels K3/K4, pallas = "
                        "projection-in-kernel encoders K5/K6); auto = scan")
    p.add_argument("--pool_impl", default="auto",
                   choices=["auto", "pair", "fast", "kernel"],
                   help="PoolHiddenNet implementation (pair = reference-"
                        "shaped NxN MLP, fast = decomposed plain PyTorch, "
                        "kernel = the CUDA pair core K1/K2); auto = kernel "
                        "for CUDA tensors")
    p.add_argument("--num_devices", default=1, type=int,
                   help="data-parallel ranks (launch one process each with "
                        "torchrun); 0 = torchrun's world size, without "
                        "torchrun every visible card")
    p.add_argument("--dist_backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend of a data-parallel run")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler trace of iterations 50-60")
    p.add_argument("--gcn_variant", default=int(gcn_variant), type=int,
                   help="1 = train_GCN.py's defaults (GCNPooling pool-net, "
                        "no graph module, d_steps 2, best_k 1)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda)")
    return p


def configs_from_args(args, gcn_variant: bool = False):
    if gcn_variant:
        graph_module, mlp_ctx = "none", True
    else:
        graph_module, mlp_ctx = "gat", False
    if getattr(args, "graph_module", None):
        graph_module = args.graph_module
        # gat-mh and plain 'none' route context through mlp_decoder_context
        mlp_ctx = graph_module in ("gat-mh", "none")
    mcfg = ModelConfig(
        obs_len=args.obs_len, pred_len=args.pred_len,
        embedding_dim=args.embedding_dim, num_layers=args.num_layers,
        dropout=args.dropout, batch_norm=args.batch_norm,
        mlp_dim=args.mlp_dim, encoder_h_dim_g=args.encoder_h_dim_g,
        decoder_h_dim_g=args.decoder_h_dim_g, noise_dim=args.noise_dim,
        noise_type=args.noise_type, noise_mix_type=args.noise_mix_type,
        pooling_type=args.pooling_type,
        pool_every_timestep=args.pool_every_timestep,
        bottleneck_dim=args.bottleneck_dim,
        graph_module=graph_module, mlp_decoder_context=mlp_ctx,
        n_heads=getattr(args, "n_heads", 1),
        dropout1=getattr(args, "dropout1", 0.0),
        alpha=getattr(args, "alpha", 0.2),
        d_type=args.d_type, encoder_h_dim_d=args.encoder_h_dim_d,
        neighborhood_size=args.neighborhood_size, grid_size=args.grid_size,
        pool_impl=getattr(args, "pool_impl", "auto"),
    )
    tcfg = TrainConfig(
        dataset_name=args.dataset_name, delim=args.delim,
        loader_num_workers=args.loader_num_workers, skip=args.skip,
        batch_size=args.batch_size, num_iterations=args.num_iterations,
        num_epochs=args.num_epochs, g_learning_rate=args.g_learning_rate,
        g_steps=args.g_steps, clipping_threshold_g=args.clipping_threshold_g,
        d_learning_rate=args.d_learning_rate, d_steps=args.d_steps,
        clipping_threshold_d=args.clipping_threshold_d,
        l2_loss_weight=args.l2_loss_weight, best_k=args.best_k,
        g_ema_decay=args.g_ema_decay,
        sparse_best_k=bool(args.sparse_best_k),
        bf16_nograd=bool(args.bf16_nograd),
        output_dir=args.output_dir, print_every=args.print_every,
        checkpoint_every=args.checkpoint_every,
        checkpoint_name=args.checkpoint_name,
        checkpoint_start_from=args.checkpoint_start_from,
        restore_from_checkpoint=bool(args.restore_from_checkpoint),
        num_samples_check=args.num_samples_check, timing=bool(args.timing),
        profile_dir=args.profile_dir,
        seed=args.seed, steps_per_dispatch=args.steps_per_dispatch,
        n_max=args.n_max, use_pallas=bool(args.use_pallas),
        lstm_impl=args.lstm_impl,
        num_devices=args.num_devices, n_buckets=args.n_buckets,
    )
    return mcfg, tcfg


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``) and train -> the final
    checkpoint dict."""
    from grouptraj_torch.train.loop import train

    argv = sys.argv[1:] if argv is None else argv
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--gcn_variant", default=0, type=int)
    gcn_variant = bool(pre.parse_known_args(argv)[0].gcn_variant)
    args = build_parser(gcn_variant).parse_args(argv)
    logging.basicConfig(level=logging.INFO, format=FORMAT, stream=sys.stdout)
    mcfg, tcfg = configs_from_args(args, gcn_variant)
    device = args.device
    if args.num_devices != 1 and "LOCAL_RANK" in os.environ:
        device = _join_torchrun(args.dist_backend, device)
    return train(mcfg, tcfg, args_snapshot=vars(args), device=device)


def _join_torchrun(backend: str, device):
    """Make the process group from torchrun's environment -> this rank's
    device (``device``, or ``cuda:LOCAL_RANK``)."""
    from grouptraj_torch.parallel.mesh import (
        check_backend, init_data_parallel,
    )
    local, n_local = (int(os.environ[k]) for k in ("LOCAL_RANK",
                                                    "LOCAL_WORLD_SIZE"))
    check_backend(backend, [device or f"cuda:{i}" for i in range(n_local)])
    device = device or f"cuda:{local}"
    init_data_parallel(backend=backend, device=device)
    return device


if __name__ == "__main__":
    main()
