"""Train N seeds of one configuration at once with the port (counterpart of
``scripts/train_many.py``):

    python -m grouptraj_torch.train.cli_many --dataset_name zara2 \
        --seeds 13,14,15,16 --output_dir runs/z2_sweep [--device cpu]

``train/cli.py``'s flags (the reference's, plus ``--device``, default
``cuda``) and ``--seeds``, the replica seeds; ``--seed`` is ignored: the
shared batch schedule is seeded by the first replica seed. Each seed writes
standard checkpoints to ``<output_dir>/s<seed>/``; a rerun with
``--restore_from_checkpoint 1`` resumes the sweep (``train/multi.py``).

Data-parallel over scenes, one process a rank (``train/cli.py``'s
recipe), every rank holding all the seeds and running each batch's
block of scenes:

    torchrun --nproc_per_node 2 -m grouptraj_torch.train.cli_many \
        --num_devices 2 --seeds 13,14 --dataset_name zara2 \
        --output_dir runs/z2_sweep

With ``--num_devices`` other than 1 under ``torchrun`` the process joins
the group (``--dist_backend``, default ``nccl``, one card a rank) and
trains on ``cuda:LOCAL_RANK`` unless ``--device`` names a device; rank 0
writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

from grouptraj_torch.train.cli import (
    FORMAT, _join_torchrun, build_parser, configs_from_args,
)


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the sweep ->
    ``{seed: final checkpoint}``."""
    from grouptraj_torch.train.multi import train_many

    argv = sys.argv[1:] if argv is None else argv
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--gcn_variant", default=0, type=int)
    gcn_variant = bool(pre.parse_known_args(argv)[0].gcn_variant)
    parser = build_parser(gcn_variant)
    parser.add_argument(
        "--seeds", type=str, required=True,
        help="comma-separated replica seeds, e.g. 13,14,15,16")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format=FORMAT, stream=sys.stdout)
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    mcfg, tcfg = configs_from_args(args, gcn_variant)
    # the shared batch schedule is seeded by the sweep's first seed
    tcfg = dataclasses.replace(tcfg, seed=seeds[0])
    device = args.device
    if args.num_devices != 1 and "LOCAL_RANK" in os.environ:
        device = _join_torchrun(args.dist_backend, device)
    return train_many(mcfg, tcfg, seeds, args_snapshot=vars(args),
                      device=device)


if __name__ == "__main__":
    main()
