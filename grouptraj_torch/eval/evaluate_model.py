"""Best-of-N ADE/FDE of checkpoints on a dataset split (the port's
counterpart of ``scripts/evaluate_model.py``):

    python -m grouptraj_torch.eval.evaluate_model \
        --model_path models/grouptraj/zara1_12_with_model.pt [--device cpu]

``--model_path`` is a checkpoint or a directory of ``*.pt`` files. Each is
loaded with the port's loader, its generator rebuilt from the stored args
and evaluated on ``<dataset>/<dset_type>`` (``utils.get_dset_path``: set
``GROUPTRAJ_DATA_DIR``), bucketed unless ``--n_buckets 1``. Prints the
reference's result line, then the checkpoint's args. Runs on ``cuda``
unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os

parser = argparse.ArgumentParser()
parser.add_argument("--model_path", type=str, required=True)
parser.add_argument("--num_samples", default=20, type=int)
parser.add_argument("--dset_type", default="test", type=str)
parser.add_argument("--use_best", default=0, type=int,
                    help="evaluate g_best_state instead of g_state")
parser.add_argument("--use_ema", default=0, type=int,
                    help="evaluate g_ema_state (generator weight EMA); "
                         "takes precedence over --use_best")
parser.add_argument("--seed", default=0, type=int)
parser.add_argument("--n_buckets", default=3, type=int,
                    help="scene-size buckets for eval batches "
                         "(1 = one global pad width)")
parser.add_argument("--device", default=None, type=str,
                    help="torch device (default: cuda)")


def get_generator(checkpoint: dict, use_best: bool = False,
                  use_ema: bool = False):
    """The checkpoint's generator -> (ModelConfig, TrajectoryGenerator)."""
    from grouptraj_torch.compat import (
        config_from_checkpoint_args, generator_state,
    )
    from grouptraj_torch.models.generator import TrajectoryGenerator

    if use_ema and checkpoint.get("g_ema_state") is not None:
        state = checkpoint["g_ema_state"]
    elif use_best and checkpoint.get("g_best_state") is not None:
        state = checkpoint["g_best_state"]
    else:
        state = checkpoint["g_state"]
    cfg = config_from_checkpoint_args(checkpoint["args"], state)
    model = TrajectoryGenerator(cfg)
    model.load_state_dict(generator_state(state))
    return cfg, model


def main(args) -> None:
    """Evaluate every checkpoint of ``args.model_path``, printing each
    result line."""
    from grouptraj_torch.data import data_loader
    from grouptraj_torch.eval.evaluate import evaluate, evaluate_bucketed
    from grouptraj_torch.train.checkpoint import load_checkpoint
    from grouptraj_torch.utils import get_dset_path, resolve_device

    device = resolve_device(args.device)
    if os.path.isdir(args.model_path):
        paths = [os.path.join(args.model_path, f)
                 for f in sorted(os.listdir(args.model_path))
                 if f.endswith(".pt")]
    else:
        paths = [args.model_path]

    for path in paths:
        checkpoint = load_checkpoint(path)
        if checkpoint is None or checkpoint.get("g_state") is None:
            print(f"Skipping {path}: no model weights")
            continue
        cfg, model = get_generator(checkpoint, bool(args.use_best),
                                   bool(args.use_ema))
        ck_args = checkpoint["args"]
        dpath = get_dset_path(ck_args["dataset_name"], args.dset_type)

        class LoaderArgs:   # the loader must use the checkpoint's horizon
            obs_len = cfg.obs_len
            pred_len = cfg.pred_len
            skip = ck_args.get("skip", 1)
            delim = ck_args.get("delim", "tab")
            batch_size = ck_args.get("batch_size", 64)
            # the pad width comes from the eval split: a training n_max
            # smaller than the largest eval scene would raise
            n_max = 0
            seed = 0

        dset, loader = data_loader(LoaderArgs, dpath, shuffle=False)
        if args.n_buckets > 1:
            ade, fde = evaluate_bucketed(
                model, dset, args.num_samples,
                batch_size=LoaderArgs.batch_size, n_buckets=args.n_buckets,
                seed=args.seed, device=device)
        else:
            ade, fde = evaluate(model, loader, args.num_samples,
                                seed=args.seed, device=device)
        print("Dataset: {}, Pred Len: {}, ADE: {:.2f}, FDE: {:.2f}".format(
            ck_args["dataset_name"], ck_args["pred_len"], ade, fde))
        for k, v in ck_args.items():
            print(k, v)


if __name__ == "__main__":
    main(parser.parse_args())
