"""grouptraj_torch — the PyTorch/CUDA port of grouptraj.

A second package beside the JAX reference ``grouptraj/``. It imports torch
and numpy, never jax, optax or grouptraj; every TPU kernel on a ported path
is a hand-written CUDA kernel under ``csrc/`` with a plain PyTorch twin in
the same module. Ported: the data layer (``data/``), Bo20 evaluation
(``eval/``) and serving for every zoo model (``gat``, ``gat-mh``,
``gcn-pool``); training (``train/``: the d-step + g-step, the loop with
its metric sweeps, checkpoints in the JAX package's schema, a CLI,
multi-seed sweeps); data parallelism over scenes in ``train()``
(``parallel/``: ranks of a ``torch.distributed`` group, ``torchrun`` with
the CLI's ``--num_devices``):

    from grouptraj_torch.serve import Predictor
    p = Predictor.from_checkpoint("models/grouptraj/zara1_12_with_model.pt")
    samples = p.predict(xy)        # xy [n, obs_len, 2] -> [k, n, pred_len, 2]

    python -m grouptraj_torch.eval.evaluate_model --model_path CKPT

    from grouptraj_torch.train import train
    ckpt = train(cfg, tcfg)        # or: python -m grouptraj_torch.train.cli

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
