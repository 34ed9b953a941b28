"""grouptraj_torch — the PyTorch/CUDA port of grouptraj.

A second package beside the JAX reference ``grouptraj/``. It imports torch
and numpy, never jax, optax or grouptraj; every TPU kernel on a ported path
is a hand-written CUDA kernel under ``csrc/`` with a plain PyTorch twin in
the same module. Ported for the ``gat`` preset: the serving path and one
training iteration (``train/steps.py``: d-step + g-step):

    from grouptraj_torch.serve import Predictor
    p = Predictor.from_checkpoint("models/grouptraj/zara1_12_with_model.pt")
    samples = p.predict(xy)        # xy [n, obs_len, 2] -> [k, n, pred_len, 2]

    from grouptraj_torch.train.steps import init_train_state, train_iterations
    state = init_train_state(cfg, tcfg)
    losses = train_iterations(state, data, idx, cfg, tcfg)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
