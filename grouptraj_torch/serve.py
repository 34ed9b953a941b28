"""Serving API: checkpoint -> best-of-k predictor (counterpart of
``grouptraj/serve.py``).

Given the observed window of a live scene, return k sampled futures:

    p = Predictor.from_checkpoint("models/grouptraj/zara1_12_with_model.pt")
    samples = p.predict(xy, groups)      # xy [n, obs_len, 2] -> [k, n, pred_len, 2]

Scenes pad to bucket sizes on both axes — pedestrians per scene to
``buckets`` and scenes per call to ``s_buckets`` — with all-invalid pad
scenes; scenes are independent through the whole model, so padding cannot
perturb real outputs. Each call runs the context once and all k samples in
one K-tiled decode. Runs on ``cuda`` unless ``device`` names another.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.utils import relative_to_abs, resolve_device, round_up


class Predictor:
    def __init__(self, state_dict: Mapping, cfg: ModelConfig,
                 num_samples: int = 20,
                 buckets: Sequence[int] = (8, 16, 32, 64), seed: int = 0,
                 param_dtype: Union[str, torch.dtype, None] = "bfloat16",
                 s_buckets: Sequence[int] = (1, 4, 16, 64, 256),
                 device: Union[str, torch.device, None] = None):
        """``state_dict``: the generator's torch-named weights (a
        checkpoint's ``g_state``; numpy arrays or tensors).

        ``param_dtype``: the weights are held on the device in this dtype
        (default bfloat16) and upcast to float32 where each is used;
        activations and positions stay float32. ``None`` or "float32"
        serves in exact float32.

        ``s_buckets``: scene-count pad targets for :meth:`predict_batch`
        (above the largest, round up to its multiple).

        ``device``: where the model runs; default ``cuda``, which raises
        when no CUDA device is present."""
        from grouptraj_torch.compat import generator_state

        self.device = resolve_device(device)
        model = TrajectoryGenerator(cfg)
        model.load_state_dict(generator_state(state_dict))
        if isinstance(param_dtype, str):
            param_dtype = getattr(torch, param_dtype)
        if param_dtype is not None:
            model.to(param_dtype)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.num_samples = num_samples
        self.buckets = sorted(buckets)
        self.s_buckets = sorted(s_buckets)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    @classmethod
    def from_checkpoint(cls, path: str, num_samples: int = 20,
                        use_best: bool = True, **kw) -> "Predictor":
        from grouptraj_torch.compat import config_from_checkpoint_args
        from grouptraj_torch.train.checkpoint import load_checkpoint

        ckpt = load_checkpoint(path)
        if ckpt is None or ckpt.get("g_state") is None:
            raise FileNotFoundError(f"no model weights at {path}")
        state = ckpt["g_best_state"] if (
            use_best and ckpt.get("g_best_state") is not None
        ) else ckpt["g_state"]
        cfg = config_from_checkpoint_args(ckpt["args"], state)
        return cls(state, cfg, num_samples, **kw)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return round_up(n, self.buckets[-1])

    def _s_bucket(self, s: int) -> int:
        for b in self.s_buckets:
            if s <= b:
                return b
        return round_up(s, self.s_buckets[-1])

    def predict(self, xy: np.ndarray, groups: Optional[np.ndarray] = None,
                noises: Optional[torch.Tensor] = None) -> np.ndarray:
        """One scene: xy [n, obs_len, 2] absolute positions, groups [n]
        (0 = ungrouped; omit for no group info) -> [num_samples, n,
        pred_len, 2]."""
        out = self.predict_batch([xy], [groups] if groups is not None
                                 else None, noises)
        return out[0]

    def pad_batch(self, scenes: Sequence[np.ndarray],
                  groups: Optional[Sequence[np.ndarray]] = None):
        """Scenes of any sizes, padded to their bucket and put on the
        device -> (obs, obs_rel, group, valid): [S, N, obs_len, 2] twice and
        [S, N] twice, with S = ``_s_bucket(len(scenes))`` and
        N = ``_bucket(max n_i)``."""
        To = self.cfg.obs_len
        S = self._s_bucket(len(scenes))
        N = self._bucket(max(s.shape[0] for s in scenes))
        obs = np.zeros((S, N, To, 2), np.float32)
        grp = np.zeros((S, N), np.float32)
        valid = np.zeros((S, N), np.float32)
        for i, s in enumerate(scenes):
            n = s.shape[0]
            if s.shape != (n, To, 2):
                raise ValueError(
                    f"scene {i}: expected [n, {To}, 2], got {s.shape}")
            obs[i, :n] = s
            valid[i, :n] = 1.0
            if groups is not None and groups[i] is not None:
                grp[i, :n] = groups[i]
        obs_rel = np.zeros_like(obs)
        obs_rel[:, :, 1:] = obs[:, :, 1:] - obs[:, :, :-1]
        obs_rel *= valid[..., None, None]
        return tuple(torch.from_numpy(x).to(self.device)
                     for x in (obs, obs_rel, grp, valid))

    @torch.inference_mode()
    def predict_batch(self, scenes: Sequence[np.ndarray],
                      groups: Optional[Sequence[np.ndarray]] = None,
                      noises: Optional[torch.Tensor] = None) -> list:
        """Scenes of any sizes -> one [num_samples, n_i, pred_len, 2] array
        each. ``noises`` ([num_samples, S_pad, N_pad, noise_dim], optional)
        replaces the draws from the predictor's generator — the padded
        shape is that of :meth:`pad_batch`."""
        obs_t, rel_t, grp_t, valid_t = self.pad_batch(scenes, groups)
        if noises is not None:
            noises = torch.as_tensor(noises, dtype=torch.float32,
                                     device=self.device)
        ctx = self.model.generator_context(obs_t, rel_t, grp_t, valid_t)
        preds = self.model.generator_sample_many(
            ctx, rel_t, valid_t, self.num_samples, self._gen,
            user_noises=noises, obs=obs_t,
            group_end=grp_t)                               # [k, S, N, Tp, 2]
        preds = relative_to_abs(preds, obs_t[None, :, :, -1, :]).cpu().numpy()
        return [preds[:, i, :s.shape[0]] for i, s in enumerate(scenes)]
