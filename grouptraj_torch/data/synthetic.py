"""Synthetic ETH/UCY-format scene files, for parity tests and on-card runs
where the real splits are absent.

Each file is tab-separated ``frame ped x y group`` rows, frames stepping
by 10 (the datasets' 2.5 fps), as the real files are. Pedestrians arrive
alone (group label 0) or as pairs and triples sharing a non-zero label,
walk at about 1.3 m/s for 20-80 frames and leave; the number present
sweeps between 2 and ``max_peds`` over each file, so the windows range
from small to crowded scenes.
"""

from __future__ import annotations

import math
import os
from typing import List

import numpy as np


def write_scene_files(data_dir: str, n_files: int = 3, frames: int = 560,
                      max_peds: int = 57, seed: int = 0) -> List[str]:
    """Write ``n_files`` scene files of ``frames`` frames each into
    ``data_dir`` (created if missing) -> their paths. Deterministic in
    ``seed``."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for f in range(n_files):
        lines = []
        walkers = []          # [ped id, position, velocity, frames left, label]
        next_id, next_label = 1, 1
        phase = rng.uniform(0, 2 * math.pi)
        for t in range(frames):
            target = 2 + (max_peds - 2) * 0.5 * (
                1 - math.cos(2 * math.pi * t / frames * (1 + f % 2) + phase))
            while len(walkers) + 3 <= max_peds and len(walkers) < target:
                size = int(rng.choice([1, 2, 3], p=[0.4, 0.35, 0.25]))
                label = 0 if size == 1 else next_label
                next_label += size > 1
                heading = rng.uniform(0, 2 * math.pi)
                # ~1.3 m/s at 0.4 s a frame
                speed = 0.4 * max(rng.normal(1.3, 0.2), 0.3)
                vel = speed * np.array([math.cos(heading), math.sin(heading)])
                base = rng.uniform(-12, 12, 2)
                life = int(rng.integers(20, 81))
                for _ in range(size):
                    walkers.append([next_id, base + rng.normal(0, 0.5, 2),
                                    vel.copy(), life, label])
                    next_id += 1
            survivors = []
            for w in walkers:
                w[2] = w[2] + rng.normal(0, 0.02, 2)     # a slow drift
                w[1] = w[1] + w[2]
                lines.append(f"{10.0 * t}\t{float(w[0])}\t{w[1][0]:.5f}\t"
                             f"{w[1][1]:.5f}\t{float(w[4])}")
                w[3] -= 1
                if w[3] > 0:
                    survivors.append(w)
            walkers = survivors
        path = os.path.join(data_dir, f"scene_{f}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        paths.append(path)
    return paths
