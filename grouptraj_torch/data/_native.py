"""ctypes binding of the native C++ windowing engine (``native/windowing.cpp``,
the source the JAX package's loader builds too).

The library is built with ``g++`` at first use into ``grouptraj_torch/_build/``
(named by a hash of the source, so an edited source rebuilds) and loaded
once. Nothing happens at import: :func:`available` builds and loads it, and
says whether that worked; :func:`extract_windows_file` raises when it did
not. The numpy path of :mod:`grouptraj_torch.data.reader` and this one give
bit-identical windows on well-formed files; the native parser skips rows
with non-numeric tokens where the numpy path raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SRC = PKG.parent / "native" / "windowing.cpp"
BUILD_DIR = PKG / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"windowing-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    if not SRC.is_file():
        raise OSError(f"native source missing: {SRC}")
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = ["g++", *FLAGS, "-o", str(tmp), str(SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise OSError("native build failed: "
                          f"{getattr(e, 'stderr', None) or e}") from e
        os.replace(tmp, out)                  # atomic: readers see whole files
    lib = ctypes.CDLL(str(out))
    lib.gt_load_file.restype = ctypes.c_void_p
    lib.gt_load_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int]
    lib.gt_num_windows.argtypes = [ctypes.c_void_p]
    lib.gt_window_peds.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gt_copy_window.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
        [np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")] * 4
    lib.gt_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Build (once) and load the library; False when that fails (no g++,
    no source). The first failure is kept: :func:`error` returns it."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            _lib = _load()
        except OSError as e:
            _error = str(e)
    return _lib is not None


def error() -> Optional[str]:
    return _error


def extract_windows_file(path: str, obs_len: int = 8, pred_len: int = 12,
                         skip: int = 1, threshold: float = 0.002,
                         min_ped: int = 1, group_required: bool = True
                         ) -> List["RawWindow"]:
    """One file's windows through the native engine, with the semantics of
    :func:`grouptraj_torch.data.reader.extract_windows`. Raises OSError
    when the library cannot be built or loaded."""
    from grouptraj_torch.data.reader import RawWindow

    if not available():
        raise OSError(f"the native windowing library is unavailable: "
                      f"{_error}")
    h = _lib.gt_load_file(path.encode(), obs_len, pred_len, skip, threshold,
                          min_ped, int(group_required))
    if not h:
        if group_required:
            # a missing label column fails as the numpy path does
            with open(path, "r") as f:
                first = f.readline().strip()
            if first and len(first.replace("\t", " ").split()) < 5:
                raise AssertionError("dataset has no labeling")
        raise IOError(f"native loader failed on {path}")
    try:
        seq_len = obs_len + pred_len
        out: List[RawWindow] = []
        for i in range(_lib.gt_num_windows(h)):
            n = _lib.gt_window_peds(h, i)
            xy = np.empty((n, seq_len, 2), np.float32)
            rel = np.empty((n, seq_len, 2), np.float32)
            group = np.empty((n, seq_len), np.float32)
            nonlin = np.empty((n,), np.float32)
            _lib.gt_copy_window(h, i, xy, rel, group, nonlin)
            out.append(RawWindow(
                xy=xy, rel=rel, group=group, non_linear=nonlin,
                loss_mask=np.ones((n, seq_len), np.float32)))
        return out
    finally:
        _lib.gt_free(h)
