"""The precision of the social-pool pair core's product (counterpart of
``jax_default_matmul_precision`` as ``grouptraj/ops/pallas_pool.py:
_use_bf16`` reads it).

The TPU kernel rounds both operands of ``relu(a_j − u_i) @ W2`` (and of
its backward's two products) to bfloat16, with float32 accumulation, at
JAX's default precision, and computes them in float32 at ``"highest"``.
The port keeps one setting with JAX's names and the same truth table:

- ``None``, ``"default"``, ``"bfloat16"``, ``"fastest"`` and
  ``"tensorfloat32"`` select the bfloat16 mode;
- ``"high"``, ``"bfloat16_3x"``, ``"highest"`` and ``"float32"`` select
  the float32-exact mode;
- any other name raises ``ValueError``.

Its initial value comes from ``GROUPTRAJ_TORCH_DEFAULT_MATMUL_PRECISION``
(the counterpart of ``JAX_DEFAULT_MATMUL_PRECISION``) and is
``"highest"`` where that is unset: the port's default is the exact mode,
while the JAX package's scripts run the bfloat16 one. The setting governs
the pool core's kernel route only (``pool_hidden_net`` with ``impl``
``'kernel'``, or ``'auto'`` on CUDA tensors), as ``_use_bf16`` governs only
the Pallas core; every other product of the port stays float32, and
``torch.set_float32_matmul_precision`` is neither read nor set.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

ENV = "GROUPTRAJ_TORCH_DEFAULT_MATMUL_PRECISION"
BF16_NAMES = (None, "default", "bfloat16", "fastest", "tensorfloat32")
EXACT_NAMES = ("high", "bfloat16_3x", "highest", "float32")


def _checked(name: Optional[str]) -> Optional[str]:
    if name not in BF16_NAMES + EXACT_NAMES:
        raise ValueError(f"unknown matmul precision {name!r}; one of "
                         f"{BF16_NAMES + EXACT_NAMES}")
    return name


_precision = _checked(os.environ.get(ENV, "highest"))


def get_default_matmul_precision() -> Optional[str]:
    return _precision


def set_default_matmul_precision(name: Optional[str]) -> None:
    """Set the pool core's precision by one of JAX's names (module
    docstring); takes effect at the next pool call."""
    global _precision
    _precision = _checked(name)


@contextlib.contextmanager
def default_matmul_precision(name: Optional[str]) -> Iterator[None]:
    """Within the block the setting is ``name``; the old value comes back
    on the way out, also after an error."""
    old = _precision
    set_default_matmul_precision(name)
    try:
        yield
    finally:
        set_default_matmul_precision(old)


def use_bf16() -> bool:
    """Whether the pool core runs in its bfloat16 mode."""
    return _precision in BF16_NAMES
