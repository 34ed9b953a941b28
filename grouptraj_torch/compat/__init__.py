"""Checkpoint configs and weight carry-over between grouptraj and the port."""

from grouptraj_torch.compat.torch_import import (  # noqa: F401
    config_from_checkpoint_args, discriminator_state, generator_state,
    params_from_jax,
)
