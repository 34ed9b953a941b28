"""Checkpoint configs, weight and optimizer-state carry-over between
grouptraj and the port."""

from grouptraj_torch.compat.torch_import import (  # noqa: F401
    adam_from_optax, config_from_checkpoint_args, discriminator_state,
    generator_state, optax_from_adam, params_from_jax, params_to_jax,
)
