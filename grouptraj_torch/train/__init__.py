"""Training side of the port: the d/g steps and the metric pass
(``steps``), the device-resident dataset and index streams
(``device_data``), checkpoints in the JAX package's schema
(``checkpoint``), the training loop (``loop.train``) and its CLI
(``python -m grouptraj_torch.train.cli``), and multi-seed sweeps
(``multi.train_many``, ``python -m grouptraj_torch.train.cli_many``)."""

from grouptraj_torch.train.steps import (  # noqa: F401
    TrainState, check_accuracy, d_step, g_step, init_train_state,
    make_check_accuracy_step, make_check_accuracy_sweep,
    summarize_check_accuracy, train_iterations,
)
from grouptraj_torch.train.checkpoint import (  # noqa: F401
    checkpoint_from_state, load_checkpoint, new_checkpoint, save_checkpoint,
    state_from_checkpoint,
)
from grouptraj_torch.train.loop import train  # noqa: F401
from grouptraj_torch.train.multi import train_many  # noqa: F401
