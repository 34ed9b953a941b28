"""Best-of-N evaluation of the port (counterpart of ``grouptraj/eval``)."""

from grouptraj_torch.eval.evaluate import (  # noqa: F401
    eval_step, evaluate, evaluate_bucketed,
)
