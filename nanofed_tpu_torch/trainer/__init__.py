from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import (
    SGD,
    LocalFitResult,
    StepStats,
    client_keys,
    draw_permutations,
    make_evaluator,
    make_grad_fn,
    make_local_fit,
    make_optimizer,
)

__all__ = [
    "SGD",
    "LocalFitResult",
    "StepStats",
    "TrainingConfig",
    "client_keys",
    "draw_permutations",
    "make_evaluator",
    "make_grad_fn",
    "make_local_fit",
    "make_optimizer",
]
