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
from nanofed_tpu_torch.trainer.schedules import SCHEDULES, lr_schedule_scale, lr_schedule_scales

__all__ = [
    "SCHEDULES",
    "SGD",
    "LocalFitResult",
    "StepStats",
    "TrainingConfig",
    "client_keys",
    "draw_permutations",
    "lr_schedule_scale",
    "lr_schedule_scales",
    "make_evaluator",
    "make_grad_fn",
    "make_local_fit",
    "make_optimizer",
]
