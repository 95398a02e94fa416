from nanofed_tpu_torch.trainer.api import Trainer
from nanofed_tpu_torch.trainer.callbacks import (
    BaseCallback,
    Callback,
    MetricsLogger,
    TelemetryCallback,
)
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
from nanofed_tpu_torch.trainer.personalization import (
    make_personalized_evaluator,
    split_client_data,
)
from nanofed_tpu_torch.trainer.private import (
    get_privacy_spent,
    local_fit_noise_events,
    make_dp_grad_fn,
    make_private_local_fit,
    record_local_fit,
    validate_privacy_budget,
)
from nanofed_tpu_torch.trainer.scaffold import (
    ScaffoldFitResult,
    make_scaffold_local_fit,
    stack_zero_controls,
    zero_controls,
)
from nanofed_tpu_torch.trainer.schedules import SCHEDULES, lr_schedule_scale, lr_schedule_scales

__all__ = [
    "SCHEDULES",
    "SGD",
    "BaseCallback",
    "Callback",
    "LocalFitResult",
    "MetricsLogger",
    "ScaffoldFitResult",
    "StepStats",
    "TelemetryCallback",
    "Trainer",
    "TrainingConfig",
    "client_keys",
    "draw_permutations",
    "get_privacy_spent",
    "local_fit_noise_events",
    "lr_schedule_scale",
    "lr_schedule_scales",
    "make_dp_grad_fn",
    "make_evaluator",
    "make_grad_fn",
    "make_local_fit",
    "make_optimizer",
    "make_personalized_evaluator",
    "make_private_local_fit",
    "make_scaffold_local_fit",
    "record_local_fit",
    "split_client_data",
    "stack_zero_controls",
    "validate_privacy_budget",
    "zero_controls",
]
