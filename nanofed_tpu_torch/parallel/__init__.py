from nanofed_tpu_torch.parallel.round_step import (
    RoundStepResult,
    build_round_step,
    client_deltas,
    init_server_state,
)

__all__ = ["RoundStepResult", "build_round_step", "client_deltas", "init_server_state"]
