"""Autotuning (counterpart of ``nanofed_tpu/tuning``): the round configuration
(``client_chunk`` x ``rounds_per_block`` x batch size; the mesh and adapter axes are
recorded as rejected until their slices land) picked from profiled candidates — see
``tuning.autotuner`` for the scoring bases and how they differ from the JAX
package's compile-only sweep — the fused-vs-unfused aggregation-epilogue table
(``tuning.epilogues``, kernels B4 and B2), and the online retuner.  The JAX
package's ``compile_cache`` and the ``profile --sweep`` / ``run --autotune`` command
line come with later slices."""

from nanofed_tpu_torch.tuning.autotuner import (
    AutotuneError,
    AutotuneResult,
    CandidateConfig,
    CandidateOutcome,
    PopulationSpec,
    TuningSpace,
    autotune,
    candidate_program_name,
    format_candidate_table,
    order_by_predicted_compile_cost,
    predicted_compile_cost,
    rank_candidates,
    resolve_hbm_budget,
)
from nanofed_tpu_torch.tuning.epilogues import (
    profile_aggregation_epilogues,
    register_epilogue_programs,
)
from nanofed_tpu_torch.tuning.retuner import OnlineRetuner, RetuneDecision

__all__ = [
    "AutotuneError",
    "AutotuneResult",
    "CandidateConfig",
    "CandidateOutcome",
    "OnlineRetuner",
    "PopulationSpec",
    "RetuneDecision",
    "TuningSpace",
    "autotune",
    "candidate_program_name",
    "format_candidate_table",
    "order_by_predicted_compile_cost",
    "predicted_compile_cost",
    "profile_aggregation_epilogues",
    "rank_candidates",
    "register_epilogue_programs",
    "resolve_hbm_budget",
]
