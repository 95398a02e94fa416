"""Autotuning (counterpart of ``nanofed_tpu/tuning``): the round configuration
(``client_chunk`` x ``rounds_per_block`` x batch size; the mesh and adapter axes are
recorded as rejected until their slices land) picked from profiled candidates — see
``tuning.autotuner`` for the scoring bases and how they differ from the JAX
package's compile-only sweep — the fused-vs-unfused aggregation-epilogue table
(``tuning.epilogues``, kernels B4 and B2), the online retuner, and the kernel-build
cache (``tuning.compile_cache``: the manifest of the built CUDA libraries, the
hit/miss counters and the warm pass)."""

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
from nanofed_tpu_torch.tuning.compile_cache import (
    WarmResult,
    build_manifest,
    install_compile_cache_metrics,
    verify_manifest,
    warm,
    write_manifest,
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
    "WarmResult",
    "autotune",
    "build_manifest",
    "candidate_program_name",
    "format_candidate_table",
    "install_compile_cache_metrics",
    "order_by_predicted_compile_cost",
    "predicted_compile_cost",
    "profile_aggregation_epilogues",
    "rank_candidates",
    "register_epilogue_programs",
    "resolve_hbm_budget",
    "verify_manifest",
    "warm",
    "write_manifest",
]
