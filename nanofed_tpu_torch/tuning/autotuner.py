"""Autotuning of the round configuration from profiled programs (counterpart of
``nanofed_tpu/tuning/autotuner.py``).

The sweep builds every candidate's round step (or, with ``rounds_per_block`` R > 1,
its R-round block) through the same ``parallel.build_round_step`` and
``parallel.build_round_block`` the ``Coordinator`` runs, with the candidate's
``client_chunk`` and per-client batch size, and profiles it
(``observability.profiling.profile_program``) on inputs of the population's shapes
and dtypes made on the device from a fixed seed: mask all ones, weights one.  The
caller's data is never touched.

One difference from the JAX package is stated, not hidden: the JAX autotuner scores
candidates with ZERO executions, from XLA's ahead-of-time cost and memory analysis.
PyTorch runs eagerly and has no such cost model for the port's round step, so here a
candidate's round RUNS (a first call, a counting call, timed calls) and its counted
FLOPs and bytes, peak device memory and measured time are what the decision logic
reads.  That logic is the JAX package's, line for line: the static feasibility
checks and their reasons, the memory-budget rejection, the ranking and its
tie-break, the cache and its key rules, the ranked artifact.

Scoring never fabricates a peak:

* **a card with a peaks row** (``observability.profiling.GPU_PEAKS``, the H100):
  candidates rank by the roofline lower bound per round,
  ``max(flops/peak_flops, bytes/peak_bandwidth)`` of the counted work;
* **the CPU and unknown cards**: by counted bytes per round, a relative ordering
  and NOT a walltime; the artifact says so in ``scoring_basis``.

The measured time per round rides in each candidate's ``cost``
(``measured_s_per_round``), where the online retuner's write-back puts its own.

A block candidate is profiled over its R rounds (``profile_program(..., rounds=R)``),
so its scores are per round, as the round step's.  The port runs on one card, so
``model_shards > 1`` and ``hosts > 1`` (mesh axes) and ``adapter_rank`` (LoRA) are
recorded as rejected with the slice that brings them; they are never raised.  Only a
``torch.cuda.OutOfMemoryError`` turns a profiled candidate into a rejection: any
other exception propagates, so a failing kernel cannot pass for an infeasible
candidate.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable

import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.utils.logger import Logger

__all__ = [
    "AutotuneError",
    "AutotuneResult",
    "CandidateConfig",
    "CandidateOutcome",
    "PopulationSpec",
    "TuningSpace",
    "autotune",
    "candidate_program_name",
    "format_candidate_table",
    "order_by_predicted_compile_cost",
    "predicted_compile_cost",
    "rank_candidates",
    "resolve_hbm_budget",
]

_log = Logger()

#: Where :func:`autotune` caches sweep results (``.gitignore`` lists it).
DEFAULT_CACHE_DIR = ".nanofed_torch_cache"

# The later slices that bring the axes this port does not sweep yet.
_LATER_AXES = {
    "model_shards": "the model mesh axis comes with the multi-GPU slice "
                    "(ROADMAP queue A item 9b)",
    "hosts": "the hosts mesh axis comes with the multi-GPU slice "
             "(ROADMAP queue A items 9b and 17)",
    "adapter_rank": "LoRA adapters come with the adapters slice "
                    "(ROADMAP queue A item 16)",
}


def _dtype_name(a: Any) -> str:
    """numpy's name of an array's or tensor's dtype ("float32", "int64")."""
    return str(a.dtype).removeprefix("torch.")


def _pad_client_count(num_clients: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= ``num_clients`` (the JAX mesh rule)."""
    return ((num_clients + n_devices - 1) // n_devices) * n_devices


class AutotuneError(NanoFedError):
    """No feasible candidate survived the sweep (every configuration was
    rejected); the artifact still records the full table with reasons."""


@dataclass(frozen=True)
class PopulationSpec:
    """The client population's SHAPES — all the tuner needs to build inputs.

    ``capacity`` is the packed per-client sample capacity (the ``[C, N, ...]``
    second dim of ``ClientData``); candidate batch sizes must divide it, which is
    exactly the constraint ``trainer.local`` enforces at dispatch."""

    num_clients: int
    capacity: int
    sample_shape: tuple[int, ...]
    x_dtype: str = "float32"
    y_dtype: str = "int32"
    mask_dtype: str = "float32"

    @classmethod
    def from_client_data(cls, data: Any) -> "PopulationSpec":
        """Shapes and dtypes of a ``ClientData`` (numpy arrays, as the packers make
        them, or tensors); dtypes are named as numpy names them ("float32")."""
        return cls(
            num_clients=int(data.x.shape[0]),
            capacity=int(data.x.shape[1]),
            sample_shape=tuple(int(d) for d in data.x.shape[2:]),
            x_dtype=_dtype_name(data.x),
            y_dtype=_dtype_name(data.y),
            mask_dtype=_dtype_name(data.mask),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True, order=True)
class CandidateConfig:
    """One point of the swept configuration space.  Ordered (field order) so the
    deterministic last-resort tie-break is the dataclass ordering itself.
    ``hosts`` (default 1: every pre-multi-host candidate) is the hosts-axis
    size of the mesh the candidate lowers on — >1 builds the 3-axis
    ``hosts x clients x model`` mesh with hierarchical aggregation.
    ``adapter_rank`` (default None: dense full fine-tune) lowers the
    parameter-efficient frozen-base round program at that LoRA rank — the
    federated/aggregated tree is the adapter tree, the base crosses as a
    read-only model-sharded input (the JAX package's ``adapters``)."""

    client_chunk: int | None
    rounds_per_block: int
    model_shards: int
    batch_size: int
    hosts: int = 1
    adapter_rank: int | None = None

    @property
    def key(self) -> tuple[int, int, int, int, int, int]:
        """Stable sort key (``None`` chunk/rank order first as 0)."""
        return (
            self.client_chunk or 0, self.rounds_per_block,
            self.model_shards, self.batch_size, self.hosts,
            self.adapter_rank or 0,
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "client_chunk": self.client_chunk,
            "rounds_per_block": self.rounds_per_block,
            "model_shards": self.model_shards,
            "batch_size": self.batch_size,
            "hosts": self.hosts,
            "adapter_rank": self.adapter_rank,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CandidateConfig":
        return cls(
            client_chunk=d.get("client_chunk"),
            rounds_per_block=int(d["rounds_per_block"]),
            model_shards=int(d["model_shards"]),
            batch_size=int(d["batch_size"]),
            hosts=int(d.get("hosts", 1)),
            adapter_rank=d.get("adapter_rank"),
        )


def _divisor_ladder(n: int, limit: int = 3) -> list[int]:
    """Up to ``limit`` proper divisors of ``n``, spread across its range (small,
    ~sqrt, large) — the interesting chunk sizes without a full divisor sweep."""
    divs = [d for d in range(1, n) if n % d == 0]
    if not divs:
        return []
    if len(divs) <= limit:
        return divs
    picks = {divs[0], divs[len(divs) // 2], divs[-1]}
    return sorted(picks)[:limit]


@dataclass(frozen=True)
class TuningSpace:
    """The candidate grid.  Build one explicitly, or derive a modest default from
    the population/device geometry with :meth:`default` — the default keeps the
    cross product small (a sweep profiles every candidate: it runs its round)."""

    client_chunks: tuple[int | None, ...]
    rounds_per_blocks: tuple[int, ...]
    model_shards: tuple[int, ...]
    batch_sizes: tuple[int, ...]
    #: Hosts-axis sizes to sweep; (1,) = single-host meshes only, the one the port
    #: runs until the multi-GPU slice.
    hosts: tuple[int, ...] = (1,)
    #: LoRA ranks to sweep (the parameter-efficient axis); (None,) = dense
    #: full fine-tune only.  Engaged when :func:`autotune` is given an
    #: ``adapter=`` spec: the default becomes a ladder around the spec's rank
    #: (rank/2, rank, 2*rank), every candidate frozen-base.
    adapter_ranks: tuple[int | None, ...] = (None,)

    @classmethod
    def default(
        cls,
        population: PopulationSpec,
        n_devices: int,
        batch_size: int,
        num_rounds: int,
        hosts: tuple[int, ...] | None = None,
        adapter_rank: int | None = None,
    ) -> "TuningSpace":
        if hosts is None:
            # The port runs one process on one card: the hosts axis is (1,) until
            # the multi-GPU slice (ROADMAP queue A item 9b).
            hosts = (1,)

        per_dev = _pad_client_count(population.num_clients, n_devices) // n_devices
        chunks: list[int | None] = [None] + [
            d for d in _divisor_ladder(per_dev, limit=2)
        ]
        rpbs = tuple(sorted({1, min(4, num_rounds), min(8, num_rounds)}))
        shards = (1, 2) if n_devices % 2 == 0 and n_devices > 1 else (1,)
        batches = tuple(sorted({
            b for b in (batch_size // 2, batch_size, batch_size * 2)
            if 1 <= b <= population.capacity and population.capacity % b == 0
        })) or (batch_size,)
        # THE one home of the adapter-rank space rule: with a spec'd rank r the
        # sweep covers the ladder {max(1, r//2), r, 2r} — enough to show where
        # rank stops paying without exploding the cross product.
        ranks: tuple[int | None, ...] = (None,)
        if adapter_rank is not None:
            ranks = tuple(sorted({max(1, adapter_rank // 2), adapter_rank,
                                  2 * adapter_rank}))
        return cls(
            client_chunks=tuple(chunks),
            rounds_per_blocks=rpbs,
            model_shards=shards,
            batch_sizes=batches,
            hosts=tuple(hosts),
            adapter_ranks=ranks,
        )

    def candidates(self) -> list[CandidateConfig]:
        out = []
        for chunk in self.client_chunks:
            for rpb in self.rounds_per_blocks:
                for shards in self.model_shards:
                    for b in self.batch_sizes:
                        for h in self.hosts:
                            for r in self.adapter_ranks:
                                out.append(
                                    CandidateConfig(chunk, rpb, shards, b, h, r)
                                )
        return sorted(set(out), key=lambda c: c.key)

    def to_dict(self) -> dict[str, Any]:
        return {
            "client_chunks": list(self.client_chunks),
            "rounds_per_blocks": list(self.rounds_per_blocks),
            "model_shards": list(self.model_shards),
            "batch_sizes": list(self.batch_sizes),
            "hosts": list(self.hosts),
            "adapter_ranks": list(self.adapter_ranks),
        }


@dataclass
class CandidateOutcome:
    """One candidate's fate: a score (feasible) or a rejection reason, plus the
    per-round cost summary the ranked table prints."""

    config: CandidateConfig
    feasible: bool
    reject_reason: str | None = None
    score: float | None = None
    cost: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "config": self.config.to_dict(),
            "feasible": self.feasible,
            **({"reject_reason": self.reject_reason}
               if self.reject_reason else {}),
            **({"score": self.score} if self.score is not None else {}),
            **({"cost": self.cost} if self.cost else {}),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CandidateOutcome":
        return cls(
            config=CandidateConfig.from_dict(d["config"]),
            feasible=bool(d["feasible"]),
            reject_reason=d.get("reject_reason"),
            score=d.get("score"),
            cost=d.get("cost", {}),
        )


def rank_candidates(outcomes: Iterable[CandidateOutcome]) -> list[CandidateOutcome]:
    """Deterministic ranking: feasible candidates by ascending score, exact ties
    broken toward the LARGER ``rounds_per_block`` (the JAX package's rule: its AOT
    cost model cannot see the per-round host tax fused blocks amortize), then the
    smaller device-memory peak, then the stable candidate key; rejected candidates
    follow in key order.

    Pure — unit-testable without running a program."""
    outcomes = list(outcomes)
    feasible = [o for o in outcomes if o.feasible]
    rejected = [o for o in outcomes if not o.feasible]
    feasible.sort(key=lambda o: (
        o.score,
        -o.config.rounds_per_block,
        o.cost.get("peak_bytes", 0),
        o.config.key,
    ))
    rejected.sort(key=lambda o: o.config.key)
    return feasible + rejected


def predicted_compile_cost(cand: CandidateConfig) -> float:
    """A dimensionless predictor of a candidate's cost to get ready, for SWEEP
    ORDERING only (never for scoring), kept as the JAX package weighs it (there: the
    XLA compile) so both packages sweep a space in the same order: fused
    multi-round blocks, client chunking, extra mesh axis cells and the adapter path
    each add work.  The weights are coarse on purpose — the point is that a
    budget-killed sweep dies in the expensive tail, not before the cheap feasible
    head was profiled."""
    return (
        (1.0 if cand.rounds_per_block > 1 else 0.0)
        + (0.5 if cand.client_chunk is not None else 0.0)
        + float(cand.hosts * cand.model_shards - 1)
        + (0.25 if cand.adapter_rank is not None else 0.0)
    )


def order_by_predicted_compile_cost(
    candidates: Iterable[CandidateConfig],
) -> list[CandidateConfig]:
    """Cheapest-first sweep order (stable: ties fall back to the candidate key, so
    equal spaces sweep identically).  This is THE sweep order of :func:`autotune`:
    under a profiling budget the cheap single-round candidates land first, so a
    budget- or wedge-killed sweep still holds a feasible winner."""
    return sorted(candidates, key=lambda c: (predicted_compile_cost(c), c.key))


def candidate_program_name(cand: CandidateConfig) -> str:
    """The ``ProgramCatalog``/telemetry name a candidate's lowered round
    program is registered and recorded under."""
    return (
        f"cand_chunk{cand.client_chunk or 0}_rpb{cand.rounds_per_block}"
        f"_m{cand.model_shards}_b{cand.batch_size}_h{cand.hosts}"
        + (f"_r{cand.adapter_rank}" if cand.adapter_rank is not None else "")
    )


def resolve_hbm_budget(
    explicit: int | None = None, device: DeviceLike = None
) -> tuple[int | None, str]:
    """The device memory budget candidates must fit, with its provenance: explicit
    argument > ``NANOFED_AUTOTUNE_HBM_BUDGET`` env > the card's
    ``torch.cuda.get_device_properties().total_memory`` > None on the CPU (no
    rejection — stated as unbounded, never a fabricated limit).  ``device=None``
    means the card, as at every entry point: without one it raises."""
    if explicit is not None:
        return int(explicit), "explicit hbm_budget_bytes argument"
    env = os.environ.get("NANOFED_AUTOTUNE_HBM_BUDGET")
    if env:
        return int(float(env)), "NANOFED_AUTOTUNE_HBM_BUDGET environment variable"
    dev = resolve_device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return int(props.total_memory), (
            f"torch.cuda.get_device_properties total_memory ({props.name})"
        )
    return None, (
        f"unbounded — no device memory limit known for platform={dev.type!r}; pass "
        "hbm_budget_bytes= or set NANOFED_AUTOTUNE_HBM_BUDGET to enable rejection"
    )


@dataclass
class AutotuneResult:
    """The sweep's outcome: the winner, the full ranked table, and enough basis
    fields that a reader of the artifact alone can audit the choice."""

    winner: CandidateConfig | None
    outcomes: list[CandidateOutcome]
    scoring_basis: str
    platform: str
    device_kind: str
    num_devices: int
    hbm_budget_bytes: int | None
    budget_basis: str
    cache_key: str
    cache_hit: bool = False
    compiles: int = 0
    compile_seconds_total: float = 0.0
    #: The sweep's compile budget (seconds), when one was set — candidates
    #: beyond the budget are in ``outcomes`` with ``skipped: compile_budget``.
    compile_budget_s: float | None = None
    #: Candidates never compiled because the budget ran out or the sweep
    #: wedged (counted so the artifact states its own incompleteness).
    skipped: int = 0
    #: Program name of the candidate whose compile blew the per-candidate
    #: deadline, when one did — the r14 postmortem field.
    wedged_at: str | None = None
    space: dict[str, Any] = field(default_factory=dict)
    population: dict[str, Any] = field(default_factory=dict)
    epilogues: dict[str, Any] = field(default_factory=dict)
    artifact_path: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "winner": self.winner.to_dict() if self.winner else None,
            "candidates": [o.to_dict() for o in self.outcomes],
            "scoring_basis": self.scoring_basis,
            "tie_break": (
                "exact score ties prefer larger rounds_per_block (AOT cost "
                "cannot see the per-round host dispatch tax fused blocks "
                "amortize), then smaller peak_bytes, then the candidate key"
            ),
            "platform": self.platform,
            "device_kind": self.device_kind,
            "num_devices": self.num_devices,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "budget_basis": self.budget_basis,
            "cache_key": self.cache_key,
            "cache_hit": self.cache_hit,
            "compiles": self.compiles,
            "compile_seconds_total": round(self.compile_seconds_total, 4),
            **({"compile_budget_s": self.compile_budget_s}
               if self.compile_budget_s is not None else {}),
            **({"skipped": self.skipped} if self.skipped else {}),
            **({"wedged_at": self.wedged_at} if self.wedged_at else {}),
            "space": self.space,
            "population": self.population,
            **({"epilogues": self.epilogues} if self.epilogues else {}),
        }

    def telemetry_payload(self) -> dict[str, Any]:
        """The ``autotune`` telemetry-record fields (what ``metrics-summary`` digests
        into its ``autotunes`` block): the JAX package's keys."""
        feasible = [o for o in self.outcomes if o.feasible]
        return {
            "winner": self.winner.to_dict() if self.winner else None,
            "scoring_basis": self.scoring_basis,
            "platform": self.platform,
            "device_kind": self.device_kind,
            "num_devices": self.num_devices,
            "candidates_total": len(self.outcomes),
            "candidates_feasible": len(feasible),
            "cache_key": self.cache_key,
            "cache_hit": self.cache_hit,
            "compiles": self.compiles,
            "compile_seconds_total": round(self.compile_seconds_total, 4),
            **({"skipped": self.skipped} if self.skipped else {}),
            **({"wedged_at": self.wedged_at} if self.wedged_at else {}),
            **({"best_score": feasible[0].score} if feasible else {}),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AutotuneResult":
        return cls(
            winner=(
                CandidateConfig.from_dict(d["winner"])
                if d.get("winner") else None
            ),
            outcomes=[CandidateOutcome.from_dict(o) for o in d.get("candidates", [])],
            scoring_basis=d.get("scoring_basis", "?"),
            platform=d.get("platform", "?"),
            device_kind=d.get("device_kind", "?"),
            num_devices=int(d.get("num_devices", 0)),
            hbm_budget_bytes=d.get("hbm_budget_bytes"),
            budget_basis=d.get("budget_basis", "?"),
            cache_key=d.get("cache_key", "?"),
            cache_hit=bool(d.get("cache_hit", False)),
            compiles=int(d.get("compiles", 0)),
            compile_seconds_total=float(d.get("compile_seconds_total", 0.0)),
            compile_budget_s=d.get("compile_budget_s"),
            skipped=int(d.get("skipped", 0)),
            wedged_at=d.get("wedged_at"),
            space=d.get("space", {}),
            population=d.get("population", {}),
            epilogues=d.get("epilogues", {}),
        )


def _model_fingerprint(model: Any) -> dict[str, Any]:
    """Shape/dtype identity of the model's parameter tree (the cache-key
    component), from one CPU init."""
    params = model.init(torch.Generator().manual_seed(0))
    return {
        "model": getattr(model, "name", type(model).__name__),
        "leaves": [
            [name, list(leaf.shape), _dtype_name(leaf)] for name, leaf in params.items()
        ],
    }


def compute_cache_key(
    model: Any,
    population: PopulationSpec,
    training: Any,
    space: TuningSpace,
    participation: float,
    num_rounds: int,
    eval_every: int,
    device_kind: str,
    num_devices: int,
    hbm_budget: int | None = None,
    adapter: Any = None,
    platform: str = "cpu",
) -> str:
    """SHA-256 over everything that changes a sweep's outcome: model fingerprint,
    population shapes, the swept space, the non-swept training dims that shape
    the program (epochs, dtype, prox), participation/rounds geometry, the device
    kind/count, the RESOLVED memory budget, and the torch and CUDA versions with the
    platform (in place of the JAX package's jax/jaxlib): a new torch or CUDA changes
    what a round costs, so it must not serve a stale tuned config.  Learning RATE is
    deliberately excluded — it never changes a program's cost."""
    payload = {
        "v": 1,
        "package": "nanofed_tpu_torch",
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
        "platform": platform,
        "adapter": adapter.to_dict() if adapter is not None else None,
        "hbm_budget": hbm_budget,
        "model": _model_fingerprint(model),
        "population": population.to_dict(),
        "space": space.to_dict(),
        "training": {
            "local_epochs": getattr(training, "local_epochs", 1),
            "compute_dtype": getattr(training, "compute_dtype", None),
            "prox_mu": getattr(training, "prox_mu", 0.0),
        },
        "participation": participation,
        "num_rounds": num_rounds,
        "eval_every": eval_every,
        "device_kind": device_kind,
        "num_devices": num_devices,
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()


def _plan_layout(
    num_clients: int,
    n_client_shards: int,
    participation: float,
    client_chunk: int | None,
) -> tuple[int, int, int, bool]:
    """Mirror the ``Coordinator``'s step-layout rules exactly (padding, cohort
    gathering, the chunk-divisibility fallback) so the profiled candidate IS the
    program the coordinator would run.  Returns ``(padded, step_clients, cohort,
    cohort_mode)``."""
    from nanofed_tpu_torch.orchestration.types import cohort_size

    padded = _pad_client_count(num_clients, n_client_shards)
    cohort = cohort_size(num_clients, participation)
    cohort_mode = cohort < num_clients
    if cohort_mode and client_chunk is not None:
        per_dev = _pad_client_count(cohort, n_client_shards) // n_client_shards
        if client_chunk < per_dev and per_dev % client_chunk != 0:
            cohort_mode = False
    step_clients = (
        _pad_client_count(cohort, n_client_shards) if cohort_mode else padded
    )
    return padded, step_clients, cohort, cohort_mode


def _candidate_inputs(
    model: Any, population: PopulationSpec, training: Any, rows: int, strategy: Any,
    device: torch.device,
) -> tuple:
    """The round step's arguments for ``rows`` clients of the population's shapes and
    dtypes, made on ``device`` from a fixed seed: random samples and labels, mask
    all ones, weights one.  Data moves to the device as the coordinator moves it
    (``ClientData.to``)."""
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.parallel.round_step import init_server_state
    from nanofed_tpu_torch.trainer.local import client_keys, draw_permutations

    gen = torch.Generator(device=device).manual_seed(0)
    params = {
        name: p.to(device)
        for name, p in model.init(torch.Generator().manual_seed(0)).items()
    }
    cap = population.capacity
    data = ClientData(
        x=torch.randn((rows, cap, *population.sample_shape), generator=gen,
                      device=device).to(getattr(torch, population.x_dtype)),
        y=torch.randint(0, max(1, model.num_classes), (rows, cap), generator=gen,
                        device=device, dtype=getattr(torch, population.y_dtype)),
        mask=torch.ones((rows, cap), device=device,
                        dtype=getattr(torch, population.mask_dtype)),
    ).to(device)
    return (
        params, init_server_state(strategy, params), data,
        torch.ones(rows, device=device),
        draw_permutations(gen, rows, training.local_epochs, cap),
        client_keys(0, rows, device),
    )


def _evaluate_candidate(
    cand: CandidateConfig,
    model: Any,
    population: PopulationSpec,
    training: Any,
    participation: float,
    num_rounds: int,
    eval_every: int,
    n_devices: int,
    budget: int | None,
    adapter: Any = None,
    device: DeviceLike = None,
) -> CandidateOutcome:
    """Build ONE candidate's round step and profile it on inputs of the population's
    shapes (:func:`_candidate_inputs`), then score its report.  Static checks
    first: a statically infeasible candidate runs nothing."""
    import time

    from nanofed_tpu_torch.aggregation.base import fedavg_strategy
    from nanofed_tpu_torch.observability.profiling import profile_program
    from nanofed_tpu_torch.parallel.multi_round import build_round_block, round_seeds
    from nanofed_tpu_torch.parallel.round_step import build_round_step

    C, cap = population.num_clients, population.capacity

    # --- Static feasibility (the JAX package's checks; nothing runs) ---------------
    if cand.batch_size < 1 or cap % cand.batch_size != 0:
        return CandidateOutcome(cand, False, reject_reason=(
            f"batch_size {cand.batch_size} does not divide the packed "
            f"per-client capacity {cap}"
        ))
    if cand.rounds_per_block > num_rounds:
        return CandidateOutcome(cand, False, reject_reason=(
            f"rounds_per_block {cand.rounds_per_block} exceeds num_rounds "
            f"{num_rounds}"
        ))
    if (
        cand.rounds_per_block > 1
        and 0 < eval_every < cand.rounds_per_block
    ):
        return CandidateOutcome(cand, False, reject_reason=(
            f"rounds_per_block {cand.rounds_per_block} > eval_every "
            f"{eval_every}: the coordinator would fall back to single rounds "
            "(blocks are cut at eval boundaries)"
        ))
    if cand.model_shards < 1 or n_devices % cand.model_shards != 0:
        return CandidateOutcome(cand, False, reject_reason=(
            f"model_shards {cand.model_shards} does not divide the "
            f"{n_devices} available devices"
        ))
    if cand.hosts < 1 or n_devices % (cand.hosts * cand.model_shards) != 0:
        return CandidateOutcome(cand, False, reject_reason=(
            f"hosts {cand.hosts} x model_shards {cand.model_shards} does not "
            f"divide the {n_devices} available devices — the 3-axis mesh "
            "needs a full (hosts, clients, model) grid"
        ))
    n_cs = n_devices // (cand.hosts * cand.model_shards)
    n_client_shards = cand.hosts * n_cs
    padded, step_clients, cohort, cohort_mode = _plan_layout(
        C, n_client_shards, participation, cand.client_chunk
    )
    c_local = step_clients // n_client_shards
    if (
        cand.client_chunk is not None
        and cand.client_chunk < c_local
        and c_local % cand.client_chunk != 0
    ):
        return CandidateOutcome(cand, False, reject_reason=(
            f"client_chunk {cand.client_chunk} does not divide the "
            f"per-device client count {c_local}"
        ))
    if (
        cand.hosts > 1
        and cand.client_chunk is not None
        and cand.client_chunk > c_local
    ):
        return CandidateOutcome(cand, False, reject_reason=(
            f"client_chunk {cand.client_chunk} exceeds the per-device client "
            f"count ({c_local} of the {c_local * n_cs}-client per-host client "
            f"shard on the hosts={cand.hosts} topology) — chunking would "
            "silently no-op; shrink the chunk or the hosts axis"
        ))
    if cand.adapter_rank is not None and adapter is None:
        return CandidateOutcome(cand, False, reject_reason=(
            f"adapter_rank {cand.adapter_rank} swept without an adapter= spec "
            "— the tuner needs the target patterns to build the adapter tree"
        ))
    # --- Axes this port does not run yet (recorded, never raised) ------------------
    for axis, engaged in (
        ("model_shards", cand.model_shards > 1),
        ("hosts", cand.hosts > 1),
        ("adapter_rank", cand.adapter_rank is not None),
    ):
        if engaged:
            return CandidateOutcome(cand, False, reject_reason=(
                f"{axis} {getattr(cand, axis)}: not in the PyTorch port yet — "
                f"{_LATER_AXES[axis]}"
            ))

    # --- Build + profile (the candidate's round runs) ------------------------------
    dev = resolve_device(device)
    strategy = fedavg_strategy()
    training_c = dataclasses.replace(training, batch_size=cand.batch_size)
    rpb = cand.rounds_per_block
    if rpb == 1:
        fn = build_round_step(model, training_c, strategy, client_chunk=cand.client_chunk)
    else:
        fn = build_round_block(
            model, training_c, strategy, num_clients=C, padded_clients=padded,
            step_clients=step_clients, cohort_size=cohort,
            client_chunk=cand.client_chunk, collect_client_detail=False,
            cohort_mode=cohort_mode, device=dev,
        )
    name = candidate_program_name(cand)
    out_of_memory = None
    t0 = time.perf_counter()
    try:
        if rpb == 1:
            args = _candidate_inputs(model, population, training_c, step_clients, strategy,
                                     dev)
        else:
            # The block gathers from the whole population: every slot a distinct
            # client with weight, every round a full cohort's work.
            params, sos, data, _, _, _ = _candidate_inputs(
                model, population, training_c, padded, strategy, dev)
            idx = (torch.arange(step_clients, device=dev).expand(rpb, step_clients)
                   .contiguous() if cohort_mode else None)
            args = (params, sos, data, torch.ones(padded, device=dev),
                    round_seeds(0, range(rpb)), [1.0] * rpb, idx,
                    torch.ones((rpb, step_clients), device=dev))
        report = profile_program(name, fn, *args, rounds=rpb, attrs=cand.to_dict())
    except torch.cuda.OutOfMemoryError as e:
        # Only running out of device memory makes a candidate infeasible; any other
        # failure (a kernel that does not launch, a wrong shape) propagates.
        out_of_memory = str(e).splitlines()[0]
    args = None
    if out_of_memory is not None:
        torch.cuda.empty_cache()  # after the traceback's frames are gone
        return CandidateOutcome(cand, False, reject_reason=(
            f"out of device memory while profiling: {out_of_memory}"
        ))
    profile_seconds = time.perf_counter() - t0

    rounds = report.rounds
    cost = {
        "flops_per_round": report.flops / rounds,
        "bytes_accessed_per_round": report.bytes_accessed / rounds,
        "peak_bytes": report.peak_bytes,
        "arithmetic_intensity": round(report.arithmetic_intensity, 4),
        "verdict": report.verdict,
        "compile_seconds": round(report.compile_seconds, 4),
        "measured_s_per_round": report.measured_s / rounds,
        "profile_seconds": round(profile_seconds, 4),
        "step_clients": step_clients,
        "cohort_mode": cohort_mode,
    }
    if report.lower_bound_s is not None:
        cost["lower_bound_s_per_round"] = report.lower_bound_s / rounds

    if budget is not None and report.peak_bytes > budget:
        return CandidateOutcome(cand, False, reject_reason=(
            f"measured peak {report.peak_bytes:,} bytes (max_memory_allocated) "
            f"exceeds the device HBM budget {budget:,} bytes"
        ), cost=cost)

    if report.peaks is not None:
        score = report.lower_bound_s / rounds
    else:
        score = report.bytes_accessed / rounds
    return CandidateOutcome(cand, True, score=score, cost=cost)


def _scoring_basis(platform: str, has_peaks: bool, peaks_basis: str | None) -> str:
    if has_peaks:
        return (
            "roofline lower bound per round: max(flops/peak_flops, "
            "bytes_accessed/peak_bandwidth) of one profiled execution (FLOPs from "
            "torch.utils.flop_counter, bytes = eager op-level bytes + the "
            f"hand-written kernels' reported bytes) ({peaks_basis}); the measured "
            "time per round is in each candidate's cost"
        )
    return (
        "bytes-accessed ordering: counted bytes per round of one profiled "
        "execution (eager op-level bytes + the hand-written kernels' reported "
        f"bytes), lower is better — platform={platform!r} has no published "
        "peaks, so this is a relative ordering, NOT a predicted walltime"
    )


def autotune(
    model: Any,
    population: PopulationSpec | Any,
    training: Any = None,
    *,
    participation: float = 1.0,
    num_rounds: int = 1,
    eval_every: int = 0,
    space: TuningSpace | None = None,
    hbm_budget_bytes: int | None = None,
    cache_dir: str | Path | None = DEFAULT_CACHE_DIR,
    out_dir: str | Path | None = "runs",
    telemetry: Any = None,
    force: bool = False,
    include_epilogues: bool = True,
    adapter: Any = None,
    compile_budget_s: float | None = None,
    candidate_deadline_s: float | None = None,
    device: DeviceLike = None,
) -> AutotuneResult:
    """Sweep the round configuration space by profiling each candidate's round step
    on ``device`` (default: the GPU); returns the ranked :class:`AutotuneResult`
    (winner first).

    ``population`` is a :class:`PopulationSpec` or a ``ClientData`` (shapes are
    taken, data is never touched).  Results are cached under ``cache_dir`` keyed by
    (model fingerprint, population, space, training dims, device kind/count, torch
    and CUDA versions) — a cache hit profiles nothing; ``force=True`` re-sweeps.
    Raises :class:`AutotuneError` when every candidate is rejected (the artifact is
    still written first).

    The sweep is budget aware, with the JAX package's knobs: candidates are
    profiled in :func:`order_by_predicted_compile_cost` order; ``compile_budget_s``
    (env ``NANOFED_AUTOTUNE_COMPILE_BUDGET``) caps the running total of profiling
    seconds — once spent, the remaining candidates are recorded ``skipped:
    compile_budget``; ``candidate_deadline_s`` (env
    ``NANOFED_AUTOTUNE_CANDIDATE_DEADLINE``) bounds one candidate's profiling — a
    candidate that blows it is the sweep's ``wedged_at`` and the rest are skipped
    (its run finishes in a daemon thread).  Both default to unbounded.

    ``include_epilogues`` profiles the aggregation-epilogue table
    (``tuning.epilogues``) at the model's flat size.  Unlike the JAX package, no
    ``except`` guards it: it launches kernels B4 and B2 on the card, and a failing
    launch must fail the sweep, not hide in the side table.

    ``telemetry`` (a ``RunTelemetry``) receives one ``compile`` record per profiled
    candidate (its first call's seconds, under the JAX name) and the ``autotune``
    record (:meth:`AutotuneResult.telemetry_payload`), on cache hits too.

    Refused here: ``adapter=`` (the adapters slice).
    """
    if adapter is not None:
        raise NotImplementedError(
            "autotune(adapter=...): LoRA adapters come with the adapters slice of "
            "nanofed_tpu_torch (ROADMAP queue A item 16)"
        )
    from nanofed_tpu_torch.observability.profiling import device_kind_of
    from nanofed_tpu_torch.trainer.config import TrainingConfig

    dev = resolve_device(device)
    training = training or TrainingConfig()
    if not isinstance(population, PopulationSpec):
        population = PopulationSpec.from_client_data(population)
    platform = dev.type
    device_kind = device_kind_of(dev)
    n_devices = 1
    if space is None:
        space = TuningSpace.default(
            population, n_devices, training.batch_size, num_rounds,
        )
    budget, budget_basis = resolve_hbm_budget(hbm_budget_bytes, dev)
    key = compute_cache_key(
        model, population, training, space, participation, num_rounds,
        eval_every, device_kind, n_devices, hbm_budget=budget, platform=platform,
    )

    cache_path = (
        Path(cache_dir) / f"autotune_{key[:16]}.json"
        if cache_dir is not None else None
    )
    if cache_path is not None and not force:
        cached = _read_cache(cache_path, key)
        # A winnerless entry is never written (below), but guard anyway: a
        # cache hit must not short-circuit the all-rejected AutotuneError.
        if cached is not None and cached.winner is not None:
            cached.cache_hit = True
            cached.compiles = 0
            _log.info(
                "autotune cache hit (%s): winner %s, zero profiles",
                cache_path, cached.winner.to_dict(),
            )
            _finish(cached, out_dir, telemetry)
            return cached
    if compile_budget_s is None:
        env_budget = os.environ.get("NANOFED_AUTOTUNE_COMPILE_BUDGET")
        compile_budget_s = float(env_budget) if env_budget else None
    if candidate_deadline_s is None:
        env_deadline = os.environ.get("NANOFED_AUTOTUNE_CANDIDATE_DEADLINE")
        candidate_deadline_s = float(env_deadline) if env_deadline else None

    def evaluate(cand: CandidateConfig) -> CandidateOutcome:
        return _evaluate_candidate(
            cand, model, population, training, participation, num_rounds,
            eval_every, n_devices, budget, device=dev,
        )

    outcomes: list[CandidateOutcome] = []
    compiles = 0
    skipped = 0
    spent = 0.0
    wedged_at: str | None = None
    for cand in order_by_predicted_compile_cost(space.candidates()):
        if wedged_at is not None:
            skipped += 1
            outcomes.append(CandidateOutcome(cand, False, reject_reason=(
                f"skipped: compile_budget (sweep wedged at {wedged_at}, "
                f"{spent:.1f}s spent profiling {compiles} candidates)"
            )))
            continue
        if compile_budget_s is not None and spent >= compile_budget_s:
            skipped += 1
            outcomes.append(CandidateOutcome(cand, False, reject_reason=(
                f"skipped: compile_budget ({spent:.1f}s of the "
                f"{compile_budget_s:.1f}s budget spent profiling {compiles} "
                "candidates)"
            )))
            continue
        if candidate_deadline_s is not None:
            # A running round cannot be preempted: evaluate in a daemon worker and
            # stop waiting at the deadline; the sweep keeps what it already priced.
            import threading as _threading

            box: list[CandidateOutcome] = []
            errors: list[BaseException] = []

            def _work(cand=cand, box=box, errors=errors):
                try:
                    box.append(evaluate(cand))
                except BaseException as e:  # re-raised below, in the sweep's thread
                    errors.append(e)

            worker = _threading.Thread(target=_work, daemon=True)
            worker.start()
            worker.join(candidate_deadline_s)
            if errors:
                raise errors[0]
            if not box:
                wedged_at = candidate_program_name(cand)
                outcome = CandidateOutcome(cand, False, reject_reason=(
                    f"wedged: profiling exceeded the {candidate_deadline_s:.1f}s "
                    "candidate deadline"
                ), cost={"wedged_at": round(float(candidate_deadline_s), 4)})
            else:
                outcome = box[0]
        else:
            outcome = evaluate(cand)
        profiled_s = outcome.cost.get("profile_seconds")
        if profiled_s is not None:
            compiles += 1
            spent += float(profiled_s)
        cand_compile_s = outcome.cost.get("compile_seconds")
        if telemetry is not None and cand_compile_s is not None:
            telemetry.record(
                "compile", program=candidate_program_name(cand),
                seconds=round(float(cand_compile_s), 4), cache_key=key[:16],
            )
        outcomes.append(outcome)
        _log.info(
            "autotune candidate %s: %s",
            cand.to_dict(),
            (f"score {outcome.score:.4g}" if outcome.feasible
             else f"rejected ({outcome.reject_reason})"),
        )

    ranked = rank_candidates(outcomes)
    feasible = [o for o in ranked if o.feasible]
    has_peaks = any("lower_bound_s_per_round" in o.cost for o in feasible)
    peaks_basis = None
    if has_peaks:
        from nanofed_tpu_torch.observability.profiling import peaks_for_device_kind

        peaks = peaks_for_device_kind(device_kind, platform)
        peaks_basis = peaks.basis if peaks is not None else None
    result = AutotuneResult(
        winner=feasible[0].config if feasible else None,
        outcomes=ranked,
        scoring_basis=_scoring_basis(platform, has_peaks, peaks_basis),
        platform=platform,
        device_kind=device_kind,
        num_devices=n_devices,
        hbm_budget_bytes=budget,
        budget_basis=budget_basis,
        cache_key=key,
        compiles=compiles,
        compile_seconds_total=math.fsum(
            o.cost.get("compile_seconds", 0.0) for o in outcomes
        ),
        compile_budget_s=compile_budget_s,
        skipped=skipped,
        wedged_at=wedged_at,
        space=space.to_dict(),
        population=population.to_dict(),
    )
    if include_epilogues:
        from nanofed_tpu_torch.tuning.epilogues import profile_aggregation_epilogues

        leaves = _model_fingerprint(model)["leaves"]
        flat = sum(math.prod(shape) or 1 for _, shape, _ in leaves)
        result.epilogues = profile_aggregation_epilogues(flat_size=flat, device=dev)

    if cache_path is not None and result.winner is not None and skipped == 0:
        # Failed (all-rejected) sweeps are never cached: a later invocation must
        # re-reject — and re-raise — rather than return winner=None.  Budget-
        # truncated or wedged sweeps are not cached either: their winner is the
        # best of an INCOMPLETE table.
        _write_cache(cache_path, result)
    _finish(result, out_dir, telemetry)
    if result.winner is None:
        raise AutotuneError(
            "autotune found no feasible candidate: " + "; ".join(
                f"{o.config.to_dict()} -> {o.reject_reason}" for o in ranked
            )
        )
    _log.info(
        "autotune winner: %s (%s)", result.winner.to_dict(), result.scoring_basis
    )
    return result


def _read_cache(path: Path, key: str) -> AutotuneResult | None:
    try:
        with path.open() as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if d.get("cache_key") != key:
        return None
    try:
        return AutotuneResult.from_dict(d)
    except (KeyError, TypeError, ValueError):
        return None


def _write_cache(path: Path, result: AutotuneResult) -> None:
    """Best-effort (an unwritable cache dir must not fail the sweep)."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(result.to_dict(), indent=2))
        tmp.replace(path)
    except OSError as e:
        _log.warning("could not write autotune cache %s: %s", path, e)


def _finish(result: AutotuneResult, out_dir: str | Path | None, telemetry: Any) -> None:
    """Emit the ranked-table artifact and the ``autotune`` telemetry record (also on
    cache hits, so every invocation leaves a fresh auditable table)."""
    if out_dir is not None:
        from nanofed_tpu_torch.utils.dates import get_current_time

        stamp = get_current_time().strftime("%Y%m%dT%H%M%S")
        path = Path(out_dir) / f"autotune_{stamp}_{result.cache_key[:8]}.json"
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(result.to_dict(), indent=2))
            result.artifact_path = str(path)
        except OSError as e:
            _log.warning("could not write autotune artifact %s: %s", path, e)
    if telemetry is not None:
        telemetry.record("autotune", **result.telemetry_payload())


def format_candidate_table(result: AutotuneResult) -> str:
    """Human-readable ranked table (the JAX package's ``profile --sweep`` table).
    The ``lora`` column is the adapter rank ("-" = dense full fine-tune)."""
    rows = [(
        "rank", "chunk", "rpb", "shards", "batch", "hosts", "lora", "score",
        "peak bytes", "verdict",
    )]
    for i, o in enumerate(result.outcomes):
        c = o.config
        rows.append((
            str(i + 1) if o.feasible else "-",
            str(c.client_chunk or "-"), str(c.rounds_per_block),
            str(c.model_shards), str(c.batch_size), str(c.hosts),
            str(c.adapter_rank or "-"),
            f"{o.score:.4g}" if o.score is not None else "-",
            f"{o.cost.get('peak_bytes', 0):,}" if o.cost else "-",
            o.cost.get("verdict", o.reject_reason or "-")
            if not o.feasible else o.cost.get("verdict", "-"),
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for j, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    lines.append("")
    lines.append(f"scoring basis: {result.scoring_basis}")
    lines.append(
        f"memory budget: "
        + (f"{result.hbm_budget_bytes:,} bytes" if result.hbm_budget_bytes
           else "none")
        + f" ({result.budget_basis})"
    )
    if result.winner is not None:
        lines.append(f"winner: {result.winner.to_dict()}")
    rejected = [o for o in result.outcomes if not o.feasible]
    for o in rejected:
        lines.append(f"rejected {o.config.to_dict()}: {o.reject_reason}")
    return "\n".join(lines)
