"""Zero-execution audit of round programs (counterpart of
``nanofed_tpu/analysis/program_audit.py``).

``fedlint`` (:mod:`nanofed_tpu_torch.analysis.fedlint`) reads SOURCE; this module
reads the PROGRAM.  Where the JAX package traces a round program to its jaxpr, the
port has no jaxpr: :func:`audit_program` runs the program once on ``meta`` copies of
its arguments (nothing executes, nothing is allocated) under a dispatch recorder
(``analysis.contracts.MetaTrace``) and the mesh's collective recorder
(``parallel.mesh.CollectiveRecorder``), once for each rank of the program's mesh, on
a described mesh (``Mesh.describe``) that stands in for the world.  It verifies four
properties:

``collective-schedule``
    Every rank records the same sequence of collectives (op, axis, operand shape).
    A rank that skips a collective, the torch form of a branch-divergent ``cond``,
    leaves its peers waiting in it: a deadlock at runtime, a finding here.

``mesh-discipline``
    Every collective's axis is a declared mesh axis, a hosts-axis collective comes
    only after a clients-axis one (the hierarchy is innermost first), and the
    cross-host traffic of a round fits one model-sized tensor: at most
    ``1.05 x`` the program's output bytes per round ``+ 4096``.

``dtype-drift``
    No ``_to_copy`` applied DIRECTLY to a bf16 input leaf up to float32/float64, and
    none from an integer input to a float.  Internal mixed-precision casts are the
    trainer's business.

``host-transfer``
    No read of a device value on the host inside the program: ``.item()`` and its
    kin (``aten._local_scalar_dense``), ``nonzero`` and other data-dependent shapes,
    a copy to the CPU.  The recorder notes each one and hands back a stand-in, so
    the run goes on and every read is reported.

Stated difference: ``donation`` is dropped (:data:`DROPPED_CHECKS`): torch has no
buffer donation, so there is no donated buffer whose aliasing could be verified, and
an eager program frees an input buffer when its last reference goes.  ``compile`` is
accepted and recorded in the report (``compiled``); the port builds no AOT artifact,
so it changes no check.  What the auditor cannot see: values (a schedule that
diverges on data rather than on the program's structure), the work inside the
hand-written kernels (their launches are opaque to dispatch; on meta tensors their
plain versions run), and host orchestration outside the program (fedlint's half).
Findings are returned, never raised; callers decide severity (``Coordinator(
strict=True)`` raises, the CLI exits 1).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Iterable, Sequence

import torch

from nanofed_tpu_torch.analysis.contracts import leaves_with_paths, run_on_meta, to_meta
from nanofed_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    HOST_AXIS,
    WORLD_AXIS,
    CollectiveRecord,
    Mesh,
    MeshLayout,
)

__all__ = [
    "AUDIT_CHECKS",
    "DROPPED_CHECKS",
    "AuditFinding",
    "AuditReport",
    "RankPrograms",
    "audit_program",
    "format_audit_reports",
    "reference_catalog",
    "run_mutation_suite",
    "schedule_mismatch_findings",
    "seeded_mutants",
]

# Every check the auditor runs.
AUDIT_CHECKS = (
    "collective-schedule",
    "mesh-discipline",
    "dtype-drift",
    "host-transfer",
)

#: The JAX package's checks the port does not run, with the reason.
DROPPED_CHECKS = {
    "donation": "torch has no buffer donation: no donated buffer exists whose aliasing "
                "could be verified, and an eager input buffer is freed when its last "
                "reference goes",
}

# Cross-host traffic slack: the budget is the program's own output bytes (the
# aggregate IS model-sized state) times this, plus a constant floor so scalar-output
# probes are not flagged for reducing a handful of metrics.
_CROSS_HOST_SLACK = 1.05
_CROSS_HOST_FLOOR_BYTES = 4096


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    """One violated property of one program."""

    program: str
    check: str
    message: str

    def render(self) -> str:
        return f"{self.program}: [{self.check}] {self.message}"

    def to_dict(self) -> dict[str, str]:
        return {"program": self.program, "check": self.check, "message": self.message}


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """Everything one program's audit established.

    ``schedule`` is rank 0's collective schedule (``"all_reduce@clients"`` entries);
    ``checks`` lists the checks that ran; ``compiled`` records the ``compile`` flag
    the audit was asked with (the port builds no AOT artifact); ``ranks`` is how many
    ranks' programs ran."""

    program: str
    findings: tuple[AuditFinding, ...]
    schedule: tuple[str, ...]
    mesh_axes: tuple[str, ...]
    checks: tuple[str, ...]
    compiled: bool
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    ranks: int = 1

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict[str, Any]:
        return {
            "program": self.program,
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "schedule": list(self.schedule),
            "mesh_axes": list(self.mesh_axes),
            "checks": list(self.checks),
            "compiled": self.compiled,
            "attrs": {k: v for k, v in self.attrs.items()
                      if isinstance(v, (str, int, float, bool, list, type(None)))},
            "ranks": self.ranks,
        }


class RankPrograms:
    """A program over a described mesh of ``shape``: ``body(mesh, *args, **kwargs)``,
    run as rank 0 when called and as every rank by :func:`audit_program`."""

    def __init__(self, shape: tuple[int, ...], body: Callable) -> None:
        self.shape = tuple(shape)
        self.body = body

    @property
    def mesh(self) -> Mesh:
        return Mesh.describe(self.shape, 0)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.body(self.mesh, *args, **kwargs)

    def ranks(self, args: tuple, kwargs: dict) -> list[tuple[Callable, tuple, dict]]:
        return [(partial(self.body, Mesh.describe(self.shape, r)), args, kwargs)
                for r in range(math.prod(self.shape))]


def _render(records: Sequence[CollectiveRecord]) -> tuple[str, ...]:
    return tuple(f"{r.op}@{r.axis}" for r in records)


def _out_bytes(out: Any) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in leaves_with_paths(out) if torch.is_tensor(leaf))


def schedule_mismatch_findings(name: str, schedules: Sequence[Sequence[str]]
                               ) -> list[AuditFinding]:
    """``collective-schedule`` findings for every rank whose schedule (a sequence of
    rendered entries) differs from rank 0's."""
    out = []
    for rank, sched in enumerate(schedules[1:], start=1):
        if list(sched) != list(schedules[0]):
            out.append(AuditFinding(
                name, "collective-schedule",
                f"rank 0 runs {list(schedules[0]) or '[no collectives]'} but rank {rank} "
                f"runs {list(sched) or '[no collectives]'} — a rank that skips or "
                "reorders a collective leaves its peers waiting: a deadlock at runtime",
            ))
    return out


def _drift_hook(inputs: set[int], name: str, findings: list[AuditFinding]):
    """The dispatch hook of ``dtype-drift``: a cast applied directly to an input."""

    def on_op(func, args, kwargs, out) -> None:
        if func.overloadpacket is not torch.ops.aten._to_copy or not args:
            return
        x, new = args[0], kwargs.get("dtype")
        if id(x) not in inputs or new is None:
            return
        old = x.dtype
        if old == torch.bfloat16 and new in (torch.float32, torch.float64):
            findings.append(AuditFinding(
                name, "dtype-drift",
                f"bf16 input upcast to {new} inside the program — the boundary dtype is "
                "a contract; upcasting silently doubles collective bytes",
            ))
        elif not old.is_floating_point and old != torch.bool and new.is_floating_point:
            findings.append(AuditFinding(
                name, "dtype-drift",
                f"integer input ({old}, token-id shaped) cast to {new} inside the "
                "program — ids must stay integral across the boundary",
            ))

    return on_op


def audit_program(
    name: str,
    fn: Callable,
    *args: Any,
    rounds: int = 1,
    mesh: Mesh | None = None,
    compile: bool = True,
    attrs: dict[str, Any] | None = None,
    ranks: Sequence[tuple[Callable, tuple, dict]] | None = None,
    **kwargs: Any,
) -> AuditReport:
    """Audit one program against the four checks; see the module docstring.

    ``fn(*args, **kwargs)`` is this rank's program with dispatch-shaped arguments
    (their values are never read: the program runs on meta copies).  ``ranks``, when
    given, is every rank's ``(fn, args, kwargs)`` in rank order (programs built on
    described meshes); a :class:`RankPrograms` ``fn`` supplies its own.  ``mesh``
    pins the declared axes; without it they are the axes the collectives ran over.
    ``compile`` is recorded in the report and changes no check."""
    if ranks is None and isinstance(fn, RankPrograms):
        ranks = fn.ranks(args, kwargs)
        mesh = mesh if mesh is not None else fn.mesh
    programs = list(ranks) if ranks is not None else [(fn, args, kwargs)]
    findings: list[AuditFinding] = []
    drift: list[AuditFinding] = []
    schedules: list[list[CollectiveRecord]] = []
    host_reads: dict[str, int] = {}
    out_bytes: list[int] = []
    for rank_fn, rank_args, rank_kwargs in programs:
        rank_args, rank_kwargs = to_meta(tuple(rank_args)), to_meta(dict(rank_kwargs))
        inputs = {id(leaf) for _, leaf in leaves_with_paths((rank_args, rank_kwargs))
                  if torch.is_tensor(leaf)}
        rank_drift: list[AuditFinding] = []
        out, trace, recorder = run_on_meta(
            name, rank_fn, rank_args, rank_kwargs, record=True,
            on_op=_drift_hook(inputs, name, rank_drift))
        if not drift:
            drift = rank_drift  # the same program on every rank: report one rank's casts
        schedules.append(list(recorder.records))
        out_bytes.append(_out_bytes(out))
        for what, where in trace.host_reads:
            key = f"{what} at {where}"
            host_reads[key] = host_reads.get(key, 0) + 1

    # -- collective-schedule ---------------------------------------------------
    findings.extend(schedule_mismatch_findings(
        name, [[f"{r.op}@{r.axis}{list(r.shape)}" for r in sched] for sched in schedules]))

    # -- mesh-discipline --------------------------------------------------------
    seen_axes = sorted({r.axis for s in schedules for r in s if r.axis != WORLD_AXIS})
    declared = tuple(mesh.axis_names) if mesh is not None else tuple(seen_axes)
    for rank, sched in enumerate(schedules):
        unknown = sorted({r.axis for r in sched
                          if r.axis != WORLD_AXIS and r.axis not in declared})
        if unknown:
            findings.append(AuditFinding(
                name, "mesh-discipline",
                f"rank {rank} runs collectives over undeclared axis "
                f"{', '.join(map(repr, unknown))} (mesh declares {list(declared)})",
            ))
            break
    if HOST_AXIS in declared:
        for rank, sched in enumerate(schedules):
            saw_clients = False
            flagged = False
            for r in sched:
                if r.axis == CLIENT_AXIS:
                    saw_clients = True
                if r.axis == HOST_AXIS and not saw_clients and not flagged:
                    findings.append(AuditFinding(
                        name, "mesh-discipline",
                        f"rank {rank}: {r.op} over the {HOST_AXIS!r} axis before any "
                        f"{CLIENT_AXIS!r}-axis collective — hierarchical order is "
                        "innermost first: cross-host wires carry pre-reduced aggregates, "
                        "never raw client traffic",
                    ))
                    flagged = True
            cross = sum(r.bytes for r in sched if r.axis == HOST_AXIS)
            budget = int(out_bytes[rank] / max(1, rounds) * _CROSS_HOST_SLACK
                         + _CROSS_HOST_FLOOR_BYTES) * max(1, rounds)
            if cross > budget:
                findings.append(AuditFinding(
                    name, "mesh-discipline",
                    f"rank {rank}: cross-host collectives move {cross} bytes but the "
                    f"round's model-sized budget is {budget} (one aggregate per round) — "
                    "an extra model-sized tensor is crossing the slow wire",
                ))
            if flagged or cross > budget:
                break

    # -- host-transfer ------------------------------------------------------------
    for key in sorted(host_reads):
        findings.append(AuditFinding(
            name, "host-transfer",
            f"{key} ({host_reads[key]}x over {len(programs)} rank(s)) — a host read "
            "inside the round program makes the host wait for the device every round",
        ))

    # -- dtype-drift ----------------------------------------------------------------
    findings.extend(drift)

    return AuditReport(
        program=name,
        findings=tuple(findings),
        schedule=_render(schedules[0]) if schedules else (),
        mesh_axes=declared,
        checks=AUDIT_CHECKS,
        compiled=bool(compile),
        attrs=dict(attrs or {}),
        ranks=len(programs),
    )


def format_audit_reports(reports: Iterable[AuditReport]) -> str:
    """Human-readable audit table + findings (what ``nanofed-tpu-torch audit``
    prints)."""
    reports = list(reports)
    lines = []
    rows = [("program", "checks", "ranks", "collectives", "mesh axes", "status")]
    for r in reports:
        rows.append((
            r.program, str(len(r.checks)), str(r.ranks), str(len(r.schedule)),
            ",".join(r.mesh_axes) or "-",
            "ok" if r.ok else f"{len(r.findings)} finding(s)",
        ))
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    for j, row in enumerate(rows):
        lines.append("  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip())
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    for r in reports:
        for f in r.findings:
            lines.append(f.render())
    total = sum(len(r.findings) for r in reports)
    lines.append("audit: clean" if total == 0 else f"audit: {total} finding(s)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# reference catalog: the program variants on tiny models
# ---------------------------------------------------------------------------

#: The JAX catalog's variants and the described mesh each runs on here (the JAX
#: catalog runs on 8 devices: its one-axis variants on a clients axis of 8).
REFERENCE_MESHES = {
    "single_step": (8,), "fused_block": (8,), "scaffold": (8,), "fsdp_2d": (4, 2),
    "hier_3axis": (2, 2, 2), "adapter": (8,), "drained_ingest": (2, 2, 2),
}


def reference_catalog(device: Any = None):
    """A :class:`~nanofed_tpu_torch.observability.profiling.ProgramCatalog` holding the
    round-program variants on tiny models, at the JAX catalog's sizes: single-step,
    fused-block, SCAFFOLD, 2-D FSDP (4, 2), 3-axis hierarchical (2, 2, 2), adapter and
    the drained-ingest reduce.  Each is built through real ``Coordinator``
    constructions, one for each rank of a described mesh of :data:`REFERENCE_MESHES`
    (the drained reduce through ``communication.federation.build_drained_ingest_reduce``
    on each rank's described mesh), so every registered program is the dispatch-true
    one; the audit runs every rank's.  ``device`` (default the card) holds the tiny
    populations; the audit itself runs on meta tensors."""
    from nanofed_tpu_torch.adapters import AdapterSpec
    from nanofed_tpu_torch.communication.federation import build_drained_ingest_reduce
    from nanofed_tpu_torch.data import federate, synthetic_classification, synthetic_token_streams
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.observability.profiling import ProgramCatalog
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.trainer import TrainingConfig

    training = TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.1)
    mlp_data = federate(synthetic_classification(256, 3, (8,), seed=0), num_clients=8,
                        scheme="iid", batch_size=16)
    lm = get_model("transformer_lm", vocab=32, seq_len=8, width=16, depth=1, heads=2)
    lm_data = federate(synthetic_token_streams(256, vocab=32, seq_len=8, seed=0),
                       num_clients=8, batch_size=16, seed=0)

    def coords(shape: tuple[int, ...], **kw) -> list:
        rpb = kw.pop("rounds_per_block", 1)
        return [Coordinator(
            kw.get("model") or get_model("mlp", in_features=8, hidden=16, num_classes=3),
            kw.get("train_data") or mlp_data,
            CoordinatorConfig(num_rounds=max(1, rpb), rounds_per_block=rpb, seed=0,
                              save_metrics=False),
            training=training, device=device, mesh=Mesh.describe(shape, r),
            **{k: v for k, v in kw.items() if k not in ("model", "train_data")},
        ) for r in range(math.prod(shape))]

    variants = [
        # (variant label, the ranks' coordinators, program name -> variant name)
        ("fused", coords((8,), rounds_per_block=2),
         {"round_step": "single_step", "round_block": "fused_block"}),
        ("scaffold", coords((8,), scaffold=True), {"scaffold_round_step": "scaffold"}),
        ("fsdp_2d", coords((4, 2)), {"round_step": "fsdp_2d"}),
        ("hier_3axis", coords((2, 2, 2)), {"round_step": "hier_3axis"}),
        ("adapter", coords((8,), model=lm, train_data=lm_data, adapter=AdapterSpec(rank=2)),
         {"adapter_round_step": "adapter"}),
    ]

    catalog = ProgramCatalog()
    for label, ranks, names in variants:
        for prog in ranks[0].program_catalog.names():
            fn, factory, rounds, attrs = ranks[0].program_catalog.registration(prog)
            variant = names.get(prog, f"{label}/{prog}")
            regs = [c.program_catalog.registration(prog) for c in ranks]
            catalog.register(
                variant, fn, args_factory=factory, rounds=rounds,
                attrs={**attrs, "variant": variant, "source_program": prog,
                       "mesh": ranks[0].mesh,
                       "rank_programs": partial(_rank_programs, regs)},
            )

    # The wire→mesh bridge's fused drained-ingest reduce (ingest slabs → host-local
    # ``coefs @ buf`` → the clients all-reduce, then ONE hosts all-reduce of the [P+1]
    # row → the FedAvg apply), so the mesh-discipline check machine-checks the fusion
    # invariant on every audit.
    shape, cap, flat = REFERENCE_MESHES["drained_ingest"], 4, 96
    drained = [build_drained_ingest_reduce(Mesh.describe(shape, r), cap, flat)
               for r in range(math.prod(shape))]

    def drained_args(r: int = 0) -> tuple[tuple, dict]:
        gen = torch.Generator().manual_seed(r)
        return (torch.randn((cap, flat), generator=gen), torch.rand((cap,), generator=gen),
                torch.zeros(flat)), {}

    catalog.register(
        "drained_ingest", drained[0], args_factory=drained_args, rounds=1,
        attrs={"variant": "drained_ingest", "source_program": "drained_ingest_reduce",
               "mesh": Mesh.describe(shape, 0),
               "rank_programs": lambda: [
                   (fn, *drained_args(r)) for r, fn in enumerate(drained)]},
    )
    return catalog


def _rank_programs(regs: list) -> list[tuple[Callable, tuple, dict]]:
    """Every rank's ``(fn, args, kwargs)`` from its coordinator's registration."""
    return [(fn, *factory()) for fn, factory, _, _ in regs]


# ---------------------------------------------------------------------------
# seeded mutants: one deliberately broken program per check
# ---------------------------------------------------------------------------


def _divergent(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank 0 all-reduces over the client axes, every other rank computes alone."""
    if mesh.rank == 0:
        return MeshLayout(mesh, {}).client_psum(x)
    return x * 2.0


def _hosts_first(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A hosts-axis all-reduce with no clients-axis reduce before it."""
    return MeshLayout(mesh, {}).hosts_all_reduce(x.clone())


def _upcast_leaf(p: torch.Tensor) -> torch.Tensor:
    return (p.to(torch.float32) * 2.0).sum()


def _host_read(x: torch.Tensor) -> torch.Tensor:
    return x * float(x.sum())


def seeded_mutants() -> list[tuple[str, str, Callable, tuple]]:
    """One deliberately broken tiny program per audit check, as ``(name,
    expected_check, fn, args)`` rows (the JAX package's, less its donation mutant).
    The mutation suite (:func:`run_mutation_suite`) audits each and asserts EXACTLY
    its check fires — proof that no check is vacuous.  The mesh mutants run on a
    described (2, 2, 2) mesh, every rank in turn."""
    x32 = torch.zeros((8, 4), dtype=torch.float32)
    return [
        ("mutant_cond_divergent", "collective-schedule", RankPrograms((2, 2, 2), _divergent),
         (x32,)),
        ("mutant_hosts_first", "mesh-discipline", RankPrograms((2, 2, 2), _hosts_first),
         (x32,)),
        ("mutant_upcast_leaf", "dtype-drift", _upcast_leaf,
         (torch.zeros((8,), dtype=torch.bfloat16),)),
        ("mutant_embedded_callback", "host-transfer", _host_read, (x32,)),
    ]


def run_mutation_suite() -> dict[str, dict[str, Any]]:
    """Audit every seeded mutant; returns ``name -> {expected, fired, ok}`` where
    ``ok`` means the mutant fired EXACTLY its expected check."""
    results: dict[str, dict[str, Any]] = {}
    for name, expected, fn, args in seeded_mutants():
        report = audit_program(name, fn, *args)
        fired = sorted({f.check for f in report.findings})
        results[name] = {"expected": expected, "fired": fired, "ok": fired == [expected]}
    return results
