"""What the ranks of the port's CPU worlds run (``tests/test_torch_mesh_*.py``).

Each function is ``fn(rank, world_size, ...)`` for ``parallel.launch.spawn_world``: it
runs in a spawned process that imports torch and ``nanofed_tpu_torch`` only (never
JAX), and returns numpy arrays and floats.  The tests hold what comes back against
the JAX package's sharded round on the same mesh shape.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

C, N = 8, 8
POISONED = 3
SENTINEL = 1e6
HYPER = dict(batch_size=4, local_epochs=1, learning_rate=0.05, momentum=0.9)
DP = dict(max_gradient_norm=0.5, noise_multiplier=0.8)
VALIDATION = dict(max_norm=100.0)
ADAPTER = dict(rank=2, alpha=4.0)


def _strategy(name: str):
    from nanofed_tpu_torch.aggregation import base

    return {"fedavg": base.fedavg_strategy,
            "fedadam": lambda: base.fedadam_strategy(0.05)}[name]()


def nan_fit(model, training):
    """The default fit, with every output of a client whose first pixel is the
    sentinel turned to NaN (the validated round's poisoned client)."""
    from nanofed_tpu_torch.core.types import ClientMetrics
    from nanofed_tpu_torch.trainer import make_local_fit

    fit = make_local_fit(model, training)

    def poisoned_fit(gp, data, perms, keys=None, lr_scale=1.0):
        res = fit(gp, data, perms, keys, lr_scale)
        poisoned = data.x[:, 0, 0, 0, 0] > 1e5
        nan = lambda t: torch.where(  # noqa: E731
            poisoned.view(-1, *[1] * (t.ndim - 1)), torch.nan, t)
        return res._replace(params={k: nan(v) for k, v in res.params.items()},
                            metrics=ClientMetrics(*(nan(m) for m in res.metrics)))
    return poisoned_fit


def _numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def run_case(inputs: dict[str, Any], case: dict[str, Any], mesh) -> dict[str, Any]:
    """``case["rounds"]`` rounds of one configuration on ``mesh`` (this rank's part);
    the gathered full params after the first and the last round, the metrics and
    per-client rows of the first."""
    from nanofed_tpu_torch.adapters import AdapterSpec, init_adapters, make_adapter_apply
    from nanofed_tpu_torch.aggregation.privacy import PrivacyAwareAggregationConfig
    from nanofed_tpu_torch.aggregation.robust import RobustAggregationConfig
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import FrozenBase, build_round_step, init_server_state
    from nanofed_tpu_torch.parallel.mesh import MeshLayout, client_slice
    from nanofed_tpu_torch.privacy import PrivacyConfig
    from nanofed_tpu_torch.security import ValidationConfig
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.utils.trees import from_numpy_params

    model = get_model("digits_mlp")
    training = TrainingConfig(**HYPER)
    strategy = _strategy(case.get("strategy", "fedavg"))
    full = from_numpy_params(inputs["params"], device="cpu")
    frozen = base = None
    if case.get("adapter"):
        spec = AdapterSpec(**ADAPTER)
        frozen = FrozenBase(base_like=full,
                            bind=lambda b: make_adapter_apply(model.apply, spec, b))
        base, full = full, init_adapters(spec, full, rng=1)
    step = build_round_step(
        model, training, strategy, client_chunk=case.get("client_chunk"),
        local_fit=nan_fit(model, training) if case.get("poisoned") else None,
        validation=ValidationConfig(**VALIDATION) if case.get("validation") else None,
        central_privacy=(PrivacyAwareAggregationConfig(privacy=PrivacyConfig(**DP))
                         if case.get("dp") else None),
        robust=RobustAggregationConfig(**case["robust"]) if case.get("robust") else None,
        frozen_base=frozen, mesh=mesh, params_like=full,
    )
    layout = MeshLayout(mesh, full)
    lo, hi = client_slice(C, mesh)
    x = inputs["x_poisoned"] if case.get("poisoned") else inputs["x"]
    data = ClientData(x[lo:hi], inputs["y"][lo:hi], inputs["mask"][lo:hi]).to(
        torch.device("cpu"))
    weights = torch.from_numpy(inputs["weights"][lo:hi])
    perms = torch.from_numpy(inputs["perms"][lo:hi])
    noise = torch.from_numpy(inputs["noise"]) if case.get("dp") else None
    gp = layout.shard_params(full)
    sos = init_server_state(strategy, gp)
    extra = () if base is None else (MeshLayout(mesh, base).shard_params(base),)
    out: dict[str, Any] = {}
    for r in range(case["rounds"]):
        res = step(gp, sos, *extra, data, weights, perms, noise=noise)
        gp, sos = res.params, res.server_opt_state
        if r == 0:
            out["metrics"] = {k: float(v) for k, v in res.metrics.items()}
            out["sq_norms"] = res.update_sq_norms.numpy().copy()
            out["client_loss"] = res.client_metrics.loss.numpy().copy()
            out["params_1"] = _numpy(layout.gather_full(gp))
    out["params_last"] = _numpy(layout.gather_full(gp))
    out["shard_bytes"] = sum(v.numel() * 4 for v in gp.values()) + sum(
        v.numel() * 4 for v in sos.values() if torch.is_tensor(v))
    return out


def run_block(inputs: dict[str, Any], mesh, rounds: int = 2, perms=None) -> dict[str, Any]:
    """A fused block of ``rounds`` rounds resampling its half-population cohorts on
    the device, on ``mesh`` (where the data is this rank's host rows) or one device
    (``mesh=None``); ``perms`` replace the drawn permutations."""
    from nanofed_tpu_torch.aggregation import base
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import build_round_block, init_server_state, round_seeds
    from nanofed_tpu_torch.parallel.mesh import MeshLayout, host_client_slice
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.utils.trees import from_numpy_params

    full = from_numpy_params(inputs["params"], device="cpu")
    layout = None if mesh is None else MeshLayout(mesh, full)
    block = build_round_block(
        get_model("digits_mlp"), TrainingConfig(**HYPER), base.fedavg_strategy(),
        num_clients=C, step_clients=C // 2, cohort_size=C // 2, device="cpu",
        mesh=mesh, params_like=full)
    gp = full if layout is None else layout.shard_params(full)
    lo, hi = (0, C) if mesh is None else host_client_slice(C, mesh)
    data = ClientData(inputs["x"][lo:hi], inputs["y"][lo:hi], inputs["mask"][lo:hi]).to(
        torch.device("cpu"))
    res = block(gp, init_server_state(base.fedavg_strategy(), gp), data,
                torch.from_numpy(inputs["mask"].sum(1)), round_seeds(7, range(rounds)),
                [1.0] * rounds, perms=perms)
    params = res.params if layout is None else layout.gather_full(res.params)
    return {"cohort_ids": res.cohort_ids.numpy().copy(), "params": _numpy(params), "loss": res.metrics["loss"].numpy().copy(),
            "exchange_bytes": block.cohort_exchange_bytes}


def mesh_rounds(rank: int, world: int, inputs: dict[str, Any],
                cases: dict[str, dict[str, Any]]) -> dict[str, Any]:
    """Every case on its mesh (``case["shape"]``), the meshes made in the order the
    cases first name them, the same on every rank.  Also reports whether JAX or the
    JAX package was imported in this rank."""
    from nanofed_tpu_torch.parallel.mesh import make_mesh

    meshes: dict[tuple, Any] = {}
    results = {}
    for name, case in cases.items():
        shape = tuple(case["shape"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, device="cpu")
        results[name] = run_case(inputs, case, meshes[shape])
    results["block-4"] = run_block(inputs, meshes[(4,)])
    results["_imports"] = sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "nanofed_tpu"))
    return results


# ---------------------------------------------------------------------------------------
# Coordinators, the runner and the tuner in a world (tests/test_torch_mesh_coordinator.py)
# ---------------------------------------------------------------------------------------

COORD = dict(num_clients=8, samples=8, rounds=3, participation=0.5, seed=3)


def coordinator_data(num_clients: int, samples: int, seed: int = 0):
    """Single-batch clients of the digits shape: one local step on every sample, so a
    client's update does not depend on the order its samples are drawn in."""
    from nanofed_tpu_torch.data import federate, synthetic_classification

    return federate(synthetic_classification(num_clients * samples, 10, (8, 8, 1),
                                             seed=seed), num_clients, batch_size=samples)


def make_coordinator(base_dir, params: dict[str, np.ndarray] | None = None, **kw):
    """A FedAdam digits_mlp coordinator of ``COORD``'s clients on the CPU; ``params``
    (the JAX package's initial weights, nested numpy) replace the port's draw."""
    from nanofed_tpu_torch.aggregation import base
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.parallel import init_server_state
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.utils.trees import from_numpy_params

    cfg = dict(num_rounds=COORD["rounds"], participation_rate=COORD["participation"],
               seed=COORD["seed"], base_dir=base_dir)
    cfg.update(kw.pop("config", {}))
    coord = Coordinator(
        get_model("digits_mlp"), coordinator_data(COORD["num_clients"], COORD["samples"]),
        CoordinatorConfig(**cfg),
        training=TrainingConfig(batch_size=COORD["samples"], local_epochs=1,
                                learning_rate=0.1),
        strategy=base.fedadam_strategy(0.05), device="cpu", **kw)
    if params is not None:
        full = from_numpy_params(params, device="cpu")
        coord.params = full if coord._layout is None else coord._layout.shard_params(full)
        coord.server_state = init_server_state(coord.strategy, coord.params)
    return coord


def _state(coord) -> tuple[dict, dict]:
    state = coord.full_server_state()
    return _numpy(coord.full_params()), {k: v.numpy().copy() for k, v in state.items()
                                         if torch.is_tensor(v)}


def coordinator_world(rank: int, world: int, tmp: str, jax_params) -> dict[str, Any]:
    """The mesh coordinator against the JAX one, resumes across mesh shapes, the runner
    over the world, and rank 0's tuner pick and retune verdict on every rank."""
    from pathlib import Path

    from nanofed_tpu_torch import run_experiment
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.persistence import FileStateStore
    from nanofed_tpu_torch.tuning import autotuner, retuner
    from nanofed_tpu_torch.tuning.autotuner import (
        CandidateConfig,
        CandidateOutcome,
        PopulationSpec,
        TuningSpace,
    )

    tmp = Path(tmp)
    out: dict[str, Any] = {}
    # 1. Three rounds on (2, 2, 1): host-local cohorts, the two-stage reduce, rank-0
    # files (metrics JSON, telemetry, checkpoints).
    coord = make_coordinator(tmp / "mesh", jax_params, mesh_shape=(2, 2, 1),
                             state_store=FileStateStore(tmp / "mesh" / "ckpt"))
    out["cohorts"] = [coord._sample_cohort(r).tolist() for r in range(COORD["rounds"])]
    rounds = coord.run()
    out["losses"] = [m.agg_metrics["loss"] for m in rounds]
    out["params"], out["state"] = _state(coord)
    out["mesh_shape"] = list(coord.mesh.shape)
    fused = make_coordinator(tmp / "fused", jax_params, mesh_shape=(2, 2, 1),
                             config=dict(rounds_per_block=COORD["rounds"]))
    fused.run()
    out["fused_params"], _ = _state(fused)
    # 2. A one-rank checkpoint (written before the world started) resumed on the
    # model-sharded (2, 2) mesh, then one more round.
    resumed = make_coordinator(tmp / "resume", mesh_shape=(2, 2), config=dict(num_rounds=2),
                               state_store=FileStateStore(tmp / "one_to_mesh"))
    out["resumed_round"] = resumed.current_round
    out["resumed_params"], out["resumed_state"] = _state(resumed)
    resumed.run()
    out["resumed_after"], _ = _state(resumed)
    # 3. The runner over the world's ranks, two virtual hosts.
    summary = run_experiment(model="linear", num_clients=8, num_rounds=2, local_epochs=1,
                             batch_size=8, train_size=64, hosts=2, device="cpu",
                             out_dir=str(tmp / "runner"))
    out["runner"] = {k: summary[k] for k in ("mesh_shape", "rounds_completed",
                                             "final_train_metrics")}
    # 4. Rank-dependent measurements: every rank takes rank 0's pick.
    def fake_evaluate(cand, *a, **kw):
        score = float(cand.client_chunk or 16) * (1 if rank == 0 else -1)
        return CandidateOutcome(cand, True, score=score, cost={"measured": rank})

    real = autotuner._evaluate_candidate
    autotuner._evaluate_candidate = fake_evaluate
    try:
        result = autotuner.autotune(
            get_model("linear", in_features=10, num_classes=2), PopulationSpec(16, 16, (10,)),
            space=TuningSpace(client_chunks=(None, 2, 4), rounds_per_blocks=(1,),
                              model_shards=(1,), batch_sizes=(16,)),
            cache_dir=None, out_dir=None, include_epilogues=False, device="cpu")
    finally:
        autotuner._evaluate_candidate = real
    out["pick"] = result.winner.to_dict()

    # 5. Rank-dependent retune verdicts: every rank applies rank 0's.
    class RankRetuner:
        def propose(self, cand):
            return retuner.RetuneDecision(old=cand, new=None, measured_s_per_round=rank,
                                          candidate_s_per_round=None, delta=None,
                                          basis="measured", reason=f"rank {rank} holds")

    coord = make_coordinator(tmp / "retune", mesh_shape=(4,), config=dict(retune_every=1))
    coord.retuner, coord._retune_candidate = RankRetuner(), CandidateConfig(None, 1, 1, 8)
    coord.current_round = 1
    coord._maybe_retune()
    out["retune"] = coord.retune_events
    return out


# ---------------------------------------------------------------------------------------
# The launcher's own behaviour (tests/test_torch_mesh.py, tests/test_torch_isolation.py)
# ---------------------------------------------------------------------------------------


def imported_modules(rank: int, world: int) -> list[str]:
    """JAX or JAX-package modules loaded in this rank after importing every module of
    the port and running a collective."""
    import importlib
    import pkgutil

    import nanofed_tpu_torch
    from nanofed_tpu_torch.parallel.mesh import MeshLayout, make_mesh

    for m in pkgutil.walk_packages(nanofed_tpu_torch.__path__, "nanofed_tpu_torch."):
        importlib.import_module(m.name)
    assert float(MeshLayout(make_mesh(device="cpu")).client_psum(torch.ones(()))) == world
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "nanofed_tpu"))


def fail_on_rank_one(rank: int, world: int) -> int:
    """Rank 1 raises while the others wait in a collective for it."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one fails on purpose")
    dist.all_reduce(torch.ones(1))
    return rank


def hang_on_rank_one(rank: int, world: int) -> int:
    """Rank 1 never joins the collective the others wait in."""
    import time

    import torch.distributed as dist

    if rank == 1:
        time.sleep(3600)
    dist.all_reduce(torch.ones(1))
    return rank


# ---------------------------------------------------------------------------------------
# SCAFFOLD, program profiling and on-device cohorts across ranks
# (tests/test_torch_scaffold_mesh.py)
# ---------------------------------------------------------------------------------------

SC_HYPER = dict(batch_size=4, local_epochs=2, learning_rate=0.1)
SC_POPULATION = 10  # the step's N_total: more than its 8 rows, as a gathered cohort's


def scaffold_step_case(inputs: dict[str, Any], mesh) -> dict[str, Any]:
    """One FedAvgM SCAFFOLD step on ``mesh`` with this rank's rows: the gathered full
    params, server control and momentum, this rank's ``delta_c`` rows, the metrics and
    the cohort's client rows."""
    from nanofed_tpu_torch.aggregation import fedavgm_strategy
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.parallel import build_scaffold_round_step, init_server_state
    from nanofed_tpu_torch.parallel.mesh import MeshLayout, client_slice
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel, unravel

    strategy = fedavgm_strategy(0.7, 0.9)
    full = from_numpy_params(inputs["params"], device="cpu")
    step = build_scaffold_round_step(get_model("digits_mlp"), TrainingConfig(**SC_HYPER),
                                     SC_POPULATION, strategy, mesh=mesh, params_like=full)
    layout = MeshLayout(mesh, full)
    lo, hi = client_slice(C, mesh)
    gp = layout.shard_params(full)
    res = step(gp, init_server_state(strategy, gp),
               layout.slice_shard(torch.from_numpy(inputs["c_global"])),
               torch.from_numpy(inputs["c_stack"][lo:hi]),
               ClientData(inputs["x"][lo:hi], inputs["y"][lo:hi],
                          inputs["mask"][lo:hi]).to(torch.device("cpu")),
               torch.from_numpy(inputs["weights"][lo:hi]),
               torch.from_numpy(inputs["perms"][lo:hi]))
    full_flat = lambda v: ravel(layout.gather_full(unravel(v, res.params))).numpy()  # noqa: E731
    return {
        "params": _numpy(layout.gather_full(res.params)),
        "c_global": full_flat(res.c_global),
        "trace": full_flat(res.server_opt_state["trace"]),
        "delta_c": res.delta_c.numpy().copy(), "rows": (lo, hi),
        "metrics": {k: float(v) for k, v in res.metrics.items()},
        "sq_norms": res.update_sq_norms.numpy().copy(),
        "client_loss": res.client_metrics.loss.numpy().copy(),
    }


def _controls(coord) -> dict[str, Any]:
    """A coordinator's whole state: full params, server state and controls."""
    params, state = _state(coord)
    c_global, c_stack = coord.full_controls()
    return {"params": params, "state": state, "c_global": c_global.numpy().copy(),
            "c_stack": c_stack.numpy().copy()}


def _published_programs() -> list[str]:
    from nanofed_tpu_torch.observability import get_registry

    text = get_registry().render_prometheus()
    return sorted({line.split('program="')[1].split('"')[0] for line in text.splitlines()
                   if line.startswith("nanofed_program_flops_total{")})


def scaffold_world(rank: int, world: int, inputs: dict[str, Any], tmp: str,
                   perms: torch.Tensor) -> dict[str, Any]:
    """The SCAFFOLD step and coordinator on (2, 2, 1), a one-rank checkpoint resumed
    there, every program profiled in lockstep, and the block's on-device cohorts over
    the hosts axis."""
    from pathlib import Path

    from nanofed_tpu_torch.parallel.mesh import make_mesh
    from nanofed_tpu_torch.persistence import FileStateStore

    tmp = Path(tmp)
    mesh = make_mesh((2, 2, 1), device="cpu")
    out: dict[str, Any] = {"step": scaffold_step_case(inputs, mesh)}
    # Three rounds from the JAX coordinator's initial weights, checkpointed by rank 0.
    coord = make_coordinator(tmp / "sc_mesh", inputs["coord_params"], mesh=mesh,
                             scaffold=True, state_store=FileStateStore(tmp / "sc_mesh_ckpt"))
    out["cohorts"] = [coord._sample_cohort(r) for r in range(COORD["rounds"])]
    coord.run()
    out["coord"] = _controls(coord)
    out["stack_rows"] = int(coord.c_stack.shape[0])
    out["exchange_bytes"] = coord.control_exchange_bytes
    # Profiled in lockstep: the SCAFFOLD step, and a fused coordinator's step and block.
    reports = coord.profile_programs()
    fused = make_coordinator(tmp / "fused", mesh=mesh, config=dict(rounds_per_block=2))
    reports += fused.profile_programs()
    out["reports"] = [(r.program, r.num_devices, r.flops, r.attrs["mesh_shape"])
                      for r in reports]
    out["published"] = _published_programs()
    # A one-rank checkpoint of two rounds resumed here, one more round, checkpointed.
    resumed = make_coordinator(tmp / "sc_resume", mesh=mesh, scaffold=True,
                               state_store=FileStateStore(tmp / "sc_one_to_mesh"))
    out["resumed_round"] = resumed.current_round
    out["resumed"] = _controls(resumed)
    out["resumed_cohort"] = resumed._sample_cohort(2)
    resumed.run()
    out["resumed_after"] = _controls(resumed)
    # The block drawing its cohorts on the device (the JAX permutations injected).
    out["block"] = run_block(inputs, mesh, perms=perms)
    # The runner takes SCAFFOLD on two virtual hosts.
    from nanofed_tpu_torch import run_experiment

    summary = run_experiment(model="linear", num_clients=8, num_rounds=2, local_epochs=1,
                             batch_size=8, train_size=64, participation=0.5, scaffold=True,
                             hosts=2, device="cpu", out_dir=str(tmp / "sc_runner"))
    out["runner"] = {k: summary[k] for k in ("mesh_shape", "rounds_completed",
                                             "final_train_metrics")}
    out["_imports"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "nanofed_tpu"))
    return out


def scaffold_model_axis_world(rank: int, world: int, inputs: dict[str, Any],
                              tmp: str) -> dict[str, Any]:
    """(1, 2): the SCAFFOLD step, a coordinator from the JAX initial weights, and the
    (2, 2, 1) run's checkpoint resumed for one more round."""
    from pathlib import Path

    from nanofed_tpu_torch.parallel.mesh import make_mesh
    from nanofed_tpu_torch.persistence import FileStateStore

    tmp = Path(tmp)
    mesh = make_mesh((1, 2), device="cpu")
    out: dict[str, Any] = {"step": scaffold_step_case(inputs, mesh)}
    coord = make_coordinator(tmp / "sc_model_axis", inputs["coord_params"], mesh=mesh,
                             scaffold=True)
    coord.run()
    out["coord"] = _controls(coord)
    out["stack_rows"] = int(coord.c_stack.shape[0])
    resumed = make_coordinator(tmp / "sc_resume_1x2", mesh=mesh, scaffold=True,
                               config=dict(num_rounds=4),
                               state_store=FileStateStore(tmp / "sc_mesh_to_1x2"))
    out["resumed_round"] = resumed.current_round
    out["resumed"] = _controls(resumed)
    resumed.run()
    out["resumed_after"] = _controls(resumed)
    # A rank whose catalog holds one more program is out of step: every rank raises.
    from nanofed_tpu_torch.core.exceptions import NanoFedError

    skewed = make_coordinator(tmp / "skewed", mesh=mesh, config=dict(num_rounds=1))
    if rank == 1:
        skewed.program_catalog.register("extra", lambda: None)
    try:
        skewed.profile_programs()
        out["skewed"] = "profiled"
    except NanoFedError as e:
        out["skewed"] = str(e)
    out["_imports"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "nanofed_tpu"))
    return out


# ---------------------------------------------------------------------------------------
# The host-local stage of a hierarchical federation (tests/test_torch_federation.py)
# ---------------------------------------------------------------------------------------


def federation_world(rank: int, world: int, inputs: dict[str, Any], tmp: str) -> dict[str, Any]:
    """Rank h is host h of a (2, 1, 1) mesh: its ingest buffer's partial drains, ONE
    row all-reduce across the hosts under a watchdog, the apply; the fused slab
    reduce; a generation committed by both hosts and read back."""
    import torch.distributed as dist

    from nanofed_tpu_torch.communication.federation import (
        apply_summed_row,
        build_cross_host_reduce,
        build_cross_host_row_psum,
        build_drained_ingest_reduce,
        host_partial_row,
    )
    from nanofed_tpu_torch.ingest import DeviceIngestBuffer
    from nanofed_tpu_torch.parallel import CollectiveWatchdog
    from nanofed_tpu_torch.parallel.mesh import make_mesh
    from nanofed_tpu_torch.persistence import GenerationStore

    mesh = make_mesh((2, 1, 1), device="cpu")
    p = inputs["base"].size
    template = {"w": torch.zeros(p)}
    row_psum = build_cross_host_row_psum(mesh)
    watchdog = CollectiveWatchdog(deadline_s=60.0, host=rank)
    out: dict[str, Any] = {}

    buf = DeviceIngestBuffer(template, 4, device="cpu")
    for cid, delta, weight, _ in inputs["hosts"][rank]:
        buf.offer(delta, client_id=cid, round_number=0, weight=weight)
    num, mass, _ = buf.drain_fedavg_partial()
    calls = []
    all_reduce = dist.all_reduce
    dist.all_reduce = lambda t, *a, **kw: (calls.append(t.numel()), all_reduce(t, *a, **kw))[1]
    try:
        total = watchdog.run(row_psum, host_partial_row(num, mass, p, extra=(1.0,)),
                             round_number=0)
    finally:
        dist.all_reduce = all_reduce
    out["all_reduces"] = calls
    new, tail = apply_summed_row(inputs["base"], total, p)
    out["fedavg"] = (new.numpy().copy(), tail.numpy().copy())

    for cid, delta, _, version in inputs["hosts"][rank]:
        buf.offer(delta, client_id=cid, round_number=version, weight=1.0)
    num, live, stats = buf.drain_fedbuff_partial(k=buf.fill, current_version=2,
                                                 valid_versions=(1, 2))
    reduce = build_cross_host_reduce(mesh, p)
    new, tail = watchdog.run(reduce, host_partial_row(num, len(live), p),
                             torch.from_numpy(inputs["base"]))
    out["fedbuff"] = (new.numpy().copy(), tail.numpy().copy(), stats)

    fused = build_drained_ingest_reduce(mesh, inputs["slabs"].shape[1], p)
    out["fused"] = fused(torch.from_numpy(inputs["slabs"][rank]),
                         torch.from_numpy(inputs["coefs"][rank]),
                         torch.from_numpy(inputs["base"])).numpy().copy()

    store = GenerationStore(tmp, host=rank)
    store.commit(0, 0, {"w": new}, {"count": 1}, hosts=[0, 1], meta={"by": "port"})
    dist.barrier()
    record = store.latest_complete()
    out["generation"] = (record.generation, record.round_number, record.hosts, record.meta)
    out["_imports"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "nanofed_tpu"))
    return out


def federation_modules(rank: int, world: int, tmp: str) -> list[str]:
    """JAX or JAX-package modules loaded in this host after one row all-reduce under a
    watchdog and one generation commit (tests/test_torch_isolation.py)."""
    from nanofed_tpu_torch.communication.federation import (
        build_cross_host_row_psum,
        host_partial_row,
    )
    from nanofed_tpu_torch.parallel.mesh import make_mesh
    from nanofed_tpu_torch.parallel.resilience import CollectiveWatchdog
    from nanofed_tpu_torch.persistence.generation_store import GenerationStore

    row_psum = build_cross_host_row_psum(make_mesh((2, 1, 1), device="cpu"))
    total = CollectiveWatchdog(60.0).run(row_psum, host_partial_row(torch.ones(3), 1.0, 3))
    assert float(total[3]) == world
    GenerationStore(tmp, host=rank).commit(0, 0, {"w": total}, {}, hosts=[0, 1])
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "nanofed_tpu"))
