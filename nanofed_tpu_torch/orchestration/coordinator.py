"""The round loop (counterpart of ``nanofed_tpu/orchestration/coordinator.py``, its
single-device simulated path).

Each round: sample the cohort and the simulated dropouts with the JAX package's numpy
streams (``default_rng(seed * 100_003 + round_id)``, ``choice`` then
``random() >= dropout_rate``), fail the round below the completion gate, run the round
step on the device, and record the weighted round metrics, the optional eval and the
per-round metrics JSON (same keys and per-client detail as the JAX package's).

Initial weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)`` and
then moved, so a seed gives the same starting model on every device.  Each round's
device randomness comes from one round seed, ``seed * 100_003 + round_id``: the epoch
permutations from a generator on the device seeded with it, drawn for the whole
population and gathered by client id, and each client's dropout keys from a hash of
(round seed, client id).  So a client trains the same whichever cohort slot or chunk
it lands in, and a gathered cohort round equals the full-N masked round.

The guarded round (``parallel.round_step``): ``validation=`` rejects updates in the
round, ``central_privacy=`` makes the reduce DP-FedAvg (accounted per round by an
``RDPAccountant`` unless ``accountant=`` is given), ``robust=`` aggregates robustly.
Under central DP the cohort and every device draw (permutations, dropout, noise) come
from OS entropy, never from the seed, and no per-client detail is written.

Profiling and tuning: every coordinator registers its round step (and its block,
when it fuses) in a ``ProgramCatalog`` (``observability.profiling``);
``profile_programs()`` (or ``CoordinatorConfig(profile_programs=True)``) profiles them
on clones of the params and server state, so the coordinator's state is left bit for
bit as it was.  ``Coordinator.from_autotune`` builds the coordinator the autotuner
picks (``tuning.autotuner``: ``client_chunk``, ``rounds_per_block`` and batch size),
and with ``retune_every > 0`` an ``OnlineRetuner`` re-ranks the sweep's table by the
round times the run realizes and hot-swaps ``client_chunk`` and ``rounds_per_block``
between rounds and blocks.

Resumable runs: ``lr_schedule`` scales each round's local steps by
``trainer.schedules.lr_schedule_scale`` of the round index (reported as the round's
``lr_scale`` unless constant); ``state_store=`` (``persistence.FileStateStore``)
checkpoints every round and, on construction, resumes from the latest COMPLETED
checkpoint: params, server state and the privacy accountant's events, with the next
round's id.  ``model_manager=`` saves a versioned model of every COMPLETED round, and
``on_round_end`` is called with each round's metrics after its artifacts are
published.  Checkpoints and versioned models are in the JAX package's formats, so a
run of either package resumes from the other's files (``persistence``).

Client training: ``grad_fn=`` builds the default local fit with another gradient and
``local_fit=`` replaces the fit (``trainer.private.make_private_local_fit`` for DP-SGD
clients, whose noise comes from the seed-derived client keys as in the JAX package).
``scaffold=True`` runs SCAFFOLD (``parallel.scaffold_step``): the server control
``c_global`` ``[P]`` and every client's control, the rows of ``c_stack`` ``[N, P]``,
stay on the device; a gathered cohort's rows are gathered by client id and its
``delta_c`` scatter-added back with ``index_add_`` (padding slots alias row 0 with
exact zeros), the full population's added in place.  Its checkpoints carry the
controls as the JAX package's do (``{"opt", "scaffold_c_global",
"scaffold_c_stack"}``).

Fused multi-round blocks (``CoordinatorConfig.rounds_per_block = R > 1``,
``parallel.multi_round``): full blocks of R rounds are enqueued on the device with no
host barrier between them, from the same host cohorts, round seeds and lr scales as
the single-round path, so a fused run equals the unfused one round for round.  The
host synchronizes and fetches the stacked metrics once a block; checkpoints and
versioned models are written at the block's last round, so a resumed run restarts at
a block edge.  SCAFFOLD, robust aggregation, central DP and ``eval_every < R`` run
single rounds (``_fused_fallback_reason``); ragged tails and the rounds before an eval
boundary run single too.

Observability, as the JAX coordinator's: the round and its phases are spans with the
JAX names and nesting (``round`` > ``cohort-sample``, ``cohort-gather``,
``local-train``, ``aggregate``; then ``publish``; a fused block's ``dispatch`` >
``cohort-sample``, then ``host_sync``), observed into the span histogram of the
metrics registry and, each as a ``torch.profiler.record_function``, visible in a
``utils.profiling.trace`` capture.  A span never synchronizes the device: the round's
one barrier closes ``local-train``, a block's closes ``host_sync``.  Each round is
charged to the ``RoundLedger``; ``update_device_occupancy`` sets the occupancy gauge
after every round and block and its value goes to the retuner.  With
``telemetry_dir`` (or ``save_metrics``, into ``base_dir``) the run writes
``telemetry.jsonl``: the ``topology`` record, every span, ``round``,
``program_profile``, ``autotune`` and ``retune`` records, and the final registry
snapshot.

Parameter-efficient federation (``adapter=AdapterSpec(...)``, ``nanofed_tpu_torch.
adapters``): the federated ``params`` and server state are the LoRA adapter tree,
initialised by ``init_adapters(spec, base, rng=seed)``, while the base model stays
on the device as ``base_params``, read by every round step and block
(``parallel.round_step.FrozenBase``) and never updated.  Checkpoints hold the
adapters; ``merged_params()`` merges them into the base (counted), and evaluation
and versioned models use the merged params, the latter with ``metadata["adapter"]``.
The round programs are catalogued as ``adapter_round_step`` and
``adapter_round_block``.  SCAFFOLD and a custom ``local_fit``/``grad_fn`` are refused
with it, as in the JAX package.

A world of ranks (``mesh=`` or ``mesh_shape=``, ``parallel.mesh``; the JAX
coordinator's ``:274-420``): every rank runs this coordinator with the same arguments.
Clients pad to the client shards; each rank builds the whole partition on the host
(deterministic) and copies only its host row's clients to its device
(``host_client_slice``), draws the same cohorts (host-local stratified draws over a
hosts axis, bit-equal to the JAX package's), and trains its slots of the step.  Params
and the server state are the rank's model shard; evaluation, checkpoints and
versioned models use the gathered full params, in the reference's layout, so a run
resumes on another mesh shape or on one rank.  Only rank 0 writes the metrics JSON,
checkpoints, versioned models and telemetry.  In a world (an initialised process
group) a coordinator with neither argument spans the world on the 1-D mesh, as the
JAX coordinator spans every device; without one it is the one-device coordinator.
SCAFFOLD on a mesh keeps the server control as the rank's model shard and the
``[N, P]`` control stack sharded over the client shards: a rank holds the rows of its
shard of the padded population (``client_slice``), a quarter of the stack on a (2, 2, 1)
mesh.  A gathered cohort's slots reference clients of their own host (host-local
draws), but not always of their own rank: each round the ranks of a host's clients
line all-gather the rows the host's slots need, and after the step all-gather the
slots' ``delta_c`` rows, each rank scatter-adding those it owns.  A SCAFFOLD
checkpoint holds the whole stack (gathered, rank 0 writes it).  ``profile_programs()``
on a mesh runs every program on every rank in lockstep (see its docstring).

``chaos=`` (a ``faults.ChaosSchedule``) drops the plan's crashed clients from every
cohort the host samples, after the dropout draw, as the JAX coordinator does; on a
mesh every rank filters the same cohort.  A fused block that resamples its cohorts on
the device does not consult the plan (nor does the JAX block).

Strict mode (``strict=True``, ``analysis``; the JAX coordinator's ``:693-706``,
``:994-1033``, ``:1221-1298``): at construction the round step and the block are held
to the round-engine contract on meta tensors (``analysis.contracts``; SCAFFOLD's step,
whose signature differs, is skipped as in the JAX package) and the rank's inputs to
the mesh layout, and every catalogued program is audited (``analysis.program_audit``):
a finding raises ``ContractViolation`` before anything is dispatched, and a retuned
program is checked again before its first dispatch.  Every round-step and block
dispatch then runs under ``analysis.strict_mode`` (``torch.cuda.set_sync_debug_mode(
"error")``), a no-op on the CPU.  The host inputs (cohorts, permutations, keys,
weights, control rows) reach the device before the guard is entered.  The server
optimizer's counters ride on the device as 0-d tensors between rounds; checkpoints
turn them into ints.  ``audit_programs()`` audits every program on demand, with an
``audit`` telemetry record and a ``program-audit`` span each; in a world of ranks the
ranks also exchange their schedules (one ``all_gather_object``) and a rank whose
schedule differs is a ``collective-schedule`` finding.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from nanofed_tpu_torch.adapters import (
    AdapterSpec,
    adapter_param_count,
    init_adapters,
    make_adapter_apply,
    merge_adapters,
)
from nanofed_tpu_torch.aggregation.base import Strategy, fedavg_strategy
from nanofed_tpu_torch.aggregation.fedavg import compute_weights
from nanofed_tpu_torch.aggregation.privacy import (
    PrivacyAwareAggregationConfig,
    record_central_privacy,
)
from nanofed_tpu_torch.aggregation.robust import RobustAggregationConfig, robust_floor
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import ClientData, Params
from nanofed_tpu_torch.models.base import Model
from nanofed_tpu_torch.observability.profiling import (
    ProgramCatalog,
    ProgramCostReport,
    update_device_occupancy,
)
from nanofed_tpu_torch.observability.registry import get_registry
from nanofed_tpu_torch.observability.spans import SpanTracer
from nanofed_tpu_torch.observability.telemetry import RunTelemetry, install_torch_event_bridge
from nanofed_tpu_torch.orchestration.engine import RoundLedger, completion_required
from nanofed_tpu_torch.orchestration.types import (
    RoundMetrics,
    RoundStatus,
    TrainingProgress,
    cohort_size,
)
from nanofed_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    HOST_AXIS,
    Mesh,
    MeshLayout,
    all_gather_object,
    broadcast_object,
    client_shard_count,
    client_slice,
    host_axis_size,
    host_client_slice,
    is_primary,
    make_mesh,
    mesh_shape_for_topology,
    pad_client_count,
    pad_clients,
    world_size,
)
from nanofed_tpu_torch.parallel.multi_round import (
    build_round_block,
    pad_permutations,
    round_seeds,
)
from nanofed_tpu_torch.parallel.round_step import (
    FrozenBase,
    build_round_step,
    init_server_state,
)
from nanofed_tpu_torch.parallel.scaffold_step import build_scaffold_round_step
from nanofed_tpu_torch.persistence import FileStateStore, ModelManager, RestoredState
from nanofed_tpu_torch.privacy.accounting import BasePrivacyAccountant, RDPAccountant
from nanofed_tpu_torch.privacy.noise import get_noise_generator
from nanofed_tpu_torch.security.validation import ValidationConfig
from nanofed_tpu_torch.trainer.config import TrainingConfig
from nanofed_tpu_torch.trainer.local import (
    GradFn,
    client_keys,
    draw_permutations,
    make_evaluator,
)
from nanofed_tpu_torch.trainer.scaffold import stack_zero_controls, zero_controls
from nanofed_tpu_torch.trainer.schedules import (
    SCHEDULES,
    lr_schedule_scale,
    lr_schedule_scales,
)
from nanofed_tpu_torch.tuning.autotuner import (
    DEFAULT_CACHE_DIR,
    PopulationSpec,
    autotune,
    candidate_program_name,
)
from nanofed_tpu_torch.tuning.retuner import OnlineRetuner
from nanofed_tpu_torch.utils.trees import (
    from_checkpoint_params,
    from_checkpoint_stack,
    from_numpy_server_state,
    ravel,
    to_numpy_params,
    to_numpy_server_state,
    tree_size,
    unravel,
    unravel_stacked,
)

_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class CoordinatorConfig:
    """``participation_rate`` sets the cohort (ceil(C * rate)); ``dropout_rate`` drops
    sampled clients at random; below ``min_completion_rate`` of the cohort the round
    FAILs and leaves the model untouched.  ``client_metrics_every`` samples the
    per-client detail of the metrics JSON (0 = never).

    ``lr_schedule`` (``trainer.schedules``: constant, cosine, linear or step, with
    ``lr_min_factor``, ``lr_decay_every`` and ``lr_decay_gamma``) scales each
    round's local steps by a pure function of the round index, so a resumed run
    continues it exactly.

    ``rounds_per_block`` (R) runs full blocks of R rounds with no host barrier
    between them (``parallel.multi_round``); 1 is the single-round loop.

    ``profile_programs`` profiles the round step at construction
    (``Coordinator.profile_programs``).  ``retune_every`` (0 = off) asks the online
    retuner for a verdict every that many rounds, on coordinators built by
    ``from_autotune``; measured numbers are written back into the autotune cache
    entry when the run completes."""

    num_rounds: int = 1
    participation_rate: float = 1.0
    min_completion_rate: float = 0.5
    dropout_rate: float = 0.0
    seed: int = 0
    base_dir: str | Path = "runs"
    save_metrics: bool = True
    eval_every: int = 0  # 0 = never evaluate during training
    rounds_per_block: int = 1
    client_metrics_every: int = 1
    lr_schedule: str = "constant"  # constant | cosine | linear | step
    lr_min_factor: float = 0.0
    lr_decay_every: int = 10  # step schedule: rounds between decays
    lr_decay_gamma: float = 0.5  # step schedule: multiplier per decay
    profile_programs: bool = False
    retune_every: int = 0

    def __post_init__(self) -> None:
        if self.num_rounds < 1:
            raise ValueError("num_rounds must be >= 1")
        if not 0.0 < self.participation_rate <= 1.0:
            raise ValueError("participation_rate must be in (0, 1]")
        if not 0.0 <= self.min_completion_rate <= 1.0:
            raise ValueError("min_completion_rate must be in [0, 1]")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError("dropout_rate must be in [0, 1)")
        if self.lr_schedule not in SCHEDULES:
            raise ValueError(
                f"unknown lr_schedule {self.lr_schedule!r}; choose from {SCHEDULES}"
            )
        if not 0.0 <= self.lr_min_factor <= 1.0:
            raise ValueError("lr_min_factor must be in [0, 1]")
        if self.lr_decay_every < 1:
            raise ValueError("lr_decay_every must be >= 1")
        if not 0.0 < self.lr_decay_gamma <= 1.0:
            # gamma=0 would zero every update from the first decay on; gamma>1 would
            # grow the lr each decay.
            raise ValueError("lr_decay_gamma must be in (0, 1]")
        if self.rounds_per_block < 1:
            raise ValueError("rounds_per_block must be >= 1")
        if self.client_metrics_every < 0:
            raise ValueError("client_metrics_every must be >= 0 (0 = never)")
        if self.retune_every < 0:
            raise ValueError("retune_every must be >= 0 (0 = off)")


class Coordinator:
    """Drives simulated federated training on one device, or as one rank of a world
    (``mesh=``/``mesh_shape=``)."""

    @classmethod
    def from_autotune(
        cls,
        model: Model,
        train_data: ClientData,
        config: CoordinatorConfig,
        training: TrainingConfig | None = None,
        *,
        tuning_space=None,
        hbm_budget_bytes: int | None = None,
        autotune_cache_dir: str | Path | None = DEFAULT_CACHE_DIR,
        autotune_force: bool = False,
        **kwargs: Any,
    ) -> "Coordinator":
        """Build a coordinator with the configuration the autotuner picks
        (``tuning.autotune``: each candidate's round step or block profiled on inputs
        of the population's shapes on the coordinator's device): the winner's
        ``client_chunk``, ``rounds_per_block`` and batch size replace the defaults.
        The ranked table lands under ``config.base_dir`` as ``autotune_*.json``;
        results are cached, so a repeat construction profiles nothing.  The coordinator carries
        ``tuned_config`` (the winner and its provenance) and ``autotune_result``;
        with ``config.retune_every > 0`` the online retuner is attached.  An
        explicit ``client_chunk`` is refused: the tuner owns it (pin it with a
        single-valued ``tuning_space``).  With ``adapter=`` the sweep profiles the
        frozen-base round on the rank ladder around the spec's rank, and the
        coordinator federates at the winner's rank."""
        owned = [k for k in ("client_chunk", "mesh_shape", "mesh") if k in kwargs]
        if owned:
            raise NanoFedError(
                f"from_autotune owns {', '.join(owned)} — the tuner picks it; pin an "
                "axis with a single-valued tuning_space instead"
            )
        if kwargs.get("scaffold"):
            raise NanoFedError(
                "from_autotune does not cover the SCAFFOLD round program (the "
                "autotuner never sweeps it); build Coordinator(scaffold=True) by hand"
            )
        training = training or TrainingConfig()
        adapter_spec = kwargs.pop("adapter", None)
        result = autotune(
            model, PopulationSpec.from_client_data(train_data), training,
            participation=config.participation_rate,
            num_rounds=config.num_rounds,
            eval_every=config.eval_every,
            space=tuning_space,
            hbm_budget_bytes=hbm_budget_bytes,
            cache_dir=autotune_cache_dir,
            out_dir=config.base_dir,
            force=autotune_force,
            adapter=adapter_spec,
            device=kwargs.get("device"),
        )
        winner = result.winner
        if adapter_spec is not None and winner.adapter_rank is not None:
            # The tuner owns the rank axis as it owns chunk and block.
            adapter_spec = dataclasses.replace(adapter_spec, rank=winner.adapter_rank)
        coord = cls(
            model, train_data,
            dataclasses.replace(config, rounds_per_block=winner.rounds_per_block),
            training=dataclasses.replace(training, batch_size=winner.batch_size),
            client_chunk=winner.client_chunk,
            adapter=adapter_spec,
            # Every rank builds the mesh of rank 0's pick (autotune broadcasts it).
            mesh_shape=mesh_shape_for_topology(
                winner.hosts, winner.model_shards, world_size()),
            **kwargs,
        )
        coord.autotune_result = result
        coord.tuned_config = {
            **winner.to_dict(),
            "used": "tuned",
            "scoring_basis": result.scoring_basis,
            "cache_hit": result.cache_hit,
            **({"artifact": result.artifact_path} if result.artifact_path else {}),
        }
        if config.retune_every > 0:
            # The sweep result IS the candidate table the online retuner re-ranks;
            # measured numbers land back in the same cache entry.
            coord.enable_retuning(result, cache_dir=autotune_cache_dir)
        if coord.telemetry is not None:
            coord.telemetry.record("autotune", **result.telemetry_payload())
        return coord

    def __init__(
        self,
        model: Model,
        train_data: ClientData,
        config: CoordinatorConfig,
        training: TrainingConfig | None = None,
        strategy: Strategy | None = None,
        eval_data: ClientData | None = None,
        client_chunk: int | None = None,
        device: DeviceLike = None,
        validation: ValidationConfig | None = None,
        central_privacy: PrivacyAwareAggregationConfig | None = None,
        accountant: BasePrivacyAccountant | None = None,
        robust: RobustAggregationConfig | None = None,
        model_manager: ModelManager | None = None,
        state_store: FileStateStore | None = None,
        on_round_end: Callable[[RoundMetrics], None] | None = None,
        grad_fn: GradFn | None = None,
        local_fit: Callable | None = None,
        scaffold: bool = False,
        telemetry_dir: str | Path | None = None,
        adapter: AdapterSpec | None = None,
        mesh: Mesh | None = None,
        mesh_shape: tuple[int, ...] | None = None,
        chaos: Any | None = None,
        strict: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        self.strict = bool(strict)
        # Planned per-client crashes (faults.ChaosSchedule), applied to every sampled
        # cohort: deterministic under the plan, unlike dropout_rate's coin flips.
        self._chaos = chaos
        if mesh is not None and mesh_shape is not None:
            raise ValueError(
                "pass either mesh= (a prebuilt Mesh) or mesh_shape= "
                "((n_client_shards, n_model_shards) or (n_hosts, "
                "n_client_shards, n_model_shards)), not both"
            )
        if mesh is None and (mesh_shape is not None or dist.is_initialized()):
            mesh = make_mesh(mesh_shape, device=self.device)
        self.mesh = mesh
        self._primary = is_primary()
        self.model = model
        self.config = config
        self.model_manager = model_manager
        self.state_store = state_store
        self.on_round_end = on_round_end
        self.training = training or TrainingConfig()
        self.strategy = strategy or fedavg_strategy()

        # The coordinator owns the accountant of its own central-DP reduce, RDP by
        # default, so the spent (ε, δ) is tracked and reported.
        self.central_privacy = central_privacy
        if accountant is not None and central_privacy is None:
            raise ValueError(
                "accountant= given without central_privacy=: the coordinator only "
                "records spend for its own central-DP reduce"
            )
        self.privacy_accountant = accountant
        if central_privacy is not None and accountant is None:
            self.privacy_accountant = RDPAccountant()
        # OS-entropy generator for DP cohorts and the DP round's device seeds, seeded
        # from the system at construction, never from config.seed.
        self._secret_sampling_rng = np.random.default_rng()

        self.num_clients = int(train_data.x.shape[0])
        # Clients pad to the client shards; a rank holds its host row's clients.
        n_shards = 1 if mesh is None else client_shard_count(mesh)
        self._n_hosts = 1 if mesh is None else host_axis_size(mesh)
        self._padded_clients = pad_client_count(self.num_clients, n_shards)
        self._rows_per_host = self._padded_clients // self._n_hosts
        if mesh is None:
            self._row0 = 0
            self._data = train_data.to(self.device)
            self._num_samples = self._data.mask.sum(1)
        else:
            padded = pad_clients(train_data, self._padded_clients)
            self._row0, row_stop = host_client_slice(self._padded_clients, mesh)
            self._data = padded.select(slice(self._row0, row_stop)).to(self.device)
            # Sample counts of the whole population, from the host copy.
            self._num_samples = torch.as_tensor(
                np.asarray(padded.mask, dtype=np.float32).sum(1)).to(self.device)
        init_gen = torch.Generator().manual_seed(config.seed)
        initial = {name: p.to(self.device) for name, p in model.init(init_gen).items()}
        # Adapter mode: the federated params are the adapter tree; the base stays on
        # the device, read by every round and never updated or rebuilt.
        self.adapter = adapter
        self._merge_count = 0
        self.base_params: Params | None = None
        if adapter is not None:
            if scaffold:
                raise ValueError(
                    "adapter= cannot be combined with scaffold=True: the "
                    "control-variate machinery assumes the federated tree IS "
                    "the model; adapter SCAFFOLD would need control state on "
                    "the adapter tree, which is not built yet"
                )
            if local_fit is not None or grad_fn is not None:
                raise ValueError(
                    "adapter= builds the local fit from the frozen base inside "
                    "the round program; a custom local_fit/grad_fn cannot see "
                    "the base and is refused (see parallel.round_step.FrozenBase)"
                )
            self.base_params = initial
            # Seeded off config.seed, a host draw as the JAX package's; B = 0 makes
            # round 0's merged model the base exactly.
            self.params: Params = init_adapters(adapter, initial, rng=config.seed)
        else:
            self.params = initial
        # On a mesh params, base and server state live as this rank's model shard;
        # the layouts know the full shapes.
        self._layout = self._base_layout = None
        self._params_like = self._base_like = None
        if mesh is not None:
            self._params_like = {k: v.to("meta") for k, v in self.params.items()}
            self._layout = MeshLayout(mesh, self._params_like)
            self.params = self._layout.shard_params(self.params)
            if self.base_params is not None:
                self._base_like = {k: v.to("meta") for k, v in self.base_params.items()}
                self._base_layout = MeshLayout(mesh, self._base_like)
                self.base_params = self._base_layout.shard_params(self.base_params)
        self.server_state = init_server_state(self.strategy, self.params)

        if robust is not None and self.cohort_size < robust_floor(robust):
            # Every round would fail closed yet be reported COMPLETED: refuse up front.
            raise ValueError(
                f"robust method {robust.method!r} needs a cohort of at least "
                f"{robust_floor(robust)} clients, but participation_rate="
                f"{config.participation_rate} over {self.num_clients} clients "
                f"samples only {self.cohort_size} per round"
            )
        # Cohort gathering (participation < 1): run the round over the K sampled
        # clients' rows, not all N with zero weights.  A chunk size that does not
        # divide the cohort keeps the full-N path, as in the JAX package.
        self._cohort_mode = self.cohort_size < self.num_clients
        if self._cohort_mode and client_chunk is not None:
            per_dev = pad_client_count(self.cohort_size, n_shards) // n_shards
            if client_chunk < per_dev and per_dev % client_chunk != 0:
                self._cohort_mode = False
        self._step_clients = (pad_client_count(self.cohort_size, n_shards)
                              if self._cohort_mode else self._padded_clients)
        # Host-local cohorts over a hosts axis: each host's slot segment only ever
        # references that host's clients (see _sample_cohort/_place_cohort).
        self._slots_per_host = self._step_clients // self._n_hosts
        if self._cohort_mode and self._n_hosts > 1:
            caps = [
                min(max(0, stop - start), self._slots_per_host)
                for start, stop in self._host_populations()
            ]
            if sum(caps) < self.cohort_size:
                raise NanoFedError(
                    f"cohort_size {self.cohort_size} exceeds the hosts-axis "
                    f"capacity (per-host caps {caps} = min(resident clients, "
                    f"slot segment {self._slots_per_host})) — shrink the "
                    "cohort or raise participation"
                )
        if (
            config.lr_schedule != "constant"
            and local_fit is not None
            and not getattr(local_fit, "supports_lr_scale", False)
        ):
            # The scale would be silently ignored: every round would train at full rate.
            raise ValueError(
                f"lr_schedule={config.lr_schedule!r} requires a local_fit that "
                "accepts lr_scale (make_local_fit/make_private_local_fit do; mark a "
                "custom one with `fit.supports_lr_scale = True` once it honors the "
                "argument)"
            )
        self.scaffold = scaffold
        if scaffold:
            incompatible = {
                "central_privacy": central_privacy, "validation": validation,
                "robust": robust, "local_fit": local_fit,
            }
            bad = [k for k, v in incompatible.items() if v is not None]
            if bad:
                # The control estimate comes from the un-noised, un-trimmed local
                # trajectory; composing it with DP noise, robust trimming or another
                # fit would bias every later round's correction.
                raise ValueError(
                    f"scaffold=True cannot be combined with {', '.join(bad)}: the "
                    "control-variate update assumes the plain corrected-SGD local fit "
                    "and the uniform participant mean"
                )
            # The server control is params-shaped round state (the rank's model shard
            # on a mesh); a rank holds its client shard's rows of the control stack.
            self.c_global = zero_controls(self.params)
            if mesh is None:
                self.c_stack = stack_zero_controls(self.params, self.num_clients)
            else:
                lo, hi = client_slice(self._padded_clients, mesh)
                self.c_stack = torch.zeros((hi - lo, tree_size(self._params_like)),
                                           device=self.device)
            self.control_exchange_bytes = 0  # received by the last round's exchanges
        # Everything a retune swap needs to rebuild the round step with another
        # client_chunk (see _rebuild_round_programs).
        self._client_chunk = client_chunk
        self._builder_ctx: dict[str, Any] = dict(
            central_privacy=central_privacy, validation=validation, robust=robust,
            grad_fn=grad_fn, local_fit=local_fit,
            frozen_base=None if adapter is None else FrozenBase(
                base_like=self.base_params if mesh is None else self._base_like,
                bind=lambda base: make_adapter_apply(model.apply, adapter, base)),
            **({} if mesh is None else {"mesh": mesh, "params_like": self._params_like}),
        )
        if scaffold:
            self._round_step = build_scaffold_round_step(
                model, self.training, self.num_clients, strategy=self.strategy,
                grad_fn=grad_fn, client_chunk=client_chunk, device=self.device,
                mesh=mesh, params_like=self._params_like,
            )
        else:
            self._round_step = build_round_step(
                model, self.training, self.strategy, client_chunk=client_chunk,
                **self._builder_ctx,
            )
        # Fused blocks, or the reason this configuration runs single rounds.
        self._round_block = None
        self._fused_fallback_reason: str | None = None
        if config.rounds_per_block > 1:
            unfused = self._unfused(config.rounds_per_block)
            if unfused:
                self._fused_fallback_reason = unfused
                _log.info(
                    "rounds_per_block=%d requested but %s is not fused; using the "
                    "single-round path", config.rounds_per_block, unfused,
                )
            else:
                self._round_block = self._build_block(client_chunk)
        # The round step, registered with a LAZY argument factory (nothing is made
        # until profile_programs() runs it).
        self.program_catalog = ProgramCatalog()
        self._register_programs()
        self._evaluator = make_evaluator(model, batch_size=256) if eval_data is not None else None
        self._eval_data = eval_data.to(self.device) if eval_data is not None else None

        self.current_round = 0
        self.history: list[RoundMetrics] = []
        self._last_client_detail: dict[str, Any] | None = None
        self.base_dir = Path(config.base_dir)
        if config.save_metrics and self._primary:
            (self.base_dir / "metrics").mkdir(parents=True, exist_ok=True)

        # Observability: round and phase metrics always flow into the process
        # registry; with save_metrics (or an explicit telemetry_dir) the run also
        # writes telemetry.jsonl.  The build bridge counts kernel libraries.
        install_torch_event_bridge()
        tel_dir = (
            Path(telemetry_dir)
            if telemetry_dir is not None
            else (self.base_dir if config.save_metrics else None)
        )
        self.telemetry = (RunTelemetry(tel_dir)
                          if tel_dir is not None and self._primary else None)
        if self.telemetry is not None:
            # The world's geometry (one process on one device without a mesh).
            world = 1 if mesh is None else mesh.world_size
            self.telemetry.record(
                "topology", process_count=world, hosts=self._n_hosts,
                mesh_shape=[1] if mesh is None else list(mesh.shape), devices=world,
                num_clients=self.num_clients,
            )
            if adapter is not None:
                # The rank and the trainable-vs-frozen sizes, digested by
                # metrics-summary; the final merge count follows at the run's end.
                self.telemetry.record(
                    "adapter", **adapter.to_dict(),
                    **adapter_param_count(adapter, self._base_like or self.base_params),
                )
        self._tracer = (
            self.telemetry.tracer
            if self.telemetry is not None
            # keep_records=False: only the histogram consumes these spans.
            else SpanTracer(keep_records=False)
        )
        self._registry = (
            self.telemetry.registry if self.telemetry is not None else get_registry()
        )
        self.program_catalog.registry = self._registry
        self._ledger = RoundLedger(
            self._registry, telemetry=self.telemetry, track_dropouts=True
        )
        # Set by from_autotune: the winner and its provenance, and the sweep result.
        self.tuned_config: dict[str, Any] | None = None
        self.autotune_result = None
        # Online retuning: attached by enable_retuning (from_autotune with
        # retune_every > 0).  _retune_candidate is the live program's row of the
        # table, _last_retune_round the round the cadence counts from, and
        # retune_events one record per verdict (the JAX package's `retune`
        # telemetry records, with `applied`).
        self.retuner: OnlineRetuner | None = None
        self._retune_candidate = None
        self._last_retune_round = 0
        self.retune_events: list[dict[str, Any]] = []
        if state_store is not None:
            restored = state_store.restore_latest()
            if restored is not None:
                self._resume(restored)
        if self.strict:
            if self.scaffold:
                _log.info("strict=True: contract check skipped for the SCAFFOLD round "
                          "program (different signature); the sync guard still applies")
            else:
                self._check_contracts()
            # The program audit runs every rank's program on meta tensors: SCAFFOLD is
            # covered too.
            self._audit_strict()
        if config.profile_programs:
            self.profile_programs()

    def _resume(self, restored: RestoredState) -> None:
        """Continue from a checkpoint of either package: its params and server state
        (checked against this model and strategy) onto the device, the accountant's
        events, and the round after the checkpointed one."""
        server_state = restored.server_state
        has_controls = isinstance(server_state, dict) and "scaffold_c_stack" in server_state
        if not self.scaffold and has_controls:
            raise NanoFedError(
                "the checkpoint carries SCAFFOLD control state but this "
                "coordinator was built with scaffold=False — resume with "
                "scaffold=True (or point at a non-SCAFFOLD run's store)"
            )
        # A checkpoint holds the full params, state and controls; a mesh rank keeps
        # its shards and its rows.
        full = self.full_params()
        if self.scaffold:
            if not has_controls:
                raise NanoFedError(
                    "scaffold=True but the checkpoint carries no control "
                    "state — it was written by a non-SCAFFOLD run; resuming "
                    "would silently zero every client's correction"
                )
            c_global = ravel(from_checkpoint_params(server_state["scaffold_c_global"], full))
            if self._layout is None:
                self.c_global = c_global
                self.c_stack = from_checkpoint_stack(
                    server_state["scaffold_c_stack"], full, self.num_clients)
            else:
                self.c_global = self._layout.slice_shard(c_global)
                self.c_stack = self._own_control_rows(server_state["scaffold_c_stack"], full)
            server_state = server_state["opt"]
        params = from_checkpoint_params(restored.params, full)
        state = from_numpy_server_state(server_state, self.strategy, params)
        if self._layout is not None:
            params = self._layout.shard_params(params)
            state = {k: self._layout.slice_shard(v) if _is_vector(v) else v
                     for k, v in state.items()}
        self.params, self.server_state = params, state
        accountant_state = restored.metadata.metrics.get("privacy_accountant")
        if self.privacy_accountant is not None and accountant_state is not None:
            self.privacy_accountant.load_state_dict(accountant_state)
        self.current_round = restored.round_number + 1
        _log.info("resumed from round %d checkpoint", restored.round_number)

    # ------------------------------------------------------------------
    # Program profiling (observability.profiling)
    # ------------------------------------------------------------------

    def _register_programs(self) -> None:
        """Register the round step under ``"round_step"`` (a SCAFFOLD coordinator's
        under ``"scaffold_round_step"``, with the controls among its arguments, and an
        adapter coordinator's under ``"adapter_round_step"``, with the frozen base, as
        the JAX package names them) and, when the coordinator fuses, its block under
        ``"round_block"`` (``"adapter_round_block"``; profiled over its R rounds).  The
        argument factories hand the programs CLONES of the params and server state;
        the step gets the data rows of its width, weights one, permutations and
        dropout keys from the config's seed (and a noise draw under central DP), the
        block the population and a full cohort each round, so profiling leaves the
        coordinator's state untouched.  On a mesh each rank's arguments are its own:
        its model shards, its slots' rows of the step, and a block's cohorts drawn from
        each host's own clients.  The attributes carry ``mesh_shape`` as the JAX
        coordinator's do (``[clients, model]`` on a 1-D mesh and on one device)."""
        n_local = self._slots.stop - self._slots.start

        def _step_args() -> tuple[tuple, dict]:
            gen = torch.Generator(device=self.device).manual_seed(self.config.seed)
            args = (
                {name: p.clone() for name, p in self.params.items()},
                {k: v.clone() for k, v in self.server_state.items()},
                self._data.select(slice(0, n_local)),
                torch.ones(n_local, device=self.device),
                draw_permutations(gen, n_local, self.training.local_epochs,
                                  self._data.y.shape[1]),
                client_keys(self.config.seed, n_local, self.device),
            )
            if self.central_privacy is not None:
                noise_type = self.central_privacy.privacy.noise_type
                args += (get_noise_generator(noise_type).standard(
                    gen, (tree_size(self._params_like or self.params),)),)
            return args, {}

        mesh_shape = [1] if self.mesh is None else list(self.mesh.shape)
        attrs = {"mesh_shape": mesh_shape + [1] * (len(mesh_shape) == 1),
                 "step_clients": self._step_clients, "client_chunk": self._client_chunk}
        if self.scaffold:
            def _scaffold_args() -> tuple[tuple, dict]:
                # The SCAFFOLD step takes the controls between the server state and
                # the data: c_global and the step's rows of the control stack.
                (params, state, data, weights, perms, keys), _ = _step_args()
                c_rows = self.c_stack[:n_local].clone()
                return (params, state, self.c_global.clone(), c_rows, data, weights,
                        perms, keys), {}

            self.program_catalog.register(
                "scaffold_round_step", self._round_step, args_factory=_scaffold_args,
                attrs=attrs,
            )
            return
        if self.adapter is not None:
            attrs = {**attrs, "adapter_rank": self.adapter.rank}

            def _adapter_step_args() -> tuple[tuple, dict]:
                # The frozen base enters as dispatched: the third argument, not cloned
                # (no round writes it).
                (params, state, *rest), _ = _step_args()
                return (params, state, self.base_params, *rest), {}

            self.program_catalog.register(
                "adapter_round_step", self._round_step, args_factory=_adapter_step_args,
                attrs=attrs,
            )
        else:
            self.program_catalog.register(
                "round_step", self._round_step, args_factory=_step_args, attrs=attrs,
            )
        if self._round_block is None:
            return
        rpb = self.config.rounds_per_block

        def _block_args() -> tuple[tuple, dict]:
            # Every slot a distinct client with weight: the profiled block runs the
            # rounds a full cohort runs; each host's slot segment holds its own clients.
            n = self._step_clients
            slot = torch.arange(n, device=self.device)
            seg = n // self._n_hosts
            ids = (slot // seg) * self._rows_per_host + slot % seg
            idx = ids.expand(rpb, n).contiguous() if self._cohort_mode else None
            args = (
                {name: p.clone() for name, p in self.params.items()},
                {k: v.clone() for k, v in self.server_state.items()},
                self._data, self._num_samples,
                round_seeds(self.config.seed, range(rpb)), [1.0] * rpb,
                idx, torch.ones((rpb, n), device=self.device),
            )
            return args, ({} if self.adapter is None else {"base_params": self.base_params})

        self.program_catalog.register(
            self._block_program_name, self._round_block, args_factory=_block_args,
            rounds=rpb, attrs={**attrs, "rounds_per_block": rpb},
        )

    @property
    def _block_program_name(self) -> str:
        return "round_block" if self.adapter is None else "adapter_round_block"

    # ------------------------------------------------------------------
    # Strict mode and the program audit (analysis)
    # ------------------------------------------------------------------

    def _check_contracts(self) -> None:
        """Hold the built round programs to the round-engine contract on meta
        tensors (``analysis.contracts``: nothing executes, nothing is allocated) and
        this rank's inputs to the mesh layout; a drifted program fails here with a
        named leaf."""
        from nanofed_tpu_torch.analysis.contracts import (
            check_input_shardings,
            check_round_block,
            check_round_step,
            to_meta,
        )

        name = "adapter_round_step" if self.adapter is not None else "round_step"
        args, _ = to_meta(self.program_catalog.registration(name)[1]())
        params, state, *rest = args
        base = None
        if self.adapter is not None:
            base, *rest = rest
        report = check_round_step(self._round_step, params, state, *rest,
                                  frozen_base=base, clients=self._step_clients)
        _log.info("strict: %s contract ok (%s)", name, report)
        if self._round_block is not None:
            (params, state, data, num_samples, seeds, scales, idx, mask), kw = to_meta(
                self.program_catalog.registration(self._block_program_name)[1]())
            report = check_round_block(self._round_block, params, state, data, num_samples,
                                       seeds, scales, cohort_idx=idx, cohort_mask=mask,
                                       frozen_base=kw.get("base_params"))
            _log.info("strict: %s contract ok (%s)", self._block_program_name, report)
        check_input_shardings(
            self._data, self.params, self.mesh, padded_clients=self._padded_clients,
            params_like=self._params_like, base_params=self.base_params,
            base_like=self._base_like,
        )

    def _audit(self, compile: bool, spans: bool = False) -> list:
        """Every catalogued program's audit report (each under a ``program-audit``
        span with ``spans``); in a world of ranks (real process groups) the ranks
        also compare their schedules (one object all-gather) and a rank whose
        schedule differs is a ``collective-schedule`` finding."""
        from nanofed_tpu_torch.analysis.program_audit import schedule_mismatch_findings

        reports = []
        for name in self.program_catalog.names():
            with (self._tracer.span("program-audit", program=name) if spans
                  else contextlib.nullcontext()):
                reports.append(self.program_catalog.audit(name, compile=compile))
        if self.mesh is not None and self.mesh.world_size > 1 and not self.mesh.described:
            schedules = all_gather_object([r.schedule for r in reports])
            reports = [
                dataclasses.replace(r, findings=r.findings + tuple(
                    schedule_mismatch_findings(r.program, [s[i] for s in schedules])))
                for i, r in enumerate(reports)
            ]
        return reports

    def _audit_strict(self) -> None:
        """The construction-time program audit: findings RAISE, so a divergent
        collective schedule, an upcast input or a host read never reaches a
        dispatch."""
        from nanofed_tpu_torch.analysis.contracts import ContractViolation

        findings = [f for report in self._audit(compile=False) for f in report.findings]
        if findings:
            raise ContractViolation(
                "program audit failed:\n" + "\n".join(f.render() for f in findings))
        _log.info("strict: program audit ok (%s)", ", ".join(self.program_catalog.names()))

    def audit_programs(self, compile: bool = True) -> list:
        """Audit every catalogued round program (``analysis.program_audit``):
        collective schedules across ranks, mesh discipline, dtype drift, host reads
        inside the program.  Appends an ``audit`` record a program to
        ``telemetry.jsonl`` (when telemetry is on) under a ``program-audit`` span and
        returns the reports; findings are REPORTED, not raised — the CLI decides the
        exit code, strict mode has its own construction-time raise."""
        reports = []
        for report in self._audit(compile=compile, spans=True):
            if self.telemetry is not None:
                self.telemetry.record("audit", **report.to_dict())
            _log.info(
                "audit %s: %s (%d collectives, axes %s, %d rank(s))", report.program,
                "ok" if report.ok else f"{len(report.findings)} finding(s)",
                len(report.schedule), ",".join(report.mesh_axes) or "-", report.ranks,
            )
            reports.append(report)
        return reports

    def _dispatch_guard(self):
        """The strict-mode sync guard around a round-step or block dispatch: every
        input is on the device by then, so a synchronizing call inside the dispatch
        is a hot-path bug and raises (``analysis.strict_mode``; a no-op on the CPU).
        A no-op context when ``strict=False``."""
        if not self.strict:
            return contextlib.nullcontext()
        from nanofed_tpu_torch.analysis.contracts import strict_mode

        return strict_mode(self.device)

    def profile_programs(self, force: bool = False) -> list[ProgramCostReport]:
        """Profile every catalogued program (``observability.profiling``: a first
        call, a counting call and timed calls of the round step on clones of the
        state), publish the ``nanofed_program_*`` gauges, and return the reports.
        Reports are cached — a second call is free unless ``force``.

        On a mesh a program holds collectives, so every rank must run the same calls
        in the same order: before each program the ranks all-gather what they are
        about to do (the program and whether its report is cached) and every rank
        raises the same error if any differs, instead of one rank waiting in a
        collective its peers never enter.  The calls themselves are bounded by the
        world's deadline, the process group's timeout.  Each rank returns its own
        reports (its share of the counts, ``num_devices`` the world size); rank 0
        alone publishes the gauges and the telemetry records."""
        reports: list[ProgramCostReport] = []
        for name in self.program_catalog.names():
            cached = self.program_catalog.report(name) is not None and not force
            if self.mesh is not None:
                _lockstep(("profile", name, cached))
            with self._tracer.span("program-profile", program=name):
                report = self.program_catalog.profile(name, force=force,
                                                      publish=self._primary)
            if not cached:
                if self.telemetry is not None:
                    self.telemetry.record("program_profile", **report.to_dict())
                bound = report.lower_bound_s
                _log.info(
                    "program %s: %.3g FLOPs/round, %.3g bytes, peak %.3g device "
                    "bytes, intensity %.2f -> %s%s (first call %.2fs, measured %.4gs)",
                    name, report.flops / report.rounds, report.bytes_accessed,
                    report.peak_bytes, report.arithmetic_intensity, report.verdict,
                    (f", >= {bound / report.rounds:.3g}s/round achievable"
                     if bound is not None else ""),
                    report.compile_seconds, report.measured_s,
                )
            reports.append(report)
        return reports

    # ------------------------------------------------------------------
    # Online retuning (tuning.retuner)
    # ------------------------------------------------------------------

    def enable_retuning(
        self,
        result,
        *,
        cache_dir: str | Path | None = DEFAULT_CACHE_DIR,
        hysteresis: float = 0.05,
        min_rounds: int = 2,
        current=None,
    ) -> OnlineRetuner:
        """Attach an :class:`~nanofed_tpu_torch.tuning.OnlineRetuner` over
        ``result``'s candidate table (``from_autotune`` calls this when
        ``config.retune_every > 0``; callable directly on a hand-built coordinator
        whose configuration matches a table row, named by ``current``, default the
        winner).  Round times flow in after every round; :meth:`start_training`
        asks for a verdict every ``config.retune_every`` rounds and writes the
        measurements back into the autotune cache entry when the run completes."""
        if self.scaffold:
            raise NanoFedError(
                "online retuning does not cover the SCAFFOLD round program "
                "(different signature; the autotuner never sweeps it)"
            )
        self.retuner = OnlineRetuner(
            result, hysteresis=hysteresis, min_rounds=min_rounds, cache_dir=cache_dir,
        )
        self._retune_candidate = current if current is not None else result.winner
        self._last_retune_round = self.current_round
        return self.retuner

    def _observe_retune(
        self, rounds: int, walltime_s: float, occupancy: float | None = None,
    ) -> None:
        """Feed one realized round or block time, and the span-derived occupancy, to
        the retuner (no-op when retuning is off)."""
        if self.retuner is None or self._retune_candidate is None:
            return
        self.retuner.observe(
            self._retune_candidate, rounds, walltime_s, occupancy=occupancy,
        )

    def _maybe_retune(self) -> None:
        """Between rounds, ask the retuner for a verdict every ``config.retune_every``
        rounds and apply a proposed swap.  Every verdict — swap, hold, or a swap the
        coordinator refused — lands in ``retune_events`` and as a ``retune``
        telemetry record."""
        cfg = self.config
        if self.retuner is None or cfg.retune_every <= 0:
            return
        if self.current_round <= 0 or self.current_round >= cfg.num_rounds:
            return
        if self.current_round - self._last_retune_round < cfg.retune_every:
            return
        self._last_retune_round = self.current_round
        # Ranks measure different round times: rank 0's verdict holds for all.
        decision = broadcast_object(self.retuner.propose(self._retune_candidate))
        applied = False
        if decision.swap:
            applied = self._apply_retune(decision)
        event = {"round": self.current_round, "applied": applied, **decision.to_dict()}
        self.retune_events.append(event)
        if self.telemetry is not None:
            self.telemetry.record("retune", **event)

    def _apply_retune(self, decision) -> bool:
        """Perform a proposed swap: rebuild the round step under the new
        ``client_chunk`` and re-register it.  Returns False (the old program
        untouched) when the coordinator refuses — the rebuild is transactional."""
        new = decision.new
        try:
            self._rebuild_round_programs(new.client_chunk, new.rounds_per_block)
        except NanoFedError as e:
            _log.warning(
                "retune swap to %s refused at the coordinator (%s); keeping %s",
                candidate_program_name(new), e, candidate_program_name(decision.old),
            )
            return False
        self._retune_candidate = new
        _log.info(
            "retune: swapped round program %s -> %s at round %d (%s basis, %+.1f%% "
            "predicted win)",
            candidate_program_name(decision.old), candidate_program_name(new),
            self.current_round, decision.basis, 100.0 * (decision.delta or 0.0),
        )
        return True

    def _unfused(self, rounds_per_block: int) -> str | None:
        """Why this configuration cannot run ``rounds_per_block``-round blocks (the
        JAX coordinator's reasons), or None."""
        ctx = self._builder_ctx
        unsupported = [name for name, active in (
            ("SCAFFOLD", self.scaffold),
            ("robust aggregation", ctx["robust"] is not None),
            ("central DP", ctx["central_privacy"] is not None),
            # Blocks are cut at eval boundaries: a shorter eval cadence would never
            # leave room for a full block.
            ("eval_every < rounds_per_block",
             0 < self.config.eval_every < rounds_per_block),
        ) if active]
        return " + ".join(unsupported) or None

    def _build_block(self, client_chunk: int | None) -> Callable:
        ctx = self._builder_ctx
        cfg = self.config
        return build_round_block(
            self.model, self.training, self.strategy,
            num_clients=self.num_clients, padded_clients=self._padded_clients,
            step_clients=self._step_clients,
            cohort_size=self.cohort_size, dropout_rate=cfg.dropout_rate,
            min_completion_rate=cfg.min_completion_rate,
            grad_fn=ctx["grad_fn"], local_fit=ctx["local_fit"],
            validation=ctx["validation"], frozen_base=ctx["frozen_base"],
            client_chunk=client_chunk,
            collect_client_detail=cfg.save_metrics and cfg.client_metrics_every > 0,
            # Explicit, never derived: the block lays out the mask as _train_block
            # builds it (full-N when the chunk does not divide the cohort).
            cohort_mode=self._cohort_mode, device=self.device,
            mesh=self.mesh, params_like=self._params_like,
        )

    def _rebuild_round_programs(self, client_chunk: int | None, rounds_per_block: int) -> None:
        """Rebuild the round step and block for a hot-swapped ``(client_chunk,
        rounds_per_block)``.  A chunk that does not divide the step's client rows is
        refused, as is a ``rounds_per_block > 1`` this configuration cannot fuse.
        Transactional: both programs are built before anything is replaced."""
        if self.scaffold:
            raise NanoFedError("online retuning does not cover the SCAFFOLD round program")
        n = self._step_clients
        if client_chunk is not None and client_chunk < n and n % client_chunk != 0:
            raise NanoFedError(
                f"client_chunk={client_chunk} does not divide the step's {n} client "
                f"rows ({'gathered cohort' if self._cohort_mode else 'full population'})"
            )
        round_step = build_round_step(
            self.model, self.training, self.strategy, client_chunk=client_chunk,
            **self._builder_ctx,
        )
        round_block = None
        if rounds_per_block > 1:
            unfused = self._unfused(rounds_per_block)
            if unfused:
                raise NanoFedError(
                    f"rounds_per_block={rounds_per_block} is not fused-capable here "
                    f"({unfused})"
                )
            round_block = self._build_block(client_chunk)
        # Commit: nothing above changed the coordinator.
        self._round_step = round_step
        self._round_block = round_block
        self._fused_fallback_reason = None
        self._client_chunk = client_chunk
        self.config = dataclasses.replace(self.config, rounds_per_block=rounds_per_block)
        if round_block is None:
            # No dead program stays profiled.
            self.program_catalog.remove(self._block_program_name)
        self._register_programs()
        if self.strict:
            # A retuned program is a NEW program: checked and audited before the
            # swap's first dispatch, the same bar as construction.
            self._check_contracts()
            self._audit_strict()

    # ------------------------------------------------------------------
    # Round loop
    # ------------------------------------------------------------------

    def start_training(self) -> Iterator[RoundMetrics]:
        """Generator over rounds.  Retune verdicts run BETWEEN rounds, and between
        blocks: the next dispatch picks up a swapped program, the one in flight never
        changes.  With ``rounds_per_block > 1`` a full block publishes all its rounds
        before the first is yielded, so a consumer that stops mid-block resumes at the
        block's edge."""
        try:
            while self.current_round < self.config.num_rounds:
                self._maybe_retune()
                n = self._block_len()
                if n > 1:
                    yield from self._train_block(n)
                    continue
                metrics = self._train_round(self.current_round)
                self.history.append(metrics)
                with self._tracer.span("publish", round=metrics.round_id):
                    self._publish_round(metrics)
                if self.on_round_end is not None:
                    self.on_round_end(metrics)
                self.current_round += 1
                yield metrics
        finally:
            # The final snapshot only when ALL rounds ran: a caller that abandons the
            # generator early may resume with a fresh start_training(), and a closed
            # sink would drop every later record.
            done = self.current_round >= self.config.num_rounds
            if self.retuner is not None and done and self._primary:
                # The next run's cache hit starts from these measurements.
                written = self.retuner.write_back()
                if self.telemetry is not None:
                    self.telemetry.record(
                        "retune_summary", **self.retuner.summary(),
                        **({"cache_entry": str(written)} if written is not None else {}),
                    )
            if self.telemetry is not None and done:
                if self.adapter is not None:
                    # How many times the run paid the full-model merge.
                    self.telemetry.record("adapter", rank=self.adapter.rank,
                                          merges=self._merge_count)
                self.telemetry.close()

    def run(self) -> list[RoundMetrics]:
        return list(self.start_training())

    def _publish_round(self, metrics: RoundMetrics, persist_state: bool = True) -> None:
        """Release the round's artifacts: the checkpoint FIRST, then the metrics JSON,
        then the versioned model (COMPLETED rounds only).  A crash between them then
        loses at most an artifact, never an accounting event: a persisted noised
        release must not outlive its accountant entry.

        ``persist_state=False`` (a fused block's rounds before its last) skips the
        checkpoint and the versioned model: ``self.params`` already holds the block's
        END state, which is persisted only under the block's last round id."""
        if self.state_store is not None and persist_state:
            # On a mesh every rank gathers (a collective); rank 0 writes.
            params, state = self.full_params(), self.full_server_state()
            if self.scaffold:
                c_global, c_stack = self.full_controls()
        if self.state_store is not None and persist_state and self._primary:
            ckpt_metrics = metrics.to_dict()
            if self.privacy_accountant is not None:
                ckpt_metrics["privacy_accountant"] = self.privacy_accountant.state_dict()
            server_state: Any = to_numpy_server_state(state, params)
            if self.scaffold:
                # The controls are round state: resuming without them would restart
                # every client's correction from zero.
                server_state = {
                    "opt": server_state,
                    "scaffold_c_global": to_numpy_params(unravel(c_global, params)),
                    "scaffold_c_stack": to_numpy_params(unravel_stacked(c_stack, params)),
                }
            self.state_store.checkpoint(
                round_number=metrics.round_id,
                params=to_numpy_params(params),
                server_state=server_state,
                metrics=ckpt_metrics,
                status="COMPLETED" if metrics.status == RoundStatus.COMPLETED else "FAILED",
            )
        if self.config.save_metrics and self._primary:
            self._save_round_metrics(metrics)
        if (
            self.model_manager is not None
            and persist_state
            and metrics.status == RoundStatus.COMPLETED
        ):
            save_params = self.full_params()
            metadata = {"round": metrics.round_id, "metrics": metrics.agg_metrics}
            if self.adapter is not None:
                # A versioned model must run for a consumer that knows nothing of
                # adapters: the MERGED params.  Checkpoints stay adapter-shaped.
                save_params = self.merged_params()
                metadata["adapter"] = self.adapter.to_dict()
            if self._primary:
                self.model_manager.save_model(save_params, metadata=metadata)

    def _sample_cohort(self, round_id: int) -> np.ndarray:
        """This round's surviving cohort: the JAX package's numpy draws exactly.  Under
        central DP the amplified ε the accountant credits holds only if the sampling
        is secret, so DP cohorts come from OS entropy."""
        if self.central_privacy is not None:
            host_rng = self._secret_sampling_rng
        else:
            host_rng = np.random.default_rng(self.config.seed * 100_003 + round_id)
        if self._n_hosts > 1 and self._cohort_mode:
            # Host-local stratified draw: every host's slot segment is filled from
            # the clients it holds (the draw order differs from the 1-D mesh's).
            sampled = self._sample_host_local(host_rng)
        else:
            sampled = host_rng.choice(self.num_clients, size=self.cohort_size,
                                      replace=False)
        if self.config.dropout_rate > 0:
            keep = host_rng.random(len(sampled)) >= self.config.dropout_rate
            sampled = sampled[keep]
        if self.central_privacy is not None:
            sampled = broadcast_object(sampled)  # rank 0's secret draw, on every rank
        if self._chaos is not None:
            # Planned crashes: a crashed client is gone from this and every later
            # cohort; the round then stands or falls on min_completion_rate.  After
            # the broadcast, so every rank filters (and counts) the same cohort.
            alive = [c for c in sampled if not self._chaos.crashed(int(c), round_id)]
            sampled = np.asarray(alive, dtype=sampled.dtype)
        return sampled

    def _host_populations(self) -> list[tuple[int, int]]:
        """Per-host resident client id ranges ``[(start, stop), ...]``: host h holds
        the padded rows ``[h*rows_per_host, (h+1)*rows_per_host)``, clipped to the
        real clients."""
        return [
            (h * self._rows_per_host,
             min((h + 1) * self._rows_per_host, self.num_clients))
            for h in range(self._n_hosts)
        ]

    def _sample_host_local(self, host_rng: np.random.Generator) -> np.ndarray:
        """Stratified cohort draw over the hosts axis, the JAX coordinator's draw for
        draw: proportional quotas with randomized largest-remainder rounding (each
        leftover slot to a host drawn with weight its outstanding remainder, uniform
        once remainders are spent), capped by each host's clients and slot segment,
        then each host's quota drawn without replacement from its own range."""
        ranges = self._host_populations()
        pops = [max(0, stop - start) for start, stop in ranges]
        total = sum(pops)
        exact = [self.cohort_size * p / total for p in pops]
        quotas = [int(q) for q in exact]
        caps = [min(p, self._slots_per_host) for p in pops]
        quotas = [min(q, c) for q, c in zip(quotas, caps)]
        short = self.cohort_size - sum(quotas)
        while short > 0:
            open_hosts = [h for h in range(self._n_hosts) if quotas[h] < caps[h]]
            if not open_hosts:
                raise NanoFedError(
                    f"cohort_size {self.cohort_size} exceeds the hosts-axis "
                    f"capacity (per-host caps {caps} = min(resident clients, "
                    f"slot segment {self._slots_per_host})) — shrink the "
                    "cohort or raise participation"
                )
            w = np.array([max(exact[h] - quotas[h], 0.0) for h in open_hosts])
            if w.sum() <= 0:
                w = np.ones(len(open_hosts))
            pick = open_hosts[int(host_rng.choice(len(open_hosts), p=w / w.sum()))]
            quotas[pick] += 1
            short -= 1
        parts = []
        for (start, _), pop, quota in zip(ranges, pops, quotas):
            if quota > 0:
                parts.append(start + host_rng.choice(pop, size=quota, replace=False))
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)

    def _place_cohort(self, survived: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Lay the survivors into the step's slots.  One host: front-packed, padding
        slots alias row 0 with weight 0.  A hosts axis: each host's survivors fill its
        slot segment, whose padding slots alias the host's first row (never another
        host's)."""
        idx = np.zeros(self._step_clients, dtype=np.int64)
        mask = np.zeros(self._step_clients, dtype=np.float32)
        if self._n_hosts <= 1:
            idx[: len(survived)] = survived
            mask[: len(survived)] = 1.0
            return idx, mask
        slots = self._slots_per_host
        for h, (start, stop) in enumerate(self._host_populations()):
            rows = survived[(survived >= start) & (survived < stop)]
            if len(rows) > slots:
                raise NanoFedError(
                    f"host {h} drew {len(rows)} cohort clients but its slot "
                    f"segment holds {slots} — host-local sampling must cap "
                    "per-host quotas at the segment width"
                )
            base = h * slots
            idx[base: base + slots] = start
            idx[base: base + len(rows)] = rows
            mask[base: base + len(rows)] = 1.0
        return idx, mask

    def _round_seed(self, round_id: int) -> int:
        """Seed of the round's device draws.  Under central DP it is 63 secret bits
        (rank 0's, on every rank of a mesh): noise regenerable from a persisted seed
        could be subtracted from the released aggregate."""
        if self.central_privacy is not None:
            return broadcast_object(int(self._secret_sampling_rng.integers(0, 1 << 63)))
        return self.config.seed * 100_003 + round_id

    def _eval_due(self, round_id: int) -> bool:
        every = self.config.eval_every
        return self._evaluator is not None and every > 0 and (round_id + 1) % every == 0

    def _round_agg(self, values: dict[str, float], lr_scale: float) -> dict[str, float]:
        """A round's metrics record: the weighted metrics, the lr scale unless the
        schedule is constant, and the client counts as ints."""
        agg = dict(values)
        if self.config.lr_schedule != "constant":
            agg["lr_scale"] = round(lr_scale, 6)
        for count_key in ("participating_clients", "valid_clients"):
            if count_key in agg:
                agg[count_key] = int(agg[count_key])
        return agg

    def _client_detail_due(self, round_id: int) -> bool:
        every = self.config.client_metrics_every
        return every > 0 and round_id % every == 0

    # ------------------------------------------------------------------
    # Fused multi-round blocks
    # ------------------------------------------------------------------

    def _block_len(self) -> int:
        """Rounds to run next as one fused block; 1 = the single-round path.  Only
        full blocks of ``rounds_per_block`` rounds run fused; ragged tails and the
        rounds leading into an eval boundary run single."""
        rpb = self.config.rounds_per_block
        if self._round_block is None or rpb <= 1:
            return 1
        n = min(rpb, self.config.num_rounds - self.current_round)
        if self.config.eval_every > 0:
            # Blocks END on eval boundaries: the eval is host work.
            n = min(n, self.config.eval_every - (self.current_round % self.config.eval_every))
        return n if n == rpb else 1

    def _train_block(self, n: int) -> list[RoundMetrics]:
        """Run ``n`` rounds as one fused block, in two spans: ``dispatch`` (sample the
        cohorts, move them to the device, enqueue the block; nothing waits on the
        device) and ``host_sync`` (the block's one barrier and the stacked-metrics
        fetch, with the ``[R, K]`` detail only when some round of the block is due).
        Cohorts, round seeds and lr scales are the single-round path's host
        functions of the round index.  Every round is then charged and published,
        with state persisted at the last."""
        cfg = self.config
        first = self.current_round
        rounds = list(range(first, first + n))
        required = completion_required(self.cohort_size, cfg.min_completion_rate)
        t0 = time.perf_counter()

        with self._tracer.span("dispatch", round=first, rounds=n):
            with self._tracer.span("cohort-sample", round=first, rounds=n):
                idx_rows = np.zeros((n, self._step_clients), dtype=np.int64)
                mask_rows = np.zeros((n, self._step_clients), dtype=np.float32)
                survived_counts = []
                for i, r in enumerate(rounds):
                    survived = self._sample_cohort(r)
                    survived_counts.append(len(survived))
                    if self._cohort_mode:
                        idx_rows[i], mask_rows[i] = self._place_cohort(survived)
                    else:
                        mask_rows[i, survived] = 1.0
            lr_scales = lr_schedule_scales(
                cfg.lr_schedule, first, n, cfg.num_rounds, min_factor=cfg.lr_min_factor,
                decay_every=cfg.lr_decay_every, gamma=cfg.lr_decay_gamma,
            )
            # Device-ready inputs BEFORE the guarded dispatch.
            idx_dev = self._to_device(idx_rows) if self._cohort_mode else None
            mask_dev = self._to_device(mask_rows)
            with self._dispatch_guard():
                result = self._round_block(
                    self.params, self.server_state, self._data, self._num_samples,
                    round_seeds(cfg.seed, rounds), lr_scales, idx_dev, mask_dev,
                    **({} if self.adapter is None else {"base_params": self.base_params}),
                )
            self.params = result.params
            self.server_state = result.server_opt_state

        with self._tracer.span("host_sync", round=first, rounds=n):
            if self.device.type == "cuda":
                # fedlint: disable=FED001 (the block's one barrier, after the whole block is enqueued: host_sync's span measures device time)
                torch.cuda.synchronize(self.device)
            names = list(result.metrics)
            values = torch.stack([result.metrics[k].double() for k in names]).tolist()
            stacked = dict(zip(names, values))
            detail = None
            if (result.client_metrics is not None
                    and any(self._client_detail_due(r) for r in rounds)):
                detail = {
                    "weights": result.weights.tolist(),
                    "client_loss": result.client_metrics.loss.tolist(),
                    "client_accuracy": result.client_metrics.accuracy.tolist(),
                    "update_sq_norms": result.update_sq_norms.tolist(),
                }
            del result
        block_duration = time.perf_counter() - t0
        per_round_s = block_duration / n
        # Occupancy on the fused basis: host_sync over dispatch + host_sync + publish.
        occupancy = update_device_occupancy(self._registry)
        self._observe_retune(n, block_duration, occupancy)

        out: list[RoundMetrics] = []
        for i, r in enumerate(rounds):
            if survived_counts[i] < required:
                _log.warning(
                    "round %d FAILED: %d/%d clients completed (< %d required)",
                    r, survived_counts[i], self.cohort_size, required,
                )
                metrics = RoundMetrics(
                    round_id=r, status=RoundStatus.FAILED, num_clients=survived_counts[i],
                    duration_s=per_round_s, timestamp=_now_iso(),
                )
            else:
                agg = self._round_agg({k: v[i] for k, v in stacked.items()}, lr_scales[i])
                # Due only at a block's last round (_block_len), so self.params is
                # this round's model.
                eval_metrics = self.evaluate() if self._eval_due(r) else {}
                _log.info(
                    "round %d: loss=%.4f acc=%.4f clients=%d (fused %d-round block, "
                    "%.2fs/round)", r, agg["loss"], agg["accuracy"], survived_counts[i],
                    n, per_round_s,
                )
                metrics = RoundMetrics(
                    round_id=r, status=RoundStatus.COMPLETED, num_clients=survived_counts[i],
                    agg_metrics=agg, eval_metrics=eval_metrics, duration_s=per_round_s,
                    timestamp=_now_iso(),
                )
            self._ledger.charge(
                status=metrics.status.name, num_clients=metrics.num_clients,
                duration_s=per_round_s, expected=self.cohort_size,
                telemetry_fields=dict(
                    round=r, status=metrics.status.name, num_clients=metrics.num_clients,
                    duration_s=round(per_round_s, 6), fused=True, rounds_per_block=n,
                ),
            )
            self._last_client_detail = None
            if (
                detail is not None
                and metrics.status == RoundStatus.COMPLETED
                and self._client_detail_due(r)
            ):
                self._last_client_detail = {k: v[i] for k, v in detail.items()}
                if self._cohort_mode:
                    self._last_client_detail["client_ids"] = idx_rows[i].tolist()
            self.history.append(metrics)
            with self._tracer.span("publish", round=r):
                # Checkpoint and versioned model only at the block's edge: a mid-block
                # checkpoint would pair round r's id with the block's END params.
                self._publish_round(metrics, persist_state=(i == n - 1))
            if self.on_round_end is not None:
                self.on_round_end(metrics)
            self.current_round += 1
            out.append(metrics)
        return out

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        """A host array on the device without a barrier: on the card a copy from
        pinned memory, enqueued on the stream, so a block's dispatch waits on nothing."""
        host = torch.as_tensor(rows)
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _train_round(self, round_id: int) -> RoundMetrics:
        """One round, instrumented: the round and its phases land as spans, the
        outcome on the ledger (and as a ``round`` telemetry record), and the
        occupancy on the single-round basis goes to the retuner."""
        t0 = time.perf_counter()
        with self._tracer.span("round", round=round_id):
            metrics = self._train_round_impl(round_id)
        duration = time.perf_counter() - t0
        self._ledger.charge(
            status=metrics.status.name, num_clients=metrics.num_clients,
            duration_s=duration, expected=self.cohort_size,
            telemetry_fields=dict(
                round=round_id, status=metrics.status.name,
                num_clients=metrics.num_clients, duration_s=round(duration, 6),
            ),
        )
        # The local-train span ends at the round's one barrier, so its share of the
        # round span is device time.
        occupancy = update_device_occupancy(self._registry)
        self._observe_retune(1, duration, occupancy)
        return metrics

    def _train_round_impl(self, round_id: int) -> RoundMetrics:
        t0 = time.perf_counter()
        cohort = self.cohort_size
        with self._tracer.span("cohort-sample", round=round_id):
            survived = self._sample_cohort(round_id)
        required = completion_required(cohort, self.config.min_completion_rate)
        if len(survived) < required:
            _log.warning(
                "round %d FAILED: %d/%d clients completed (< %d required)",
                round_id, len(survived), cohort, required,
            )
            return RoundMetrics(
                round_id=round_id, status=RoundStatus.FAILED, num_clients=len(survived),
                duration_s=time.perf_counter() - t0, timestamp=_now_iso(),
            )

        seed = self._round_seed(round_id)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        perms = draw_permutations(
            gen, self.num_clients, self.training.local_epochs, self._data.y.shape[1]
        )
        keys = client_keys(seed, self._padded_clients, self.device)
        noise = None
        if self.central_privacy is not None:
            # The whole model's draw: the same on every rank of a mesh.
            noise = get_noise_generator(self.central_privacy.privacy.noise_type).standard(
                gen, (tree_size(self._params_like or self.params),)
            )
        perms = pad_permutations(perms, self._padded_clients)
        idx_dev = None
        sl = self._slots
        with self._tracer.span("cohort-gather", round=round_id, cohort=len(survived)):
            # The whole step's weights on every rank; this rank trains its slots.
            if self._cohort_mode:
                idx, mask = self._place_cohort(survived)
                idx_dev = torch.as_tensor(idx, device=self.device)
                ids = idx_dev[sl]
                data = self._data.select(ids - self._row0)
                weights = compute_weights(
                    self._num_samples[idx_dev], torch.as_tensor(mask, device=self.device)
                )
            else:
                ids = sl
                data = self._data.select(slice(sl.start - self._row0, sl.stop - self._row0))
                mask = np.zeros(self._padded_clients, dtype=np.float32)
                mask[survived] = 1.0
                weights = compute_weights(
                    self._num_samples, torch.as_tensor(mask, device=self.device))
            perms, keys = perms[ids], keys[ids]

        cfg = self.config
        lr_scale = lr_schedule_scale(
            cfg.lr_schedule, round_id, cfg.num_rounds, min_factor=cfg.lr_min_factor,
            decay_every=cfg.lr_decay_every, gamma=cfg.lr_decay_gamma,
        )
        # The round step runs local training and the reduce as one program, so
        # local-train covers both (its attribute says so).  The round's one barrier
        # ends the span, so its duration is device time, not the enqueue.
        with self._tracer.span("local-train", round=round_id, fused="train+aggregate"):
            step_weights = weights[sl]
            if self.scaffold:
                cohort_idx = idx if self._cohort_mode else None
                # Host work (the exchange plan) before the guarded dispatch.
                c_rows = self._control_rows(cohort_idx, idx_dev)
                with self._dispatch_guard():
                    result = self._round_step(
                        self.params, self.server_state, self.c_global, c_rows, data,
                        step_weights, perms, keys, lr_scale,
                    )
                self.c_global = result.c_global
                self._add_control_deltas(cohort_idx, idx_dev, result.delta_c)
            else:
                base = () if self.adapter is None else (self.base_params,)
                with self._dispatch_guard():
                    result = self._round_step(
                        self.params, self.server_state, *base, data, step_weights, perms,
                        keys, noise, lr_scale,
                    )
            self.params = result.params
            self.server_state = result.server_opt_state
            if self.device.type == "cuda":
                # fedlint: disable=FED001 (the round's one barrier, inside the local-train span so its duration is device time, not the enqueue)
                torch.cuda.synchronize(self.device)

        with self._tracer.span("aggregate", round=round_id):
            agg = self._round_agg({k: float(v) for k, v in result.metrics.items()},
                                  lr_scale)
            if self.privacy_accountant is not None:
                record_central_privacy(
                    self.privacy_accountant, self.central_privacy,
                    sampling_rate=self.cohort_size / self.num_clients,
                )
                spent = self.privacy_accountant.get_privacy_spent(
                    self.central_privacy.privacy.delta
                )
                agg["privacy_epsilon"] = spent.epsilon_spent
                agg["privacy_delta"] = spent.delta_spent
            eval_metrics = self.evaluate() if self._eval_due(round_id) else {}

        # Under central DP no per-client detail is written: the weights reveal who
        # took part, and per-client losses and norms describe the un-noised deltas.
        self._last_client_detail = None
        if (
            self.config.save_metrics
            and self.central_privacy is None
            and self._client_detail_due(round_id)
        ):
            self._last_client_detail = {
                "weights": weights.tolist(),
                "client_loss": result.client_metrics.loss.tolist(),
                "client_accuracy": result.client_metrics.accuracy.tolist(),
                "update_sq_norms": result.update_sq_norms.tolist(),
            }
            if self._cohort_mode:
                # Cohort-slot order: which client each slot hosted.
                self._last_client_detail["client_ids"] = idx.tolist()

        duration = time.perf_counter() - t0
        _log.info(
            "round %d: loss=%.4f acc=%.4f clients=%d (%.2fs)",
            round_id, agg["loss"], agg["accuracy"], len(survived), duration,
        )
        return RoundMetrics(
            round_id=round_id, status=RoundStatus.COMPLETED, num_clients=len(survived),
            agg_metrics=agg, eval_metrics=eval_metrics, duration_s=duration,
            timestamp=_now_iso(),
        )

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    @property
    def training_progress(self) -> TrainingProgress:
        """Rounds run, completed and failed so far (``history``), and the mean loss
        and accuracy of the completed rounds."""
        completed = [m for m in self.history if m.status == RoundStatus.COMPLETED]
        failed = [m for m in self.history if m.status == RoundStatus.FAILED]
        global_metrics: dict[str, float] = {}
        for key in ("loss", "accuracy"):
            vals = [m.agg_metrics[key] for m in completed if key in m.agg_metrics]
            if vals:
                global_metrics[key] = float(np.mean(vals))
        return TrainingProgress(
            current_round=self.current_round,
            total_rounds=self.config.num_rounds,
            completed_rounds=len(completed),
            failed_rounds=len(failed),
            global_metrics=global_metrics,
        )

    @property
    def _slots(self) -> slice:
        """This rank's slots of the step (all of them on one device)."""
        if self.mesh is None:
            return slice(0, self._step_clients)
        return slice(*client_slice(self._step_clients, self.mesh))

    @property
    def cohort_size(self) -> int:
        return cohort_size(self.num_clients, self.config.participation_rate)

    @property
    def privacy_spent(self):
        """Cumulative central-DP spend (``PrivacySpent``), or None without central DP."""
        if self.privacy_accountant is None:
            return None
        return self.privacy_accountant.get_privacy_spent(self.central_privacy.privacy.delta)

    def full_params(self) -> Params:
        """The full federated params: ``params`` itself on one device, gathered from
        the model shards on a mesh (a collective: every rank calls it)."""
        return self.params if self._layout is None else self._layout.gather_full(self.params)

    def full_server_state(self) -> Any:
        """The server state over the full params (gathered on a mesh, as
        :meth:`full_params`)."""
        if self._layout is None or not self._layout.model_sharded:
            return self.server_state
        return {k: ravel(self._layout.gather_full(unravel(v, self.params)))
                if _is_vector(v) else v for k, v in self.server_state.items()}

    def full_c_global(self) -> torch.Tensor:
        """SCAFFOLD's server control ``[P]``, whole (gathered from the model shards on
        a mesh with a model axis: every rank calls it)."""
        if self._layout is None or not self._layout.model_sharded:
            return self.c_global
        return ravel(self._layout.gather_full(unravel(self.c_global, self.params)))

    def full_controls(self) -> tuple[torch.Tensor, torch.Tensor]:
        """SCAFFOLD's server control ``[P]`` and the population's control stack
        ``[N, P]``, whole: the coordinator's own on one device, gathered on a mesh (a
        collective: every rank calls it)."""
        if self._layout is None:
            return self.c_global, self.c_stack
        stack = self._layout.client_all_gather(self.c_stack)
        return self.full_c_global(), stack[: self.num_clients]

    def _own_control_rows(self, nested: Any, full: Params) -> torch.Tensor:
        """This rank's rows of a checkpoint's ``[N, P]`` control stack (padding rows
        zero), read on the host and moved to the device."""
        host_like = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in full.items()}
        stack = from_checkpoint_stack(nested, host_like, self.num_clients)
        lo, hi = client_slice(self._padded_clients, self.mesh)
        rows = torch.zeros((hi - lo, stack.shape[1]))
        real = max(0, min(hi, self.num_clients) - lo)
        rows[:real] = stack[lo: lo + real]
        return rows.to(self.device)

    def _control_plan(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
        """How the host's slot segment's control rows spread over its clients line:
        each segment slot's client id, the line coordinate of the rank holding that
        row, and the most rows any rank of the line holds (the exchange's pack)."""
        mesh = self.mesh
        seg = self._slots_per_host
        h, c = mesh.coords[HOST_AXIS], mesh.coords[CLIENT_AXIS]
        ids = idx[h * seg: (h + 1) * seg]
        per = self._padded_clients // client_shard_count(mesh)
        owner = ids // per - h * mesh.dims[1]
        counts = np.bincount(owner, minlength=mesh.dims[1])
        return ids, owner, int(counts.max())

    def _control_rows(self, idx: np.ndarray | None, idx_dev: torch.Tensor | None
                      ) -> torch.Tensor:
        """The control rows of this rank's slots.  One device: gathered by client id.
        A mesh without cohorts: the rank's own rows are its slots.  A mesh with
        cohorts: every rank of the host's clients line packs the rows it holds for
        the host's segment, and one all-gather over the line brings each rank its
        slots' rows."""
        if self.mesh is None:
            return self.c_stack if idx_dev is None else self.c_stack[idx_dev]
        if idx is None:
            return self.c_stack
        ids, owner, most = self._control_plan(idx)
        lo = client_slice(self._padded_clients, self.mesh)[0]
        c = self.mesh.coords[CLIENT_AXIS]
        mine = np.flatnonzero(owner == c)
        pack = torch.zeros((most, self.c_stack.shape[1]), device=self.device)
        pack[: len(mine)] = self.c_stack[torch.as_tensor(ids[mine] - lo, device=self.device)]
        gathered = self._layout.host_local_all_gather(pack)
        self.control_exchange_bytes = gathered.numel() * gathered.element_size()
        # Slot q of the segment is row (owner, rank of q among the owner's slots).
        slot_rank = np.zeros(len(ids), dtype=np.int64)
        for o in np.unique(owner):
            where = np.flatnonzero(owner == o)
            slot_rank[where] = np.arange(len(where))
        per_rank = len(ids) // self.mesh.dims[1]
        mine_slots = slice(c * per_rank, (c + 1) * per_rank)
        rows = owner[mine_slots] * most + slot_rank[mine_slots]
        return gathered[torch.as_tensor(rows, device=self.device)]

    def _add_control_deltas(self, idx: np.ndarray | None, idx_dev: torch.Tensor | None,
                            delta_c: torch.Tensor) -> None:
        """Scatter-add the step's ``delta_c`` rows into the stack: participants' rows
        move by their delta, padding and dropped slots add exact zeros (collision-safe
        though they alias a host's first row).  On a mesh with cohorts the host's
        clients line all-gathers its slots' deltas and each rank adds the rows it
        holds."""
        if idx is None:
            self.c_stack += delta_c
            return
        if self.mesh is None:
            self.c_stack.index_add_(0, idx_dev, delta_c)
            return
        ids, owner, _ = self._control_plan(idx)
        gathered = self._layout.host_local_all_gather(delta_c)
        self.control_exchange_bytes += gathered.numel() * gathered.element_size()
        mine = np.flatnonzero(owner == self.mesh.coords[CLIENT_AXIS])
        lo = client_slice(self._padded_clients, self.mesh)[0]
        self.c_stack.index_add_(0, torch.as_tensor(ids[mine] - lo, device=self.device),
                                gathered[torch.as_tensor(mine, device=self.device)])

    def merged_params(self) -> Params:
        """The model the outside world consumes: the full ``params``, or in adapter
        mode the base with the adapters merged in (``adapters.merge_adapters``).
        Each merge is counted: it is the one full-model-sized computation adapter
        federation pays outside the rounds.  On a mesh it gathers (every rank calls
        it)."""
        if self.adapter is None:
            return self.full_params()
        self._merge_count += 1
        base = (self.base_params if self._base_layout is None
                else self._base_layout.gather_full(self.base_params))
        with torch.no_grad():
            return merge_adapters(base, self.full_params(), self.adapter)

    def evaluate(self) -> dict[str, float]:
        """The eval set's loss and accuracy under :meth:`merged_params`."""
        if self._evaluator is None:
            raise NanoFedError("no eval_data was provided to the Coordinator")
        return {k: float(v)
                for k, v in self._evaluator(self.merged_params(), self._eval_data).items()}

    def _save_round_metrics(self, metrics: RoundMetrics) -> None:
        payload: dict[str, Any] = metrics.to_dict()
        if metrics.status == RoundStatus.COMPLETED and self._last_client_detail is not None:
            payload["clients"] = self._last_client_detail
        path = self.base_dir / "metrics" / f"metrics_round_{metrics.round_id}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2))
        tmp.replace(path)


def _is_vector(v: torch.Tensor) -> bool:
    """A params-shaped server-state vector (not a 0-d counter)."""
    return v.ndim > 0


def _lockstep(step: Any) -> None:
    """Check that every rank of the world is about to take the same ``step``; raises
    on every rank, naming the ranks' steps, when they differ (one all-gather, bounded
    by the process group's timeout)."""
    if not dist.is_initialized():
        return
    steps = all_gather_object(step)
    if any(s != steps[0] for s in steps):
        raise NanoFedError(f"the ranks are out of step: {dict(enumerate(steps))}")


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()
