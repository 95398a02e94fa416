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

The JAX coordinator's ``adapter=``, ``chaos=``, ``mesh=``, ``mesh_shape=`` and
``strict=`` come with later slices: a value other than the JAX default raises
``NotImplementedError`` naming the ROADMAP item (:data:`LATER_SLICE_KEYWORDS`).
"""

from __future__ import annotations

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
from nanofed_tpu_torch.parallel.multi_round import build_round_block, round_seeds
from nanofed_tpu_torch.parallel.round_step import build_round_step, init_server_state
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

#: The JAX coordinator's keywords that later slices bring: name -> (the JAX default,
#: which is accepted, and the ROADMAP queue A item that lands it).
LATER_SLICE_KEYWORDS: dict[str, tuple[Any, str]] = {
    "adapter": (None, "item 16 (transformer, adapters and fleet)"),
    "chaos": (None, "item 17 (multi-host federation and faults)"),
    "mesh": (None, "item 9b (several GPUs)"),
    "mesh_shape": (None, "item 9b (several GPUs)"),
    "strict": (False, "item 21 (analysis)"),
}


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
    """Drives simulated federated training on one device."""

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
        single-valued ``tuning_space``)."""
        if "client_chunk" in kwargs:
            raise NanoFedError(
                "from_autotune owns client_chunk — the tuner picks it; pin an axis "
                "with a single-valued tuning_space instead"
            )
        if kwargs.get("scaffold"):
            raise NanoFedError(
                "from_autotune does not cover the SCAFFOLD round program (the "
                "autotuner never sweeps it); build Coordinator(scaffold=True) by hand"
            )
        training = training or TrainingConfig()
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
            device=kwargs.get("device"),
        )
        winner = result.winner
        coord = cls(
            model, train_data,
            dataclasses.replace(config, rounds_per_block=winner.rounds_per_block),
            training=dataclasses.replace(training, batch_size=winner.batch_size),
            client_chunk=winner.client_chunk,
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
        **later_slice: Any,
    ) -> None:
        for name, value in later_slice.items():
            if name not in LATER_SLICE_KEYWORDS:
                raise TypeError(
                    f"Coordinator.__init__() got an unexpected keyword argument {name!r}"
                )
            default, item = LATER_SLICE_KEYWORDS[name]
            if value != default:
                raise NotImplementedError(
                    f"{name}=: not supported by this slice of nanofed_tpu_torch; it comes "
                    f"with ROADMAP queue A {item} (run nanofed_tpu for it)"
                )
        self.device = resolve_device(device)
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
        self._data = train_data.to(self.device)
        self._num_samples = self._data.mask.sum(1)
        init_gen = torch.Generator().manual_seed(config.seed)
        self.params: Params = {
            name: p.to(self.device) for name, p in model.init(init_gen).items()
        }
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
            if client_chunk < self.cohort_size and self.cohort_size % client_chunk != 0:
                self._cohort_mode = False
        self._step_clients = self.cohort_size if self._cohort_mode else self.num_clients
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
            self.c_global = zero_controls(self.params)
            self.c_stack = stack_zero_controls(self.params, self.num_clients)
        # Everything a retune swap needs to rebuild the round step with another
        # client_chunk (see _rebuild_round_programs).
        self._client_chunk = client_chunk
        self._builder_ctx: dict[str, Any] = dict(
            central_privacy=central_privacy, validation=validation, robust=robust,
            grad_fn=grad_fn, local_fit=local_fit,
        )
        if scaffold:
            self._round_step = build_scaffold_round_step(
                model, self.training, self.num_clients, strategy=self.strategy,
                grad_fn=grad_fn, client_chunk=client_chunk, device=self.device,
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
        if config.save_metrics:
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
        self.telemetry = RunTelemetry(tel_dir) if tel_dir is not None else None
        if self.telemetry is not None:
            # One process on one device: the JAX record's single-host geometry.
            self.telemetry.record(
                "topology", process_count=1, hosts=1, mesh_shape=[1], devices=1,
                num_clients=self.num_clients,
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
        if self.scaffold:
            if not has_controls:
                raise NanoFedError(
                    "scaffold=True but the checkpoint carries no control "
                    "state — it was written by a non-SCAFFOLD run; resuming "
                    "would silently zero every client's correction"
                )
            self.c_global = ravel(from_checkpoint_params(
                server_state["scaffold_c_global"], self.params))
            self.c_stack = from_checkpoint_stack(
                server_state["scaffold_c_stack"], self.params, self.num_clients)
            server_state = server_state["opt"]
        self.params = from_checkpoint_params(restored.params, self.params)
        self.server_state = from_numpy_server_state(server_state, self.strategy, self.params)
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
        under ``"scaffold_round_step"``, with the controls among its arguments, as
        the JAX package names it) and, when the coordinator fuses, its block under
        ``"round_block"`` (profiled over its R rounds).  The
        argument factories hand the programs CLONES of the params and server state;
        the step gets the data rows of its width, weights one, permutations and
        dropout keys from the config's seed (and a noise draw under central DP), the
        block the population and a full cohort each round, so profiling leaves the
        coordinator's state untouched."""

        def _step_args() -> tuple[tuple, dict]:
            n = self._step_clients
            gen = torch.Generator(device=self.device).manual_seed(self.config.seed)
            args = (
                {name: p.clone() for name, p in self.params.items()},
                {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in self.server_state.items()},
                self._data.select(slice(0, n)),
                torch.ones(n, device=self.device),
                draw_permutations(gen, n, self.training.local_epochs, self._data.y.shape[1]),
                client_keys(self.config.seed, n, self.device),
            )
            if self.central_privacy is not None:
                noise_type = self.central_privacy.privacy.noise_type
                args += (get_noise_generator(noise_type).standard(
                    gen, (tree_size(self.params),)),)
            return args, {}

        attrs = {"step_clients": self._step_clients, "client_chunk": self._client_chunk}
        if self.scaffold:
            def _scaffold_args() -> tuple[tuple, dict]:
                # The SCAFFOLD step takes the controls between the server state and
                # the data: c_global and the step's rows of the control stack.
                (params, state, data, weights, perms, keys), _ = _step_args()
                c_rows = self.c_stack[: self._step_clients].clone()
                return (params, state, self.c_global.clone(), c_rows, data, weights,
                        perms, keys), {}

            self.program_catalog.register(
                "scaffold_round_step", self._round_step, args_factory=_scaffold_args,
                attrs=attrs,
            )
            return
        self.program_catalog.register(
            "round_step", self._round_step, args_factory=_step_args, attrs=attrs,
        )
        if self._round_block is None:
            return
        rpb = self.config.rounds_per_block

        def _block_args() -> tuple[tuple, dict]:
            # Every slot a distinct client with weight: the profiled block runs the
            # rounds a full cohort runs.
            n = self._step_clients
            idx = (torch.arange(n, device=self.device).expand(rpb, n).contiguous()
                   if self._cohort_mode else None)
            args = (
                {name: p.clone() for name, p in self.params.items()},
                {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in self.server_state.items()},
                self._data, self._num_samples,
                round_seeds(self.config.seed, range(rpb)), [1.0] * rpb,
                idx, torch.ones((rpb, n), device=self.device),
            )
            return args, {}

        self.program_catalog.register(
            "round_block", self._round_block, args_factory=_block_args, rounds=rpb,
            attrs={**attrs, "rounds_per_block": rpb},
        )

    def profile_programs(self, force: bool = False) -> list[ProgramCostReport]:
        """Profile every catalogued program (``observability.profiling``: a first
        call, a counting call and timed calls of the round step on clones of the
        state), publish the ``nanofed_program_*`` gauges, and return the reports.
        Reports are cached — a second call is free unless ``force``."""
        reports: list[ProgramCostReport] = []
        for name in self.program_catalog.names():
            cached = self.program_catalog.report(name) is not None and not force
            with self._tracer.span("program-profile", program=name):
                report = self.program_catalog.profile(name, force=force)
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
        decision = self.retuner.propose(self._retune_candidate)
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
            num_clients=self.num_clients, step_clients=self._step_clients,
            cohort_size=self.cohort_size, dropout_rate=cfg.dropout_rate,
            min_completion_rate=cfg.min_completion_rate,
            grad_fn=ctx["grad_fn"], local_fit=ctx["local_fit"],
            validation=ctx["validation"], client_chunk=client_chunk,
            collect_client_detail=cfg.save_metrics and cfg.client_metrics_every > 0,
            # Explicit, never derived: the block lays out the mask as _train_block
            # builds it (full-N when the chunk does not divide the cohort).
            cohort_mode=self._cohort_mode, device=self.device,
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
            self.program_catalog.remove("round_block")  # no dead program stays profiled
        self._register_programs()

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
            if self.retuner is not None and done:
                # The next run's cache hit starts from these measurements.
                written = self.retuner.write_back()
                if self.telemetry is not None:
                    self.telemetry.record(
                        "retune_summary", **self.retuner.summary(),
                        **({"cache_entry": str(written)} if written is not None else {}),
                    )
            if self.telemetry is not None and done:
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
            ckpt_metrics = metrics.to_dict()
            if self.privacy_accountant is not None:
                ckpt_metrics["privacy_accountant"] = self.privacy_accountant.state_dict()
            server_state: Any = to_numpy_server_state(self.server_state, self.params)
            if self.scaffold:
                # The controls are round state: resuming without them would restart
                # every client's correction from zero.
                server_state = {
                    "opt": server_state,
                    "scaffold_c_global": to_numpy_params(unravel(self.c_global, self.params)),
                    "scaffold_c_stack": to_numpy_params(
                        unravel_stacked(self.c_stack, self.params)),
                }
            self.state_store.checkpoint(
                round_number=metrics.round_id,
                params=to_numpy_params(self.params),
                server_state=server_state,
                metrics=ckpt_metrics,
                status="COMPLETED" if metrics.status == RoundStatus.COMPLETED else "FAILED",
            )
        if self.config.save_metrics:
            self._save_round_metrics(metrics)
        if (
            self.model_manager is not None
            and persist_state
            and metrics.status == RoundStatus.COMPLETED
        ):
            self.model_manager.save_model(
                self.params,
                metadata={"round": metrics.round_id, "metrics": metrics.agg_metrics},
            )

    def _sample_cohort(self, round_id: int) -> np.ndarray:
        """This round's surviving cohort: the JAX package's numpy draws exactly.  Under
        central DP the amplified ε the accountant credits holds only if the sampling
        is secret, so DP cohorts come from OS entropy."""
        if self.central_privacy is not None:
            host_rng = self._secret_sampling_rng
        else:
            host_rng = np.random.default_rng(self.config.seed * 100_003 + round_id)
        sampled = host_rng.choice(self.num_clients, size=self.cohort_size, replace=False)
        if self.config.dropout_rate > 0:
            keep = host_rng.random(len(sampled)) >= self.config.dropout_rate
            sampled = sampled[keep]
        return sampled

    def _place_cohort(self, survived: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Front-pack the survivors into the step's slots; padding slots alias row 0
        with weight 0."""
        idx = np.zeros(self._step_clients, dtype=np.int64)
        mask = np.zeros(self._step_clients, dtype=np.float32)
        idx[: len(survived)] = survived
        mask[: len(survived)] = 1.0
        return idx, mask

    def _round_seed(self, round_id: int) -> int:
        """Seed of the round's device draws.  Under central DP it is 63 secret bits:
        noise regenerable from a persisted seed could be subtracted from the released
        aggregate."""
        if self.central_privacy is not None:
            return int(self._secret_sampling_rng.integers(0, 1 << 63))
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
            idx_dev = self._to_device(idx_rows) if self._cohort_mode else None
            mask_dev = self._to_device(mask_rows)
            result = self._round_block(
                self.params, self.server_state, self._data, self._num_samples,
                round_seeds(cfg.seed, rounds), lr_scales, idx_dev, mask_dev,
            )
            self.params = result.params
            self.server_state = result.server_opt_state

        with self._tracer.span("host_sync", round=first, rounds=n):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the block's one barrier
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
        keys = client_keys(seed, self.num_clients, self.device)
        noise = None
        if self.central_privacy is not None:
            noise = get_noise_generator(self.central_privacy.privacy.noise_type).standard(
                gen, (tree_size(self.params),)
            )
        idx_dev = None
        with self._tracer.span("cohort-gather", round=round_id, cohort=len(survived)):
            if self._cohort_mode:
                idx, mask = self._place_cohort(survived)
                idx_dev = torch.as_tensor(idx, device=self.device)
                data = self._data.select(idx_dev)
                perms = perms[idx_dev]
                keys = keys[idx_dev]
                weights = compute_weights(
                    self._num_samples[idx_dev], torch.as_tensor(mask, device=self.device)
                )
            else:
                data = self._data
                mask = np.zeros(self.num_clients, dtype=np.float32)
                mask[survived] = 1.0
                weights = compute_weights(
                    self._num_samples, torch.as_tensor(mask, device=self.device))

        cfg = self.config
        lr_scale = lr_schedule_scale(
            cfg.lr_schedule, round_id, cfg.num_rounds, min_factor=cfg.lr_min_factor,
            decay_every=cfg.lr_decay_every, gamma=cfg.lr_decay_gamma,
        )
        # The round step runs local training and the reduce as one program, so
        # local-train covers both (its attribute says so).  The round's one barrier
        # ends the span, so its duration is device time, not the enqueue.
        with self._tracer.span("local-train", round=round_id, fused="train+aggregate"):
            if self.scaffold:
                c_rows = self.c_stack if idx_dev is None else self.c_stack[idx_dev]
                result = self._round_step(
                    self.params, self.server_state, self.c_global, c_rows, data, weights,
                    perms, keys, lr_scale,
                )
                self.c_global = result.c_global
                if idx_dev is None:
                    self.c_stack += result.delta_c
                else:
                    # Participants' rows move by their delta; padding and dropped slots
                    # add exact zeros (collision-safe though they alias row 0).
                    self.c_stack.index_add_(0, idx_dev, result.delta_c)
            else:
                result = self._round_step(
                    self.params, self.server_state, data, weights, perms, keys, noise,
                    lr_scale,
                )
            self.params = result.params
            self.server_state = result.server_opt_state
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the round's one barrier

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
    def cohort_size(self) -> int:
        return cohort_size(self.num_clients, self.config.participation_rate)

    @property
    def privacy_spent(self):
        """Cumulative central-DP spend (``PrivacySpent``), or None without central DP."""
        if self.privacy_accountant is None:
            return None
        return self.privacy_accountant.get_privacy_spent(self.central_privacy.privacy.delta)

    def evaluate(self) -> dict[str, float]:
        if self._evaluator is None:
            raise NanoFedError("no eval_data was provided to the Coordinator")
        return {k: float(v) for k, v in self._evaluator(self.params, self._eval_data).items()}

    def _save_round_metrics(self, metrics: RoundMetrics) -> None:
        payload: dict[str, Any] = metrics.to_dict()
        if metrics.status == RoundStatus.COMPLETED and self._last_client_detail is not None:
            payload["clients"] = self._last_client_detail
        path = self.base_dir / "metrics" / f"metrics_round_{metrics.round_id}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2))
        tmp.replace(path)


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()
