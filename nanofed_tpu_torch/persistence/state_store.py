"""Round-state checkpointing and fault tolerance (counterpart of
``nanofed_tpu/persistence/state_store.py``).

A ``Coordinator`` or ``NetworkCoordinator`` given a ``state_store`` checkpoints every
round and resumes from the latest COMPLETED checkpoint on construction;
``run_fault_tolerant`` retries a whole training run through recoverable failures,
each retry re-entering at the checkpointed round.

State layout per checkpoint (the JAX package's, so either package resumes from the
other's)::

    base_dir/checkpoints/round_<N>/
      metadata.json   round number, status, timestamp, metrics (written last, durably)
      state.pkl       {params, server_state}: the JAX package's nested numpy trees, the
                      server state as optax records (``persistence.serialization``)

The store holds what it is given; the coordinators convert their flat params and
``[P]`` server state at this boundary (``utils.trees``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, NamedTuple

from nanofed_tpu_torch.core.exceptions import CheckpointError, NanoFedError
from nanofed_tpu_torch.persistence.serialization import (
    load_state_pickle,
    save_state_pickle,
    write_text_durable,
)
from nanofed_tpu_torch.utils.dates import get_current_time
from nanofed_tpu_torch.utils.logger import Logger

COMPLETED = "COMPLETED"
FAILED = "FAILED"


@dataclass(frozen=True)
class CheckpointMetadata:
    """A checkpoint's ``metadata.json``: round, status, time and the round's metrics."""

    round_number: int
    status: str = COMPLETED
    timestamp: str = ""
    metrics: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "round_number": self.round_number,
            "status": self.status,
            "timestamp": self.timestamp,
            "metrics": self.metrics,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CheckpointMetadata":
        return cls(
            round_number=int(d["round_number"]),
            status=str(d.get("status", COMPLETED)),
            timestamp=str(d.get("timestamp", "")),
            metrics=dict(d.get("metrics", {})),
        )


class RestoredState(NamedTuple):
    """What ``restore``/``restore_latest`` hand back to the coordinator."""

    round_number: int
    params: Any
    server_state: Any
    metadata: CheckpointMetadata


class FileStateStore:
    """Checkpoint round state to disk; restore the latest COMPLETED round."""

    def __init__(self, base_dir: str | Path, keep_last: int | None = None) -> None:
        self.base_dir = Path(base_dir) / "checkpoints"
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    def _round_dir(self, round_number: int) -> Path:
        return self.base_dir / f"round_{round_number}"

    def checkpoint(
        self,
        round_number: int,
        params: Any,
        server_state: Any = None,
        metrics: dict[str, Any] | None = None,
        status: str = COMPLETED,
    ) -> CheckpointMetadata:
        """Persist one round's state; ``metadata.json`` is published last."""
        d = self._round_dir(round_number)
        d.mkdir(parents=True, exist_ok=True)
        save_state_pickle(d / "state.pkl", {"params": params, "server_state": server_state})
        meta = CheckpointMetadata(
            round_number=round_number,
            status=status,
            timestamp=get_current_time().isoformat(),
            metrics=metrics or {},
        )
        # metadata.json written last: its presence marks the checkpoint as
        # complete, published durably (fsynced): a marker must never outlive (or
        # predate) the durability of the state it vouches for.
        write_text_durable(d / "metadata.json", json.dumps(meta.to_dict(), indent=2))
        if self.keep_last is not None:
            self._prune()
        return meta

    def list_checkpoints(self) -> list[CheckpointMetadata]:
        """All intact checkpoints, ascending by round."""
        metas = []
        for d in self.base_dir.glob("round_*"):
            meta_path = d / "metadata.json"
            if not meta_path.exists() or not (d / "state.pkl").exists():
                continue  # torn checkpoint (crash mid-write) — not a recovery point
            try:
                metas.append(CheckpointMetadata.from_dict(json.loads(meta_path.read_text())))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
        metas.sort(key=lambda m: m.round_number)
        return metas

    def restore(self, round_number: int) -> RestoredState:
        d = self._round_dir(round_number)
        meta_path = d / "metadata.json"
        if not meta_path.exists():
            raise CheckpointError(f"no checkpoint for round {round_number} in {self.base_dir}")
        meta = CheckpointMetadata.from_dict(json.loads(meta_path.read_text()))
        state = load_state_pickle(d / "state.pkl")
        return RestoredState(
            round_number=round_number,
            params=state["params"],
            server_state=state["server_state"],
            metadata=meta,
        )

    def restore_latest(self) -> RestoredState | None:
        """Latest COMPLETED checkpoint, or None when starting fresh."""
        completed = [m for m in self.list_checkpoints() if m.status == COMPLETED]
        if not completed:
            return None
        return self.restore(completed[-1].round_number)

    def _prune(self) -> None:
        metas = self.list_checkpoints()
        # The newest COMPLETED checkpoint is the recovery point restore_latest() needs;
        # it must survive pruning even when newer FAILED rounds fill the keep budget.
        completed = [m for m in metas if m.status == COMPLETED]
        protect = {completed[-1].round_number} if completed else set()
        for meta in metas[: max(0, len(metas) - self.keep_last)]:
            if meta.round_number in protect:
                continue
            d = self._round_dir(meta.round_number)
            for f in d.iterdir():
                f.unlink()
            d.rmdir()


# ----------------------------------------------------------------------
# Recovery policy
# ----------------------------------------------------------------------

#: Exception types recovery will retry through; everything else propagates.
RECOVERABLE_EXCEPTIONS: tuple[type[BaseException], ...] = (
    TimeoutError,
    ConnectionError,
    RuntimeError,
)


def is_recoverable(exc: BaseException) -> bool:
    # NanoFedError is not a RuntimeError; config/validation bugs in our own stack are
    # deterministic and must not be retried.
    if isinstance(exc, NanoFedError):
        return False
    return isinstance(exc, RECOVERABLE_EXCEPTIONS)


@dataclass(frozen=True)
class SimpleRecoveryStrategy:
    """Decide whether to retry after a failure."""

    max_retries: int = 3

    def should_recover(self, exc: BaseException, attempt: int) -> bool:
        return attempt < self.max_retries and is_recoverable(exc)


def run_fault_tolerant(
    make_coordinator: Callable[[], Any],
    strategy: SimpleRecoveryStrategy | None = None,
) -> list[Any]:
    """Run a full training loop, rebuilding the coordinator from its state store after
    recoverable failures.

    ``make_coordinator`` must construct a ``Coordinator`` wired to a ``FileStateStore``;
    each retry re-enters at the checkpointed round.  Returns the last attempt's
    round metrics.
    """
    strategy = strategy or SimpleRecoveryStrategy()
    log = Logger()
    attempt = 0
    last_start: int | None = None
    while True:
        coordinator = make_coordinator()
        # A retry that resumes past the previous crash point made progress — reset the
        # failure budget so a long run tolerates max_retries failures per stall, not
        # per lifetime.
        start = int(getattr(coordinator, "current_round", 0))
        if last_start is not None and start > last_start:
            attempt = 0
        last_start = start
        try:
            return coordinator.run()
        except BaseException as exc:  # noqa: BLE001 — policy decides what propagates
            if not strategy.should_recover(exc, attempt):
                raise
            attempt += 1
            log.warning(
                "recoverable failure (%s: %s); restarting from latest checkpoint "
                "(attempt %d/%d)",
                type(exc).__name__, exc, attempt, strategy.max_retries,
            )
