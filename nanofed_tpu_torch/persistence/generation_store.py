"""Coordinated multi-host checkpoints: generations with commit markers (counterpart of
``nanofed_tpu/persistence/generation_store.py``, on the same directory layout, so
either package reads the other's generations).

``FileStateStore`` checkpoints one process's round state, which is enough for a
single controller and wrong for hosts that must agree on which checkpoint every one of
them finished writing: a host that crashes right after publishing its own state has
peers mid-write, and resuming from "my newest file" would mix rounds across hosts.

:class:`GenerationStore`:

* each host writes its block-boundary state under a monotonically increasing
  **generation** (``completed_rounds // block_size``), then its per-host **commit
  marker**: state first, marker second, each written to a temporary name, fsynced and
  renamed (``persistence.serialization``), so a marker proves its state is complete
  and on disk, the rule the state store's ``metadata.json`` follows;
* the marker records the **participant set** (the hosts of the mesh at the time): a
  generation is *complete* only when every host of that set has committed it, and
  recovery resumes from the newest complete generation, never a torn one;
* params are the same on every host, so a restore may read any committed host's
  state file.

At most one block is lost: a failure in round r recovers to generation
``r // block_size`` or the one before it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from nanofed_tpu_torch.core.exceptions import CheckpointError
from nanofed_tpu_torch.persistence.serialization import (
    load_state_pickle,
    save_state_pickle,
    write_text_durable,
)

__all__ = ["GenerationRecord", "GenerationStore"]


class GenerationRecord:
    """What :meth:`GenerationStore.latest_complete` hands back: the generation, its
    round, the hosts that committed it, the state (numpy-leaf trees, as pickled) and
    the marker's extra fields."""

    def __init__(self, generation: int, round_number: int, hosts: tuple[int, ...],
                 params: Any, server_state: Any, meta: dict[str, Any]) -> None:
        self.generation = generation
        self.round_number = round_number
        self.hosts = hosts
        self.params = params
        self.server_state = server_state
        self.meta = meta


class GenerationStore:
    """Per-host, generation-numbered checkpoints with commit-by-all recovery.

    Layout::

        base_dir/generations/gen_<G>/
          host_<H>.state.pkl       {params, server_state}
          host_<H>.commit.json     {host, generation, round, hosts: [...], **meta}

    One instance a host (``host`` is its hosts-axis row); a supervisor or a rejoining
    host reads with ``host=None``."""

    def __init__(self, base_dir: str | Path, host: int | None = None) -> None:
        self.base_dir = Path(base_dir) / "generations"
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.host = host

    def _gen_dir(self, generation: int) -> Path:
        return self.base_dir / f"gen_{generation}"

    def commit(self, generation: int, round_number: int, params: Any, server_state: Any,
               hosts: list[int] | tuple[int, ...], meta: dict[str, Any] | None = None) -> None:
        """Write this host's state for ``generation``, then its commit marker.
        ``params`` and ``server_state`` are numpy or tensor trees (as
        ``save_state_pickle`` takes them); ``hosts`` is the current participant set,
        whose unanimous commit makes the generation a recovery point."""
        if self.host is None:
            raise CheckpointError("a read-only GenerationStore cannot commit")
        if generation < 0:
            raise CheckpointError(f"generation must be >= 0, got {generation}")
        d = self._gen_dir(generation)
        d.mkdir(parents=True, exist_ok=True)
        save_state_pickle(d / f"host_{self.host}.state.pkl",
                          {"params": params, "server_state": server_state})
        marker = {
            "host": self.host,
            "generation": generation,
            "round": int(round_number),
            "hosts": sorted(int(h) for h in hosts),
            **(meta or {}),
        }
        # After the state, and durably: a marker must never outlive (or predate) the
        # durability of the state it vouches for.
        write_text_durable(d / f"host_{self.host}.commit.json", json.dumps(marker, indent=2))

    def _markers(self, generation: int) -> dict[int, dict[str, Any]]:
        out: dict[int, dict[str, Any]] = {}
        for path in self._gen_dir(generation).glob("host_*.commit.json"):
            try:
                marker = json.loads(path.read_text())
                out[int(marker["host"])] = marker
            except (OSError, ValueError, KeyError):
                continue  # a torn marker: that host has not committed
        return out

    def generations(self) -> list[int]:
        """Every generation with at least one commit marker, ascending."""
        gens = []
        for d in self.base_dir.glob("gen_*"):
            try:
                g = int(d.name.split("_", 1)[1])
            except ValueError:
                continue
            if self._markers(g):
                gens.append(g)
        return sorted(gens)

    def is_complete(self, generation: int) -> bool:
        """True when every host of the generation's recorded participant set has
        committed it; markers that disagree on the set (a torn reshape) are not a
        recovery point."""
        markers = self._markers(generation)
        if not markers:
            return False
        participant_sets = {tuple(m.get("hosts", ())) for m in markers.values()}
        if len(participant_sets) != 1:
            return False
        (participants,) = participant_sets
        if not participants:
            return False
        return all(h in markers
                   and (self._gen_dir(generation) / f"host_{h}.state.pkl").exists()
                   for h in participants)

    def latest_complete(self) -> GenerationRecord | None:
        """The newest generation every participant committed, restored (this host's
        own file when it committed one, else the first committed host's); None when
        there is none (start fresh)."""
        for g in reversed(self.generations()):
            if not self.is_complete(g):
                continue
            markers = self._markers(g)
            hosts = tuple(sorted(markers))
            prefer = self.host if self.host is not None and self.host in markers else hosts[0]
            state = load_state_pickle(self._gen_dir(g) / f"host_{prefer}.state.pkl")
            marker = markers[prefer]
            return GenerationRecord(
                generation=g, round_number=int(marker["round"]), hosts=hosts,
                params=state["params"], server_state=state["server_state"],
                meta={k: v for k, v in marker.items()
                      if k not in ("host", "generation", "round", "hosts")},
            )
        return None
