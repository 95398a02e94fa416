#!/usr/bin/env python
"""Record the closed-loop online-retuning evidence of the PyTorch/CUDA port
(counterpart of ``scripts/record_retune_evidence.py``).

The claim under test: the autotuner's ahead-of-time (AOT) ranking can be wrong about
measured walltime, and the online retuner corrects it mid-run.  The reference asserts
that its AOT ranking picks ``client_chunk=1``; the port's ranking is its own (the
profiled programs' roofline bound a round on a card with a peaks row, their counted
bytes a round on the CPU), so here that premise is MEASURED, not assumed:

1. The AOT sweep (``Coordinator.from_autotune``) ranks the space; its winner is the
   incumbent.
2. A probe run measures every other feasible candidate for real: a coordinator pinned
   to it trains ``PROBE_ROUNDS`` rounds, and its per-round walltimes (first block
   dropped: it pays the first call's start-up) seed the retuner's measured table.
3. The closed loop: the coordinator starts on the AOT winner with
   ``retune_every=RETUNE_EVERY``; the retuner re-ranks on measured walltime and any
   swap lands at a block boundary.
4. ``write_back()`` stamps the measured numbers into the cached autotune entry.

The artifact keeps the reference artifact's keys and adds ``device`` (the card's
name and power limit, torch and CUDA versions, the kernels' launches) and
``premise``: the AOT winner, the steady-state measured winner and whether they
differ.  When they agree, no swap is needed and the artifact records whether the
retuner held the incumbent; when they differ, the reference's checks apply (one
applied swap, post-swap steady rounds faster than the incumbent's).  The structural
checks hold always: at most one applied swap, on a block boundary, and a write-back
that leaves a ``measured`` block.

Configurations: ``reference`` (the reference script's: ``digits_mlp``, 32 iid
clients of ``synthetic_classification(1024, 10, (8, 8, 1))``, chunk None or 1,
batch 16) and ``flagship`` (the 1000-client ``mnist_cnn`` flagship at 60 synthetic
MNIST samples a client, bf16, 2 local epochs, chunk None, 125 or 250, batch 64: the
space of ``chip_smoke.py``'s phase (i)).  Both run ``NUM_ROUNDS`` rounds in blocks of
``RPB`` with a decision every ``RETUNE_EVERY`` rounds.

Usage (from the repo root; the card by default, ``--device cpu`` on request):
    python scripts/record_retune_evidence_torch.py [--config flagship] [--device cpu]

Writes ``runs/retune_torch.json`` (``runs/retune_flagship_torch.json`` for the
flagship).  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

NUM_ROUNDS = 16
RPB = 2
# Two blocks before the first decision: the incumbent's first block pays the first
# call's start-up, the second is steady state.
RETUNE_EVERY = 4
PROBE_ROUNDS = 6
FLAGSHIP_CHUNKS = (None, 125, 250)  # chip_smoke.py's TUNED_CHUNKS
FLAGSHIP_BATCHES = (64,)  # chip_smoke.py's TUNED_BATCHES


def read_jsonl(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line]


def telemetry_records(tel_dir: Path) -> list[dict]:
    files = sorted(tel_dir.glob("*.jsonl"))
    assert files, f"no telemetry written under {tel_dir}"
    out: list[dict] = []
    for f in files:
        out.extend(read_jsonl(f))
    return out


def workload(config: str):
    """``(model, data, training, space, note)`` of a named configuration."""
    from nanofed_tpu_torch.data import federate, load_mnist, synthetic_classification
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.tuning import TuningSpace

    if config == "reference":
        train = synthetic_classification(1024, 10, (8, 8, 1), seed=0)
        data = federate(train, num_clients=32, scheme="iid", batch_size=16, seed=0)
        return (get_model("digits_mlp"), data,
                TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.1),
                TuningSpace(client_chunks=(None, 1), rounds_per_blocks=(RPB,),
                            model_shards=(1,), batch_sizes=(16,)),
                "digits_mlp, 32 clients iid, synthetic classification (1024 samples, "
                "8x8x1)")
    if config == "flagship":
        data = federate(load_mnist("train", None, synthetic_size=60_000), num_clients=1000,
                        batch_size=64, seed=0)
        return (get_model("mnist_cnn"), data,
                TrainingConfig(batch_size=64, local_epochs=2, learning_rate=0.1,
                               compute_dtype="bfloat16"),
                TuningSpace(client_chunks=FLAGSHIP_CHUNKS, rounds_per_blocks=(RPB,),
                            model_shards=(1,), batch_sizes=FLAGSHIP_BATCHES),
                "mnist_cnn, 1000 clients of 60 synthetic MNIST samples, bf16, 2 local "
                "epochs (the flagship)")
    raise ValueError(f"unknown configuration {config!r}: 'reference' or 'flagship'")


def steady(round_records: dict, start: int, stop: int) -> float | None:
    """Mean round seconds over rounds ``[start, stop)``, or None when empty."""
    rows = [round_records[i]["duration_s"] for i in range(start, stop) if i in round_records]
    return sum(rows) / len(rows) if rows else None


def record_retune(config: str = "reference", device: str | None = None,
                  work: str | Path | None = None, check_outcome: bool = True) -> dict:
    """The retune lifecycle at ``config`` on ``device``; returns the artifact.

    The structural checks always raise (``AssertionError``).  With ``check_outcome``
    the reference's checks of a disagreement also raise: exactly one applied swap and
    post-swap steady rounds faster than the incumbent's (``chip_smoke.py`` passes
    False: which candidate wins on a given host must not fail it)."""
    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.core.device import device_record, resolve_device
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.tuning import candidate_program_name

    dev = resolve_device(device)
    ops.reset_launch_counts()
    work = Path(work) if work is not None else Path(tempfile.mkdtemp(prefix="retune_"))
    model, data, training, space, note = workload(config)

    # --- 1 + 3. The AOT sweep, then the closed loop on its winner -----------------
    coord = Coordinator.from_autotune(
        model, data,
        CoordinatorConfig(num_rounds=NUM_ROUNDS, seed=0, base_dir=work / "runs",
                          retune_every=RETUNE_EVERY),
        training, tuning_space=space, autotune_cache_dir=work / "cache",
        telemetry_dir=work / "tel", device=dev,
    )
    result = coord.autotune_result
    ranked = sorted((o for o in result.outcomes if o.feasible), key=lambda o: o.score)
    aot_ranking = [{"program": candidate_program_name(o.config), "config": o.config.to_dict(),
                    "aot_score": o.score, "aot_rank": i} for i, o in enumerate(ranked)]
    incumbent = coord._retune_candidate
    inc_name = candidate_program_name(incumbent)
    print(f"AOT ranking: {[(r['program'], r['aot_score']) for r in aot_ranking]}; "
          f"incumbent {inc_name}", flush=True)

    # --- 2. Probe every alternative for real -----------------------------------------
    probes = {}
    for outcome in ranked:
        alt = outcome.config
        if alt == incumbent:
            continue
        name = candidate_program_name(alt)
        probe = Coordinator(
            model, data,
            CoordinatorConfig(num_rounds=PROBE_ROUNDS, seed=0, base_dir=work / f"probe_{name}",
                              rounds_per_block=alt.rounds_per_block),
            training=training, client_chunk=alt.client_chunk,
            telemetry_dir=work / f"probe_tel_{name}", device=dev,
        )
        for _ in probe.start_training():
            pass
        rows = [r for r in telemetry_records(work / f"probe_tel_{name}")
                if r.get("type") == "round"][alt.rounds_per_block:]
        assert len(rows) >= 2, "probe too short to satisfy min_rounds"
        walltime = sum(r["duration_s"] for r in rows)
        probes[name] = {"config": alt, "rounds": len(rows), "walltime_s": walltime}
        coord.retuner.observe(alt, rounds=len(rows), walltime_s=walltime)
        print(f"probe {name}: {len(rows)} rounds, {walltime / len(rows):.6f} s/round",
              flush=True)

    for _ in coord.start_training():
        pass

    # --- Harvest -------------------------------------------------------------------
    records = telemetry_records(work / "tel")
    retunes = [r for r in records if r.get("type") == "retune"]
    summaries = [r for r in records if r.get("type") == "retune_summary"]
    assert summaries, "no retune_summary record: write_back never ran"
    summary = summaries[-1]
    swaps = [r for r in retunes if r.get("swap") and r.get("applied")]
    assert len(swaps) <= 1, f"more than one applied swap: {swaps}"
    swap = swaps[0] if swaps else None
    if swap is not None:
        assert swap["round"] % RPB == 0, "swap did not land on a block boundary"
    cache_entry = summary.get("cache_entry")
    assert cache_entry, "retune_summary carries no cache_entry path"
    entry = json.loads(Path(cache_entry).read_text())
    assert "measured" in entry, "write-back left no measured block in the entry"

    # Steady-state rates from the run's own round telemetry; each program's first
    # block pays its first call's start-up and is dropped:
    #   [0, RPB)            incumbent's first block
    #   [RPB, end)          incumbent steady state (end = the swap round, or the last)
    #   [swap, swap+RPB)    the swapped-in program's first block
    #   [swap+RPB, rounds)  post-swap steady state
    round_records = {r["round"]: r for r in records if r.get("type") == "round"}
    end = swap["round"] if swap is not None else NUM_ROUNDS
    inc_steady = steady(round_records, RPB, end)
    assert inc_steady is not None, "no steady incumbent rounds"
    measured = {inc_name: inc_steady,
                **{name: p["walltime_s"] / p["rounds"] for name, p in probes.items()}}
    measured_winner = min(measured, key=measured.get)
    differ = measured_winner != inc_name
    table = coord.retuner.measured_table()
    post_swap = None
    if swap is not None:
        new_name = swap.get("new_program")
        probe = probes.get(new_name, {"rounds": 0, "walltime_s": 0.0})
        row = table[new_name]
        post_rounds = row["rounds"] - probe["rounds"]
        post_s = (row["rounds"] * row["s_per_round"] - probe["walltime_s"]) / post_rounds
        post_steady = steady(round_records, swap["round"] + RPB, NUM_ROUNDS)
        inc_row = table[inc_name]
        assert post_rounds == NUM_ROUNDS - swap["round"]
        post_swap = {
            "program": new_name,
            "rounds": post_rounds,
            "s_per_round": round(post_s, 6),
            "incumbent_s_per_round": inc_row["s_per_round"],
            "speedup_pct": round(100.0 * (1.0 - post_s / inc_row["s_per_round"]), 2),
            "steady_s_per_round": None if post_steady is None else round(post_steady, 6),
            "steady_rounds": max(0, NUM_ROUNDS - swap["round"] - RPB),
            "steady_vs_incumbent_steady_speedup_pct": None if post_steady is None else round(
                100.0 * (1.0 - post_steady / inc_steady), 2),
        }
    if check_outcome and differ:
        assert swap is not None, (
            f"the measured winner {measured_winner} differs from the AOT winner {inc_name}, "
            "but the retuner applied no swap")
        assert post_swap["steady_s_per_round"] is not None and (
            post_swap["steady_s_per_round"] < inc_steady), (
            "steady post-swap rounds were not faster than the incumbent's steady rounds")

    record = device_record(dev)
    verdict = ("the retuner swapped" if swap is not None else "the retuner held the incumbent")
    artifact = {
        "what": (
            "closed-loop online retuning of the PyTorch/CUDA port: the AOT ranking of the "
            "profiled programs against measured walltime, the alternatives probed, and the "
            "retuner's verdicts mid-run"
        ),
        "basis": (
            f"measured wall-clock per round on {record['name']} ({record['nvidia_smi']}; "
            f"torch {record['torch']}, CUDA {record['cuda']}); the AOT scores are the "
            f"sweep's: {result.scoring_basis}.  {note}, {NUM_ROUNDS} rounds, "
            f"rounds_per_block={RPB}, retune_every={RETUNE_EVERY}, probes of "
            f"{PROBE_ROUNDS} rounds."
        ),
        "config": config,
        "aot_ranking": aot_ranking,
        "probe": {
            name: {"program": name, "rounds": p["rounds"],
                   "walltime_s": round(p["walltime_s"], 6),
                   "s_per_round": round(p["walltime_s"] / p["rounds"], 6)}
            for name, p in probes.items()
        },
        "premise": {
            "aot_winner": inc_name,
            "aot_scores": {r["program"]: r["aot_score"] for r in aot_ranking},
            "measured_winner": measured_winner,
            "steady_state_s_per_round": {k: round(v, 6) for k, v in measured.items()},
            "differ": differ,
            "retuner": verdict,
            "swap_needed": differ,
            "note": (
                "steady state: the incumbent's rounds of the closed-loop run after its "
                "first block and before any swap; each alternative's probe rounds after "
                "its first block (another run in the same process)"
            ),
        },
        "disagreement": {
            "aot_winner": inc_name,
            "measured_winner": measured_winner,
            "aot_says": f"{inc_name} ranks first",
            "measured_says": (
                f"{measured_winner} at {measured[measured_winner]:.6f} s/round steady-state "
                "is the fastest measured"
            ),
            "steady_state_s_per_round": {k: round(v, 6) for k, v in measured.items()},
            "note": ("the AOT and measured winners differ" if differ else
                     "no disagreement: the AOT winner is also the measured winner, so no "
                     "swap is needed"),
        },
        "swap": None if swap is None else {
            "round": swap["round"],
            "block_boundary": swap["round"] % RPB == 0,
            "old_program": swap.get("old_program"),
            "new_program": swap.get("new_program"),
            "delta": swap.get("delta"),
            "basis": swap.get("basis"),
        },
        "post_swap": post_swap,
        "decisions": [
            {k: r.get(k) for k in (
                "round", "swap", "applied", "old_program", "new_program",
                "measured_s_per_round", "candidate_s_per_round", "delta",
                "basis", "reason",
            ) if r.get(k) is not None}
            for r in retunes
        ],
        "write_back": {"cache_entry": str(Path(cache_entry).relative_to(work)),
                       "measured": entry["measured"]},
        "device": record,
    }
    print(f"premise: AOT {inc_name}, measured {measured_winner} "
          f"({json.dumps(artifact['premise']['steady_state_s_per_round'])}); {verdict}"
          + (f" at round {swap['round']}" if swap is not None else ""), flush=True)
    return artifact


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=["reference", "flagship"], default="reference")
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--out", default=None, help="artifact path (default: runs/retune_"
                    "torch.json, runs/retune_flagship_torch.json for the flagship)")
    args = ap.parse_args()
    artifact = record_retune(args.config, args.device)
    stem = "retune_torch" if args.config == "reference" else "retune_flagship_torch"
    out = Path(args.out) if args.out else REPO / "runs" / f"{stem}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=2, sort_keys=True) + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
