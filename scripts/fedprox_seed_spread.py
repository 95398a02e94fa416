#!/usr/bin/env python
"""FedProx against FedAvg over more seeds than the evidence artifact's three, on the
PyTorch/CUDA port.

Runs the ``noniid_fedprox`` arms of ``scripts/record_evidence_torch.py`` at their
configuration (``digits_mlp(96)`` on the digits, Dirichlet(0.05) over 30 clients, 30%
participation, 16 local epochs at lr 0.5, 25 rounds, batch 16; mu 0, 0.05 and 0.2) over
seeds ``--seeds`` (default 0-9), and reports each arm's last-5-round mean accuracy by
seed, its mean over the seeds and its spread (sample standard deviation, min, max), and
the FedProx-FedAvg gap of each mu.  The artifacts themselves keep the reference's seeds
0-2; this is the check of their verdict.  ``tests/fedprox_seed_spread_jax.py`` runs the
JAX package's arms the same way, on the CPU.

Usage (from the repo root):
    python scripts/fedprox_seed_spread.py [--device cpu] [--seeds 0-9]

Writes ``runs/noniid_fedprox_seeds_torch_<device>.json``.  Nothing here imports JAX or
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

MUS = (0.0, 0.05, 0.2)
REGIME = dict(alpha=0.05, local_epochs=16, learning_rate=0.5, clients=30,
              participation=0.3, rounds=25, batch_size=16)


def parse_seeds(text: str) -> list[int]:
    """``"0-9"`` or ``"0,3,5"``."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def torch_run(device: str | None):
    """``(run, device type)``: ``run(mu, seed, base_dir)`` gives one run's per-round
    held-out accuracies on the port."""
    sys.path.insert(0, str(REPO / "scripts"))
    import record_evidence_torch as ev

    from nanofed_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    train, test = ev._digits()

    def run(mu: float, seed: int, base_dir: Path) -> list[float]:
        return ev._accuracies(ev._drift_coordinator(train, test, REGIME, seed,
                                                    REGIME["learning_rate"], dev, base_dir,
                                                    prox_mu=mu))

    return run, dev.type


def spread(values: list[float]) -> dict:
    return {"mean": round(statistics.fmean(values), 4),
            "std": round(statistics.stdev(values), 4) if len(values) > 1 else 0.0,
            "min": round(min(values), 4), "max": round(max(values), 4)}


def summarise(package: str, where: str, seeds: list[int], run) -> dict:
    """Every arm over ``seeds`` through ``run``; the record of its spreads and gaps."""
    t0 = time.time()
    last5: dict[str, list[float]] = {}
    for mu in MUS:
        for seed in seeds:
            accs = run(mu, seed, REPO / "runs" / "fedprox_seed_run")
            value = statistics.fmean(accs[-5:])
            last5.setdefault(f"mu={mu}", []).append(round(value, 4))
            print(f"{package} {where} mu={mu} seed={seed}: last-5 mean {value:.4f} "
                  f"final {accs[-1]:.4f}", flush=True)
    arms = {arm: {"last5_by_seed": vals, **spread(vals)} for arm, vals in last5.items()}
    fedavg = last5["mu=0.0"]
    gaps = {arm: spread([p - f for p, f in zip(vals, fedavg)])
            for arm, vals in last5.items() if arm != "mu=0.0"}
    print(json.dumps({arm: {k: v for k, v in a.items() if k != "last5_by_seed"}
                      for arm, a in arms.items()}))
    print("gaps:", json.dumps(gaps))
    return {"package": package, "device": where, "seeds": seeds, "regime": REGIME,
            "arms": arms, "fedprox_minus_fedavg": gaps,
            "elapsed_s": round(time.time() - t0, 1)}


def write(record: dict, out: str | None) -> Path:
    path = Path(out) if out else (
        REPO / "runs" / f"noniid_fedprox_seeds_{record['package']}_{record['device']}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2) + "\n")
    print(path)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--seeds", default="0-9")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    run, where = torch_run(args.device)
    record = summarise("torch", where, parse_seeds(args.seeds), run)
    from nanofed_tpu_torch.core.device import device_record

    record["device_record"] = device_record(where)
    write(record, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
