"""End-to-end federated MNIST on the PyTorch port: parity with the reference example.

The counterpart of ``run_experiment.py`` beside it, on ``nanofed_tpu_torch``: the
reference's three clients with 12k/8k/4k MNIST samples, 2 rounds x 2 local epochs of
SGD(lr=0.1) at batch 64.  The three clients train together under one ``vmap`` on the
card and the server's weighted mean is kernel B1 (``ops.weighted_mean_flat``).

Run:  python examples/mnist/run_experiment_torch.py [--rounds 2] [--synthetic]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root (no pip install)

from nanofed_tpu_torch.data import load_mnist, pack_clients, pack_eval
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.trainer import TrainingConfig

# The reference's three clients (run_experiment.py:126-131), as shares of 60k samples.
CLIENT_SIZES = (12_000, 8_000, 4_000)
SYNTHETIC_TRAIN = 24_000  # --synthetic; its test split is a sixth of it, 4,000


def run(rounds: int = 2, epochs: int = 2, data_dir: str | None = None,
        synthetic_size: int | None = None, out_dir: str = "runs/mnist_example_torch",
        device: str | None = None) -> tuple[list, dict[str, float]]:
    """Train the three clients for ``rounds`` rounds; return each round's metrics and
    the final evaluation.  ``synthetic_size`` replaces MNIST by that many synthetic
    samples (and a sixth of it for the test split), the clients' sizes scaled to it."""
    train = load_mnist("train", data_dir, synthetic_size=synthetic_size)
    test = load_mnist("test", data_dir,
                      synthetic_size=synthetic_size and synthetic_size // 6)
    sizes = list(CLIENT_SIZES)
    if synthetic_size:
        sizes = [int(s * synthetic_size / 60_000) for s in sizes]
    rng = np.random.default_rng(0)
    parts = [rng.choice(len(train), size=s, replace=False) for s in sizes]
    coordinator = Coordinator(
        model=get_model("mnist_cnn"),
        train_data=pack_clients(train, parts, batch_size=64),
        config=CoordinatorConfig(num_rounds=rounds, base_dir=out_dir, eval_every=1),
        training=TrainingConfig(batch_size=64, local_epochs=epochs, learning_rate=0.1),
        eval_data=pack_eval(test, batch_size=256),
        device=device,
    )
    history = []
    for metrics in coordinator.start_training():
        history.append(metrics)
        print(
            f"round {metrics.round_id}: status={metrics.status.name} "
            f"train_loss={metrics.agg_metrics.get('loss', float('nan')):.4f} "
            f"eval_acc={metrics.eval_metrics.get('accuracy', float('nan')):.4f} "
            f"({metrics.duration_s:.2f}s)"
        )
    final = coordinator.evaluate()
    print(json.dumps({"final_eval": final}, indent=2))
    return history, final


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--data-dir", default=None, help="dir with MNIST idx files")
    parser.add_argument(
        "--synthetic", action="store_true",
        help="use synthetic MNIST-shaped data (no dataset download needed)",
    )
    parser.add_argument("--out-dir", default="runs/mnist_example_torch")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card, cuda)")
    args = parser.parse_args()
    run(args.rounds, args.epochs, args.data_dir,
        SYNTHETIC_TRAIN if args.synthetic else None, args.out_dir, args.device)


if __name__ == "__main__":
    main()
