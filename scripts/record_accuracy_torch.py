#!/usr/bin/env python
"""Record the real-data accuracy evidence of the PyTorch/CUDA port (counterpart of
``scripts/record_accuracy.py``).

Runs federated FedAvg on real handwritten-digit images to >= 97% held-out test accuracy
with ``nanofed_tpu_torch`` and writes ``runs/accuracy_<dataset>_<tag>.json`` with the
config, the per-eval trajectory and the wall clock to 97%, the reference artifact's
keys plus ``device`` (the card's name and power limit, torch and CUDA versions, and the
kernel launches of the run).

Dataset: with MNIST IDX files under ``--data-dir`` the MNIST CNN runs at the reference
example's settings; otherwise the digits bundled with the port (1,797 real 8x8 images,
``nanofed_tpu_torch/data/digits.csv.gz``), natively for ``--model mlp`` or bilinearly
upsampled to 28x28 for the flagship ``mnist_cnn`` (``--model cnn``, the default).

Usage (from the repo root; the card by default, ``--device cpu`` on request):
    python scripts/record_accuracy_torch.py [--data-dir data/mnist] [--round-tag torch]
    python scripts/record_accuracy_torch.py --model mlp --hidden 128 --clients 100 \\
        --momentum 0.9 --local-epochs 4

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TARGET_ACC = 0.97


def record_accuracy(
    model: str = "cnn",
    clients: int | None = None,
    max_rounds: int = 60,
    momentum: float | None = None,
    local_epochs: int | None = None,
    lr: float | None = None,
    hidden: int | None = None,
    lr_schedule: str = "constant",
    lr_min_factor: float = 0.0,
    data_dir: str | None = None,
    round_tag: str = "torch",
    device: str | None = None,
    base_dir: str | Path = "runs/accuracy_run",
) -> dict:
    """Train until held-out accuracy reaches :data:`TARGET_ACC` or ``max_rounds`` end;
    return the artifact.  The arguments are the reference script's flags."""
    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.core.device import device_record, resolve_device
    from nanofed_tpu_torch.data import (
        federate,
        load_digits_dataset,
        load_mnist,
        pack_eval,
        resize_images,
    )
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.trainer import TrainingConfig

    dev = resolve_device(device)
    ops.reset_launch_counts()
    mnist_available = False
    if data_dir is not None:
        try:
            load_mnist("train", data_dir, synthetic_fallback=False)
            mnist_available = True
        except FileNotFoundError:
            print(f"no MNIST under {data_dir}; using the bundled digits", flush=True)

    if mnist_available:
        dataset, model_name = "mnist", "mnist_cnn"
        mdl = get_model(model_name)
        train = load_mnist("train", data_dir, synthetic_fallback=False)
        test = load_mnist("test", data_dir, synthetic_fallback=False)
        training = TrainingConfig(batch_size=64, local_epochs=2, learning_rate=0.1)
        num_clients, batch_eval = 10, 256
    elif model == "cnn":
        # The flagship CNN itself on real pixels: the digits upsampled to its input.
        dataset, model_name = "digits_cnn28", "mnist_cnn"
        mdl = get_model(model_name)
        train = resize_images(load_digits_dataset("train"), 28, 28)
        test = resize_images(load_digits_dataset("test"), 28, 28)
        training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.1)
        num_clients, batch_eval = 8, 128
    else:
        dataset, model_name = "digits", "digits_mlp"
        mdl = get_model(model_name, hidden=hidden or 96)
        train = load_digits_dataset("train")
        test = load_digits_dataset("test")
        training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.5)
        num_clients, batch_eval = 8, 128

    overrides = {k: v for k, v in (("momentum", momentum), ("local_epochs", local_epochs),
                                   ("learning_rate", lr)) if v is not None}
    if overrides:
        training = dataclasses.replace(training, **overrides)
    if clients is not None:
        num_clients = clients
        dataset = f"{dataset}_{num_clients}c"
        if num_clients * 2 > len(train):
            # Degenerate shards (< 2 images a client): keep batches meaningful.
            training = dataclasses.replace(training, batch_size=2)
    print(f"dataset={train.name}: {len(train)} train / {len(test)} test (real data)",
          flush=True)
    coord = Coordinator(
        model=mdl,
        train_data=federate(train, num_clients=num_clients, scheme="iid",
                            batch_size=training.batch_size, seed=0),
        config=CoordinatorConfig(num_rounds=max_rounds, seed=0, base_dir=base_dir,
                                 eval_every=1, lr_schedule=lr_schedule,
                                 lr_min_factor=lr_min_factor),
        training=training,
        eval_data=pack_eval(test, batch_size=batch_eval),
        device=dev,
    )

    t0 = time.time()
    trajectory = []
    reached_at = None
    for m in coord.start_training():
        acc = m.eval_metrics.get("accuracy")
        if acc is None:
            continue
        trajectory.append({"round": m.round_id, "test_accuracy": round(float(acc), 4),
                           "elapsed_s": round(time.time() - t0, 2)})
        print(f"round {m.round_id}: test acc {acc:.4f}", flush=True)
        if acc >= TARGET_ACC:
            reached_at = trajectory[-1]
            break

    bundled = "the digits bundled with the port (nanofed_tpu_torch/data/digits.csv.gz)"
    return {
        "artifact": f"accuracy_{dataset}_{round_tag}",
        "dataset": train.name,
        "real_data": True,
        "data_note": (
            "MNIST IDX files" if mnist_available
            else f"{bundled}: 1,797 real handwritten-digit images (UCI optdigits), "
                 "bilinearly upsampled 8x8 -> 28x28 so the flagship MNIST-CNN "
                 "architecture is the model under test" if model_name == "mnist_cnn"
            else f"{bundled}: 1,797 real handwritten-digit images (UCI optdigits)"
        ),
        "model": (f"{model_name}(hidden={hidden or 96})"
                  if model_name == "digits_mlp" else model_name),
        "num_clients": num_clients,
        "scheme": "iid",
        "training": {"batch_size": training.batch_size,
                     "local_epochs": training.local_epochs,
                     "learning_rate": training.learning_rate,
                     "momentum": training.momentum,
                     "lr_schedule": lr_schedule},
        "target_accuracy": TARGET_ACC,
        "reached": reached_at is not None,
        "reached_at_round": reached_at["round"] if reached_at else None,
        "wall_clock_to_target_s": reached_at["elapsed_s"] if reached_at else None,
        "final_test_accuracy": trajectory[-1]["test_accuracy"] if trajectory else None,
        "trajectory": trajectory,
        "platform": dev.type,
        "devices": 1,
        "reference_parity_note": (
            "reference records 93.75% round-1 aggregated accuracy on MNIST "
            "(docs/source/getting_started/tutorial.rst:325-334); target here is the "
            "BASELINE.md 97% test-accuracy bar on real data"
        ),
        "device": device_record(dev),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None, help="MNIST IDX dir (else the digits)")
    ap.add_argument("--round-tag", default="torch")
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--max-rounds", type=int, default=60)
    ap.add_argument("--model", choices=["mlp", "cnn"], default="cnn",
                    help="without MNIST: digits_mlp on native 8x8, or the flagship "
                    "MNIST CNN on the digits bilinearly upsampled to 28x28")
    ap.add_argument("--clients", type=int, default=None,
                    help="override the client count (the artifact's name records it)")
    ap.add_argument("--momentum", type=float, default=None)
    ap.add_argument("--local-epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--hidden", type=int, default=None,
                    help="digits_mlp width override (mlp model only)")
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine", "linear", "step"])
    ap.add_argument("--lr-min-factor", type=float, default=0.0)
    args = ap.parse_args()
    artifact = record_accuracy(
        model=args.model, clients=args.clients, max_rounds=args.max_rounds,
        momentum=args.momentum, local_epochs=args.local_epochs, lr=args.lr,
        hidden=args.hidden, lr_schedule=args.lr_schedule,
        lr_min_factor=args.lr_min_factor, data_dir=args.data_dir,
        round_tag=args.round_tag, device=args.device,
    )
    out = REPO / "runs" / f"{artifact['artifact']}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(artifact, indent=2))
    print(json.dumps({k: v for k, v in artifact.items() if k != "trajectory"}, indent=2))
    print(f"artifact written to {out}")
    return 0 if artifact["reached"] else 1


if __name__ == "__main__":
    sys.exit(main())
