"""Named benchmark configurations (counterpart of ``nanofed_tpu/benchmarks.py``): the
BASELINE.json suite as ``run_experiment`` keyword arguments, the same six with the
same values.

1. ``mnist_iid``        — 10 clients, IID, MNIST CNN, sync FedAvg.
2. ``mnist_labelskew``  — 100 clients, label skew, 10% participation.
3. ``fedprox_cifar10``  — FedProx (μ=0.01) on CIFAR-10 ResNet-8, 100 clients,
   Dirichlet α=0.5, 10% participation.
4. ``dp_fedavg_mnist``  — central DP-FedAvg, σ calibrated to (ε=8, δ=1e-5).
5. ``cross_silo``       — 8 clients, ResNet-18 on CIFAR-100, full participation.
6. ``mnist_1000``       — 1000 clients of 60 samples, ``client_chunk=125``, bf16.

Without CIFAR files under ``data_dir`` the CIFAR configurations run on the loader's
synthetic CIFAR-shaped data (``data.load_cifar``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from nanofed_tpu_torch.core.device import DeviceLike

BENCHMARKS: dict[str, dict[str, Any]] = {
    "mnist_iid": dict(
        model="mnist_cnn", num_clients=10, num_rounds=5, local_epochs=2,
        batch_size=64, learning_rate=0.1, scheme="iid", participation=1.0,
    ),
    "mnist_labelskew": dict(
        model="mnist_cnn", num_clients=100, num_rounds=5, local_epochs=1,
        batch_size=32, learning_rate=0.1, scheme="label_skew", participation=0.1,
        shards_per_client=2,
    ),
    "fedprox_cifar10": dict(
        model="resnet8", num_clients=100, num_rounds=3, local_epochs=1,
        batch_size=32, learning_rate=0.05, scheme="dirichlet", participation=0.1,
        alpha=0.5, prox_mu=0.01,
    ),
    "dp_fedavg_mnist": dict(
        model="mnist_cnn", num_clients=10, num_rounds=3, local_epochs=1,
        batch_size=64, learning_rate=0.1, scheme="iid", participation=1.0,
        dp=True,
    ),
    "cross_silo": dict(
        model="resnet18", num_clients=8, num_rounds=2, local_epochs=1,
        batch_size=32, learning_rate=0.05, scheme="iid", participation=1.0,
    ),
    "mnist_1000": dict(
        model="mnist_cnn", num_clients=1000, num_rounds=3, local_epochs=2,
        batch_size=64, learning_rate=0.1, scheme="iid", participation=1.0,
        client_chunk=125, compute_dtype="bfloat16",
    ),
}


def run_benchmark(
    name: str, out_dir: str = "runs/bench", device: DeviceLike = None, **overrides: Any
) -> dict[str, Any]:
    """Run one named benchmark on ``device`` (default: the GPU); ``overrides`` adjust
    any ``run_experiment`` keyword (e.g. ``train_size=`` for a smaller synthetic run).

    The summary gains ``rounds_per_sec``: one over the median round time of the
    rounds after the first.  On the card the first round pays for cuDNN's choice of
    convolution algorithms and the kernels' first build and load (there is no XLA
    compile), so it is left out; a one-round run uses its only round."""
    if name not in BENCHMARKS:
        raise KeyError(f"unknown benchmark {name!r}; have {sorted(BENCHMARKS)}")
    from nanofed_tpu_torch.experiments import run_experiment

    config = dict(BENCHMARKS[name])
    config.update(overrides)
    if config.pop("dp", False):
        from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig
        from nanofed_tpu_torch.orchestration import cohort_size
        from nanofed_tpu_torch.privacy import PrivacyConfig
        from nanofed_tpu_torch.privacy.accounting import noise_multiplier_for_budget

        # σ calibrated so the whole run spends the (ε=8, δ=1e-5) budget at the
        # realized cohort rate.
        q = cohort_size(config["num_clients"], config["participation"]) / config["num_clients"]
        sigma = noise_multiplier_for_budget(
            8.0, 1e-5, sampling_rate=q, num_events=config["num_rounds"]
        )
        config["central_privacy"] = PrivacyAwareAggregationConfig(
            privacy=PrivacyConfig(
                epsilon=8.0, delta=1e-5, max_gradient_norm=1.0, noise_multiplier=sigma
            )
        )
    summary = run_experiment(out_dir=out_dir, device=device, **config)
    durations = summary.get("round_durations_s", [])
    steady = durations[1:] or durations
    if steady:
        summary["rounds_per_sec"] = float(1.0 / np.median(steady))
    summary["benchmark"] = name
    return summary
