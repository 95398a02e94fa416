"""High-level experiment runner (counterpart of ``nanofed_tpu/experiments.py``), reduced
to the flags this slice supports, and the engine behind ``nanofed-tpu-torch run``.

:func:`load_datasets_for` picks the data by the model's input shape, as the JAX
runner does: MNIST-shaped, the 8x8 digits, CIFAR-shaped (10 or 100 classes, files under
``data_dir`` or the synthetic fallback), else synthetic data of the model's shape.

``central_privacy`` (DP-FedAvg at the reduce), ``robust_trim_k``/``robust_method``
(robust aggregation), the client lr schedule (``lr_schedule``, ``lr_min_factor``,
``lr_decay_every``, ``lr_decay_gamma``), ``profile_programs``, ``autotune`` and
``retune_every``, ``scaffold``, ``rounds_per_block`` (fused multi-round blocks) and
``telemetry_dir`` are taken as the JAX runner takes them.  Update validation is not a
runner flag in either package: it is ``Coordinator(validation=...)``.  The JAX
runner's other flags (mesh axes, strict mode, adapters) come with later slices;
passing one with a value other than the JAX default raises ``NotImplementedError``
naming it, never a silent ignore.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from nanofed_tpu_torch.aggregation import PrivacyAwareAggregationConfig, RobustAggregationConfig
from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.data import (
    federate,
    load_cifar,
    load_digits_dataset,
    load_mnist,
    pack_eval,
    synthetic_classification,
)
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig, RoundStatus
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.utils.logger import Logger

# The JAX runner's flags that later slices bring, with the JAX defaults (accepted).
LATER_SLICE_FLAGS: dict[str, Any] = {
    "model_shards": 1,
    "hosts": 1,
    "strict": False,
    "adapter_rank": None,
    "adapter_alpha": None,
}


def load_datasets_for(
    mdl: Any, data_dir: str | None, train_size: int | None, seed: int = 0
) -> tuple[Any, Any]:
    """Train and test datasets matching a model's input shape (MNIST-shaped, the 8x8
    digits, CIFAR-shaped, or synthetic for anything else); the test split is a sixth
    of ``train_size`` when it is given."""
    test_size = (train_size or 0) // 6 or None
    if getattr(mdl, "token_stream", False):
        raise NotImplementedError(
            "token-stream models: synthetic_token_streams comes with the transformer "
            "slice of nanofed_tpu_torch (ROADMAP queue A item 16)"
        )
    if mdl.input_shape == (28, 28, 1):
        train = load_mnist("train", data_dir, synthetic_size=train_size)
        test = load_mnist("test", data_dir, synthetic_size=test_size)
    elif mdl.input_shape == (8, 8, 1):
        train = load_digits_dataset("train")
        test = load_digits_dataset("test")
    elif mdl.input_shape == (32, 32, 3):
        nc = mdl.num_classes
        train = load_cifar("train", data_dir, num_classes=nc, synthetic_size=train_size)
        test = load_cifar("test", data_dir, num_classes=nc, synthetic_size=test_size)
    else:
        train = synthetic_classification(
            train_size or 4096, mdl.num_classes, mdl.input_shape, seed=seed
        )
        test = synthetic_classification(
            test_size or 1024, mdl.num_classes, mdl.input_shape, seed=seed + 1
        )
    return train, test


def run_experiment(
    model: str = "mnist_cnn",
    num_clients: int = 10,
    num_rounds: int = 2,
    local_epochs: int = 2,
    batch_size: int = 64,
    learning_rate: float = 0.1,
    scheme: str = "iid",
    participation: float = 1.0,
    data_dir: str | None = None,
    out_dir: str | Path = "runs",
    seed: int = 0,
    prox_mu: float = 0.0,
    eval_every: int = 0,
    train_size: int | None = None,
    client_chunk: int | None = None,
    compute_dtype: str | None = None,
    client_metrics_every: int = 1,
    lr_schedule: str = "constant",
    lr_min_factor: float = 0.0,
    lr_decay_every: int = 10,
    lr_decay_gamma: float = 0.5,
    device: DeviceLike = None,
    central_privacy: PrivacyAwareAggregationConfig | None = None,
    robust_trim_k: int | None = None,
    robust_method: str | None = None,
    profile_programs: bool = False,
    autotune: bool = False,
    retune_every: int = 0,
    scaffold: bool = False,
    rounds_per_block: int = 1,
    telemetry_dir: str | Path | None = None,
    **kwargs: Any,
) -> dict[str, Any]:
    """Run a simulated federated experiment on ``device`` (default: the GPU) and return
    a summary dict.  ``client_chunk`` trains and reduces the clients in chunks of that
    many (the streamed round); ``compute_dtype="bfloat16"`` runs local forward and
    backward in bf16.  ``central_privacy`` turns the reduce into DP-FedAvg;
    ``robust_trim_k``/``robust_method`` (either one set) aggregate robustly, with
    ``trim_k`` defaulting to 1 and the method to ``"trimmed_mean"``.  ``lr_schedule``
    decays the client lr across rounds (``CoordinatorConfig``).  ``scaffold=True``
    runs SCAFFOLD (``Coordinator(scaffold=True)``: control variates, the uniform
    participant mean).  ``rounds_per_block > 1`` runs full blocks of that many rounds
    with no host barrier between them (``CoordinatorConfig.rounds_per_block``);
    configurations the fused path does not cover run single rounds.

    ``profile_programs=True`` profiles the round step at construction
    (``observability.profiling``) and the summary carries ``program_profiles``.
    ``autotune=True`` builds the coordinator with ``Coordinator.from_autotune``: the
    ``client_chunk`` and batch size of the best profiled candidate, the ranked
    table under ``out_dir`` as ``autotune_*.json``, and ``tuned_config`` in the
    summary; it refuses an explicit ``client_chunk``.  ``retune_every`` (requires
    ``autotune=True``) re-ranks the table every N rounds by the measured round times
    and swaps ``client_chunk`` when the measurements say so; the summary carries a
    ``retunes`` block.  ``telemetry_dir`` is where the run's ``telemetry.jsonl``
    goes (default: ``out_dir``, as metrics are saved).  Remaining keyword arguments go to the partitioner (e.g.
    ``proportions=[0.75, 0.25]`` for unequal IID shares)."""
    dev = resolve_device(device)
    refused = [
        name for name, default in LATER_SLICE_FLAGS.items()
        if name in kwargs and kwargs[name] != default
    ]
    if refused:
        raise NotImplementedError(
            f"{', '.join(refused)}: not supported by this slice of nanofed_tpu_torch "
            "(run nanofed_tpu for it)"
        )
    scheme_kwargs = {k: v for k, v in kwargs.items() if k not in LATER_SLICE_FLAGS}
    if retune_every > 0 and not autotune:
        raise NanoFedError(
            "retune_every requires autotune=True: the online retuner re-ranks "
            "the sweep's candidate table — without a sweep there is no table"
        )
    pinned = [name for name, engaged in (
        ("client_chunk", client_chunk is not None),
        ("rounds_per_block", rounds_per_block != 1),
    ) if engaged]
    if autotune and pinned:
        raise NanoFedError(
            f"autotune=True owns {', '.join(pinned)} — drop the explicit value(s) or "
            "tune by hand without autotune"
        )
    robust = None
    if robust_trim_k is not None or robust_method is not None:
        robust = RobustAggregationConfig(
            trim_k=robust_trim_k if robust_trim_k is not None else 1,
            method=robust_method or "trimmed_mean",
        )

    mdl = get_model(model)
    train, test = load_datasets_for(mdl, data_dir, train_size, seed)
    Logger().info("dataset %s: %d train / %d test samples", train.name, len(train), len(test))
    client_data = federate(
        train, num_clients=num_clients, scheme=scheme, batch_size=batch_size, seed=seed,
        **scheme_kwargs,
    )
    config = CoordinatorConfig(
        num_rounds=num_rounds, participation_rate=participation, seed=seed,
        base_dir=out_dir, eval_every=eval_every, rounds_per_block=rounds_per_block,
        client_metrics_every=client_metrics_every,
        lr_schedule=lr_schedule, lr_min_factor=lr_min_factor,
        lr_decay_every=lr_decay_every, lr_decay_gamma=lr_decay_gamma,
        profile_programs=profile_programs, retune_every=retune_every,
    )
    training = TrainingConfig(
        batch_size=batch_size, local_epochs=local_epochs, learning_rate=learning_rate,
        prox_mu=prox_mu, compute_dtype=compute_dtype,
    )
    shared_kwargs: dict[str, Any] = dict(
        eval_data=pack_eval(test, batch_size=256), device=dev,
        central_privacy=central_privacy, robust=robust, scaffold=scaffold,
        telemetry_dir=telemetry_dir,
    )
    if autotune:
        coordinator = Coordinator.from_autotune(
            mdl, client_data, config, training=training, **shared_kwargs,
        )
    else:
        coordinator = Coordinator(
            model=mdl, train_data=client_data, config=config, training=training,
            client_chunk=client_chunk, **shared_kwargs,
        )
    rounds = coordinator.run()
    final_eval = coordinator.evaluate()
    completed = [r for r in rounds if r.status == RoundStatus.COMPLETED]
    spent = coordinator.privacy_spent
    program_profiles = {
        r.program: r.to_dict() for r in coordinator.program_catalog.reports()
    }
    return {
        **({"privacy_spent": {"epsilon_spent": spent.epsilon_spent,
                              "delta_spent": spent.delta_spent}}
           if spent is not None else {}),
        **({"program_profiles": program_profiles} if program_profiles else {}),
        **({"tuned_config": coordinator.tuned_config}
           if coordinator.tuned_config is not None else {}),
        **({"retunes": coordinator.retuner.summary()}
           if coordinator.retuner is not None else {}),
        "model": model,
        "num_clients": num_clients,
        "rounds_completed": len(completed),
        "rounds_failed": len(rounds) - len(completed),
        "final_train_metrics": completed[-1].agg_metrics if completed else {},
        "final_eval_metrics": final_eval,
        "round_durations_s": [r.duration_s for r in rounds],
        "devices": [str(dev)],
        "params_device": str(next(iter(coordinator.params.values())).device),
    }
