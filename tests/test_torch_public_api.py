"""The small public names of the orchestration, core, aggregation and models layers
against the JAX package's: the record types' fields, the exception hierarchy,
``validate_updates``' verdicts and messages, the model registry, the coordinator's
progress snapshot, and the coordinator's answer to the JAX-only keywords (a
``NotImplementedError`` naming the ROADMAP item that brings each)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.core import exceptions as jax_exceptions
from nanofed_tpu.core.types import ClientUpdates as JaxClientUpdates
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.models import list_models as jax_list_models
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.orchestration import types as jax_types
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu_torch.aggregation import AggregationResult, validate_updates
from nanofed_tpu_torch.core import exceptions
from nanofed_tpu_torch.core.types import ClientMetrics, ClientUpdates
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model, list_models
from nanofed_tpu_torch.orchestration import (
    ClientInfo,
    Coordinator,
    CoordinatorConfig,
    TrainingProgress,
)
from nanofed_tpu_torch.orchestration.coordinator import LATER_SLICE_KEYWORDS
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.utils.trees import flatten_with_names


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("ours,theirs", [
    (ClientInfo, jax_types.ClientInfo),
    (TrainingProgress, jax_types.TrainingProgress),
    (AggregationResult, jax_base.AggregationResult),
])
def test_record_types_have_the_jax_fields(ours, theirs):
    assert _fields(ours) == _fields(theirs)
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["TrainingError", "ValidationError"])
def test_exceptions_sit_where_the_jax_ones_do(name):
    ours, theirs = getattr(exceptions, name), getattr(jax_exceptions, name)
    assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in theirs.__mro__]
    assert ours.__doc__ == theirs.__doc__
    with pytest.raises(exceptions.NanoFedError):
        raise ours("x")


NESTED = {"dense": {"bias": np.zeros(3, np.float32), "kernel": np.zeros((5, 3), np.float32)}}


def _updates(stacked, c=4):
    weights = np.ones(c, np.float32)
    jax_u = JaxClientUpdates({k: {n: jnp.asarray(a) for n, a in v.items()}
                              for k, v in stacked.items()}, jnp.asarray(weights), None)
    flat = {k: torch.from_numpy(v) for k, v in flatten_with_names(stacked).items()}
    metrics = ClientMetrics(*(torch.zeros(c),) * 3)
    return jax_u, ClientUpdates(flat, torch.from_numpy(weights), metrics)


@pytest.mark.parametrize("case", ["ok", "client_count", "leaf_shape", "missing_leaf"])
def test_validate_updates_gives_the_jax_verdicts(case):
    c = 4
    stacked = {"dense": {"bias": np.zeros((c, 3), np.float32),
                         "kernel": np.zeros((c, 5, 3), np.float32)}}
    if case == "client_count":
        stacked["dense"]["bias"] = np.zeros((c + 1, 3), np.float32)
    elif case == "leaf_shape":
        stacked["dense"]["kernel"] = np.zeros((c, 5, 4), np.float32)
    elif case == "missing_leaf":
        del stacked["dense"]["kernel"]
    jax_u, ours = _updates(stacked, c)
    jax_global = {"dense": {n: jnp.asarray(a) for n, a in NESTED["dense"].items()}}
    port_global = {k: torch.from_numpy(v) for k, v in flatten_with_names(NESTED).items()}
    if case == "ok":
        jax_base.validate_updates(jax_u, jax_global)
        validate_updates(ours, port_global)
        return
    with pytest.raises(jax_exceptions.AggregationError) as want:
        jax_base.validate_updates(jax_u, jax_global)
    with pytest.raises(exceptions.AggregationError) as got:
        validate_updates(ours, port_global)
    if case != "missing_leaf":  # the structure message names each package's tree
        assert str(got.value) == str(want.value)


def test_list_models_is_the_jax_registry_less_the_later_models():
    ours, theirs = list_models(), jax_list_models()
    assert ours == sorted(ours) and set(ours) <= set(theirs)
    assert set(theirs) - set(ours) == {"transformer_lm", "transformer_lm_scan"}  # item 16


def test_training_progress_counts_like_jax(tmp_path):
    """Dropout fails some rounds: both coordinators (same numpy draws) report the same
    counts, and each averages its own completed rounds' loss and accuracy."""
    kw = dict(num_rounds=5, participation_rate=0.5, dropout_rate=0.3,
              min_completion_rate=0.75, seed=0, save_metrics=False)
    theirs = JaxCoordinator(
        model=jax_get_model("mlp", in_features=16, hidden=8, num_classes=4),
        train_data=jax_federate(jax_synthetic(128, 4, (16,), seed=0), 8, batch_size=16),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax", **kw),
        training=JaxTrainingConfig(batch_size=16, local_epochs=1))
    ours = Coordinator(
        model=get_model("mlp", in_features=16, hidden=8, num_classes=4),
        train_data=federate(synthetic_classification(128, 4, (16,), seed=0), 8, batch_size=16),
        config=CoordinatorConfig(base_dir=tmp_path / "torch", **kw),
        training=TrainingConfig(batch_size=16, local_epochs=1),
        device="cpu")
    assert ours.training_progress == TrainingProgress(0, 5, 0, 0, {})
    theirs.run()
    ours.run()
    got, want = ours.training_progress, theirs.training_progress
    assert (got.current_round, got.total_rounds, got.completed_rounds, got.failed_rounds) == (
        want.current_round, want.total_rounds, want.completed_rounds, want.failed_rounds)
    assert got.failed_rounds > 0 and got.completed_rounds > 0
    assert got.global_metrics.keys() == want.global_metrics.keys() == {"loss", "accuracy"}
    losses = [m.agg_metrics["loss"] for m in ours.history if m.agg_metrics]
    assert got.global_metrics["loss"] == pytest.approx(float(np.mean(losses)))


@pytest.mark.parametrize("keyword,value,item", [
    ("adapter", object(), "item 16"),
    ("chaos", object(), "item 17"),
    ("mesh", object(), "item 9b"),
    ("mesh_shape", (1, 1), "item 9b"),
    ("strict", True, "item 21"),
])
def test_coordinator_refuses_the_jax_only_keywords_with_their_item(tmp_path, keyword, value,
                                                                    item):
    model = get_model("linear", in_features=10, num_classes=2)
    data = federate(synthetic_classification(32, 2, (10,), seed=0), 2, batch_size=8)
    config = CoordinatorConfig(base_dir=tmp_path, save_metrics=False)
    with pytest.raises(NotImplementedError, match=f"{keyword}=.*{item}"):
        Coordinator(model, data, config, device="cpu", **{keyword: value})
    default = LATER_SLICE_KEYWORDS[keyword][0]
    Coordinator(model, data, config, device="cpu", **{keyword: default})  # the JAX default
    with pytest.raises(TypeError, match="unexpected keyword argument 'mesh_shapes'"):
        Coordinator(model, data, config, device="cpu", mesh_shapes=(1, 1))


def test_coordinator_telemetry_dir_writes_the_runs_telemetry(tmp_path):
    """``telemetry_dir=``, a JAX keyword this slice ports: the run's records land there,
    not under ``base_dir``."""
    from nanofed_tpu_torch.observability import summarize_telemetry

    model = get_model("linear", in_features=10, num_classes=2)
    data = federate(synthetic_classification(32, 2, (10,), seed=0), 2, batch_size=8)
    config = CoordinatorConfig(num_rounds=2, base_dir=tmp_path / "base")
    Coordinator(model, data, config, TrainingConfig(batch_size=8), device="cpu",
                telemetry_dir=tmp_path / "tel").run()
    assert not (tmp_path / "base" / "telemetry.jsonl").exists()
    summary = summarize_telemetry(tmp_path / "tel" / "telemetry.jsonl")
    assert summary["rounds"] == {"COMPLETED": 2}
    assert summary["topology"]["num_clients"] == 2 and "local-train" in summary["phases"]
    assert "telemetry_dir" not in LATER_SLICE_KEYWORDS
