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
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.core.types import ClientMetrics as JaxClientMetrics
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
from nanofed_tpu_torch.core.types import ClientData, ClientMetrics, ClientUpdates
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


@pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
def test_client_data_num_samples_sums_the_mask_like_jax(host):
    """``num_samples`` of a [2, 3] mask: the mask summed over its last axis, in its
    dtype and shape, as the JAX ``ClientData.num_samples``."""
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    x = np.zeros((2, 3, 4), np.float32)
    y = np.zeros((2, 3), np.int32)
    want = JaxClientData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)).num_samples
    data = ClientData(x, y, mask)
    got = data.num_samples if host else data.to(torch.device("cpu")).num_samples
    got = np.asarray(got)
    assert got.dtype == np.asarray(want).dtype == np.float32
    assert got.shape == want.shape == (2,)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, [2.0, 3.0])


def test_client_metrics_to_dict_like_jax():
    """``to_dict()`` of one client's metrics: the reference's keys, ``float``,
    ``float`` and ``int``."""
    ours = ClientMetrics(torch.tensor(0.25), torch.tensor(0.75), torch.tensor(12)).to_dict()
    theirs = JaxClientMetrics(jnp.float32(0.25), jnp.float32(0.75), jnp.int32(12)).to_dict()
    assert ours == theirs == {"loss": 0.25, "accuracy": 0.75, "samples_processed": 12}
    assert list(ours) == list(theirs)
    assert [type(v) for v in ours.values()] == [type(v) for v in theirs.values()] == \
        [float, float, int]


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
    """The transformer slice brought the last missing family: the registries are
    equal."""
    ours, theirs = list_models(), jax_list_models()
    assert ours == sorted(ours) and set(ours) <= set(theirs)
    assert set(theirs) - set(ours) == set()


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


@pytest.mark.parametrize("participation,dropout", [(1.0, 0.0), (0.5, 0.25)])
def test_coordinator_chaos_drops_planned_crashes_as_jax(tmp_path, participation, dropout):
    """``chaos=`` (a ``faults.ChaosSchedule``): every sampled cohort loses the plan's
    crashed clients after the dropout draw, the JAX coordinator's cohorts exactly."""
    from nanofed_tpu.faults import ChaosSchedule as JaxSchedule
    from nanofed_tpu.faults import FaultPlan as JaxPlan
    from nanofed_tpu_torch.faults import ChaosSchedule, FaultPlan

    assert "chaos" not in LATER_SLICE_KEYWORDS
    kw = dict(seed=5, participation_rate=participation, dropout_rate=dropout,
              save_metrics=False)
    plan_args = (2, list(range(10)), 6)
    plan = FaultPlan.generate(*plan_args, crash_fraction=0.3)
    theirs = JaxCoordinator(
        model=jax_get_model("linear", in_features=10, num_classes=2),
        train_data=jax_federate(jax_synthetic(80, 2, (10,), seed=0), 10, batch_size=8),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax", **kw),
        training=JaxTrainingConfig(batch_size=8, local_epochs=1),
        chaos=JaxSchedule(JaxPlan.generate(*plan_args, crash_fraction=0.3)))
    ours = Coordinator(
        get_model("linear", in_features=10, num_classes=2),
        federate(synthetic_classification(80, 2, (10,), seed=0), 10, batch_size=8),
        CoordinatorConfig(base_dir=tmp_path / "torch", **kw), device="cpu",
        chaos=ChaosSchedule(plan))
    plain = Coordinator(
        get_model("linear", in_features=10, num_classes=2),
        federate(synthetic_classification(80, 2, (10,), seed=0), 10, batch_size=8),
        CoordinatorConfig(base_dir=tmp_path / "plain", **kw), device="cpu")
    crashes = {e.client: e.round for e in plan.events}
    assert len(crashes) == 3
    for round_id in range(6):
        got = ours._sample_cohort(round_id)
        np.testing.assert_array_equal(got, theirs._sample_cohort(round_id))
        alive = [c for c in plain._sample_cohort(round_id)
                 if crashes.get(int(c), round_id + 1) > round_id]
        np.testing.assert_array_equal(got, alive)


@pytest.mark.parametrize("kw,error", [
    (dict(mesh_shape=(1,)), None),
    (dict(mesh_shape=(1, 1)), None),
    (dict(mesh_shape=(2, 2)), "mesh shape (2, 2) needs 4 devices but 1 are available"),
    (dict(mesh_shape=(1,), mesh=object()), "pass either mesh="),
])
def test_coordinator_takes_mesh_and_mesh_shape(tmp_path, kw, error):
    """``mesh=``/``mesh_shape=``, which earlier slices refused: without a process group
    the world is one rank, so a one-rank mesh runs a round (its collectives the
    identity) and a larger one fails at the JAX mesh's own check."""
    model = get_model("linear", in_features=10, num_classes=2)
    data = federate(synthetic_classification(32, 2, (10,), seed=0), 2, batch_size=8)
    config = CoordinatorConfig(base_dir=tmp_path, save_metrics=False)
    if error is not None:
        with pytest.raises(ValueError, match=error.replace("(", r"\(").replace(")", r"\)")):
            Coordinator(model, data, config, device="cpu", **kw)
        return
    coord = Coordinator(model, data, config, training=TrainingConfig(batch_size=8),
                        device="cpu", **kw)
    assert coord.mesh.shape == kw["mesh_shape"]
    (metrics,) = coord.run()
    assert metrics.status.name == "COMPLETED"


def test_coordinator_takes_the_adapter_keyword(tmp_path):
    """``adapter=``, which earlier slices refused: the federated params are the
    adapter tree of the adapted kernel, the base stays beside them, and a round runs."""
    from nanofed_tpu_torch.adapters import AdapterSpec

    assert "adapter" not in LATER_SLICE_KEYWORDS
    model = get_model("mlp", in_features=10, hidden=16, num_classes=2)
    data = federate(synthetic_classification(32, 2, (10,), seed=0), 2, batch_size=8)
    coord = Coordinator(model, data, CoordinatorConfig(base_dir=tmp_path, save_metrics=False),
                        TrainingConfig(batch_size=8), device="cpu",
                        adapter=AdapterSpec(rank=2))
    assert list(coord.params) == ["fc1/kernel/A", "fc1/kernel/B"]
    assert list(coord.base_params) == list(model.init(torch.Generator().manual_seed(0)))
    assert coord.run()[0].status.name == "COMPLETED"


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
