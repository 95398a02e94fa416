"""The small public names of the orchestration, core, aggregation and models layers
against the JAX package's: the record types' fields, the exception hierarchy,
``validate_updates``' verdicts and messages, the model registry, the coordinator's
progress snapshot, and the coordinator's keywords: every JAX keyword is taken
(``strict=`` last, with the analysis slice), and the package exports (``__all__``) of
every JAX subpackage and the root, less a stated list of names tied to JAX."""

import dataclasses

import jax
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


def _coordinator_keywords() -> set[str]:
    import inspect

    return set(inspect.signature(Coordinator).parameters)


@pytest.mark.parametrize("keyword,value,item", [
    ("strict", True, "item 21"),
])
def test_coordinator_refuses_the_jax_only_keywords_with_their_item(tmp_path, keyword, value,
                                                                    item):
    """The last JAX keyword a slice brought (``strict=``, ROADMAP ``item``) is taken at
    both values with the JAX default, and a keyword the JAX coordinator lacks is still
    a ``TypeError``."""
    import inspect

    model = get_model("linear", in_features=10, num_classes=2)
    data = federate(synthetic_classification(32, 2, (10,), seed=0), 2, batch_size=8)
    config = CoordinatorConfig(base_dir=tmp_path, save_metrics=False)
    assert inspect.signature(Coordinator).parameters[keyword].default is False
    assert inspect.signature(JaxCoordinator).parameters[keyword].default is False
    strict = Coordinator(model, data, config, TrainingConfig(batch_size=8), device="cpu",
                         **{keyword: value})
    assert strict.strict is True and strict.run()[0].status.name == "COMPLETED"
    assert Coordinator(model, data, config, device="cpu", **{keyword: False}).strict is False
    with pytest.raises(TypeError, match="unexpected keyword argument 'mesh_shapes'"):
        Coordinator(model, data, config, device="cpu", mesh_shapes=(1, 1))


@pytest.mark.parametrize("participation,dropout", [(1.0, 0.0), (0.5, 0.25)])
def test_coordinator_chaos_drops_planned_crashes_as_jax(tmp_path, participation, dropout):
    """``chaos=`` (a ``faults.ChaosSchedule``): every sampled cohort loses the plan's
    crashed clients after the dropout draw, the JAX coordinator's cohorts exactly."""
    from nanofed_tpu.faults import ChaosSchedule as JaxSchedule
    from nanofed_tpu.faults import FaultPlan as JaxPlan
    from nanofed_tpu_torch.faults import ChaosSchedule, FaultPlan

    assert "chaos" in _coordinator_keywords()
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

    assert "adapter" in _coordinator_keywords()
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
    assert "telemetry_dir" in _coordinator_keywords()


# The JAX packages' exported names without a torch meaning, with the reason each is
# not exported by the port (ROADMAP's stated differences).
NO_TORCH_MEANING = {
    "core": {"PRNGKey": "a JAX key type: the port's randomness is counter-based hashes "
                        "of explicit integers and seeded torch.Generator streams"},
    "trainer": {"stack_rngs": "stacks JAX keys per client; the port draws permutations "
                              "and hashes client keys (trainer.local.client_keys)"},
    "observability": {"install_jax_event_bridge": "bridges jax.monitoring events; the "
                                                  "port installs install_torch_event_bridge"},
    "parallel": {
        "stack_round_keys": "stacks JAX round keys; a fused block takes host round seeds "
                            "(parallel.round_seeds)",
        "client_sharding": "a jax.sharding.NamedSharding; a rank holds its own rows "
                           "(parallel.client_slice)",
        "param_sharding": "a NamedSharding per leaf; a rank holds its model shard "
                          "(MeshLayout.shard_params, param_partition_spec)",
        "replicated_sharding": "a NamedSharding; a replicated tensor is each rank's own",
        "shard_client_data": "device_put onto a sharding; a rank copies its host rows to "
                             "its device (host_client_slice)",
        "shard_host_local_data": "assembles a global array from process-local rows; one "
                                 "process a device holds its rows already",
        "shard_params": "device_put of params onto param_sharding; MeshLayout.shard_params "
                        "cuts the rank's shard",
        "ModelAxisLayout": "the JAX model-axis half of the layout; MeshLayout holds both "
                           "axes' layouts",
        "build_sharded_round": "shard_map of the round; build_round_step(mesh=) is the "
                               "rank's part of the round",
    },
}


def _jax_subpackages() -> list[str]:
    import pkgutil

    import nanofed_tpu

    return [""] + sorted(m.name for m in pkgutil.iter_modules(nanofed_tpu.__path__)
                         if m.ispkg)


@pytest.mark.parametrize("sub", _jax_subpackages(), ids=lambda s: s or "root")
def test_every_jax_export_is_exported_by_the_port(sub):
    """C5: for the root and every JAX subpackage with an ``__all__``, the JAX names less
    the stated list are all present in the port's package (``hasattr``), and every
    stated name really is exported by JAX and absent here."""
    import importlib

    theirs = importlib.import_module("nanofed_tpu" + (f".{sub}" if sub else ""))
    ours = importlib.import_module("nanofed_tpu_torch" + (f".{sub}" if sub else ""))
    stated = NO_TORCH_MEANING.get(sub, {})
    names = set(getattr(theirs, "__all__", ()))
    assert names, f"nanofed_tpu.{sub} has no __all__"
    assert set(stated) <= names and not any(hasattr(ours, n) for n in stated)
    assert sorted(n for n in names - set(stated) if not hasattr(ours, n)) == []
    assert all(len(reason) >= 15 for reason in stated.values())
    if not sub:
        assert ours.__version__ == theirs.__version__ == "0.4.0"


def test_the_ported_tree_helpers_match_jax():
    """The JAX ``tree_*`` helpers given a torch meaning on the port's flat params."""
    from nanofed_tpu import utils as jax_utils
    from nanofed_tpu_torch import utils

    rng = np.random.default_rng(0)
    a = {"a": {"w": rng.normal(size=(2, 3)).astype(np.float32)},
         "b": rng.normal(size=4).astype(np.float32)}
    b = jax.tree.map(lambda x: x * 0.5 + 1.0, a)
    ta, tb = flatten_with_names(a), flatten_with_names(b)
    ta, tb = ({k: torch.from_numpy(np.asarray(v)) for k, v in t.items()} for t in (ta, tb))

    def same(got, want):
        want = flatten_with_names(want) if isinstance(want, dict) else {"": want}
        got = got if isinstance(got, dict) else {"": got}
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6)

    same(utils.tree_add(ta, tb), jax_utils.tree_add(a, b))
    same(utils.tree_sub(ta, tb), jax_utils.tree_sub(a, b))
    same(utils.tree_scale(ta, 3.0), jax_utils.tree_scale(a, 3.0))
    same(utils.tree_where(False, ta, tb), jax_utils.tree_where(False, a, b))
    same(utils.tree_vdot(ta, tb), jax_utils.tree_vdot(a, b))
    same(utils.tree_global_norm(ta), jax_utils.tree_global_norm(a))
    same(utils.tree_zeros_like(ta), jax_utils.tree_zeros_like(a))
    flat, unravel_fn = utils.tree_ravel(ta)
    jflat, _ = jax_utils.tree_ravel(a)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert all(torch.equal(unravel_fn(flat)[k], ta[k]) for k in ta)
    assert utils.tree_cast(ta, torch.bfloat16)["b"].dtype == torch.bfloat16
    named, names = utils.tree_flatten_with_names(a)
    jnamed, _ = jax_utils.tree_flatten_with_names(a)
    assert names == [n for n, _ in jnamed] == [n for n, _ in named]
    mapped = utils.tree_map_with_path_names(lambda n, x: n, a)
    assert mapped == jax_utils.tree_map_with_path_names(lambda n, x: n, a)
