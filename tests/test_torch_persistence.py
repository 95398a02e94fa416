"""The port's persistence layer (``nanofed_tpu_torch/persistence``) on the CPU: the
cases of ``tests/unit/persistence/test_persistence.py`` on port params, and the files
of each package read by the other.

Tolerances: none.  Every cross-load is bit for bit (npz archives, pickled numpy
arrays and JSON sidecars store the values themselves), and so is every round trip.
Loading a JAX ``state.pkl`` runs in a subprocess in which ``jax``, ``optax`` and
``ml_dtypes`` cannot be imported, as on a machine that has none of them.
"""

import json
import pickle
import subprocess
import sys
import textwrap
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from nanofed_tpu import persistence as jp
from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu_torch.aggregation import base
from nanofed_tpu_torch.core.exceptions import CheckpointError, ModelManagerError, NanoFedError
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.persistence import (
    CheckpointMetadata,
    FileStateStore,
    ModelManager,
    SimpleRecoveryStrategy,
    is_recoverable,
    load_pytree_npz,
    load_state_pickle,
    save_pytree_npz,
    save_state_pickle,
)
from nanofed_tpu_torch.utils.trees import (
    flatten_with_names,
    from_numpy_server_state,
    ravel,
    to_numpy_params,
    to_numpy_server_state,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def params():
    model = get_model("mlp", in_features=4, hidden=8, num_classes=3)
    return model.init(torch.Generator().manual_seed(0))


def _equal(a, b):
    """Flat params equal bit for bit (same names, order, dtypes, values)."""
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype
        assert torch.equal(a[name].cpu(), b[name].cpu()), name


class TestSerialization:
    def test_npz_round_trip_exact(self, params, tmp_path):
        save_pytree_npz(tmp_path / "ckpt.npz", params)
        _equal(load_pytree_npz(tmp_path / "ckpt.npz", like=params), params)

    def test_load_without_template_gives_flat_params(self, tmp_path):
        save_pytree_npz(tmp_path / "ckpt.npz", {"layer/w": torch.ones(2, 2),
                                                 "layer/b": torch.zeros(2)})
        assert set(load_pytree_npz(tmp_path / "ckpt.npz")) == {"layer/w", "layer/b"}

    @pytest.mark.parametrize("load", [load_pytree_npz, load_state_pickle])
    def test_missing_file_raises(self, tmp_path, load):
        with pytest.raises(CheckpointError):
            load(tmp_path / "nope")

    @pytest.mark.parametrize("like", [{"w": torch.ones(3, 3)}, {"w": torch.ones(2, 2).double()},
                                      {"w": torch.ones(2, 2), "v": torch.ones(1)}],
                             ids=["shape", "dtype", "missing"])
    def test_template_mismatch_raises(self, tmp_path, like):
        save_pytree_npz(tmp_path / "ckpt.npz", {"w": torch.ones(2, 2)})
        with pytest.raises(CheckpointError):
            load_pytree_npz(tmp_path / "ckpt.npz", like=like)


class TestModelManager:
    def test_save_load_round_trip(self, params, tmp_path):
        mm = ModelManager(tmp_path)
        v = mm.save_model(params, metadata={"round": 3, "metrics": {"loss": 0.5}})
        assert v.version_id.startswith("model_v_")
        assert v.round_number == 3
        restored, version = mm.load_model(like=params)
        assert version.version_id == v.version_id
        _equal(restored, params)

    def test_load_latest_and_specific(self, params, tmp_path):
        mm = ModelManager(tmp_path)
        v1 = mm.save_model(params, metadata={"round": 0})
        v2 = mm.save_model({k: p + 1.0 for k, p in params.items()}, metadata={"round": 1})
        latest, version = mm.load_model(like=params)
        assert version.version_id == v2.version_id
        first, _ = mm.load_model(version_id=v1.version_id, like=params)
        _equal(first, params)
        _equal(latest, {k: p + 1.0 for k, p in params.items()})

    def test_list_versions_ordered(self, params, tmp_path):
        mm = ModelManager(tmp_path)
        ids = [mm.save_model(params, metadata={"round": i}).version_id for i in range(3)]
        assert [v.version_id for v in mm.list_versions()] == ids

    def test_counter_survives_new_manager(self, params, tmp_path):
        ModelManager(tmp_path).save_model(params)
        assert ModelManager(tmp_path).save_model(params).version_id.endswith("_0002")

    def test_load_empty_raises(self, tmp_path):
        with pytest.raises(ModelManagerError):
            ModelManager(tmp_path).load_model()

    @pytest.mark.parametrize("text", ["{}", "{torn", '{"version_id": "x", "created_at": 3}'])
    def test_torn_or_foreign_config_skipped_in_listing(self, params, tmp_path, text):
        mm = ModelManager(tmp_path)
        v = mm.save_model(params)
        (mm.configs_dir / "model_v_x_0099.json").write_text(text)
        assert [x.version_id for x in mm.list_versions()] == [v.version_id]
        assert mm.load_model(like=params)[1].version_id == v.version_id


class TestFileStateStore:
    def test_checkpoint_restore_round_trip(self, params, tmp_path):
        store = FileStateStore(tmp_path)
        state = to_numpy_server_state({"trace": ravel(params) * 0.5}, params)
        store.checkpoint(2, to_numpy_params(params), server_state=state, metrics={"loss": 0.1})
        restored = store.restore_latest()
        assert restored.round_number == 2
        assert restored.metadata.metrics["loss"] == 0.1
        assert set(flatten_with_names(restored.params)) == set(params)
        for name, leaf in flatten_with_names(restored.params).items():
            np.testing.assert_array_equal(leaf, params[name].numpy())
        got = from_numpy_server_state(restored.server_state, base.fedavgm_strategy(), params)
        assert torch.equal(got["trace"], ravel(params) * 0.5)

    def test_restore_latest_skips_failed(self, params, tmp_path):
        store = FileStateStore(tmp_path)
        store.checkpoint(0, to_numpy_params(params), status="COMPLETED")
        store.checkpoint(1, to_numpy_params(params), status="FAILED")
        assert store.restore_latest().round_number == 0
        metas = {m.round_number: m.status for m in store.list_checkpoints()}
        assert metas == {0: "COMPLETED", 1: "FAILED"}

    def test_restore_latest_empty_is_none(self, tmp_path):
        assert FileStateStore(tmp_path).restore_latest() is None

    def test_torn_checkpoint_ignored(self, params, tmp_path):
        store = FileStateStore(tmp_path)
        store.checkpoint(0, to_numpy_params(params))
        d = store.base_dir / "round_1"  # a crash mid-write: state without metadata
        d.mkdir()
        (d / "state.pkl").write_bytes(b"garbage")
        assert store.restore_latest().round_number == 0

    def test_prune_keeps_last_k(self, params, tmp_path):
        store = FileStateStore(tmp_path, keep_last=2)
        for r in range(5):
            store.checkpoint(r, to_numpy_params(params))
        assert [m.round_number for m in store.list_checkpoints()] == [3, 4]

    def test_prune_protects_last_completed(self, params, tmp_path):
        store = FileStateStore(tmp_path, keep_last=2)
        for r, status in enumerate(["COMPLETED", "FAILED", "FAILED"]):
            store.checkpoint(r, to_numpy_params(params), status=status)
        assert store.restore_latest().round_number == 0
        for r, status in enumerate(["COMPLETED", "FAILED", "FAILED"], start=3):
            store.checkpoint(r, to_numpy_params(params), status=status)
        rounds = [m.round_number for m in store.list_checkpoints()]
        assert 3 in rounds and 0 not in rounds
        assert store.restore_latest().round_number == 3

    def test_metadata_round_trip(self):
        m = CheckpointMetadata(round_number=7, status="FAILED", timestamp="t", metrics={"a": 1})
        assert CheckpointMetadata.from_dict(m.to_dict()) == m


class TestRecoveryPolicy:
    @pytest.mark.parametrize("exc,recoverable", [
        (TimeoutError(), True), (ConnectionError(), True), (RuntimeError(), True),
        (ValueError(), False), (NanoFedError("deterministic bug"), False),
    ])
    def test_recoverable_exceptions(self, exc, recoverable):
        assert is_recoverable(exc) is recoverable

    def test_strategy_respects_max_retries(self):
        s = SimpleRecoveryStrategy(max_retries=2)
        assert s.should_recover(TimeoutError(), attempt=0)
        assert s.should_recover(TimeoutError(), attempt=1)
        assert not s.should_recover(TimeoutError(), attempt=2)
        assert not s.should_recover(ValueError(), attempt=0)


# ----------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------

NESTED = {"fc1": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
                  "bias": np.full(4, -0.25, np.float32)},
          "emb": np.linspace(-2, 3, 6, dtype=np.float32).astype(ml_dtypes.bfloat16)}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_npz_cross_loads_with_a_bfloat16_leaf(tmp_path, direction):
    path = tmp_path / "p.npz"
    port = {name: (torch.from_numpy(leaf.view(np.uint16).copy()).view(torch.bfloat16)
                   if leaf.dtype == ml_dtypes.bfloat16 else torch.from_numpy(leaf))
            for name, leaf in flatten_with_names(NESTED).items()}
    if direction == "port_to_jax":
        save_pytree_npz(path, port)
        got = jp.load_pytree_npz(path, like=NESTED)
        for want, leaf in zip(jax.tree.leaves(NESTED), jax.tree.leaves(got)):
            assert leaf.dtype == want.dtype
            np.testing.assert_array_equal(leaf.view(np.uint8), want.view(np.uint8))
    else:
        jp.save_pytree_npz(path, NESTED)
        _equal(load_pytree_npz(path, like=port), port)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_model_manager_directories_cross_load(params, tmp_path, direction):
    """Each package lists and loads the other's versions and numbers its own past them."""
    nested = to_numpy_params(params)
    writer_port = direction == "port_to_jax"
    for r in range(2):
        if writer_port:
            ModelManager(tmp_path).save_model({k: p + r for k, p in params.items()},
                                              metadata={"round": r})
        else:
            jp.ModelManager(tmp_path).save_model(jax.tree.map(lambda a: a + r, nested),
                                                 metadata={"round": r})
    if writer_port:
        mm = jp.ModelManager(tmp_path)
        assert [v.round_number for v in mm.list_versions()] == [0, 1]
        latest, _ = mm.load_model(like=nested)
        jax.tree.map(np.testing.assert_array_equal, latest, jax.tree.map(lambda a: a + 1, nested))
        assert mm.save_model(nested, metadata={"round": 2}).version_id.endswith("_0003")
        assert [v.round_number for v in ModelManager(tmp_path).list_versions()] == [0, 1, 2]
    else:
        mm = ModelManager(tmp_path)
        assert [v.round_number for v in mm.list_versions()] == [0, 1]
        _equal(mm.load_model(like=params)[0], {k: p + 1 for k, p in params.items()})
        assert mm.save_model(params, metadata={"round": 2}).version_id.endswith("_0003")
        assert [v.round_number for v in jp.ModelManager(tmp_path).list_versions()] == [0, 1, 2]


# name: (JAX strategy, port strategy) with the same server optimizer.
SERVER_SCHEDULE = optax.cosine_decay_schedule(1.0, decay_steps=4, alpha=0.1)
def port_cosine(c: torch.Tensor) -> torch.Tensor:
    """``SERVER_SCHEDULE`` in torch ops on the 0-d count (the port's schedule contract:
    no read of the count on the host)."""
    t = torch.clamp(c, max=4).float()
    return 0.9 * (0.5 * (1 + torch.cos(torch.pi * t / 4))) + 0.1

CROSS_STRATEGIES = {
    "fedavg": (jax_base.fedavg_strategy, base.fedavg_strategy),
    "fedavgm": (jax_base.fedavgm_strategy, base.fedavgm_strategy),
    "fedadam": (jax_base.fedadam_strategy, base.fedadam_strategy),
    "fedyogi": (jax_base.fedyogi_strategy, base.fedyogi_strategy),
    "fedavgm_cosine": (lambda: jax_base.fedavgm_strategy(SERVER_SCHEDULE),
                       lambda: base.fedavgm_strategy(port_cosine)),
}


def _jax_state(name, nested, steps=2):
    """A JAX server state after ``steps`` updates of fixed pseudo-random gradients."""
    tx = CROSS_STRATEGIES[name][0]().server_tx
    state = tx.init(nested)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        grad = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), nested)
        _, state = tx.update(grad, state)
    return jax.tree.map(np.asarray, state)


def _port_state(name, params, steps=2):
    tx = CROSS_STRATEGIES[name][1]().server_tx
    state = tx.init(ravel(params))
    rng = np.random.default_rng(1)
    for _ in range(steps):
        _, state = tx.update(torch.from_numpy(
            rng.normal(size=ravel(params).numel()).astype(np.float32)), state)
    return state


@pytest.mark.parametrize("name", list(CROSS_STRATEGIES))
def test_port_state_pickle_loads_as_optax_in_jax(params, tmp_path, name):
    """What the port writes, the JAX package's plain ``pickle.load`` turns into real
    optax states, structured as ``server_tx.init(params)`` and holding the values."""
    nested = to_numpy_params(params)
    state = _port_state(name, params)
    save_state_pickle(tmp_path / "state.pkl", {
        "params": nested, "server_state": to_numpy_server_state(state, params)})
    got = jp.load_state_pickle(tmp_path / "state.pkl")
    init = CROSS_STRATEGIES[name][0]().server_tx.init(nested)
    assert jax.tree.structure(got["server_state"]) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(got["server_state"]), jax.tree.leaves(init)):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b)
    again = from_numpy_server_state(load_state_pickle(tmp_path / "state.pkl")["server_state"],
                                    CROSS_STRATEGIES[name][1](), params)
    assert set(again) == set(state)
    for key, value in state.items():
        assert torch.equal(again[key], value) if torch.is_tensor(value) else again[key] == value


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_state_store_directories_cross_load(params, tmp_path, direction):
    """A store written by one package is restored and extended by the other: the latest
    COMPLETED round, its params and its FedAvgM trace, bit for bit."""
    nested = to_numpy_params(params)
    jax_state = _jax_state("fedavgm", nested)
    if direction == "port_to_jax":
        store = FileStateStore(tmp_path)
        port_state = from_numpy_server_state(_pickled(tmp_path, jax_state), base.fedavgm_strategy(),
                                             params)
        store.checkpoint(0, nested, to_numpy_server_state(port_state, params), {"loss": 1.0})
        store.checkpoint(1, nested, status="FAILED")
        other = jp.FileStateStore(tmp_path)
        restored = other.restore_latest()
        assert restored.round_number == 0 and restored.metadata.metrics == {"loss": 1.0}
        jax.tree.map(np.testing.assert_array_equal, restored.server_state, jax_state)
        jax.tree.map(np.testing.assert_array_equal, restored.params, nested)
        other.checkpoint(2, nested, jax_state)
        assert FileStateStore(tmp_path).restore_latest().round_number == 2
    else:
        store = jp.FileStateStore(tmp_path)
        store.checkpoint(0, nested, jax_state, {"loss": 1.0})
        store.checkpoint(1, nested, status="FAILED")
        restored = FileStateStore(tmp_path).restore_latest()
        assert restored.round_number == 0 and restored.metadata.metrics == {"loss": 1.0}
        got = from_numpy_server_state(restored.server_state, base.fedavgm_strategy(), params)
        np.testing.assert_array_equal(
            got["trace"].numpy(),
            np.concatenate([a.ravel() for a in flatten_with_names(jax_state[0].trace).values()]))
        FileStateStore(tmp_path).checkpoint(2, nested, to_numpy_server_state(got, params))
        assert jp.FileStateStore(tmp_path).restore_latest().round_number == 2


def _pickled(tmp_path, state):
    """A JAX state as the port reads it from a checkpoint."""
    jp.save_state_pickle(tmp_path / "jax_state.pkl", state)
    return load_state_pickle(tmp_path / "jax_state.pkl")


# The subprocess: jax, optax and ml_dtypes cannot be imported, as on a machine without
# them.  It restores every JAX checkpoint under argv[1] with the port and writes what
# it read; a bfloat16 leaf and a foreign global must be refused.
_LOADER = textwrap.dedent("""
    import json, sys
    for blocked in ("jax", "jaxlib", "optax", "ml_dtypes"):
        sys.modules[blocked] = None
    from pathlib import Path
    import numpy as np, torch
    from nanofed_tpu_torch.aggregation import base
    from nanofed_tpu_torch.core.exceptions import CheckpointError
    from nanofed_tpu_torch.persistence import FileStateStore, load_state_pickle
    from nanofed_tpu_torch.utils.trees import from_checkpoint_params, from_numpy_server_state

    root = Path(sys.argv[1])
    strategies = {"fedavg": base.fedavg_strategy(), "fedavgm": base.fedavgm_strategy(),
                  "fedadam": base.fedadam_strategy(), "fedyogi": base.fedyogi_strategy(),
                  "fedavgm_cosine": base.fedavgm_strategy(lambda c: 1.0)}
    like = {k: torch.from_numpy(v) for k, v in np.load(root / "like.npz").items()}
    out, arrays = {}, {}
    for name, strategy in strategies.items():
        restored = FileStateStore(root / name).restore_latest()
        params = from_checkpoint_params(restored.params, like)
        state = from_numpy_server_state(restored.server_state, strategy, params)
        out[name] = {"round": restored.round_number,
                     "counts": {k: int(v) for k, v in state.items() if v.ndim == 0}}
        arrays.update({f"{name}.params.{k}": v.numpy() for k, v in params.items()})
        arrays.update({f"{name}.state.{k}": v.numpy() for k, v in state.items()
                       if v.ndim > 0})
    for case in ("bfloat16", "foreign"):
        try:
            load_state_pickle(root / f"{case}.pkl")
            out[case] = "loaded"
        except CheckpointError as e:
            out[case] = str(e)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "optax", "ml_dtypes", "nanofed_tpu")
                    and sys.modules[m] is not None)
    out["imported"] = leaked
    np.savez(root / "read.npz", **arrays)
    (root / "read.json").write_text(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_checkpoints_read_without_jax(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpts")
    model = get_model("mlp", in_features=4, hidden=8, num_classes=3)
    like = model.init(torch.Generator().manual_seed(0))
    np.savez(root / "like.npz", **{k: v.numpy() for k, v in like.items()})
    nested = jax.tree.map(lambda a: a * 2, to_numpy_params(like))
    written = {}
    for name in CROSS_STRATEGIES:
        state = _jax_state(name, nested)
        jp.FileStateStore(root / name).checkpoint(3, nested, state, {"loss": 0.5})
        written[name] = state
    jp.save_state_pickle(root / "bfloat16.pkl",
                         {"params": {"w": jnp.ones(3, jnp.bfloat16)}, "server_state": None})
    (root / "foreign.pkl").write_bytes(pickle.dumps({"params": OrderedDict(w=np.ones(2))}))
    proc = subprocess.run([sys.executable, "-c", _LOADER, str(root)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with np.load(root / "read.npz") as read:
        arrays = dict(read)
    return nested, written, json.loads((root / "read.json").read_text()), arrays


@pytest.mark.parametrize("name", list(CROSS_STRATEGIES))
def test_jax_state_pickle_loads_without_jax_optax_or_ml_dtypes(
        jax_checkpoints_read_without_jax, name):
    nested, written, read, arrays = jax_checkpoints_read_without_jax
    assert read["imported"] == []
    assert read[name]["round"] == 3
    for leaf_name, leaf in flatten_with_names(nested).items():
        np.testing.assert_array_equal(arrays[f"{name}.params.{leaf_name}"], leaf)
    transform, schedule = written[name]
    for field in ("trace", "mu", "nu"):
        if field in transform._fields:
            want = np.concatenate([a.ravel() for a in
                                   flatten_with_names(getattr(transform, field)).values()])
            np.testing.assert_array_equal(arrays[f"{name}.state.{field}"], want)
    counts = {}
    if "count" in transform._fields:
        counts["count"] = int(transform.count)
    if "count" in schedule._fields:
        counts["schedule_count"] = int(schedule.count)
    assert read[name]["counts"] == counts


@pytest.mark.parametrize("case,names", [("bfloat16", "ml_dtypes"),
                                        ("foreign", "collections.OrderedDict")])
def test_state_pickle_refuses_what_it_cannot_read_safely(jax_checkpoints_read_without_jax,
                                                         case, names):
    """A bfloat16 leaf in a pickle names ml_dtypes: refused with a CheckpointError (not
    read); so is any global a round state never holds."""
    read = jax_checkpoints_read_without_jax[2]
    assert names in read[case] and "loaded" != read[case]
