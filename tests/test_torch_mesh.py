"""The port's mesh arithmetic (``parallel.mesh``) against the JAX package's, with no
processes: the shape validators and their errors, ``param_partition_spec`` for every
leaf of ``mnist_cnn``, ``resnet8`` and a 2-layer ``transformer_lm`` at 2 and 4 model
shards, ``pad_client_count``, each rank's client rows and its host row's range on the
(2, 2, 2), (4, 2) and (2, 4, 1) meshes (held against the JAX client sharding's blocks
over the conftest's 8 virtual CPU devices), and the coordinator's host-local cohort
draws.  Then the launcher (``parallel.launch.spawn_world``): a rank that raises fails
its world with its traceback, a rank that hangs is killed at the world's deadline,
and ``initialize_distributed`` refuses what it must."""

import time

import jax
import numpy as np
import pytest
import torch
import torch_world_ranks as W
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.parallel import mesh as jax_mesh
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.parallel import mesh
from nanofed_tpu_torch.parallel.launch import spawn_world
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.utils.trees import flatten_with_names


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("model_shards,n_devices", [
    (1, 4), (2, 4), (4, 4), (3, 4), (0, 4), (2, 1), (8, 8),
])
def test_mesh_shape_for_model_shards_equals_jax(model_shards, n_devices):
    assert (_outcome(mesh.mesh_shape_for_model_shards, model_shards, n_devices)
            == _outcome(jax_mesh.mesh_shape_for_model_shards, model_shards, n_devices))


@pytest.mark.parametrize("hosts,model_shards,n_devices", [
    (1, 1, 4), (2, 1, 4), (2, 2, 8), (4, 1, 4), (3, 1, 4), (0, 1, 4), (2, 0, 4),
    (2, 3, 8), (1, 2, 1), (2, 1, 1),
])
def test_mesh_shape_for_topology_equals_jax(hosts, model_shards, n_devices):
    assert (_outcome(mesh.mesh_shape_for_topology, hosts, model_shards, n_devices)
            == _outcome(jax_mesh.mesh_shape_for_topology, hosts, model_shards, n_devices))


def test_make_mesh_without_a_world_is_one_rank_and_checks_the_shape():
    m = mesh.make_mesh(device="cpu")
    assert (m.shape, m.dims, m.world_size, m.groups) == ((1,), (1, 1, 1), 1, {})
    x = torch.arange(3.0)
    layout = mesh.MeshLayout(m)
    assert layout.client_psum(x) is x and layout.client_all_gather(x) is x
    for shape, error in (((2, 2), "needs 4 devices but 1 are available"),
                         ((0,), "must be positive"), ((1, 1, 1, 1), "must be")):
        with pytest.raises(ValueError, match=error):
            mesh.make_mesh(shape, device="cpu")


def _port_leaves(name, **kw):
    params = get_model(name, **kw).init(torch.Generator().manual_seed(0))
    return {k: tuple(v.shape) for k, v in params.items()}


def _jax_leaves(name, **kw):
    params = jax.eval_shape(jax_get_model(name, **kw).init, jax.random.key(0))
    return {k: tuple(v.shape) for k, v in flatten_with_names(params).items()}


@pytest.mark.parametrize("name,kw", [
    ("mnist_cnn", {}), ("resnet8", {}),
    ("transformer_lm", dict(vocab=256, seq_len=32, width=64, depth=2, heads=4)),
])
@pytest.mark.parametrize("shards", [2, 4])
def test_param_partition_spec_equals_jax_for_every_leaf(name, kw, shards):
    port, ref = _port_leaves(name, **kw), _jax_leaves(name, **kw)
    assert port == ref
    for leaf, shape in port.items():
        want = tuple(jax_mesh.param_partition_spec(shape, shards))
        assert mesh.param_partition_spec(shape, shards) == want, leaf


@pytest.mark.parametrize("num_clients,n_devices", [(8, 4), (10, 4), (1, 8), (1000, 4),
                                                   (7, 1), (0, 3)])
def test_pad_client_count_equals_jax(num_clients, n_devices):
    assert (mesh.pad_client_count(num_clients, n_devices)
            == jax_mesh.pad_client_count(num_clients, n_devices))


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2), (2, 4, 1)])
def test_client_rows_equal_the_jax_client_sharding(shape):
    """Rank r (row-major over (hosts, clients, model), as the JAX mesh reshapes its
    device list) holds the block the JAX client sharding gives device r; its host row's
    range is the union of its host row's devices' blocks (what JAX's
    ``host_client_slice`` gives a process holding one host row)."""
    padded = 16
    jm = jax_mesh.make_mesh(jax.devices(), shape=shape)
    sharding = NamedSharding(jm, P(jax_mesh.client_axes(jm)))
    blocks = {d.id: (idx[0].start or 0, idx[0].stop or padded)
              for d, idx in sharding.devices_indices_map((padded,)).items()}
    per_host = 8 // (shape[0] if len(shape) == 3 else 1)
    for rank in range(8):
        m = mesh.Mesh.describe(shape, rank)
        assert mesh.client_slice(padded, m) == blocks[rank]
        host = [blocks[r] for r in range(8) if r // per_host == rank // per_host]
        assert mesh.host_client_slice(padded, m) == (min(b[0] for b in host),
                                                     max(b[1] for b in host))


@pytest.mark.parametrize("num_clients,participation,dropout", [
    (8, 0.5, 0.0), (10, 0.5, 0.3), (10, 0.3, 0.0), (12, 0.75, 0.2),
])
def test_host_local_cohort_draws_equal_jax(tmp_path, num_clients, participation, dropout):
    """The stratified per-host draws of a (2, 2, 1) coordinator, round for round,
    including a last host with fewer real clients (padding) and dropouts."""
    cfg = dict(participation_rate=participation, dropout_rate=dropout, seed=11,
               save_metrics=False, num_rounds=6)
    jc = JaxCoordinator(
        model=jax_get_model("linear", in_features=10, num_classes=2),
        train_data=jax_federate(jax_synthetic(num_clients * 8, 2, (10,), seed=0),
                                num_clients, batch_size=8),
        config=JaxCoordinatorConfig(base_dir=tmp_path / "jax", **cfg),
        training=JaxTrainingConfig(batch_size=8),
        mesh=jax_mesh.make_mesh(jax.devices()[:4], shape=(2, 2, 1)), strict=False)
    tc = Coordinator(
        get_model("linear", in_features=10, num_classes=2),
        federate(synthetic_classification(num_clients * 8, 2, (10,), seed=0), num_clients,
                 batch_size=8),
        CoordinatorConfig(base_dir=tmp_path / "torch", **cfg),
        training=TrainingConfig(batch_size=8), device="cpu",
        mesh=mesh.Mesh.describe((2, 2, 1), 0))
    assert (tc._step_clients, tc._padded_clients) == (jc._step_clients, jc._padded_clients)
    for r in range(6):
        survived = tc._sample_cohort(r)
        np.testing.assert_array_equal(survived, jc._sample_cohort(r))
        for got, want in zip(tc._place_cohort(survived), jc._place_cohort(survived)):
            np.testing.assert_array_equal(got, want)


def test_a_rank_that_raises_fails_its_world_with_the_traceback():
    with pytest.raises(RuntimeError, match="(?s)of a world of 2 failed.*--- rank 1:.*rank one fails"):
        spawn_world(W.fail_on_rank_one, 2, backend="gloo", device="cpu", timeout_s=60)


def test_a_rank_that_hangs_is_killed_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of a world of 2 did not finish"):
        spawn_world(W.hang_on_rank_one, 2, backend="gloo", device="cpu", timeout_s=6)
    assert time.monotonic() - t0 < 6 + 15  # the deadline, then the kills


def test_initialize_distributed_refuses_what_it_must(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialize_distributed("gloo") == {"process_index": 0, "process_count": 1}
    with pytest.raises(ValueError, match="no rendezvous address"):
        mesh.initialize_distributed("gloo", world_size=2, rank=0)
    with pytest.raises(ValueError, match="backend must be one of"):
        mesh.initialize_distributed("mpi", init_method="file:///nowhere", world_size=1,
                                    rank=0)
    with pytest.raises(ValueError, match="the CPU needs 'gloo'"):
        mesh.initialize_distributed("nccl", init_method="file:///nowhere", world_size=1,
                                    rank=0, device="cpu")
