"""Frozen-base adapter rounds of the port against the JAX package's, on the CPU: the
round step (``parallel.round_step.FrozenBase``), the fused block, and the entry points
``Coordinator(adapter=)``, ``run_experiment(adapter_rank=)``, the command line and the
autotuner's rank axis (the port's counterpart of ``tests/unit/adapters/
test_adapter_round.py`` and ``tests/integration/test_adapter_federation.py``).

The JAX weights are carried across (``from_numpy_params``); adapters are bit-equal by
construction (a host numpy draw).  Tolerances: one round step 1e-5 (the JAX fit's own
permutations injected); a 3-round coordinator trajectory 1e-4 with single-batch
clients (a batch holds a client's whole data, so the permutation only reorders a
sum); the port against itself (chunked, fused, resumed) 1e-6."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu import adapters as jax_adapters
from nanofed_tpu.aggregation import base as jax_base
from nanofed_tpu.core.exceptions import NanoFedError as JaxNanoFedError
from nanofed_tpu.core.types import ClientData as JaxClientData
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_token_streams as jax_token_streams
from nanofed_tpu.experiments import run_experiment as jax_run_experiment
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.orchestration import Coordinator as JaxCoordinator
from nanofed_tpu.orchestration import CoordinatorConfig as JaxCoordinatorConfig
from nanofed_tpu.parallel.mesh import make_mesh
from nanofed_tpu.parallel.round_step import FrozenBase as JaxFrozenBase
from nanofed_tpu.parallel.round_step import build_round_step as jax_build_round_step
from nanofed_tpu.parallel.round_step import init_server_state as jax_init_server_state
from nanofed_tpu.persistence import FileStateStore as JaxFileStateStore
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.trainer.local import stack_rngs
from nanofed_tpu.tuning import TuningSpace as JaxTuningSpace
from nanofed_tpu_torch import cli, run_experiment
from nanofed_tpu_torch.adapters import AdapterSpec, make_adapter_apply, merge_adapters
from nanofed_tpu_torch.aggregation import fedavg_strategy
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.core.types import ClientData
from nanofed_tpu_torch.data import federate, pack_eval, synthetic_token_streams
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.observability import summarize_telemetry
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.parallel import (
    FrozenBase,
    build_round_block,
    build_round_step,
    init_server_state,
    round_seeds,
)
from nanofed_tpu_torch.persistence import FileStateStore, ModelManager
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.tuning import PopulationSpec, TuningSpace, autotune
from nanofed_tpu_torch.utils.trees import flatten_with_names, from_numpy_params, ravel

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-6, atol=1e-6)
DIMS = dict(vocab=64, seq_len=16, width=32, depth=2, heads=2)
C = 8


def jax_permutations(rngs, epochs, n):
    """The permutations the JAX local fit draws from each client's key."""
    def one(rng):
        keys = jax.random.split(rng, epochs)
        return jnp.stack([jax.random.permutation(jax.random.split(k)[0], n) for k in keys])
    return torch.from_numpy(np.stack([np.asarray(one(r)) for r in rngs]).astype(np.int64))


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_with_names(jax.device_get(tree)).items()}


@pytest.fixture(scope="module")
def step_setup():
    jm = jax_get_model("transformer_lm", **DIMS)
    base = jax.device_get(jm.init(jax.random.key(0)))
    spec = AdapterSpec(rank=4, alpha=8.0)
    jspec = jax_adapters.AdapterSpec(rank=4, alpha=8.0)
    jad = jax.device_get(jax_adapters.init_adapters(jspec, base, rng=1))
    cd = jax_federate(jax_token_streams(32 * C, vocab=DIMS["vocab"], seq_len=DIMS["seq_len"],
                                        seed=0), num_clients=C, batch_size=16)
    weights = np.asarray(cd.mask).sum(1) * np.asarray([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    rngs = stack_rngs(jax.random.key(2), C)
    training = dict(batch_size=16, local_epochs=1, learning_rate=0.3)
    return dict(jm=jm, base=base, spec=spec, jspec=jspec, jad=jad, cd=cd,
                weights=weights, rngs=rngs, training=training,
                perms=jax_permutations(rngs, 1, np.asarray(cd.y).shape[1]))


@pytest.fixture(scope="module")
def jax_step_result(step_setup):
    s = step_setup
    strategy = jax_base.fedavg_strategy()
    step = jax_build_round_step(
        s["jm"].apply, JaxTrainingConfig(**s["training"]), make_mesh(jax.devices()[:1]),
        strategy, params_like=s["jad"],
        frozen_base=JaxFrozenBase(base_like=s["base"], bind=lambda bf: jax_adapters.
                                  make_adapter_apply(s["jm"].apply, s["jspec"], bf)))
    data = JaxClientData(*(jnp.asarray(np.asarray(a)) for a in s["cd"]))
    return step(s["jad"], jax_init_server_state(strategy, s["jad"]), s["base"], data,
                jnp.asarray(s["weights"]), s["rngs"])


def _port_step(s, client_chunk=None):
    model = get_model("transformer_lm", **DIMS)
    spec = s["spec"]
    frozen = FrozenBase(base_like=None,
                        bind=lambda b: make_adapter_apply(model.apply, spec, b))
    step = build_round_step(model, TrainingConfig(**s["training"]), fedavg_strategy(),
                            client_chunk=client_chunk, frozen_base=frozen)
    ad = from_numpy_params(s["jad"], device="cpu")
    base = from_numpy_params(s["base"], device="cpu")
    base_before = {k: v.clone() for k, v in base.items()}
    out = step(ad, init_server_state(fedavg_strategy(), ad), base,
               ClientData(*s["cd"]).to(torch.device("cpu")), torch.from_numpy(s["weights"]),
               s["perms"])
    assert all(torch.equal(base[k], base_before[k]) for k in base)  # read only
    return out


@pytest.mark.parametrize("client_chunk", [None, 2], ids=["materialised", "chunked"])
def test_adapter_round_step_matches_jax(step_setup, jax_step_result, client_chunk):
    got = _port_step(step_setup, client_chunk)
    want = jax_step_result
    wp = _flat(want.params)
    assert list(got.params) == list(wp)
    for name, leaf in got.params.items():
        np.testing.assert_allclose(leaf.numpy(), wp[name], **STEP_TOL, err_msg=name)
    for key in ("loss", "accuracy", "samples", "participating_clients"):
        np.testing.assert_allclose(float(got.metrics[key]), float(want.metrics[key]),
                                   **STEP_TOL)
    np.testing.assert_allclose(got.update_sq_norms.numpy(),
                               np.asarray(want.update_sq_norms), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got.client_metrics.loss.numpy(),
                               np.asarray(want.client_metrics.loss), **STEP_TOL)
    assert float(got.metrics["participating_clients"]) == 7  # client 2 has weight 0


def test_frozen_base_refuses_a_custom_fit_as_jax(step_setup):
    model = get_model("transformer_lm", **DIMS)
    frozen = FrozenBase(None, lambda b: make_adapter_apply(model.apply, step_setup["spec"], b))
    with pytest.raises(ValueError) as got:
        build_round_step(model, TrainingConfig(), local_fit=lambda *a, **k: None,
                         frozen_base=frozen)
    with pytest.raises(ValueError) as want:
        jax_build_round_step(step_setup["jm"].apply, JaxTrainingConfig(),
                             make_mesh(jax.devices()[:1]), local_fit=lambda *a: None,
                             params_like=step_setup["jad"],
                             frozen_base=JaxFrozenBase(step_setup["base"], lambda bf: None))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="local_fit/grad_fn"):
        build_round_step(model, TrainingConfig(), grad_fn=lambda *a: None, frozen_base=frozen)


def test_fused_block_takes_the_base_and_equals_single_steps(step_setup):
    """A 2-round block with the base as its loop-invariant input equals two round
    steps from the same seeds; a block built with a frozen base refuses a call
    without one."""
    s = step_setup
    model = get_model("transformer_lm", **DIMS)
    frozen = FrozenBase(None, lambda b: make_adapter_apply(model.apply, s["spec"], b))
    training = TrainingConfig(**s["training"])
    block = build_round_block(model, training, fedavg_strategy(), num_clients=C,
                              frozen_base=frozen, device="cpu")
    step = build_round_step(model, training, fedavg_strategy(), frozen_base=frozen)
    ad = from_numpy_params(s["jad"], device="cpu")
    base = from_numpy_params(s["base"], device="cpu")
    data = ClientData(*s["cd"]).to(torch.device("cpu"))
    mask = torch.ones((2, C))
    out = block(ad, init_server_state(fedavg_strategy(), ad), data, data.mask.sum(1),
                round_seeds(0, [0, 1]), [1.0, 1.0], None, mask, base_params=base)
    from nanofed_tpu_torch.trainer import client_keys, draw_permutations

    p, sos = ad, init_server_state(fedavg_strategy(), ad)
    for seed in round_seeds(0, [0, 1]):
        gen = torch.Generator().manual_seed(seed)
        perms = draw_permutations(gen, C, 1, data.y.shape[1])
        r = step(p, sos, base, data, data.mask.sum(1), perms, client_keys(seed, C, "cpu"))
        p, sos = r.params, r.server_opt_state
    torch.testing.assert_close(ravel(out.params), ravel(p), **SELF_TOL)
    assert all(k.endswith(("/A", "/B")) for k in out.params)
    with pytest.raises(ValueError, match="base_params must be passed"):
        block(ad, init_server_state(fedavg_strategy(), ad), data, data.mask.sum(1),
              round_seeds(0, [0]), [1.0], None, mask[:1])


# --- the coordinator -------------------------------------------------------------

LM = dict(vocab=64, seq_len=16, width=32, depth=2, heads=2)
TRAIN = dict(batch_size=16, local_epochs=1, learning_rate=0.5)


def _jax_coord(tmp_path, rounds, **kw):
    cfg = {k: kw.pop(k) for k in ("participation_rate", "eval_every") if k in kw}
    return JaxCoordinator(
        model=jax_get_model("transformer_lm", **LM),
        train_data=jax_federate(jax_token_streams(16 * C, vocab=64, seq_len=16, seed=0),
                                num_clients=C, batch_size=16),
        config=JaxCoordinatorConfig(num_rounds=rounds, seed=3, base_dir=tmp_path, **cfg),
        training=JaxTrainingConfig(**TRAIN),
        adapter=jax_adapters.AdapterSpec(rank=4), **kw)


def _coord(tmp_path, rounds, jc=None, eval_data=False, **kw):
    """A port adapter coordinator of 8 single-batch clients (16 sequences each),
    starting from the JAX coordinator's base when ``jc`` is given."""
    cfg = {k: kw.pop(k) for k in ("participation_rate", "eval_every", "rounds_per_block",
                                  "save_metrics") if k in kw}
    coord = Coordinator(
        model=get_model("transformer_lm", **LM),
        train_data=federate(synthetic_token_streams(16 * C, vocab=64, seq_len=16, seed=0),
                            num_clients=C, batch_size=16),
        config=CoordinatorConfig(num_rounds=rounds, seed=3, base_dir=tmp_path, **cfg),
        training=TrainingConfig(**TRAIN),
        eval_data=(pack_eval(synthetic_token_streams(32, vocab=64, seq_len=16, seed=1), 16)
                   if eval_data else None),
        adapter=kw.pop("adapter", AdapterSpec(rank=4)), device="cpu", **kw)
    if jc is not None:
        coord.base_params = from_numpy_params(jax.device_get(jc._adapter_base_host),
                                              device="cpu")
    return coord


def test_coordinator_trajectory_matches_jax(tmp_path):
    """3 rounds, 50% cohorts from the same numpy stream: the adapters start bit-equal
    and end within 1e-4 of the JAX coordinator's, with the same metrics."""
    jc = _jax_coord(tmp_path / "jax", 3, participation_rate=0.5)
    tc = _coord(tmp_path / "port", 3, jc, participation_rate=0.5)
    start = _flat(jc.params)
    assert list(tc.params) == list(start)
    assert all(np.array_equal(tc.params[k].numpy(), start[k]) for k in start)
    jr, tr = jc.run(), tc.run()
    want = _flat(jc.params)
    for name, leaf in tc.params.items():
        np.testing.assert_allclose(leaf.numpy(), want[name], **RUN_TOL, err_msg=name)
    for j, t in zip(jr, tr):
        assert (t.round_id, t.status.name, t.num_clients) == (
            j.round_id, j.status.name, j.num_clients)
        assert t.agg_metrics.keys() == j.agg_metrics.keys()
        for key in j.agg_metrics:
            np.testing.assert_allclose(t.agg_metrics[key], j.agg_metrics[key], **RUN_TOL)


def test_chunked_coordinator_equals_materialised(tmp_path):
    a = _coord(tmp_path / "a", 2)
    b = _coord(tmp_path / "b", 2, client_chunk=4)
    a.run(), b.run()
    torch.testing.assert_close(ravel(b.params), ravel(a.params), **SELF_TOL)


def test_fused_coordinator_equals_single_rounds(tmp_path):
    fused = _coord(tmp_path / "f", 4, rounds_per_block=2)
    single = _coord(tmp_path / "s", 4)
    assert fused._round_block is not None
    calls = []
    block = fused._round_block
    fused._round_block = lambda *a, **k: calls.append(k) or block(*a, **k)
    fr, sr = fused.run(), single.run()
    assert len(calls) == 2 and all("base_params" in k for k in calls)
    torch.testing.assert_close(ravel(fused.params), ravel(single.params), **SELF_TOL)
    for f, s in zip(fr, sr):
        for key in s.agg_metrics:
            np.testing.assert_allclose(f.agg_metrics[key], s.agg_metrics[key], **SELF_TOL)


@pytest.mark.parametrize("kw", [dict(scaffold=True),
                                dict(local_fit=lambda *a, **k: None),
                                dict(grad_fn=lambda *a, **k: None)],
                         ids=["scaffold", "local_fit", "grad_fn"])
def test_coordinator_refusals_match_jax(tmp_path, kw):
    with pytest.raises(ValueError) as want:
        _jax_coord(tmp_path / "jax", 1, **kw)
    with pytest.raises(ValueError) as got:
        _coord(tmp_path / "port", 1, **kw)
    assert str(got.value) == str(want.value)


def test_jax_adapter_checkpoint_resumes_the_port(tmp_path):
    store = tmp_path / "store"
    jc = _jax_coord(tmp_path / "jax", 2, state_store=JaxFileStateStore(store))
    jc.run()
    tc = _coord(tmp_path / "port", 4, jc, state_store=FileStateStore(store))
    assert tc.current_round == 2
    want = _flat(jc.params)
    assert all(np.array_equal(tc.params[k].numpy(), want[k]) for k in want)
    assert [m.round_id for m in tc.run()] == [2, 3]


def test_port_adapter_checkpoint_resumes_jax(tmp_path):
    store = tmp_path / "store"
    tc = _coord(tmp_path / "port", 2, state_store=FileStateStore(store))
    tc.run()
    jc = _jax_coord(tmp_path / "jax", 4, state_store=JaxFileStateStore(store))
    assert jc.current_round == 2
    got = _flat(jc.params)
    assert list(got) == list(tc.params)
    assert all(np.array_equal(got[k], tc.params[k].numpy()) for k in got)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    whole = _coord(tmp_path / "whole", 4)
    whole.run()
    store = FileStateStore(tmp_path / "store")
    first = _coord(tmp_path / "first", 4, state_store=store)
    rounds = first.start_training()
    next(rounds), next(rounds)
    rounds.close()
    resumed = _coord(tmp_path / "again", 4, state_store=FileStateStore(tmp_path / "store"))
    assert resumed.current_round == 2
    resumed.run()
    torch.testing.assert_close(ravel(resumed.params), ravel(whole.params), **SELF_TOL)


def test_merged_params_and_the_versioned_model(tmp_path):
    """Round 0's merge is the base bit for bit; every merge is counted; versioned
    models hold MERGED params with the spec in their metadata, checkpoints the
    adapters; evaluation runs on the merge; telemetry carries the adapter record."""
    manager = ModelManager(tmp_path / "models")
    coord = _coord(tmp_path / "run", 2, eval_data=True, eval_every=1,
                   model_manager=manager, state_store=FileStateStore(tmp_path / "store"),
                   telemetry_dir=tmp_path / "tel")
    merged0 = coord.merged_params()
    assert list(merged0) == list(coord.base_params)
    assert all(torch.equal(merged0[k], coord.base_params[k]) for k in merged0)
    assert coord._merge_count == 1
    coord.run()
    assert coord._merge_count == 1 + 2 + 2  # evals and versioned models of 2 rounds
    params, version = manager.load_model()
    want = merge_adapters(coord.base_params, coord.params, coord.adapter)
    assert list(params) == list(want)
    for name in want:
        torch.testing.assert_close(params[name], want[name], rtol=0, atol=0)
    config = json.loads(open(version.config_path).read())
    assert config["metadata"]["adapter"] == AdapterSpec(rank=4).to_dict()
    restored = FileStateStore(tmp_path / "store").restore_latest()
    assert sorted(flatten_with_names(restored.params)) == sorted(coord.params)
    digest = summarize_telemetry(tmp_path / "tel" / "telemetry.jsonl")
    assert digest["adapter"]["rank"] == 4 and digest["adapter"]["merges"] == 5
    assert digest["adapter"]["adapter_params"] < digest["adapter"]["base_params"]
    assert coord.evaluate().keys() == {"loss", "accuracy"}


@pytest.mark.parametrize("rpb", [1, 2])
def test_programs_are_catalogued_under_the_jax_names(tmp_path, rpb):
    coord = _coord(tmp_path, 2, rounds_per_block=rpb)
    names = coord.program_catalog.names()
    assert "adapter_round_step" in names and ("adapter_round_block" in names) == (rpb > 1)
    before = ravel(coord.params).clone()
    reports = {r.program: r for r in coord.profile_programs()}
    assert reports["adapter_round_step"].attrs["adapter_rank"] == 4
    assert reports["adapter_round_step"].flops > 0
    assert torch.equal(ravel(coord.params), before)


# --- the runner, the command line and the autotuner --------------------------------

def test_run_experiment_adapter_summary_as_jax(tmp_path):
    kw = dict(model="transformer_lm", num_clients=4, num_rounds=1, local_epochs=1,
              batch_size=16, train_size=256, adapter_rank=2, adapter_alpha=4.0)
    ours = run_experiment(out_dir=tmp_path / "port", device="cpu", **kw)
    theirs = jax_run_experiment(out_dir=tmp_path / "jax", **kw)
    assert ours["adapter"].keys() == theirs["adapter"].keys()
    for key in ("rank", "alpha", "targets", "min_dim", "base_params", "adapter_params",
                "ratio", "merges"):
        assert ours["adapter"][key] == theirs["adapter"][key], key
    assert ours["rounds_completed"] == 1
    with pytest.raises(JaxNanoFedError) as want:
        jax_run_experiment(model="mlp", adapter_alpha=8.0, train_size=64)
    with pytest.raises(NanoFedError) as got:
        run_experiment(model="mlp", adapter_alpha=8.0, train_size=64, device="cpu")
    assert str(got.value) == str(want.value)


def test_cli_run_and_profile_take_the_adapter_flags(tmp_path, capsys):
    rc = cli.main(["run", "--model", "transformer_lm", "--clients", "4", "--rounds", "1",
                   "--epochs", "1", "--batch-size", "16", "--train-size", "256",
                   "--adapter-rank", "2", "--adapter-alpha", "4", "--out-dir",
                   str(tmp_path), "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["adapter"]["rank"], out["adapter"]["alpha"]) == (2, 4.0)
    rc = cli.main(["profile", "--model", "transformer_lm", "--clients", "4",
                   "--train-size", "64", "--batch-size", "16", "--rounds-per-block", "1",
                   "--adapter-rank", "2", "--device", "cpu", "--json"])
    assert rc == 0
    reports = json.loads(capsys.readouterr().out)
    assert [r["program"] for r in reports] == ["adapter_round_step"]  # no SCAFFOLD program


@pytest.mark.parametrize("rank", [1, 4, 8])
def test_rank_ladder_equals_jax(rank):
    pop = PopulationSpec(16, 32, (16,), x_dtype="int32")
    from nanofed_tpu.tuning import PopulationSpec as JaxPopulationSpec

    jpop = JaxPopulationSpec(16, 32, (16,), x_dtype="int32")
    ours = TuningSpace.default(pop, 1, 16, 4, adapter_rank=rank)
    theirs = JaxTuningSpace.default(jpop, 1, 16, 4, adapter_rank=rank)
    assert ours.adapter_ranks == theirs.adapter_ranks
    assert [c.to_dict() for c in ours.candidates()] == [c.to_dict()
                                                          for c in theirs.candidates()]


def test_autotune_sweeps_the_rank_axis_and_from_autotune_takes_the_winner(tmp_path):
    """``autotune(adapter=)`` profiles the frozen-base round at ranks 2, 4 and 8 with
    the chunk and batch pinned, prints the ``lora`` column, and
    ``Coordinator.from_autotune(adapter=)`` federates at the winner's rank."""
    from nanofed_tpu_torch.tuning import format_candidate_table

    cd = federate(synthetic_token_streams(16 * C, vocab=64, seq_len=16, seed=0),
                  num_clients=C, batch_size=16)
    model = get_model("transformer_lm", **LM)
    pop = PopulationSpec.from_client_data(cd)
    space = dataclasses.replace(TuningSpace.default(pop, 1, 16, 1, adapter_rank=4),
                                client_chunks=(None,), batch_sizes=(16,))
    res = autotune(model, pop, TrainingConfig(**TRAIN), space=space, cache_dir=None,
                   out_dir=None, adapter=AdapterSpec(rank=4), device="cpu",
                   include_epilogues=False)
    ranks = sorted(o.config.adapter_rank for o in res.outcomes if o.feasible)
    assert ranks == [2, 4, 8]
    assert "lora" in format_candidate_table(res)
    coord = Coordinator.from_autotune(
        model, cd, CoordinatorConfig(num_rounds=1, base_dir=tmp_path), TrainingConfig(**TRAIN),
        tuning_space=space, autotune_cache_dir=None, adapter=AdapterSpec(rank=4),
        device="cpu")
    assert coord.adapter.rank == coord.tuned_config["adapter_rank"]
    assert coord.params[next(iter(coord.params))].shape[-1] == coord.adapter.rank


@pytest.mark.cuda
def test_adapter_round_on_the_card_equals_the_cpu(step_setup):
    """On a GPU: the frozen-base round launches B1 normalised and B3 once each and
    agrees with the CPU within 1e-4; chip_smoke.py (v) runs the flagships."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: checks the adapter round's kernels on the card")
    from nanofed_tpu_torch import ops

    s = step_setup
    model = get_model("transformer_lm", **DIMS)
    frozen = FrozenBase(None, lambda b: make_adapter_apply(model.apply, s["spec"], b))
    step = build_round_step(model, TrainingConfig(**s["training"]), frozen_base=frozen)
    out = {}
    for dev in ("cuda", "cpu"):
        d = torch.device(dev)
        ad = from_numpy_params(s["jad"], device=dev)
        ops.reset_launch_counts()
        out[dev] = step(ad, init_server_state(fedavg_strategy(), ad),
                        from_numpy_params(s["base"], device=dev), ClientData(*s["cd"]).to(d),
                        torch.from_numpy(s["weights"]).to(d), s["perms"].to(d))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["weighted_mean_flat"] == 1 and counts["row_sq_norms"] == 1
    torch.testing.assert_close(ravel(out["cuda"].params).cpu(), ravel(out["cpu"].params),
                               rtol=1e-4, atol=1e-4)
