"""The port's heterogeneous fleet (``nanofed_tpu_torch.fleet``: profile, aggregate, wire,
gateway, tuning; ``TenantFootprint.for_fleet``; ``TuningSpace.for_fleet``) against the
JAX package's ``nanofed_tpu.fleet`` on the CPU, on the same inputs: numpy trees drawn
from seeds, the JAX base weights carried across with ``from_numpy_params``, an ``mlp``
and the ``tiny`` transformer, cohorts mixing ranks 4, 8 and 32.

Tolerances: profiles, population splits, wire sizing, footprints, the mix sweep and
``for_fleet`` ranks are equal; ``revive_adapters`` and ``pad_adapters_to_rank`` are
bit-equal (host numpy draws, float32 products by a scalar); both aggregation routes
agree with JAX's and with each other within 1e-6 (float32 sums in another order);
projected dense images ``scaling * A @ B`` within 1e-5 of the leaf's largest magnitude
(float64 SVDs from two LAPACKs, singular-vector signs free; raw factors are never
compared) and ``projection_error`` within 1e-6; the client state's residual norms
within 1e-6; gateway images and submit rows within 1e-6.  Codec bodies decode across
packages both ways, and q8/topk8 bodies are byte-equal (the zip headers' times aside).
The stated differences are pinned here: one factorization a leaf a publish shared by
every tier, and tier rows built on the gateway's device and copied into their ingest
slot."""

import dataclasses
import io
import zipfile

import jax
import numpy as np
import pytest
import torch

from nanofed_tpu import adapters as jax_adapters
from nanofed_tpu import fleet as jfleet
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.models.transformer import FLAGSHIP_CONFIGS
from nanofed_tpu.service.scheduler import TenantFootprint as JaxFootprint
from nanofed_tpu.tuning.autotuner import PopulationSpec as JaxPopulation
from nanofed_tpu.tuning.autotuner import TuningSpace as JaxSpace
from nanofed_tpu_torch import fleet
from nanofed_tpu_torch.adapters import AdapterSpec, adapter_delta, init_adapters
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.fleet import aggregate as port_aggregate
from nanofed_tpu_torch.ingest import DeviceIngestBuffer
from nanofed_tpu_torch.service.scheduler import TenantFootprint
from nanofed_tpu_torch.tuning.autotuner import PopulationSpec, TuningSpace
from nanofed_tpu_torch.utils.trees import (
    flatten_with_names,
    from_numpy_params,
    ravel,
    unflatten_names,
)

ROUTE_TOL = 1e-6
IMAGE_RTOL = 1e-5
ALPHA = 32.0  # the reference fleet's common alpha (its max rank)
RANKS = (4, 4, 8, 32)
WEIGHTS = (3.0, 1.0, 2.0, 5.0)
TIERS = ("phone", "phone", "edge", "silo")
TINY = dict(zip(("vocab", "seq_len", "width", "depth", "heads"), FLAGSHIP_CONFIGS["tiny"]))


@pytest.fixture(scope="module", params=["mlp", "tiny"])
def base(request):
    """(JAX base as a nested numpy tree, the same as port tensors)."""
    if request.param == "mlp":
        model = jax_get_model("mlp", in_features=48, hidden=64, num_classes=10)
    else:
        model = jax_get_model("transformer_lm", **TINY)
    jp = jax.device_get(model.init(jax.random.key(3)))
    return jp, from_numpy_params(jp, device="cpu")


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_with_names(tree).items()}


def _jspec(spec):
    return jax_adapters.AdapterSpec(rank=spec.rank, alpha=spec.alpha, targets=spec.targets,
                                    min_dim=spec.min_dim, init_scale=spec.init_scale)


def _trees(base_tree, rank, seed):
    """One rank-``rank`` adapter tree with nonzero A and B: (JAX nested, port flat)."""
    spec = AdapterSpec(rank=rank, alpha=ALPHA)
    pad = jax_adapters.init_adapters(_jspec(spec), base_tree, rng=seed)
    rng = np.random.default_rng(seed + 1000)
    jt = jax.tree.map(lambda x: np.asarray(x) + rng.normal(0, 0.02, np.shape(x))
                      .astype(np.float32), pad)
    return spec, jt, from_numpy_params(jt, device="cpu")


@pytest.fixture(scope="module")
def cohort(base):
    jp, pp = base
    out = []
    for i, (rank, weight, tier) in enumerate(zip(RANKS, WEIGHTS, TIERS)):
        spec, jt, pt = _trees(jp, rank, seed=i)
        out.append((jfleet.AdapterUpdate(_jspec(spec), jt, weight, tier),
                    fleet.AdapterUpdate(spec, pt, weight, tier)))
    return out


def _gap(port_tree, jax_tree):
    want = _flat(jax_tree)
    assert list(port_tree) == list(want)
    return max(float(np.abs(port_tree[k].numpy() - want[k]).max()) for k in want)


def _image(spec, base_like, tree):
    return {k: v.double() for k, v in adapter_delta(spec, base_like, tree).items()}


def _dead(tree):
    """Per A leaf, the indices of dead directions (zero A column and zero B row)."""
    out = {}
    for name, a in tree.items():
        if name.endswith("/A"):
            a = np.asarray(a)
            b = np.asarray(tree[name[:-2] + "/B"])
            out[name] = tuple(np.flatnonzero((np.abs(a).sum(0) == 0) & (np.abs(b).sum(1) == 0)))
    return out


# -- profile ------------------------------------------------------------------


def _custom(pkg):
    return pkg.FleetProfile(name="two", tiers=(
        pkg.DeviceTier(name="thin", fraction=0.9, adapter_rank=2, codec="topk8",
                       topk_fraction=0.1, availability=0.5),
        pkg.DeviceTier(name="fat", fraction=0.1, adapter_rank=16, codec="f32")))


@pytest.mark.parametrize("which", ["reference", "custom"])
def test_profiles_equal_jax(which):
    port = fleet.reference_fleet() if which == "reference" else _custom(fleet)
    ref = jfleet.reference_fleet() if which == "reference" else _custom(jfleet)
    assert port.to_dict() == ref.to_dict()
    assert fleet.FleetProfile.from_dict(ref.to_dict()) == port
    assert jfleet.FleetProfile.from_dict(port.to_dict()) == ref
    assert (port.max_rank, port.max_rank_tier.name) == (ref.max_rank, ref.max_rank_tier.name)
    assert [t.encoding for t in port.tiers] == [t.encoding for t in ref.tiers]
    assert fleet.CODEC_ENCODINGS == jfleet.CODEC_ENCODINGS
    assert {k: s.to_dict() for k, s in port.specs(min_dim=4).items()} == \
        {k: s.to_dict() for k, s in ref.specs(min_dim=4).items()}


@pytest.mark.parametrize("population", [3, 7, 24, 100, 1001])
def test_population_split_equals_jax(population):
    for port, ref in ((fleet.reference_fleet(), jfleet.reference_fleet()),
                      (_custom(fleet), _custom(jfleet))):
        if population < len(port.tiers):
            continue
        assert port.population_split(population) == ref.population_split(population)


@pytest.mark.parametrize("kwargs", [
    dict(name="", fraction=0.5), dict(name="a/b", fraction=0.5), dict(name="t", fraction=0),
    dict(name="t", fraction=0.5, adapter_rank=0), dict(name="t", fraction=0.5, codec="zip"),
    dict(name="t", fraction=0.5, batch_size=0), dict(name="t", fraction=0.5, arrival="x"),
    dict(name="t", fraction=0.5, arrival_rate=0), dict(name="t", fraction=0.5, availability=0),
    dict(name="t", fraction=0.5, local_steps=0), dict(name="t", fraction=0.5, topk_fraction=2),
])
def test_tier_validation_messages_equal_jax(kwargs):
    with pytest.raises(NanoFedError) as got:
        fleet.DeviceTier(**kwargs)
    with pytest.raises(Exception) as want:
        jfleet.DeviceTier(**kwargs)
    assert str(got.value) == str(want.value)


def test_profile_validation_messages_equal_jax():
    cases = [
        lambda pkg: pkg.FleetProfile(name="", tiers=()),
        lambda pkg: pkg.FleetProfile(name="p", tiers=()),
        lambda pkg: pkg.FleetProfile(name="p", tiers=(pkg.DeviceTier("a", 0.5),
                                                      pkg.DeviceTier("a", 0.5))),
        lambda pkg: pkg.FleetProfile(name="p", tiers=(pkg.DeviceTier("a", 0.5),)),
        lambda pkg: pkg.reference_fleet().tier("watch"),
        lambda pkg: pkg.reference_fleet().population_split(2),
    ]
    for case in cases:
        with pytest.raises(NanoFedError) as got:
            case(fleet)
        with pytest.raises(Exception) as want:
            case(jfleet)
        assert str(got.value) == str(want.value)


def test_wire_bytes_per_round_equals_jax(base):
    jp, pp = base
    for population in (24, 1000):
        assert fleet.reference_fleet().wire_bytes_per_round(pp, population) == \
            jfleet.reference_fleet().wire_bytes_per_round(jp, population)


# -- aggregation ----------------------------------------------------------------


def test_both_routes_equal_jax_and_each_other(base, cohort):
    jp, pp = base
    jax_updates = [j for j, _ in cohort]
    port_updates = [p for _, p in cohort]
    dense = fleet.aggregate_dense(port_updates, pp)
    padded = fleet.aggregate_padded(port_updates, pp)
    assert _gap(dense, jfleet.aggregate_dense(jax_updates, jp)) <= ROUTE_TOL
    assert _gap(padded, jfleet.aggregate_padded(jax_updates, jp)) <= ROUTE_TOL
    assert max(float((dense[k] - padded[k]).abs().max()) for k in dense) <= ROUTE_TOL
    over = fleet.aggregate_padded(port_updates, pp, pad_rank=64)
    assert max(float((dense[k] - over[k]).abs().max()) for k in dense) <= ROUTE_TOL


def test_aggregation_refusals_equal_jax(base, cohort):
    jp, pp = base
    cases = [
        (lambda: fleet.aggregate_dense([], pp), lambda: jfleet.aggregate_dense([], jp)),
        (lambda: fleet.aggregate_padded([], pp), lambda: jfleet.aggregate_padded([], jp)),
        (lambda: fleet.aggregate_padded([p for _, p in cohort], pp, pad_rank=4),
         lambda: jfleet.aggregate_padded([j for j, _ in cohort], jp, pad_rank=4)),
        (lambda: fleet.AdapterUpdate(AdapterSpec(rank=4), {}, weight=0.0),
         lambda: jfleet.AdapterUpdate(jax_adapters.AdapterSpec(rank=4), {}, weight=0.0)),
    ]
    for port_call, jax_call in cases:
        with pytest.raises(NanoFedError) as got:
            port_call()
        with pytest.raises(Exception) as want:
            jax_call()
        assert str(got.value) == str(want.value)
    narrow = AdapterSpec(rank=8, alpha=ALPHA, targets=("*fc1*", "*wq*"))
    mixed = [cohort[0][1], fleet.AdapterUpdate(narrow, init_adapters(narrow, pp, rng=1))]
    with pytest.raises(NanoFedError, match="same leaves"):
        fleet.aggregate_padded(mixed, pp)


def test_pad_adapters_to_rank_is_bit_equal_to_jax(base):
    jp, pp = base
    lo, hi = AdapterSpec(rank=4, alpha=ALPHA), AdapterSpec(rank=32, alpha=ALPHA)
    _, jt, pt = _trees(jp, 4, seed=5)
    padded = fleet.pad_adapters_to_rank(pt, lo, hi)
    assert _gap(padded, jfleet.pad_adapters_to_rank(jt, _jspec(lo), _jspec(hi))) == 0.0
    assert max(float((a - b).abs().max()) for a, b in zip(
        adapter_delta(lo, pp, pt).values(), adapter_delta(hi, pp, padded).values())) == 0.0
    with pytest.raises(NanoFedError, match="project_to_rank"):
        fleet.pad_adapters_to_rank(padded, hi, lo)


@pytest.mark.parametrize("rank", [4, 8, 32])
def test_project_to_rank_images_and_errors_equal_jax(base, cohort, rank):
    """Dense images of the projection within 1e-5 of each leaf's largest magnitude;
    ``projection_error`` within 1e-6; the achieved error is the SVD tail
    (Eckart–Young, as ``tests/unit/fleet/test_fleet_aggregate.py`` checks)."""
    jp, pp = base
    dense = fleet.aggregate_dense([p for _, p in cohort], pp)
    jdense = jfleet.aggregate_dense([j for j, _ in cohort], jp)
    spec = AdapterSpec(rank=rank, alpha=ALPHA)
    tree = fleet.project_to_rank(dense, spec, pp)
    jtree = from_numpy_params(jfleet.project_to_rank(jdense, _jspec(spec), jp), device="cpu")
    assert list(tree) == list(jtree)
    got, want = _image(spec, pp, tree), _image(spec, pp, jtree)
    for name in got:
        scale = float(dense[name].abs().max()) or 1.0
        assert float((got[name] - want[name]).abs().max()) <= IMAGE_RTOL * scale, name
    err = fleet.projection_error(dense, spec, pp)
    jerr = jfleet.projection_error(jdense, _jspec(spec), jp)
    assert err.keys() == jerr.keys()
    assert max(abs(err[k] - jerr[k]) for k in err) <= 1e-6
    for name in adapter_delta(spec, pp, tree):
        if name in err:
            m = dense[name].double()
            achieved = float(torch.linalg.norm(m - got[name]) / torch.linalg.norm(m))
            assert achieved == pytest.approx(err[name], abs=1e-5)


def test_revive_adapters_is_bit_equal_to_jax(base, cohort):
    """Round 0 (a zero delta: every direction dead) and a projection above the delta's
    true rank (its zero-padded tail dead): the revived trees equal JAX's bit for bit."""
    jp, pp = base
    spec = AdapterSpec(rank=32, alpha=ALPHA)
    zero = {k: torch.zeros_like(v) for k, v in pp.items()}
    jzero = jax.tree.map(np.zeros_like, jp)
    one = cohort[0]
    low = adapter_delta(one[1].spec, pp, one[1].adapters)
    jlow = jax_adapters.adapter_delta(one[0].spec, jp, one[0].adapters)
    for dense, jdense in ((zero, jzero), (low, jlow)):
        tree = fleet.project_to_rank(dense, spec, pp)
        jtree = jfleet.project_to_rank(jdense, _jspec(spec), jp)
        assert _dead(tree) == _dead(_flat(jtree))
        got = fleet.revive_adapters(tree, spec, seed=9)
        want = _flat(jfleet.revive_adapters(jtree, _jspec(spec), seed=9))
        for name in got:
            if name.endswith("/A"):
                dead = list(_dead(tree)[name])
                np.testing.assert_array_equal(got[name].numpy()[:, dead], want[name][:, dead])
        assert _dead(got) == _dead(want) == {k: () for k in _dead(got)}


def test_redistribute_factors_each_leaf_once_for_every_tier(base, cohort, monkeypatch):
    """Stated difference: one float64 factorization a leaf serves every tier; the
    views equal a factorization a tier (dense images, dead directions)."""
    jp, pp = base
    dense = fleet.aggregate_dense([p for _, p in cohort], pp)
    profile = fleet.reference_fleet()
    calls = []
    real = port_aggregate.factor_leaves
    monkeypatch.setattr(port_aggregate, "factor_leaves",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    shared = fleet.redistribute(dense, profile, pp)
    assert len(calls) == 1
    monkeypatch.setattr(port_aggregate, "factor_leaves", real)
    specs = profile.specs()
    jdense = jfleet.aggregate_dense([j for j, _ in cohort], jp)
    jtrees = jfleet.redistribute(jdense, jfleet.reference_fleet(), jp)
    for name, spec in specs.items():
        alone = fleet.project_to_rank(dense, spec, pp)
        for other in (alone, from_numpy_params(jtrees[name], device="cpu")):
            got, want = _image(spec, pp, shared[name]), _image(spec, pp, other)
            for leaf in got:
                scale = float(dense[leaf].abs().max()) or 1.0
                assert float((got[leaf] - want[leaf]).abs().max()) <= IMAGE_RTOL * scale
            assert _dead(shared[name]) == _dead(other)


# -- wire --------------------------------------------------------------------------


def _members(payload):
    with zipfile.ZipFile(io.BytesIO(payload)) as z:
        return [(info.filename, z.read(info)) for info in z.infolist()]


@pytest.mark.parametrize("tier_name", ["phone", "edge", "silo"])
def test_tier_bodies_decode_across_packages(base, tier_name):
    """Each package decodes the other's body into the same tree; q8 and topk8 bodies
    are byte-equal member by member (their zip times aside)."""
    jp, pp = base
    tier = fleet.reference_fleet().tier(tier_name)
    jtier = jfleet.reference_fleet().tier(tier_name)
    spec = fleet.reference_fleet().specs()[tier_name]
    jpub = jax_adapters.init_adapters(_jspec(spec), jp, rng=2)
    pub = from_numpy_params(jpub, device="cpu")
    rng = np.random.default_rng(11)
    jtrained = jax.tree.map(lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x))
                            .astype(np.float32), jpub)
    trained = from_numpy_params(jtrained, device="cpu")
    body = fleet.TierClientState(tier, spec, pub).encode(trained, seed=4)
    jbody = jfleet.TierClientState(jtier, _jspec(spec), jpub).encode(jtrained, seed=4)
    if tier.codec != "f32":
        assert _members(body) == _members(jbody)
    assert len(body) == len(jbody)
    ours = fleet.decode_tier_submit(tier, jbody, template=pub, published=pub)
    theirs = jfleet.decode_tier_submit(jtier, body, template=jpub, published=jpub)
    assert _gap(ours, theirs) == 0.0
    tol = {"silo": 0.0, "edge": 0.05}.get(tier_name)
    if tol is not None:  # topk8 drops its tail by design
        assert max(float((ours[k] - trained[k]).abs().max()) for k in ours) <= tol


def test_tier_client_state_sequence_matches_jax(base):
    """encode/commit/reject/retry/set_base on two phones and an edge box in both
    packages: the same bodies, residual norms within 1e-6, each client's residual its
    own (a rejected phone leaves the other phone and the edge box untouched)."""
    jp, pp = base
    profile, jprofile = fleet.reference_fleet(), jfleet.reference_fleet()
    specs = profile.specs()
    states, jstates, trees = {}, {}, {}
    for cid, tier_name in (("p0", "phone"), ("p1", "phone"), ("e0", "edge")):
        spec = specs[tier_name]
        jpub = jax_adapters.init_adapters(_jspec(spec), jp, rng=1)
        states[cid] = fleet.TierClientState(profile.tier(tier_name), spec,
                                            from_numpy_params(jpub, device="cpu"))
        jstates[cid] = jfleet.TierClientState(jprofile.tier(tier_name), _jspec(spec), jpub)
        trees[cid] = jpub

    def step(cid, seed, accept):
        rng = np.random.default_rng(seed)
        trees[cid] = jax.tree.map(lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x))
                                  .astype(np.float32), trees[cid])
        local = from_numpy_params(trees[cid], device="cpu")
        body = states[cid].encode(local, seed=seed)
        jbody = jstates[cid].encode(trees[cid], seed=seed)
        assert _members(body) == _members(jbody)
        if accept:
            states[cid].commit(), jstates[cid].commit()
        else:
            states[cid].reject(local), jstates[cid].reject(trees[cid])

    step("p0", 1, True)
    step("p1", 2, True)
    step("e0", 3, True)
    before = {cid: s.residual_norm() for cid, s in states.items()}
    step("p0", 4, False)  # rejected: the whole delta folds into p0's residual
    assert states["p1"].residual_norm() == before["p1"]
    assert states["e0"].residual_norm() == before["e0"] == 0.0
    assert states["p0"].residual_norm() > before["p0"] > 0.0
    step("p0", 5, True)  # the retry measures only the training after the fold
    jpub = jax_adapters.init_adapters(_jspec(specs["phone"]), jp, rng=6)
    states["p1"].set_base(from_numpy_params(jpub, device="cpu"))
    jstates["p1"].set_base(jpub)
    trees["p1"] = jpub
    step("p1", 7, True)
    for cid in states:
        assert abs(states[cid].residual_norm() - jstates[cid].residual_norm()) <= 1e-6
        assert (states[cid].bytes_sent, states[cid].submits) == \
            (jstates[cid].bytes_sent, jstates[cid].submits)
    with pytest.raises(NanoFedError, match="trains rank 4"):
        fleet.TierClientState(profile.tier("phone"), specs["edge"], {})


# -- gateway -------------------------------------------------------------------------


def _global(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(0, scale, np.shape(x))
                        .astype(np.float32), tree)


@pytest.fixture(scope="module")
def gateways(base):
    """Both packages' gateways after publishes of rounds 0-2 (window 1), and the port's
    factorization count a publish."""
    jp, pp = base
    port = fleet.FleetGateway(fleet.reference_fleet(), pp, revive_seed=5, device="cpu")
    ref = jfleet.FleetGateway(jfleet.reference_fleet(), jp, revive_seed=5)
    calls = []
    real = port_aggregate.factor_leaves
    fleet.gateway.factor_leaves = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        for r in range(3):
            jglobal = jp if r == 0 else _global(jp, r)
            ref.publish(r, jglobal, window=1)
            port.publish(r, from_numpy_params(jglobal, device="cpu"), window=1)
            if r == 0:
                round0 = (port.stats(), ref.stats(),
                          {t: (port.view(t).tree, _flat(ref.view(t).tree))
                           for t in port.specs})
    finally:
        fleet.gateway.factor_leaves = real
    return port, ref, calls, round0


def test_gateway_round_zero_views_are_bit_equal_to_jax(gateways):
    """At round 0 the global delta is zero: every direction is revived from the same
    host draws, so trees, payload sizes and stats equal JAX's exactly."""
    _, _, _, (stats, jstats, trees) = gateways
    assert stats == jstats
    for name, (got, want) in trees.items():
        assert list(got) == list(want)
        for leaf in got:
            np.testing.assert_array_equal(got[leaf].numpy(), want[leaf])


def test_gateway_views_equal_jax(base, gateways):
    jp, pp = base
    port, ref, calls, _ = gateways
    assert calls == [1, 1, 1]  # one factorization a publish, whatever the tier count
    assert sorted(port._views) == sorted(ref._views) == [1, 2]
    for tier, spec in port.specs.items():
        for r in (1, 2):
            view, jview = port.view(tier, r), ref.view(tier, r)
            jtree = from_numpy_params(jview.tree, device="cpu")
            assert _dead(view.tree) == _dead(jtree)
            np.testing.assert_allclose(view.flat_dense.numpy(), jview.flat_dense,
                                       rtol=0, atol=ROUTE_TOL)
            np.testing.assert_allclose(view.flat_dense.numpy(),
                                       ravel(adapter_delta(spec, pp, view.tree)).numpy(),
                                       rtol=0, atol=0)
            decoded = fleet.decode_tier_submit(fleet.reference_fleet().tier("silo"),
                                               view.payload, view.tree, view.tree)
            assert all(torch.equal(decoded[k], view.tree[k]) for k in decoded)
    assert port.stats()["live_rounds"] == ref.stats()["live_rounds"] == [1, 2]
    assert {t: {k: v for k, v in s.items() if k != "payload_bytes"}
            for t, s in port.stats()["tiers"].items()} == \
        {t: {k: v for k, v in s.items() if k != "payload_bytes"}
         for t, s in ref.stats()["tiers"].items()}
    for probe in (lambda g: g.view("phone", 0), lambda g: g.view("phone", 3),
                  lambda g: g.view("watch"), lambda g: g.spec("watch")):
        with pytest.raises(NanoFedError) as got:
            probe(port)
        with pytest.raises(Exception) as want:
            probe(ref)
        assert str(got.value) == str(want.value)


def test_gateway_views_equal_a_factorization_a_tier(base, gateways):
    """Stated difference: the shared factorization gives each tier the view a
    projection of its own would (images, dead directions)."""
    jp, pp = base
    port = gateways[0]
    jglobal = from_numpy_params(_global(jp, 2), device="cpu")
    dense = {k: jglobal[k] - pp[k] for k in pp}
    for tier, spec in port.specs.items():
        alone = fleet.revive_adapters(fleet.project_to_rank(dense, spec, pp), spec, seed=7)
        got = port.view(tier, 2).flat_dense
        want = ravel(adapter_delta(spec, pp, alone))
        assert float((got - want).abs().max()) <= IMAGE_RTOL * float(want.abs().max())
        projected = fleet.project_to_rank(dense, spec, pp)
        for name, dead in _dead(projected).items():
            dead = list(dead)
            assert torch.equal(port.view(tier, 2).tree[name][:, dead], alone[name][:, dead])


@pytest.mark.parametrize("tier_name", ["phone", "edge", "silo"])
def test_decode_submit_rows_equal_jax(base, gateways, tier_name):
    """A client of the port's server fetched the port's view: its body decodes into the
    row the JAX package's functions give on that view (``decode_tier_submit``,
    ``adapter_delta``, ``flatten_params``).  Views of the two packages may differ by
    singular-vector signs, so a delta body is only meaningful against the view its
    client fetched."""
    from nanofed_tpu.ingest.pipeline import flatten_params as jax_flatten

    jp, pp = base
    port, ref, _, _ = gateways
    view = port.view(tier_name, 2)
    jtree = {k: v.numpy() for k, v in view.tree.items()}
    jnested = unflatten_names(jtree)
    jspec = ref.spec(tier_name)
    state = jfleet.TierClientState(ref.profile.tier(tier_name), jspec, jnested)
    body = state.encode(_global(jnested, 13, scale=0.03), seed=1)
    row = port.decode_submit(tier_name, body, round_number=2)
    assert row.dtype == torch.float32 and row.shape == (port.flat_size,)
    decoded = jfleet.decode_tier_submit(ref.profile.tier(tier_name), body, template=jnested,
                                        published=jnested)
    want = (jax_flatten(jax_adapters.adapter_delta(jspec, jp, decoded))
            - jax_flatten(jax_adapters.adapter_delta(jspec, jp, jnested)))
    np.testing.assert_allclose(row.numpy(), want, rtol=0, atol=ROUTE_TOL)
    with pytest.raises(NanoFedError, match="no published fleet view"):
        port.decode_submit(tier_name, body, round_number=0)


def test_tier_rows_are_copied_into_their_ingest_slot(base, gateways):
    """Stated difference: a tensor row (what the gateway builds on its device) goes into
    its slot at once; the drain equals the staged host rows' drain."""
    jp, pp = base
    port = gateways[0]
    rows = [port.view(t, 2).flat_dense * (i + 1) for i, t in enumerate(port.specs)]
    direct = DeviceIngestBuffer(pp, 4, device="cpu")
    staged = DeviceIngestBuffer(pp, 4, device="cpu")
    for i, row in enumerate(rows):
        direct.offer(row, client_id=f"c{i}", round_number=2, weight=float(i + 1))
        staged.offer(row.numpy(), client_id=f"c{i}", round_number=2, weight=float(i + 1))
    assert direct._staged == {} and len(staged._staged) == len(rows)
    zero = np.zeros(port.flat_size, np.float32)
    assert torch.equal(direct.drain_fedavg(zero)[0], staged.drain_fedavg(zero)[0])
    with pytest.raises(ValueError, match="flat delta shape"):
        direct.offer(rows[0][:-1], client_id="x", round_number=2, weight=1.0)


# -- footprint, tuning space, mix sweep ------------------------------------------------


@pytest.mark.parametrize("capacity", [4, 64])
def test_fleet_footprint_equals_jax(base, capacity):
    jp, pp = base
    for port_profile, jax_profile in ((fleet.reference_fleet(), jfleet.reference_fleet()),
                                      (_custom(fleet), _custom(jfleet))):
        got = TenantFootprint.for_fleet(port_profile, pp, ingest_capacity=capacity, agg_k=6)
        want = JaxFootprint.for_fleet(jax_profile, jp, ingest_capacity=capacity, agg_k=6)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_tuning_space_for_fleet_equals_jax():
    pop = PopulationSpec(num_clients=40, capacity=64, sample_shape=(16,))
    jpop = JaxPopulation(num_clients=40, capacity=64, sample_shape=(16,))
    for port_profile, jax_profile in ((fleet.reference_fleet(), jfleet.reference_fleet()),
                                      (_custom(fleet), _custom(jfleet))):
        got = TuningSpace.for_fleet(port_profile, pop, 1, 16, 4, hosts=(1,))
        want = JaxSpace.for_fleet(jax_profile, jpop, 1, 16, 4, hosts=(1,))
        assert got.to_dict() == want.to_dict()
    assert got.adapter_ranks == (1, 2, 4, 8, 16, 32)
    assert TuningSpace.for_fleet(fleet.reference_fleet(), pop, 1, 16, 4, hosts=(1,)) \
        .adapter_ranks == (2, 4, 8, 16, 32, 64)


@pytest.mark.parametrize("budget", [None, 4 * 2**20, 2**30])
def test_mix_sweep_equals_jax(base, budget):
    jp, pp = base
    profile, jprofile = fleet.reference_fleet(), jfleet.reference_fleet()
    assert [c.to_dict() for c in fleet.mix_candidates(profile)] == \
        [c.to_dict() for c in jfleet.mix_candidates(jprofile)]
    cand = fleet.mix_candidates(profile)[5]
    jcand = jfleet.mix_candidates(jprofile)[5]
    assert fleet.profile_with_ranks(profile, cand).to_dict() == \
        jfleet.profile_with_ranks(jprofile, jcand).to_dict()
    costs = {2: 0.5, 4: 0.6, 8: 0.7, 16: 0.9, 32: 1.3, 64: 2.0}
    got = fleet.sweep_fleet_mix(profile, pp, 120, hbm_budget_bytes=budget, ingest_capacity=8,
                                step_costs=costs, device="cpu")
    want = jfleet.sweep_fleet_mix(jprofile, jp, 120, hbm_budget_bytes=budget,
                                  ingest_capacity=8, step_costs=costs)
    assert [o.to_dict() for o in got] == [o.to_dict() for o in want]
    assert [o.detail for o in got] == [o.detail for o in want]
