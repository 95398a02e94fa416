"""The port's LoRA adapter algebra (``nanofed_tpu_torch.adapters``) against the JAX
package's, on the CPU (the port's counterpart of ``tests/unit/adapters/test_lora.py``
and ``tests/unit/communication/test_adapter_codec.py``).

``init_adapters`` with an int seed is a host numpy draw in both packages and must be
bit-equal; merge, unmerge and the dense delta agree within 1e-6 (float32 products of
rank r summed in another order); ``target_paths`` and the counts are equal; the q8 and
topk8 payloads of an adapter-shaped delta are byte-equal to the JAX codec's (the zip
headers' times aside)."""

import io
import zipfile

import jax
import numpy as np
import pytest
import torch

from nanofed_tpu import adapters as jax_adapters
from nanofed_tpu.adapters import evidence as jax_evidence
from nanofed_tpu.communication import codec as jax_codec
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu_torch import adapters
from nanofed_tpu_torch.adapters import AdapterSpec, evidence
from nanofed_tpu_torch.communication import codec
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.models import transformer
from nanofed_tpu_torch.utils.trees import flatten_with_names, from_numpy_params, unflatten_names

TOL = dict(rtol=1e-6, atol=1e-6)
DIMS = dict(vocab=256, seq_len=32, width=64, depth=2, heads=4)


@pytest.fixture(scope="module", params=[False, True], ids=["unrolled", "scan"])
def base(request):
    """(JAX base tree as numpy, the same as port tensors, the port model)."""
    scan = request.param
    jp = jax.device_get(jax_get_model("transformer_lm", scan_layers=scan, **DIMS).init(
        jax.random.key(1)))
    return jp, from_numpy_params(jp, device="cpu"), get_model("transformer_lm",
                                                              scan_layers=scan, **DIMS)


def _jax_spec(spec):
    return jax_adapters.AdapterSpec(rank=spec.rank, alpha=spec.alpha, targets=spec.targets,
                                    min_dim=spec.min_dim, init_scale=spec.init_scale)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_with_names(tree).items()}


def _bumped(ad, seed=0):
    """Adapters with a nonzero B (and A moved), the same values for both packages."""
    rng = np.random.default_rng(seed)
    return {k: v + torch.from_numpy(rng.normal(0, 0.05, tuple(v.shape)).astype(np.float32))
            for k, v in ad.items()}


SPECS = [AdapterSpec(rank=4), AdapterSpec(rank=8, alpha=2.0),
         AdapterSpec(rank=2, targets=("*attn*kernel",), min_dim=16, init_scale=0.1)]


@pytest.mark.parametrize("spec", SPECS, ids=["r4", "r8_alpha2", "r2_attn"])
def test_init_adapters_is_bit_equal(base, spec):
    jp, pp, _ = base
    want = _flat(jax_adapters.init_adapters(_jax_spec(spec), jp, rng=7))
    got = adapters.init_adapters(spec, pp, rng=7)
    assert list(got) == list(want)
    for name, leaf in got.items():
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want[name], err_msg=name)
    assert all(not bool(got[k].any()) for k in got if k.endswith("/B"))


@pytest.mark.parametrize("spec", SPECS, ids=["r4", "r8_alpha2", "r2_attn"])
def test_target_paths_and_counts_equal_jax(base, spec):
    jp, pp, _ = base
    js = _jax_spec(spec)
    assert adapters.target_paths(spec, pp) == jax_adapters.target_paths(js, jp)
    assert adapters.adapter_param_count(spec, pp) == jax_adapters.adapter_param_count(js, jp)
    assert adapters.adapter_wire_ratio(spec, pp) == pytest.approx(
        jax_adapters.adapter_wire_ratio(js, jp))
    # Shapes alone give the same answers (the flagships are counted that way).
    shapes = {k: tuple(v.shape) for k, v in pp.items()}
    assert adapters.adapter_param_count(spec, shapes) == adapters.adapter_param_count(spec, pp)


@pytest.mark.parametrize("spec", SPECS[:2], ids=["r4", "r8_alpha2"])
def test_merge_unmerge_and_delta_match_jax(base, spec):
    jp, pp, _ = base
    js = _jax_spec(spec)
    ad = _bumped(adapters.init_adapters(spec, pp, rng=3))
    jad = unflatten_names({k: v.numpy() for k, v in ad.items()})
    for ours, theirs in (
        (adapters.merge_adapters(pp, ad, spec), jax_adapters.merge_adapters(jp, jad, js)),
        (adapters.unmerge_adapters(pp, ad, spec), jax_adapters.unmerge_adapters(jp, jad, js)),
        (adapters.adapter_delta(spec, pp, ad), jax_adapters.adapter_delta(js, jp, jad)),
    ):
        want = _flat(jax.device_get(theirs))
        assert list(ours) == list(want)
        for name, leaf in ours.items():
            np.testing.assert_allclose(leaf.numpy(), want[name], **TOL, err_msg=name)
    back = adapters.unmerge_adapters(adapters.merge_adapters(pp, ad, spec), ad, spec)
    for name in pp:
        torch.testing.assert_close(back[name], pp[name], rtol=1e-5, atol=1e-5)


def test_identity_start_and_stacked_per_layer_delta():
    """B = 0 merges to the base bit for bit; a stacked [L, d, d] kernel adapts per
    layer: its delta is the per-layer product, and the scan and unrolled trees count
    the same trainable parameters."""
    spec = AdapterSpec(rank=2)
    unrolled = get_model("transformer_lm", **{**DIMS, "depth": 3}).init(
        torch.Generator().manual_seed(0))
    stacked = transformer.stack_blocks(unrolled)
    ad = adapters.init_adapters(spec, stacked, rng=0)
    assert ad["blocks/attn/wq/kernel/A"].shape == (3, 64, 2)
    assert ad["blocks/attn/wq/kernel/B"].shape == (3, 2, 64)
    merged = adapters.merge_adapters(stacked, ad, spec)
    assert all(torch.equal(merged[k], stacked[k]) for k in stacked)
    assert (adapters.adapter_param_count(spec, stacked)
            == adapters.adapter_param_count(spec, unrolled))
    bumped = _bumped(ad)
    delta = adapters.adapter_delta(spec, stacked, bumped)["blocks/attn/wq/kernel"]
    a, b = bumped["blocks/attn/wq/kernel/A"], bumped["blocks/attn/wq/kernel/B"]
    for layer in range(3):
        torch.testing.assert_close(delta[layer], a[layer] @ b[layer], **TOL)


def test_make_adapter_apply_is_apply_of_the_merge(base):
    _, pp, model = base
    spec = AdapterSpec(rank=4)
    ad = _bumped(adapters.init_adapters(spec, pp, rng=0))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 32)))
    bound = adapters.make_adapter_apply(model.apply, spec, pp)
    torch.testing.assert_close(bound(ad, x),
                               model.apply(adapters.merge_adapters(pp, ad, spec), x),
                               rtol=0, atol=0)
    # Gradients reach A and B through the merge, none the base.
    grads = torch.func.grad(lambda a: bound(a, x)[:, 0].sum())(ad)
    assert set(grads) == set(ad) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert any(bool(g.any()) for k, g in grads.items() if k.endswith("/A"))


def test_spec_refusals_and_dict_equal_jax(base):
    jp, pp, _ = base
    for kw in (dict(rank=0), dict(alpha=0.0), dict(min_dim=0), dict(targets=())):
        with pytest.raises(Exception) as want:
            jax_adapters.AdapterSpec(**kw)
        with pytest.raises(NanoFedError) as got:
            AdapterSpec(**kw)
        assert str(got.value) == str(want.value)
    spec = AdapterSpec(rank=4, alpha=6.0)
    assert spec.to_dict() == _jax_spec(spec).to_dict() and spec.scaling == 1.5
    with pytest.raises(NanoFedError, match="matches no leaf"):
        adapters.target_paths(AdapterSpec(targets=("*nonexistent*",)), pp)
    with pytest.raises(TypeError, match="int seed"):
        adapters.init_adapters(spec, pp, rng=torch.Generator())


def _members(payload):
    with zipfile.ZipFile(io.BytesIO(payload)) as z:
        return [(info.filename, z.read(info)) for info in z.infolist()]


def _without_times(payload):
    """The payload with every zip header's DOS time and date zeroed."""
    out = bytearray(payload)
    for sig, offset in ((b"PK\x03\x04", 10), (b"PK\x01\x02", 12)):
        start = 0
        while (i := out.find(sig, start)) >= 0:
            out[i + offset:i + offset + 4] = b"\0\0\0\0"
            start = i + 4
    return bytes(out)


@pytest.fixture(scope="module")
def adapter_delta_trees():
    """An adapter-shaped delta as ``test_adapter_codec.py`` builds it: rank-4 adapters
    of a width-128, vocab-1024 transformer plus seeded N(0, 0.01) noise, as the JAX
    nested tree and the port's flat dict."""
    jp = jax_get_model("transformer_lm", vocab=1024, seq_len=8, width=128, depth=2,
                       heads=4).init(jax.random.key(0))
    ad = jax_adapters.init_adapters(jax_adapters.AdapterSpec(rank=4), jp, rng=0)
    rng = np.random.default_rng(42)
    jtree = jax.tree.map(lambda x: np.asarray(x) + rng.normal(0, 0.01, x.shape).astype(
        np.float32), ad)
    return jtree, from_numpy_params(jtree, device="cpu")


@pytest.mark.parametrize("encoding", ["q8", "topk8"])
def test_adapter_delta_payloads_are_byte_equal(adapter_delta_trees, encoding):
    jtree, ours = adapter_delta_trees
    if encoding == "q8":
        got, want = codec.encode_delta_q8(ours, seed=5), jax_codec.encode_delta_q8(jtree, seed=5)
    else:
        got = codec.encode_delta_topk8(ours, fraction=0.05, seed=5)
        want = jax_codec.encode_delta_topk8(jtree, fraction=0.05, seed=5)
    assert _members(got) == _members(want)
    assert _without_times(got) == _without_times(want)


def test_measure_wire_bytes_equals_jax(adapter_delta_trees):
    """The same dense and adapter deltas through both packages' measurement."""
    jtree, ours = adapter_delta_trees
    rng = np.random.default_rng(1)
    jdense = {"fc": {"kernel": rng.normal(0, 0.01, (512, 256)).astype(np.float32)}}
    got = evidence.measure_wire_bytes(None, from_numpy_params(jdense, device="cpu"), ours)
    want = jax_evidence.measure_wire_bytes(None, jdense, jtree)
    assert got == want
    assert got["q8_reduction"] > 1.0


def test_flagship_memory_sweep_on_tiny_configs():
    """The sweep's shape on the CPU at the smallest configurations: the replicated
    dense and adapter rounds run, the model-sharded layouts are rejected (one
    device), and no memory budget applies off the card."""
    out = evidence.flagship_memory_sweep("tiny", rank=4, frontier_name="tiny", device="cpu")
    cands = out["candidates"]
    assert cands["dense_replicated"]["feasible"] and cands["adapter_replicated_base"]["feasible"]
    assert not cands["dense_fsdp_m2_stream"]["feasible"]
    assert cands["adapter_replicated_base"]["config"]["adapter_rank"] == 4
    assert out["fits_one_card"] and out["memory_bytes"] is None
    assert out["config"]["params"] == transformer.transformer_param_count(256, 32, 64, 2)
    assert out["adapter_counts"]["ratio"] > 1


def test_generate_adapter_evidence_writes_the_artifact(tmp_path, monkeypatch):
    """The evidence artifact at a cut size (2 clients, 2 rounds, no flagship sweep, the
    ``evidence`` geometry narrowed: no check here depends on its width): its keys are
    the JAX artifact's less the JAX environment's, the run was strict as the JAX
    one is, the losses are the rounds', and the telemetry stream carries the measured
    bytes."""
    from nanofed_tpu_torch.observability import summarize_telemetry

    monkeypatch.setitem(transformer.FLAGSHIP_CONFIGS, "evidence", (64, 16, 32, 2, 2))
    art = evidence.generate_adapter_evidence(out_dir=tmp_path, tag="t", rank=4, num_clients=2,
                                             num_rounds=2, skip_flagship=True, device="cpu")
    assert set(art) == {"record_type", "tag", "created", "env", "workload", "adapter",
                        "losses", "loss_descending", "final_eval", "wire_bytes_per_round",
                        "reached", "conclusion", "artifact_path"}
    assert len(art["losses"]) == 2 and art["adapter"]["rank"] == 4
    assert art["wire_bytes_per_round"]["q8_reduction"] > 1
    assert art["workload"]["width"] == transformer.FLAGSHIP_CONFIGS["evidence"][2]
    assert art["workload"]["strict_mode"] is True
    digest = summarize_telemetry(tmp_path / "adapter_t_telemetry" / "telemetry.jsonl")
    assert digest["adapter"]["rank"] == 4 and digest["adapter"]["merges"] >= 1
