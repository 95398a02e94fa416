"""The port's causal transformer LM (``nanofed_tpu_torch.models.transformer``) and its
token streams against the JAX package's, on the CPU (the port's counterpart of
``tests/unit/models/test_transformer.py``).

The JAX weights are carried across with ``utils.trees.from_numpy_params``; the same
token ids go through both forwards, in both parameter layouts.  Tolerance 1e-5 on the
log-probs: float32 products and softmaxes summed in another order.  The flagships'
parameter counts and ravel order are checked from shapes only (no init of the 1.3B
``large`` tree); ``synthetic_token_streams`` must be bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.data import synthetic_token_streams as jax_token_streams
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.models import list_models as jax_list_models
from nanofed_tpu.models import transformer as jax_transformer
from nanofed_tpu.persistence.serialization import tree_flatten_with_names
from nanofed_tpu_torch.data import federate, synthetic_token_streams
from nanofed_tpu_torch.models import get_model, list_models
from nanofed_tpu_torch.models import transformer
from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
from nanofed_tpu_torch.trainer.local import make_local_fit
from nanofed_tpu_torch.utils.trees import from_numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, SEQ, WIDTH, DEPTH, HEADS = 256, 32, 64, 2, 4
DIMS = dict(vocab=VOCAB, seq_len=SEQ, width=WIDTH, depth=DEPTH, heads=HEADS)


@pytest.fixture(scope="module", params=[False, True], ids=["unrolled", "scan"])
def pair(request):
    """(JAX model, JAX params, port model, the same params as port tensors)."""
    scan = request.param
    jm = jax_get_model("transformer_lm", scan_layers=scan, **DIMS)
    jp = jax.device_get(jm.init(jax.random.key(0)))
    return jm, jp, get_model("transformer_lm", scan_layers=scan, **DIMS), \
        from_numpy_params(jp, device="cpu")


def _tokens(n=6, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ)).astype(np.int32)


def test_apply_matches_jax(pair):
    jm, jp, pm, pp = pair
    x = _tokens()
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = pm.apply(pp, torch.from_numpy(x))
    assert got.shape == (6, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_apply_sequence_matches_jax(pair):
    _, jp, _, pp = pair
    x = _tokens(seed=1)
    want = np.asarray(jax_transformer.apply_sequence(jp, jnp.asarray(x), heads=HEADS))
    got = transformer.apply_sequence(pp, torch.from_numpy(x), heads=HEADS)
    assert got.shape == (6, SEQ, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("t", [SEQ - 1, SEQ // 2, 1])
def test_causality(pair, t):
    """Changing token t leaves every position before t as it was, and moves t."""
    _, _, _, pp = pair
    x = torch.from_numpy(_tokens(2, seed=2))
    full = transformer.apply_sequence(pp, x, heads=HEADS)
    x2 = x.clone()
    x2[:, t] = (x2[:, t] + 1) % VOCAB
    full2 = transformer.apply_sequence(pp, x2, heads=HEADS)
    torch.testing.assert_close(full[:, :t], full2[:, :t], rtol=0, atol=1e-6)
    assert not torch.allclose(full[:, t:], full2[:, t:])


def test_stack_and_unstack_round_trip_as_jax():
    jm = jax_get_model("transformer_lm", **DIMS)
    jp = jax.device_get(jm.init(jax.random.key(3)))
    pp = from_numpy_params(jp, device="cpu")
    stacked = transformer.stack_blocks(pp)
    want = from_numpy_params(jax.device_get(jax_transformer.stack_blocks(jp)), device="cpu")
    assert list(stacked) == list(want)
    for name in want:
        assert torch.equal(stacked[name], want[name]), name
    back = transformer.unstack_blocks(stacked)
    assert list(back) == list(pp) and all(torch.equal(back[k], pp[k]) for k in pp)
    with pytest.raises(ValueError, match="already scan layout"):
        transformer.stack_blocks(stacked)
    with pytest.raises(ValueError, match="already unrolled"):
        transformer.unstack_blocks(pp)
    x = torch.from_numpy(_tokens(seed=4))
    torch.testing.assert_close(transformer.apply_sequence(stacked, x, heads=HEADS),
                               transformer.apply_sequence(pp, x, heads=HEADS), rtol=0, atol=0)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
@pytest.mark.parametrize("name", list(transformer.FLAGSHIP_CONFIGS))
def test_param_count_of_every_flagship_from_shapes(name, scan):
    """The analytic count against the JAX tree (``eval_shape``) and the port's shapes,
    leaf for leaf, for every flagship and both layouts."""
    assert transformer.FLAGSHIP_CONFIGS[name] == jax_transformer.FLAGSHIP_CONFIGS[name]
    vocab, seq_len, width, depth, _ = transformer.FLAGSHIP_CONFIGS[name]
    jm = jax_transformer.flagship(name, scan_layers=scan)
    named, _ = tree_flatten_with_names(jax.eval_shape(lambda: jm.init(jax.random.key(0))))
    shapes = transformer.transformer_param_shapes(vocab, seq_len, width, depth, scan)
    assert [(n, tuple(a.shape)) for n, a in named] == list(shapes.items())
    count = transformer.transformer_param_count(vocab, seq_len, width, depth)
    assert count == jax_transformer.transformer_param_count(vocab, seq_len, width, depth)
    assert count == sum(int(np.prod(s)) for s in shapes.values())


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_ravel_order_at_depth_12_is_ravel_pytrees(scan):
    """At the ``base`` flagship's depth ``block_10`` and ``block_11`` sort before
    ``block_2``: the port's flat order is ``ravel_pytree``'s, offset for offset."""
    vocab, seq_len, width, depth, _ = transformer.FLAGSHIP_CONFIGS["base"]
    jm = jax_transformer.flagship("base", scan_layers=scan)
    abstract = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract)
    want = ["/".join(str(k.key) for k in path) for path, _ in leaves]
    got = list(transformer.transformer_param_shapes(vocab, seq_len, width, depth, scan))
    assert got == want
    if not scan:
        blocks = [n.split("/")[0] for n in got if n.startswith("block_")]
        assert blocks.index("block_10") < blocks.index("block_2")
    flat = jax.eval_shape(lambda: jax.flatten_util.ravel_pytree(jm.init(jax.random.key(0)))[0])
    assert flat.shape == (transformer.transformer_param_count(vocab, seq_len, width, depth),)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_port_init_follows_the_jax_layout_and_distributions(scan):
    """The port's own init: the shapes' names and order, float32 on the generator's
    device, N(0, 0.02) embeddings, kernels within the dense bound, the output
    projections scaled by 1/sqrt(2 depth), norms at 1 and 0."""
    model = get_model("transformer_lm", scan_layers=scan, **DIMS)
    params = model.init(torch.Generator().manual_seed(0))
    shapes = transformer.transformer_param_shapes(VOCAB, SEQ, WIDTH, DEPTH, scan)
    assert [(k, tuple(v.shape)) for k, v in params.items()] == list(shapes.items())
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in params.values())
    assert abs(float(params["tok_emb"].std()) - 0.02) < 0.002
    prefix = "blocks" if scan else "block_1"
    bound = 1.0 / np.sqrt(WIDTH)
    assert float(params[f"{prefix}/attn/wq/kernel"].abs().max()) <= bound
    assert float(params[f"{prefix}/attn/wo/kernel"].abs().max()) <= bound / np.sqrt(2 * DEPTH)
    assert float(params[f"{prefix}/mlp/fc2/kernel"].abs().max()) <= 0.5 / np.sqrt(
        2 * DEPTH * WIDTH)
    assert torch.equal(params[f"{prefix}/ln1/scale"], torch.ones_like(params[f"{prefix}/ln1/scale"]))
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_registry_and_metadata_equal_jax():
    assert list_models() == jax_list_models()
    for name in ("transformer_lm", "transformer_lm_scan"):
        ours, theirs = get_model(name), jax_get_model(name)
        assert (ours.name, ours.input_shape, ours.num_classes, ours.token_stream) == (
            theirs.name, theirs.input_shape, theirs.num_classes, theirs.token_stream)
    assert get_model("transformer_lm_scan", scan_layers=False).name == "transformer_lm_scan"
    with pytest.raises(ValueError, match="divisible"):
        get_model("transformer_lm", width=10, heads=4)


def test_bf16_forward_is_finite_under_the_mask():
    """The causal mask fills with bf16's most negative finite value: a bf16 forward
    stays finite and close to the float32 one."""
    model = get_model("transformer_lm", **DIMS)
    params = model.init(torch.Generator().manual_seed(1))
    x = torch.from_numpy(_tokens(seed=5))
    low = model.apply({k: v.bfloat16() for k, v in params.items()}, x)
    assert low.dtype == torch.bfloat16 and bool(torch.isfinite(low).all())
    assert float((low.float() - model.apply(params, x)).abs().max()) < 0.1


@pytest.mark.parametrize("n,vocab,seq_len,seed,temperature,chain_seed", [
    (64, 256, 32, 0, 0.35, 4321),
    (100, 50, 7, 3, 0.35, 4321),
    (33, 1024, 64, 1, 1.0, 7),
    (16, 8192, 128, 0, 0.35, 4321),
])
def test_synthetic_token_streams_are_bit_equal(n, vocab, seq_len, seed, temperature,
                                                chain_seed):
    ours = synthetic_token_streams(n, vocab=vocab, seq_len=seq_len, seed=seed,
                                   temperature=temperature, chain_seed=chain_seed)
    theirs = jax_token_streams(n, vocab=vocab, seq_len=seq_len, seed=seed,
                               temperature=temperature, chain_seed=chain_seed)
    assert ours.x.dtype == theirs.x.dtype == np.int32 and ours.y.dtype == np.int32
    np.testing.assert_array_equal(ours.x, theirs.x)
    np.testing.assert_array_equal(ours.y, theirs.y)
    assert (ours.num_classes, ours.name) == (theirs.num_classes, theirs.name)


def test_token_stream_refusals_match_jax():
    for kw in (dict(vocab=1), dict(seq_len=0)):
        with pytest.raises(ValueError) as want:
            jax_token_streams(4, **kw)
        with pytest.raises(ValueError) as got:
            synthetic_token_streams(4, **kw)
        assert str(got.value) == str(want.value)


def test_token_ids_stay_integer_through_the_fit():
    """A federated token stream reaches the device as int64 ids (never float), and a
    bf16 fit leaves them uncast: one local epoch trains to finite params."""
    cd = federate(synthetic_token_streams(64, seed=0), num_clients=4, batch_size=16)
    data = cd.to(torch.device("cpu"))
    assert data.x.dtype == torch.int64 and data.y.dtype == torch.int64
    model = get_model("transformer_lm", **DIMS)
    params = model.init(torch.Generator().manual_seed(0))
    fit = make_local_fit(model, TrainingConfig(batch_size=16, local_epochs=1,
                                               compute_dtype="bfloat16"))
    perms = draw_permutations(torch.Generator().manual_seed(0), 4, 1, data.y.shape[1])
    out = fit(params, data, perms, client_keys(0, 4, "cpu"))
    assert all(bool(torch.isfinite(v).all()) for v in out.params.values())
    assert out.params["tok_emb"].dtype == torch.float32


@pytest.mark.cuda
def test_transformer_forward_on_the_card_equals_the_cpu():
    """On a GPU: the forward and its gradient on the card against the CPU (TF32 off);
    chip_smoke.py (v6) runs an adapter round."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: checks the transformer's forward on the card")
    from nanofed_tpu_torch.core.device import resolve_device

    resolve_device("cuda")
    model = get_model("transformer_lm", **DIMS)
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_tokens())
    want = model.apply(params, x)
    got = model.apply({k: v.cuda() for k, v in params.items()}, x.cuda()).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
