"""Port params: names, ravel order and weight carrying against the JAX package's
``utils.trees``, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.utils import trees as jt
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.utils import trees


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jax_get_model("mnist_cnn").init(jax.random.key(0)))


def test_names_and_ravel_order_match_the_jax_tree(jax_params):
    named, _ = jt.tree_flatten_with_names(jax_params)
    params = trees.from_numpy_params(jax_params, device="cpu")
    assert list(params) == [name for name, _ in named]
    port_init = get_model("mnist_cnn").init(torch.Generator().manual_seed(0))
    assert list(port_init) == list(params)
    assert {k: tuple(v.shape) for k, v in port_init.items()} == {
        name: tuple(leaf.shape) for name, leaf in named
    }
    flat, _ = jt.tree_ravel(jax_params)
    np.testing.assert_array_equal(trees.ravel(params).numpy(), np.asarray(flat))
    assert trees.tree_size(params) == flat.size == 1_199_882


def test_from_numpy_params_round_trips_exactly(jax_params):
    back = trees.to_numpy_params(trees.from_numpy_params(jax_params, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jax_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_unravel_gives_views_in_ravel_order(jax_params):
    params = trees.from_numpy_params(jax_params, device="cpu")
    flat = trees.ravel(params)
    views = trees.unravel(flat, params)
    for name in params:
        torch.testing.assert_close(views[name], params[name], rtol=0, atol=0)
        assert views[name].data_ptr() >= flat.data_ptr()


def _stacked(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"k": rng.normal(size=(4, 3, 2))}, "b": rng.normal(size=(4, 5))}


def test_tree_arithmetic_matches_jax():
    """tree_weighted_mean / tree_sq_norm / tree_clip_by_global_norm agree to 1e-6
    (float32 sums of a few dozen terms)."""
    nested = jax.tree.map(lambda a: a.astype(np.float32), _stacked())
    port = trees.from_numpy_params(nested, device="cpu")
    w = np.asarray([1.0, 0.0, 2.0, 3.0], np.float32)
    want = jt.tree_weighted_mean(jax.tree.map(jnp.asarray, nested), jnp.asarray(w))
    got = trees.tree_weighted_mean(port, torch.from_numpy(w))
    for (name, leaf) in jt.tree_flatten_with_names(want)[0]:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(leaf), rtol=1e-6, atol=1e-6)
    one = jax.tree.map(lambda a: a[0], nested)
    port_one = {k: v[0] for k, v in port.items()}
    np.testing.assert_allclose(float(trees.tree_sq_norm(port_one)),
                               float(jt.tree_sq_norm(one)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        clipped, norm = trees.tree_clip_by_global_norm(port_one, max_norm)
        j_clipped, j_norm = jt.tree_clip_by_global_norm(one, max_norm)
        np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-6)
        for (name, leaf) in jt.tree_flatten_with_names(j_clipped)[0]:
            np.testing.assert_allclose(clipped[name].numpy(), np.asarray(leaf), rtol=1e-6,
                                       atol=1e-7)


def test_ravel_stacked_rows_are_per_client_ravels():
    nested = jax.tree.map(lambda a: a.astype(np.float32), _stacked(1))
    port = trees.from_numpy_params(nested, device="cpu")
    mat = trees.ravel_stacked(port)
    for c in range(4):
        flat, _ = jt.tree_ravel(jax.tree.map(lambda a: a[c], nested))
        np.testing.assert_array_equal(mat[c].numpy(), np.asarray(flat))
