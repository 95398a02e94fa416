"""The port's update signing (``security.signing``) against the JAX package's, on the
CPU: every signed byte string is byte-equal across packages for float32 and bfloat16
leaves (the JAX leaf's numpy type string and a tuple shape, not a ``torch.Size``),
and a signature made by either package's ``SecurityManager`` verifies in the other,
while a tampered body, round or metrics string fails.  No tolerance: bytes and
verdicts are exact.
"""

import pytest

pytest.importorskip("cryptography", reason="signing needs the crypto dependency")

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from nanofed_tpu.security import signing as jax_signing
from nanofed_tpu_torch.security import signing
from nanofed_tpu_torch.utils.trees import flatten_with_names

NESTED = {"conv": {"bias": np.arange(4, dtype=np.float32) / 3,
                   "kernel": np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 3, 1, 4)},
          "dense": {"kernel": np.full((4, 2), 0.1, np.float32)},
          "scale": np.asarray(1.5, np.float32)}


def _trees(dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    torch_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    jax_tree = jax.tree.map(lambda a: jnp.asarray(a.astype(np_dtype)), NESTED)
    port = {name: torch.from_numpy(np.array(a)).to(torch_dtype)
            for name, a in flatten_with_names(NESTED).items()}
    return jax_tree, port


@pytest.fixture(scope="module")
def managers():
    return {"port": signing.SecurityManager(), "jax": jax_signing.SecurityManager()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_canonical_and_update_bytes_are_equal_across_packages(dtype):
    jax_tree, port = _trees(dtype)
    ours = signing.canonical_bytes(port)
    assert ours == jax_signing.canonical_bytes(jax_tree)
    assert (b"conv/kernel:<V2:(2, 3, 1, 4):" if dtype == "bf16"
            else b"conv/kernel:<f4:(2, 3, 1, 4):") in ours
    # np.ascontiguousarray widens the JAX package's 0-d leaf to one dimension.
    assert b"scale:" + (b"<V2" if dtype == "bf16" else b"<f4") + b":(1,):" in ours
    args = ("client_3", 7, '{"num_samples": 60.0, "loss": 0.25}')
    assert (signing.update_signing_bytes(port, *args)
            == jax_signing.update_signing_bytes(jax_tree, *args))


def test_numpy_leaves_sign_like_the_jax_package():
    """The compressed paths sign float32 numpy reconstructions: same bytes."""
    port = {name: np.asarray(a) for name, a in flatten_with_names(NESTED).items()}
    assert signing.canonical_bytes(port) == jax_signing.canonical_bytes(NESTED)


def test_masked_enrollment_and_secagg_body_bytes_are_equal():
    body = b"\x00\x01npz-bytes"
    assert (signing.masked_signing_bytes(body, "c1", 3, "{}")
            == jax_signing.masked_signing_bytes(body, "c1", 3, "{}"))
    for num_samples in (10, 10.0, 600.5):
        assert (signing.enrollment_signing_bytes("c1", bytes(range(32)), num_samples,
                                                 "sess", "cuda")
                == jax_signing.enrollment_signing_bytes("c1", bytes(range(32)), num_samples,
                                                        "sess", "cuda"))
    for kind in ("shares", "unmask"):
        assert (signing.secagg_body_signing_bytes(kind, body, "c1", "sess:4")
                == jax_signing.secagg_body_signing_bytes(kind, body, "c1", "sess:4"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("signer", ["port", "jax"])
def test_update_signatures_verify_across_packages_and_tampering_fails(managers, signer,
                                                                      dtype):
    jax_tree, port = _trees(dtype)
    tree = port if signer == "port" else jax_tree
    metrics = '{"num_samples": 60.0}'
    sig = managers[signer].sign_update(tree, "c1", 2, metrics)
    pem = managers[signer].get_public_key()
    for pkg, params in ((signing, port), (jax_signing, jax_tree)):
        assert pkg.verify_update_signature(params, "c1", 2, metrics, sig, pem)
        assert not pkg.verify_update_signature(params, "c1", 3, metrics, sig, pem)
        assert not pkg.verify_update_signature(params, "c1", 2, '{"num_samples": 6e9}',
                                               sig, pem)
        assert not pkg.verify_update_signature(params, "c2", 2, metrics, sig, pem)
    tampered = dict(port)
    tampered["dense/kernel"] = tampered["dense/kernel"].clone()
    tampered["dense/kernel"][0, 0] += 1
    assert not signing.verify_update_signature(tampered, "c1", 2, metrics, sig, pem)
    other = managers["jax" if signer == "port" else "port"].get_public_key()
    assert not signing.verify_update_signature(port, "c1", 2, metrics, sig, other)


@pytest.mark.parametrize("signer", ["port", "jax"])
def test_body_signatures_verify_across_packages_and_tampering_fails(managers, signer):
    m, pem = managers[signer], managers[signer].get_public_key()
    body = b"masked-npz"
    sig = m.sign_masked_update(body, "c1", 4, "{}")
    enroll = m.sign_enrollment("c1", bytes(32), 600, "sess", "host")
    shares = m.sign_secagg_body("shares", body, "c1", "sess:4")
    for pkg in (signing, jax_signing):
        assert pkg.verify_masked_signature(body, "c1", 4, "{}", sig, pem)
        assert not pkg.verify_masked_signature(body + b"x", "c1", 4, "{}", sig, pem)
        assert not pkg.verify_masked_signature(body, "c1", 5, "{}", sig, pem)
        assert pkg.verify_enrollment_signature("c1", bytes(32), 600.0, "sess", enroll, pem,
                                               backend="host")
        assert not pkg.verify_enrollment_signature("c1", bytes(32), 600.0, "sess", enroll,
                                                   pem, backend="cuda")
        assert pkg.verify_secagg_body_signature("shares", body, "c1", "sess:4", shares, pem)
        assert not pkg.verify_secagg_body_signature("unmask", body, "c1", "sess:4", shares,
                                                    pem)
    assert not signing.verify_masked_signature(body, "c1", 4, "{}", sig, b"not a pem")
