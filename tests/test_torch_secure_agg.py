"""Secure aggregation of the port (``security/secure_agg.py``) against the JAX package.

Both packages' parties are built from the same raw X25519 private bytes, so their pair
seeds agree.  The ``host`` backend is the JAX package's numpy arithmetic, held bit for
bit: masked vectors, the unmasked sum, Shamir shares and the dropout recovery; a
cohort that mixes port and JAX parties cancels exactly.  The ``cuda`` backend (run
here with ``device="cpu"``, i.e. through the kernels' plain versions) is held to the
JAX package's device-backend quantize (B5 in interpret mode) and to the cancellation
invariants; its mask stream is the host's, so its recovery equals the host's too.
Every comparison is exact (uint32 arithmetic and power-of-two scales).
"""

import pytest

pytest.importorskip("cryptography", reason="secure aggregation needs the crypto dependency")

import jax
import jax.numpy as jnp
import numpy as np
import torch
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.ops import quantize_u32 as jax_quantize_u32
from nanofed_tpu.security import secure_agg as jax_sa
from nanofed_tpu.utils.trees import tree_ravel
from nanofed_tpu_torch import ops
from nanofed_tpu_torch.core.exceptions import AggregationError
from nanofed_tpu_torch.security import secure_agg as sa
from nanofed_tpu_torch.utils.trees import from_numpy_params, ravel

CFG = dict(min_clients=3, frac_bits=16)
WEIGHTS = [0.5, 0.2, 0.3]


def _keys(n: int, seed: int):
    """n (port, JAX) keypair twins from seeded raw private bytes."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        raw = rng.bytes(32)
        pairs.append((sa.ClientKeyPair(private=X25519PrivateKey.from_private_bytes(raw)),
                      jax_sa.ClientKeyPair(private=X25519PrivateKey.from_private_bytes(raw))))
    return pairs


def _params(n: int, seed: int = 0):
    """n clients' params of the JAX ``linear`` model (6 -> 3) as (port, JAX) twins."""
    model = jax_get_model("linear", in_features=6, num_classes=3)
    nested = [jax.tree.map(np.asarray, model.init(jax.random.key(seed + i))) for i in range(n)]
    return [(from_numpy_params(p, device="cpu"), p) for p in nested]


def _flat(nested) -> np.ndarray:
    return np.asarray(tree_ravel(nested)[0])


def _masked_cohort(keys, params, backend="host", self_seeds=None, round_number=3):
    """Every party's masked vector from both packages (host) or the port alone."""
    cfg_p, cfg_j = sa.SecureAggregationConfig(**CFG), jax_sa.SecureAggregationConfig(**CFG)
    pks = [k.public_bytes() for k, _ in keys]
    out = []
    for i, ((kp, kj), (pp, pj)) in enumerate(zip(keys, params)):
        ss = None if self_seeds is None else self_seeds[i]
        port = sa.mask_update(pp, i, kp, pks, round_number, cfg_p, weight=WEIGHTS[i],
                              backend=backend, self_seed=ss, device="cpu")
        jaxv = (jax_sa.mask_update(pj, i, kj, pks, round_number, cfg_j, weight=WEIGHTS[i],
                                   self_seed=ss) if backend == "host" else None)
        out.append((port, jaxv))
    return out


@pytest.mark.parametrize("with_self_mask", [False, True])
def test_host_mask_update_and_unmask_sum_match_jax_bit_for_bit(with_self_mask):
    keys, params = _keys(3, seed=1), _params(3)
    seeds = [bytes([i]) * 32 for i in range(3)] if with_self_mask else None
    masked = _masked_cohort(keys, params, self_seeds=seeds)
    for port, jaxv in masked:
        assert port.dtype == np.uint32
        np.testing.assert_array_equal(port, jaxv)
    if with_self_mask:
        return  # the self masks stay in until the dropout-tolerant unmask round
    got = sa.unmask_sum([p for p, _ in masked], params[0][0], sa.SecureAggregationConfig(**CFG),
                        device="cpu")
    want = jax_sa.unmask_sum([j for _, j in masked], params[0][1],
                             jax_sa.SecureAggregationConfig(**CFG))
    np.testing.assert_array_equal(ravel(got).numpy().view(np.int32), _flat(want).view(np.int32))


def test_mixed_port_and_jax_cohort_cancels_to_the_quantized_sum():
    """Parties 0 and 1 mask with the port, party 2 with the JAX package."""
    keys, params = _keys(3, seed=2), _params(3, seed=10)
    masked = _masked_cohort(keys, params)
    vectors = [masked[0][0], masked[1][0], masked[2][1]]
    total = np.zeros_like(vectors[0])
    for v in vectors:
        total = total + v
    want = np.zeros_like(total)
    for w, (_, pj) in zip(WEIGHTS, params):
        want = want + jax_sa.quantize(_flat(pj).astype(np.float64) * w, 16)
    np.testing.assert_array_equal(total, want)


def test_shamir_shares_and_reconstruction_match_jax():
    values = np.random.default_rng(3).integers(-(1 << 29), 1 << 29, size=50)
    port = sa.share_vector(values, 5, 3, rng=np.random.default_rng(4))
    ref = jax_sa.share_vector(values, 5, 3, rng=np.random.default_rng(4))
    for a, b in zip(port, ref):
        assert a.x == b.x
        np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(sa.reconstruct_vector(port[2:], 3), values)
    np.testing.assert_array_equal(sa.reconstruct_vector(port[1:4], 3),
                                  jax_sa.reconstruct_vector(ref[1:4], 3))
    secret = bytes(range(32))
    assert sa.reconstruct_secret_bytes(sa.share_secret_bytes(secret, 4, 3)[1:], 3) == secret
    with pytest.raises(AggregationError):
        sa.reconstruct_vector(port[:2], 3)


def _dropout_round(n: int = 4, t: int = 3, seed: int = 5, backend: str = "host",
                   drop: bool = True):
    """A dropout-tolerant round of n parties (threshold t) in which the last one drops
    after the share exchange (with ``drop``; else every party submits): the port's
    survivors' masked vectors, the round's epks and every survivor's reveals, built
    through the port's share functions."""
    identities, ephemerals = _keys(n, seed), _keys(n, seed + 100)
    order = [f"c{i}" for i in range(n)]
    id_pub = {c: k.public_bytes() for c, (k, _) in zip(order, identities)}
    epks = {c: k.public_bytes() for c, (k, _) in zip(order, ephemerals)}
    params, rnd, ctx = _params(n, seed=20), 1, "session:1"
    self_seeds, inboxes = {}, {c: {} for c in order}
    for c, (ik, _), (ek, _) in zip(order, identities, ephemerals):
        self_seeds[c], sealed = sa.make_dropout_shares(ik, ek, order, id_pub, t, my_id=c,
                                                       context=ctx)
        for recipient, blob in sealed.items():
            inboxes[recipient][c] = blob
    cfg = sa.SecureAggregationConfig(min_clients=n - 1, threshold=t, dropout_tolerant=True)
    masked, reveals = {}, {}
    survivors, dropped = (order[:-1], order[-1:]) if drop else (order, [])
    for i, c in enumerate(survivors):
        held = sa.open_share_inbox(identities[i][0], c, id_pub, inboxes[c], epks, ctx)
        masked[c] = sa.mask_update(params[i][0], i, ephemerals[i][0],
                                   [epks[o] for o in order], rnd, cfg, weight=0.25,
                                   backend=backend, self_seed=self_seeds[c], device="cpu")
        reveals[c] = sa.build_unmask_reveals(
            {"dropped": dropped, "survivors": survivors}, c, held)
    expect = np.zeros(params[0][0]["fc/bias"].numel() + params[0][0]["fc/kernel"].numel(),
                      np.uint32)
    for pp, _ in params[:len(survivors)]:
        flat = np.concatenate([v.numpy().ravel() for v in pp.values()])
        expect = expect + (jax_sa.quantize(flat.astype(np.float64) * 0.25, 16)
                           if backend == "host" else
                           np.asarray(jax_quantize_u32(jnp.asarray(flat) * np.float32(0.25), 16,
                                                       interpret=True)))
    return masked, order, epks, rnd, reveals, cfg, expect


def test_recover_unmasked_sum_with_one_dropout_matches_jax():
    masked, order, epks, rnd, reveals, cfg, expect = _dropout_round()
    got = sa.recover_unmasked_sum(masked, order, epks, rnd, reveals, cfg, device="cpu")
    ref = jax_sa.recover_unmasked_sum(
        masked, order, epks, rnd, reveals,
        jax_sa.SecureAggregationConfig(min_clients=3, threshold=3, dropout_tolerant=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, expect)


def test_cuda_backend_recovery_on_the_cpu_equals_the_host_recovery():
    """The cuda backend expands the host's stream, so the same round recovers through
    either backend; its quantize is the JAX device backend's (float32 product, B5)."""
    masked, order, epks, rnd, reveals, cfg, expect = _dropout_round(backend="cuda")
    host = sa.recover_unmasked_sum(masked, order, epks, rnd, reveals, cfg, device="cpu")
    cuda = sa.recover_unmasked_sum(masked, order, epks, rnd, reveals, cfg, backend="cuda",
                                   device="cpu")
    np.testing.assert_array_equal(cuda, host)
    np.testing.assert_array_equal(cuda, expect)


@pytest.mark.parametrize("with_dropout", [False, True])
def test_cuda_backend_recovery_equals_the_port_and_jax_host_recoveries(with_dropout):
    """The cuda backend's recovery (every correction in one B7, run here through its
    plain version) equals the port's and the JAX package's ``host`` recoveries bit for
    bit, with the last party dropped after the share exchange and with none dropped."""
    masked, order, epks, rnd, reveals, cfg, expect = _dropout_round(backend="cuda",
                                                                    drop=with_dropout)
    args = (masked, order, epks, rnd, reveals, cfg)
    cuda = sa.recover_unmasked_sum(*args, backend="cuda", device="cpu")
    np.testing.assert_array_equal(cuda, sa.recover_unmasked_sum(*args, device="cpu"))
    jax_cfg = jax_sa.SecureAggregationConfig(min_clients=cfg.min_clients,
                                             threshold=cfg.threshold, dropout_tolerant=True)
    np.testing.assert_array_equal(cuda, jax_sa.recover_unmasked_sum(*args[:5], jax_cfg))
    np.testing.assert_array_equal(cuda, expect)


def test_cuda_mask_update_is_one_launch_of_every_mask():
    """The cuda backend's masked vector (one B7 for all masks) has the bits of the
    one-launch-per-mask formula: B5 of the float32 product, then each peer's mask
    added for a later peer and subtracted for an earlier one, then the self mask."""
    keys, params = _keys(4, seed=9), _params(4, seed=60)
    pks = [k.public_bytes() for k, _ in keys]
    cfg = sa.SecureAggregationConfig(min_clients=3)
    me, self_seed, rnd = 1, bytes(range(32)), 5
    got = sa.mask_update(params[me][0], me, keys[me][0], pks, rnd, cfg, weight=0.25,
                         backend="cuda", self_seed=self_seed, device="cpu")
    ctx = f"round:{rnd}".encode()
    flat = ravel(params[me][0]).to(torch.float32) * float(np.float32(0.25))
    vec = ops.quantize_u32_plain(flat, cfg.frac_bits)
    for j, pk in enumerate(pks):
        if j != me:
            words = sa._fold_seed_words(sa._pair_seed(keys[me][0], pk, ctx))
            vec = ops.add_mask_plain(vec, words, 1 if j > me else -1)
    vec = ops.add_mask_plain(vec, sa._fold_seed_words(sa._self_mask_seed(self_seed, ctx)), 1)
    np.testing.assert_array_equal(got, vec.view(torch.int32).numpy().view(np.uint32))


def test_expand_masks_is_the_signed_sum_of_the_host_streams():
    rng = np.random.default_rng(11)
    seeds = [rng.bytes(32) for _ in range(5)]
    signs = [1, -1, -1, 1, -1]
    want = np.zeros(777, np.uint32)
    for seed, sign in zip(seeds, signs):
        want = want + jax_sa.expand_mask(seed, 777) if sign > 0 else want - jax_sa.expand_mask(
            seed, 777)
    np.testing.assert_array_equal(sa.expand_masks(seeds, signs, 777), want)
    np.testing.assert_array_equal(sa.expand_masks(seeds, signs, 777, "cuda", device="cpu"), want)
    np.testing.assert_array_equal(sa.expand_masks([], [], 9, "cuda", device="cpu"),
                                  np.zeros(9, np.uint32))
    with pytest.raises(ValueError, match="signs"):
        sa.expand_masks(seeds, signs[:2], 777)


def test_cuda_backend_quantize_matches_jax_device_backend_b5():
    """A one-party cohort adds no masks: the cuda backend's vector is B5 of the
    float32 product ``x * float32(weight)``, as the JAX device backend computes it."""
    (kp, _), = _keys(1, seed=6)
    (pp, pj), = _params(1, seed=30)
    cfg = sa.SecureAggregationConfig(min_clients=1)
    got = sa.mask_update(pp, 0, kp, [kp.public_bytes()], 0, cfg, weight=0.3, backend="cuda",
                         device="cpu")
    want = np.asarray(jax_quantize_u32(jnp.asarray(_flat(pj), jnp.float32) * 0.3, 16,
                                       interpret=True))
    np.testing.assert_array_equal(got, want)


def test_cuda_backend_cohort_cancels_to_the_sum_of_its_quantized_updates():
    keys, params = _keys(3, seed=7), _params(3, seed=40)
    masked = _masked_cohort(keys, params, backend="cuda")
    total = np.zeros_like(masked[0][0])
    want = np.zeros_like(total)
    for (port, _), w, (_, pj) in zip(masked, WEIGHTS, params):
        total = total + port
        want = want + np.asarray(jax_quantize_u32(jnp.asarray(_flat(pj)) * np.float32(w), 16,
                                                  interpret=True))
    np.testing.assert_array_equal(total, want)
    # The pairwise masks really are on: no party's vector is its bare quantized update.
    bare = np.asarray(jax_quantize_u32(jnp.asarray(_flat(params[0][1])) * np.float32(0.5), 16,
                                       interpret=True))
    assert not np.array_equal(masked[0][0], bare)


def test_expand_mask_backends():
    seed = bytes(range(32))
    host = sa.expand_mask(seed, 1001)
    np.testing.assert_array_equal(host, jax_sa.expand_mask(seed, 1001, "host"))
    np.testing.assert_array_equal(sa.expand_mask(seed, 1001, "cuda", device="cpu"), host)
    with pytest.raises(ValueError, match="TPU"):
        sa.expand_mask(seed, 10, "device")
    with pytest.raises(ValueError, match="unknown backend"):
        sa.mask_update(_params(1)[0][0], 0, _keys(1, 8)[0][0], [b"k"], 0,
                       sa.SecureAggregationConfig(min_clients=1), backend="tpu")


def test_threshold_aggregator_and_transport_box_match_jax():
    (pp, pj), = _params(1, seed=50)
    cfg = sa.SecureAggregationConfig(min_clients=1, threshold=2)
    agg = sa.ThresholdSecureAggregator(3, cfg)
    got = agg.aggregate([agg.share_update(pp, weight=0.5)], pp)
    ref = jax_sa.ThresholdSecureAggregator(
        3, jax_sa.SecureAggregationConfig(min_clients=1, threshold=2))
    want = ref.aggregate([ref.share_update(pj, weight=0.5)], pj)
    np.testing.assert_array_equal(ravel(got).numpy(), _flat(want))
    box = sa.TransportBox(key=bytes(32))
    blob = box.encrypt(b"payload", b"aad")
    assert jax_sa.TransportBox(key=bytes(32)).decrypt(blob, b"aad") == b"payload"
