"""The port's compressed update encodings (``q8-delta``, ``topk8-delta``) against the
JAX package's, on the CPU.

Both packages encode in numpy float32 on the host with the same stochastic-rounding
draws (``default_rng(seed).random(shape, float32)``, leaf by leaf in ravel order), so
the tolerance everywhere is none: payloads member for member and byte for byte (a
zip member's header carries its wall-clock time, so whole payloads are compared with
that field cleared), decodes and reconstructions bit for bit, on float32 and
bfloat16 templates.  The topk8 client's error-feedback residual is held across
packages over 3 rounds, a refused submit and its retry included.
"""

import pytest

pytest.importorskip("aiohttp", reason="the network mode needs aiohttp")

import asyncio
import io
import itertools
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

import nanofed_tpu.communication.http_client as jax_http_client
import nanofed_tpu_torch.communication.http_client as port_http_client
from nanofed_tpu.communication import HTTPClient as JaxHTTPClient
from nanofed_tpu.communication import codec as jax_codec
from nanofed_tpu_torch.communication import HTTPClient, HTTPServer, codec
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.ingest import IngestConfig
from nanofed_tpu_torch.utils.trees import flatten_with_names

SHAPES = {"a": {"bias": (5,), "kernel": (7, 5)}, "b": {"bias": (3,), "kernel": (5, 3)},
          "c": {"scale": ()}}


def _nested(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {layer: {name: np.asarray(rng.standard_normal(shape) * scale, np.float32)
                    for name, shape in leaves.items()}
            for layer, leaves in SHAPES.items()}


def _jax_tree(nested, dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    return jax.tree.map(lambda a: jnp.asarray(a.astype(np_dtype)), nested)


def _port_tree(nested, dtype):
    torch_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    return {name: torch.from_numpy(np.array(a, np.float32)).to(torch_dtype)
            for name, a in flatten_with_names(nested).items()}


def _bits(leaf):
    """A leaf's raw bits as an integer numpy array (bf16 and float32 alike)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.int16 if leaf.dtype == torch.bfloat16 else torch.int32).numpy()
    arr = np.asarray(leaf)
    return arr.view(np.int16 if arr.dtype.itemsize == 2 else np.int32)


def _assert_same_bits(jax_tree, port_params):
    jax_flat = flatten_with_names(jax.tree.map(np.asarray, jax_tree))
    assert list(jax_flat) == list(port_params)
    for name, leaf in port_params.items():
        np.testing.assert_array_equal(_bits(leaf), _bits(jax_flat[name]), err_msg=name)


def _members(payload):
    with zipfile.ZipFile(io.BytesIO(payload)) as z:
        return [(info.filename, z.read(info)) for info in z.infolist()]


def _without_times(payload):
    """The payload with every zip header's DOS time and date zeroed (the local and
    central headers carry them at fixed offsets)."""
    out = bytearray(payload)
    for sig, offset in ((b"PK\x03\x04", 10), (b"PK\x01\x02", 12)):
        start = 0
        while (i := out.find(sig, start)) >= 0:
            out[i + offset:i + offset + 4] = b"\0\0\0\0"
            start = i + 4
    return bytes(out)


ENCODERS = {
    "q8": (lambda pkg, delta, seed: pkg.encode_delta_q8(delta, seed=seed),
           "decode_delta_q8", "reconstruct_q8"),
    "topk8": (lambda pkg, delta, seed: pkg.encode_delta_topk8(delta, 0.3, seed=seed),
              "decode_delta_topk8", "reconstruct_topk8"),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("encoding", ["q8", "topk8"])
def test_payloads_are_byte_equal_for_the_same_delta_and_seed(encoding, dtype):
    encode = ENCODERS[encoding][0]
    delta = _nested(1, scale=0.01)
    ours = encode(codec, _port_tree(delta, dtype), 7)
    theirs = encode(jax_codec, _jax_tree(delta, dtype), 7)
    assert _members(ours) == _members(theirs)
    assert _without_times(ours) == _without_times(theirs)
    assert _members(encode(codec, _port_tree(delta, dtype), 8)) != _members(ours)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("encoding", ["q8", "topk8"])
def test_each_package_decodes_the_others_payloads_bit_equal(encoding, dtype):
    encode, decode, _ = ENCODERS[encoding]
    delta, base = _nested(2, scale=0.01), _nested(3)
    port_like, jax_like = _port_tree(base, dtype), _jax_tree(base, dtype)
    from_port = encode(codec, _port_tree(delta, "f32"), 11)
    from_jax = encode(jax_codec, _jax_tree(delta, "f32"), 11)
    for payload in (from_port, from_jax):
        got = getattr(codec, decode)(payload, like=port_like)
        want = getattr(jax_codec, decode)(payload, like=jax_like)
        assert all(leaf.dtype == port_like[name].dtype for name, leaf in got.items())
        _assert_same_bits(want, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("encoding", ["q8", "topk8"])
def test_reconstructions_are_bit_equal_across_packages(encoding, dtype):
    encode, _, reconstruct = ENCODERS[encoding]
    payload = encode(jax_codec, _jax_tree(_nested(4, scale=0.01), "f32"), 5)
    base = _nested(5)
    got = getattr(codec, reconstruct)(_port_tree(base, dtype), payload)
    want = getattr(jax_codec, reconstruct)(_jax_tree(base, dtype), payload)
    assert all(leaf.dtype == torch.float32 for leaf in got.values())
    _assert_same_bits(want, got)


def test_decoders_refuse_what_does_not_fit():
    like = _port_tree(_nested(0), "f32")
    plain = codec.encode_params(like)
    with pytest.raises(Exception, match="non-q8 entry"):
        codec.decode_delta_q8(plain, like=like)
    bad = io.BytesIO()
    np.savez_compressed(bad, **{"a/bias::tk8i": np.array([99], np.uint32),
                                "a/bias::q8q": np.array([1], np.int8),
                                "a/bias::q8s": np.float32(1.0)})
    with pytest.raises(Exception, match="out of range"):
        codec.decode_delta_topk8(bad.getvalue(), like=like)


def _seeded(encoder):
    """``encoder`` with seeds 0, 1, 2, ... call by call: the client's draws made
    reproducible, the same sequence in both packages."""
    seeds = itertools.count()

    def encode(delta, fraction=0.05):
        return encoder(delta, fraction, seed=next(seeds))

    return encode


def _residuals(client):
    if client._residual is None:
        return None
    res = client._residual
    if isinstance(client, JaxHTTPClient):
        res = flatten_with_names(jax.tree.map(np.asarray, res))
    return {name: np.asarray(v, np.float32) for name, v in res.items()}


def _topk8_run(pkg, monkeypatch):
    """One topk8 client over 3 rounds against a port server with a one-slot ingest
    buffer: round 0 accepted; round 1 refused with 429 (another client holds the
    slot), then its retry accepted once the slot is drained; round 2 accepted.  The
    residual after each submit, and the server's drained deltas."""
    module = jax_http_client if pkg == "jax" else port_http_client
    monkeypatch.setattr(module, "encode_delta_topk8", _seeded(module.encode_delta_topk8))
    init = _nested(0)
    trained = [_nested(20 + r, scale=0.02) for r in range(4)]

    async def main():
        port = free_port()
        server = HTTPServer(port=port, ingest=IngestConfig(capacity=1), device="cpu")
        await server.start()
        url = f"http://127.0.0.1:{port}"
        template = _jax_tree(init, "f32") if pkg == "jax" else _port_tree(init, "f32")
        client_cls = JaxHTTPClient if pkg == "jax" else HTTPClient
        seen, drained = [], []

        def local(params, r):
            if pkg == "jax":
                return jax.tree.map(lambda p, d: np.asarray(p) + d, params, trained[r])
            return {k: v + torch.from_numpy(flatten_with_names(trained[r])[k])
                    for k, v in params.items()}

        async def drain():
            flat, metas = await server.drain_ingest_fedavg()
            drained.append(flat.numpy().copy())
            return metas

        try:
            global_params = _port_tree(init, "f32")
            async with client_cls(url, "c0", update_encoding="topk8-delta",
                                  topk_fraction=0.2) as client, \
                    HTTPClient(url, "z") as blocker:
                for r in range(3):
                    await server.publish_model(global_params, r)
                    params, _, _ = await client.fetch_global_model(like=template)
                    if r == 1:
                        await blocker.fetch_global_model(like=_port_tree(init, "f32"))
                        assert await blocker.submit_update(_port_tree(init, "f32"), {})
                        assert not await client.submit_update(local(params, r), {})
                        seen.append(_residuals(client))
                        await drain()
                        params = local(params, 3)  # trained on before the retry
                    assert await client.submit_update(local(params, r), {})
                    seen.append(_residuals(client))
                    await drain()
                    global_params = {k: torch.from_numpy(v) for k, v in
                                     flatten_with_names(_nested(30 + r)).items()}
        finally:
            await server.stop()
        return seen, drained

    return asyncio.run(main())


def test_topk8_residual_matches_over_three_rounds_with_a_refused_submit(monkeypatch):
    port_seen, port_drained = _topk8_run("port", monkeypatch)
    jax_seen, jax_drained = _topk8_run("jax", monkeypatch)
    assert len(port_seen) == len(jax_seen) == 4
    for ours, theirs in zip(port_seen, jax_seen):
        assert ours.keys() == theirs.keys()
        for name in ours:
            np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    assert len(port_drained) == 4
    for ours, theirs in zip(port_drained, jax_drained):
        np.testing.assert_array_equal(ours, theirs)
