"""Secure aggregation: the server learns only the SUM of client updates (counterpart
of ``nanofed_tpu/security/secure_agg.py``, whose host arithmetic is copied here bit
for bit, so port and JAX parties can share one cohort).

The standard constructions:

* **Pairwise additive masking** (the SecAgg construction of Bonawitz et al., CCS 2017,
  single-round, no-dropout variant): every client pair (i, j) derives a shared seed via
  X25519 ECDH + HKDF; client i adds ``PRG(seed_ij)`` for j > i and subtracts it for j < i.
  In the modular sum over all clients the masks cancel *exactly* — updates are fixed-point
  quantized to uint32 so cancellation is bit-exact, not float-approximate.  The server sees
  only uniformly-masked vectors and the final sum.

* **Shamir threshold secret sharing** over the Mersenne prime 2^31 − 1: each client splits
  its quantized update into ``n`` shares of which any ``threshold`` reconstruct; share
  addition is pointwise, so summing every client's share ``k`` and reconstructing yields the
  cohort sum while fewer than ``threshold`` servers learn nothing.

* **AES-GCM transport encryption** for update payloads in the real-network mode.

Two mask-expansion backends, one per cohort (the server pins it at enrollment):

* ``host`` — numpy: ``quantize`` in float64 and ``_prg_uint32`` (numpy's Philox4x64-10).
  The JAX package's host backend, bit for bit: port and JAX parties interoperate.
* ``cuda`` — the card: ``weight * x`` in float32, kernel B5 (``ops.quantize_u32``), one
  kernel B7 (``ops.add_mask``) per peer plus the self mask.  B7 expands the same
  Philox4x64-10 stream under the same 128-bit key as ``_prg_uint32``, so the masks are
  the host's bits; the quantize differs (float32 product vs float64), which is why a
  cohort still uses one backend.  ``device=`` picks the card (``None`` -> ``"cuda"``;
  ``"cpu"`` runs the kernels' plain versions).

The JAX package's ``device`` backend expands the TPU core's own random stream, which
nothing here can reproduce: the port refuses it.  The server dequantizes the modular
sum with kernel B6 (``ops.dequantize_u32``) on its device, which equals
``np.float32(dequantize(total))`` exactly.

Secure aggregation is a cross-trust-domain feature that only exists when clients are
genuinely separate parties: it runs in the network mode, never in the simulated round.
"""

from __future__ import annotations

import os
import secrets
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    _CRYPTOGRAPHY_ERROR: str | None = None
except ImportError as _e:  # pragma: no cover - depends on the environment
    # The pure fixed-point/Shamir/mask arithmetic (quantize, dequantize, PRG
    # expansion, share reconstruction) is numpy-only and must stay importable
    # without the optional ``cryptography`` package; anything touching X25519 /
    # HKDF / AES-GCM raises a pointed error at call time instead.
    hashes = serialization = AESGCM = HKDF = None  # type: ignore[assignment]
    X25519PrivateKey = X25519PublicKey = None  # type: ignore[assignment]
    _CRYPTOGRAPHY_ERROR = str(_e)

import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.exceptions import AggregationError
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.ops.quantize import add_mask, dequantize_u32, quantize_u32
from nanofed_tpu_torch.utils.trees import ravel, unravel

#: Mask-expansion backends the port runs (see the module note).
BACKENDS = ("host", "cuda")


def _require_cryptography() -> None:
    if _CRYPTOGRAPHY_ERROR is not None:
        raise ImportError(
            "secure aggregation's key agreement and share sealing require the "
            f"'cryptography' package, which failed to import: {_CRYPTOGRAPHY_ERROR}"
        )


@dataclass(frozen=True)
class SecureAggregationConfig:
    """Secure-aggregation settings.

    ``frac_bits`` sets fixed-point precision (quantization step 2^-frac_bits); the masked
    ring is uint32.  The sum of all clients' scaled values must stay within ±2^31·2^-frac_bits
    to avoid wraparound — with the default 16 fractional bits that is ±32768 total mass,
    far above any normalized model update.

    ``dropout_tolerant=True`` switches masked rounds to the double-masking SecAgg
    variant (Bonawitz et al. §4): every client adds a SELF mask on top of the pairwise
    masks, and at the START OF EVERY ROUND draws a fresh ephemeral mask key + self
    seed and Shamir-shares both with the round's cohort (per-execution freshness —
    see ``make_dropout_shares``).  When a client drops mid-round, any ``threshold``
    survivors' shares let the server reconstruct the dropped client's round pairwise
    seeds (cancelling its orphaned masks) and the survivors' self-mask seeds — the
    round completes as the weighted FedAvg of the survivors instead of failing.  The
    self mask is what keeps a *delivered-but-presumed-dropped* update private:
    reconstructing a client's pairwise seeds alone never exposes its update.  Default
    False = the single-round no-dropout variant (any missing cohort member fails the
    round).  In tolerant mode ``min_clients`` doubles as the recovery privacy floor
    (no sum over fewer survivors is ever revealed) and ``threshold`` must exceed half
    the cohort (split-view defense).
    """

    min_clients: int = 3
    frac_bits: int = 16
    threshold: int = 2  # Shamir reconstruction threshold
    dropout_tolerant: bool = False


# ---------------------------------------------------------------------------------------
# Fixed-point quantization (exact modular arithmetic ⇒ exact mask cancellation)
# ---------------------------------------------------------------------------------------


def quantize(vec: np.ndarray, frac_bits: int) -> np.ndarray:
    """Float vector → uint32 fixed-point (two's-complement wraparound encodes sign)."""
    scaled = np.round(np.asarray(vec, np.float64) * (1 << frac_bits)).astype(np.int64)
    return (scaled % (1 << 32)).astype(np.uint32)


def dequantize(vec: np.ndarray, frac_bits: int) -> np.ndarray:
    """uint32 fixed-point → float64, interpreting values as centered (signed) residues."""
    as_int = vec.astype(np.int64)
    centered = np.where(as_int >= 1 << 31, as_int - (1 << 32), as_int)
    return centered.astype(np.float64) / (1 << frac_bits)


# ---------------------------------------------------------------------------------------
# Pairwise additive masking (SecAgg)
# ---------------------------------------------------------------------------------------


@dataclass(frozen=True)
class ClientKeyPair:
    """One client's X25519 keypair for pairwise seed agreement."""

    private: X25519PrivateKey

    @staticmethod
    def generate() -> "ClientKeyPair":
        _require_cryptography()
        return ClientKeyPair(private=X25519PrivateKey.generate())

    def public_bytes(self) -> bytes:
        return self.private.public_key().public_bytes(
            encoding=serialization.Encoding.Raw, format=serialization.PublicFormat.Raw
        )


def _pair_seed(my_key: ClientKeyPair, peer_public: bytes, round_context: bytes) -> bytes:
    """Shared 32-byte seed for a client pair: ECDH → HKDF bound to the round context.

    Symmetric by construction (X25519(sk_i, pk_j) == X25519(sk_j, pk_i)), so both ends of
    the pair expand the identical mask and the ± cancellation is exact.
    """
    _require_cryptography()
    shared = my_key.private.exchange(X25519PublicKey.from_public_bytes(peer_public))
    return HKDF(
        algorithm=hashes.SHA256(), length=32, salt=b"nanofed-tpu-secagg", info=round_context
    ).derive(shared)


def _prg_uint32(seed: bytes, size: int) -> np.ndarray:
    """Expand a 32-byte seed into ``size`` uniform uint32 words (Philox counter PRG).

    numpy's Philox key is 2x uint64 (128 bits), so the 256-bit HKDF seed is XOR-folded
    onto it; the parse is explicitly little-endian so two parties on different-endian
    hosts expand identical pairwise mask streams (the ± cancellation depends on it).
    """
    words = np.frombuffer(seed, dtype="<u8")  # 4 little-endian words from all 32 bytes
    key = words[:2] ^ words[2:]
    return np.random.Generator(np.random.Philox(key=key)).integers(
        0, 1 << 32, size=size, dtype=np.uint32
    )


def _self_mask_seed(self_seed: bytes, round_context: bytes) -> bytes:
    """Per-round self-mask seed: the enrollment-time 32-byte secret ``b_i`` is shared
    ONCE, so each round's self mask must be a fresh derivation bound to the round."""
    _require_cryptography()
    return HKDF(
        algorithm=hashes.SHA256(), length=32, salt=b"nanofed-tpu-secagg-self",
        info=round_context,
    ).derive(self_seed)


def _fold_seed_words(seed: bytes) -> np.ndarray:
    """256-bit seed -> the device kernel's 4 int32 words (endian-independent
    two's-complement centering; a .view would reinterpret in NATIVE byte order and
    break cross-endian mask cancellation — the invariant _prg_uint32 pins for the
    host path)."""
    words = np.frombuffer(seed, dtype="<u4")
    folded = (words[:4] ^ words[4:]).astype(np.int64)
    return np.where(folded >= 1 << 31, folded - (1 << 32), folded).astype(np.int32)


def _to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """A torch.uint32 vector (on any device) as a numpy uint32 array, through its int32
    bits (torch moves and converts uint32 tensors in few versions)."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def check_backend(backend: str) -> None:
    """Raise for a backend the port does not run."""
    if backend == "device":
        raise ValueError(
            "mask backend 'device' is the TPU kernel's random stream, which the port "
            "cannot expand: use 'cuda' (the port's card backend) or 'host'"
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use 'host' or 'cuda'")


def expand_mask(
    seed: bytes, size: int, backend: str = "host", device: DeviceLike = None
) -> np.ndarray:
    """Expand a 32-byte seed into the uint32 mask stream a client with this
    ``backend`` would have added — the server-side primitive for dropout recovery
    (reconstructed seeds must expand the SAME stream the clients used).  ``cuda``
    is one kernel B7 on zeros, on ``device``."""
    check_backend(backend)
    if backend == "host":
        return _prg_uint32(seed, size)
    zeros = torch.zeros(size, dtype=torch.int32, device=resolve_device(device))
    return _to_numpy_u32(add_mask(zeros.view(torch.uint32), _fold_seed_words(seed), 1))


def mask_update(
    params: Params,
    client_index: int,
    my_key: ClientKeyPair,
    all_public_keys: Sequence[bytes],
    round_number: int,
    config: SecureAggregationConfig | None = None,
    weight: float = 1.0,
    backend: str = "host",
    self_seed: bytes | None = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Client side: quantize ``weight · params`` and add the pairwise masks.

    Returns the masked flat uint32 vector to send to the server.  ``weight`` lets FedAvg
    weighting survive secure aggregation: clients pre-scale by (their weight / total) so the
    server-side sum IS the weighted mean.

    ``self_seed`` (dropout-tolerant mode) additionally adds the per-round SELF mask
    ``PRG(HKDF(self_seed, round))``: it keeps the update private even if the server
    later reconstructs this client's pairwise seeds, and is removed during the unmask
    round via the Shamir shares the client distributed at the round's start.

    ``backend="cuda"`` runs quantization and mask expansion on ``device`` through
    kernels B5 and B7: the masks are never written to memory, and the masked vector
    comes to the host once, for the wire.  Its quantize rounds ``weight * x`` in
    float32 where the host backend rounds in float64, so the WHOLE cohort uses one
    backend — the roster pins one per cohort and registration rejects mixed cohorts.
    ``unmask_sum`` is stream-agnostic.
    """
    config = config or SecureAggregationConfig()
    if len(all_public_keys) < config.min_clients:
        raise AggregationError(
            f"Need at least {config.min_clients} clients, got {len(all_public_keys)}"
        )
    ctx = f"round:{round_number}".encode()
    check_backend(backend)
    if backend == "cuda":
        return _mask_update_cuda(
            params, client_index, my_key, all_public_keys, ctx, config, weight, self_seed,
            device,
        )
    flat = ravel(params).detach().cpu().numpy()
    vec = quantize(np.asarray(flat, np.float64) * weight, config.frac_bits)
    for j, peer_pk in enumerate(all_public_keys):
        if j == client_index:
            continue
        mask = _prg_uint32(_pair_seed(my_key, peer_pk, ctx), vec.size)
        if j > client_index:
            vec = vec + mask  # uint32 wraps mod 2^32 by construction
        else:
            vec = vec - mask
    if self_seed is not None:
        vec = vec + _prg_uint32(_self_mask_seed(self_seed, ctx), vec.size)
    return vec


def _mask_update_cuda(
    params: Params,
    client_index: int,
    my_key: ClientKeyPair,
    all_public_keys: Sequence[bytes],
    ctx: bytes,
    config: SecureAggregationConfig,
    weight: float,
    self_seed: bytes | None,
    device: DeviceLike,
) -> np.ndarray:
    """Card-backend masking: B5 on ``weight * x`` in float32 (the weight rounded to
    float32 first, as the JAX device backend multiplies), then one B7 per peer and one
    for the self mask.  The 256-bit HKDF seeds fold to the kernel's four words (both
    parties fold identically); mask bits never touch memory."""
    flat = ravel(params).detach().to(device=resolve_device(device), dtype=torch.float32)
    vec = quantize_u32(flat * float(np.float32(weight)), config.frac_bits)
    for j, peer_pk in enumerate(all_public_keys):
        if j == client_index:
            continue
        words = _fold_seed_words(_pair_seed(my_key, peer_pk, ctx))
        vec = add_mask(vec, words, 1 if j > client_index else -1)
    if self_seed is not None:
        vec = add_mask(vec, _fold_seed_words(_self_mask_seed(self_seed, ctx)), 1)
    return _to_numpy_u32(vec)


def dequantize_sum(
    total: np.ndarray, frac_bits: int, device: DeviceLike = None
) -> torch.Tensor:
    """A modular sum (uint32 ``[P]``) -> float32 ``[P]`` on ``device``, by kernel B6:
    exactly ``np.float32(dequantize(total, frac_bits))``."""
    q = torch.from_numpy(np.ascontiguousarray(total, dtype=np.uint32).view(np.int32))
    return dequantize_u32(q.to(resolve_device(device)).view(torch.uint32), frac_bits)


def unmask_sum(
    masked_updates: Iterable[np.ndarray],
    template: Params,
    config: SecureAggregationConfig | None = None,
    device: DeviceLike = None,
) -> Params:
    """Server side: modular sum of masked vectors — pairwise masks cancel — then
    dequantize (kernel B6, on ``device``) and unravel into params shaped like
    ``template``."""
    config = config or SecureAggregationConfig()
    vectors = list(masked_updates)
    if len(vectors) < config.min_clients:
        raise AggregationError(
            f"Need at least {config.min_clients} clients, got {len(vectors)}"
        )
    total = np.zeros_like(vectors[0])
    for v in vectors:
        total = total + v
    return unravel(dequantize_sum(total, config.frac_bits, device), template)


# ---------------------------------------------------------------------------------------
# Shamir threshold secret sharing over GF(2^31 - 1)
# ---------------------------------------------------------------------------------------

_PRIME = (1 << 31) - 1  # Mersenne prime; int64 products of residues stay < 2^62


def _mod(x: np.ndarray) -> np.ndarray:
    return np.mod(x, _PRIME)


@dataclass(frozen=True)
class Share:
    """One party's share: evaluation point ``x`` and the share vector."""

    x: int
    values: np.ndarray  # int64 residues mod _PRIME


def _csprng_residues(shape: tuple[int, ...]) -> np.ndarray:
    """Uniform residues mod p straight from OS entropy.  Shamir's secrecy is
    information-theoretic ONLY if the polynomial coefficients are unpredictable: a
    64-bit-seeded PCG64 draw would let an attacker holding a single share (plus the
    published ephemeral public key to verify guesses against) brute-force the seed and
    recover the secret.  The 2^64-mod-p bias is ~2^-33 — negligible."""
    n = int(np.prod(shape)) if shape else 1
    words = np.frombuffer(os.urandom(8 * n), dtype="<u8")
    return (words % np.uint64(_PRIME)).astype(np.int64).reshape(shape)


def share_vector(
    values: np.ndarray, num_shares: int, threshold: int, rng: np.random.Generator | None = None
) -> list[Share]:
    """Split an int64 vector (entries in (−2^30, 2^30), negatives encoded mod p) into
    ``num_shares`` Shamir shares with reconstruction threshold ``threshold``.

    Coefficients come from OS entropy (see ``_csprng_residues``); pass ``rng`` only
    for deterministic tests — never when sharing real key material."""
    if not 1 <= threshold <= num_shares:
        raise AggregationError(f"invalid threshold {threshold} for {num_shares} shares")
    secret = _mod(np.asarray(values, np.int64))
    # Random degree-(t-1) polynomial per element with constant term = secret.
    if rng is None:
        coeffs = _csprng_residues((threshold - 1, secret.size))
    else:
        coeffs = rng.integers(0, _PRIME, size=(threshold - 1, secret.size), dtype=np.int64)
    shares = []
    for x in range(1, num_shares + 1):
        acc = np.zeros_like(secret)
        for c in coeffs[::-1]:  # Horner: acc = acc*x + c
            acc = _mod(acc * x + c)
        shares.append(Share(x=x, values=_mod(acc * x + secret)))
    return shares


def _lagrange_at_zero(xs: Sequence[int]) -> list[int]:
    """Lagrange basis coefficients ℓ_k(0) mod p for the given evaluation points."""
    coeffs = []
    for k, xk in enumerate(xs):
        num, den = 1, 1
        for m, xm in enumerate(xs):
            if m == k:
                continue
            num = (num * (-xm)) % _PRIME
            den = (den * (xk - xm)) % _PRIME
        coeffs.append((num * pow(den, _PRIME - 2, _PRIME)) % _PRIME)
    return coeffs


def reconstruct_vector(shares: Sequence[Share], threshold: int) -> np.ndarray:
    """Recover the secret vector from any ``threshold`` shares (centered back to signed)."""
    if len(shares) < threshold:
        raise AggregationError(f"need {threshold} shares, got {len(shares)}")
    use = shares[:threshold]
    acc = np.zeros_like(use[0].values)
    for coef, share in zip(_lagrange_at_zero([s.x for s in use]), use):
        acc = _mod(acc + _mod(share.values * coef))
    return np.where(acc > _PRIME // 2, acc - _PRIME, acc)


def add_shares(per_client_shares: Sequence[Sequence[Share]]) -> list[Share]:
    """Pointwise share addition: party k sums every client's k-th share.  Reconstructing
    the result yields the SUM of all client secrets — the threshold secure-sum."""
    num_parties = len(per_client_shares[0])
    out = []
    for k in range(num_parties):
        x = per_client_shares[0][k].x
        acc = np.zeros_like(per_client_shares[0][k].values)
        for client in per_client_shares:
            if client[k].x != x:
                raise AggregationError("share evaluation points misaligned across clients")
            acc = _mod(acc + client[k].values)
        out.append(Share(x=x, values=acc))
    return out


class ThresholdSecureAggregator:
    """Threshold secure-sum of model updates via Shamir sharing.  Values are
    fixed-point quantized (entries must stay within ±2^30·2^-frac_bits after
    summation)."""

    def __init__(self, num_parties: int, config: SecureAggregationConfig | None = None):
        self._config = config or SecureAggregationConfig()
        self._num_parties = num_parties

    def share_update(self, params: Params, weight: float = 1.0) -> list[Share]:
        flat = ravel(params).detach().cpu().numpy()
        scaled = np.round(
            np.asarray(flat, np.float64) * weight * (1 << self._config.frac_bits)
        ).astype(np.int64)
        return share_vector(scaled, self._num_parties, self._config.threshold)

    def aggregate(self, per_client_shares: Sequence[Sequence[Share]], template: Params) -> Params:
        if len(per_client_shares) < self._config.min_clients:
            raise AggregationError(
                f"Need at least {self._config.min_clients} clients, "
                f"got {len(per_client_shares)}"
            )
        summed = add_shares(per_client_shares)
        total = reconstruct_vector(summed, self._config.threshold)
        flat = (total.astype(np.float64) / (1 << self._config.frac_bits)).astype(np.float32)
        device = next(iter(template.values())).device
        return unravel(torch.from_numpy(flat).to(device), template)


# ---------------------------------------------------------------------------------------
# Dropout-tolerant SecAgg (Bonawitz et al. §4: double masking + share-based recovery)
# ---------------------------------------------------------------------------------------


def _bytes_to_words(secret: bytes) -> np.ndarray:
    """32-byte secret -> 16 little-endian uint16 words as int64 (every word < 2^16 ≪ p,
    so Shamir over GF(2^31−1) shares it losslessly)."""
    if len(secret) != 32:
        raise AggregationError(f"expected a 32-byte secret, got {len(secret)}")
    return np.frombuffer(secret, dtype="<u2").astype(np.int64)


def _words_to_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype="<u2").tobytes()


def share_secret_bytes(
    secret: bytes, num_shares: int, threshold: int,
    rng: np.random.Generator | None = None,
) -> list[Share]:
    """Shamir-share a 32-byte secret (an X25519 private key or a self-mask seed)."""
    return share_vector(_bytes_to_words(secret), num_shares, threshold, rng)


def reconstruct_secret_bytes(shares: Sequence[Share], threshold: int) -> bytes:
    """Recover a 32-byte secret from any ``threshold`` shares."""
    words = reconstruct_vector(shares, threshold)
    if words.shape != (16,) or (words < 0).any() or (words >= 1 << 16).any():
        raise AggregationError("reconstructed share vector is not a 32-byte secret")
    return _words_to_bytes(words)


def _transport_key(my_key: ClientKeyPair, peer_public: bytes) -> bytes:
    """Pairwise AES-256 key for share transport through the (untrusted-for-content)
    server — an HKDF derivation of the same X25519 agreement as the mask seeds, under
    a DIFFERENT salt so transport keys and mask seeds are cryptographically independent."""
    _require_cryptography()
    shared = my_key.private.exchange(X25519PublicKey.from_public_bytes(peer_public))
    return HKDF(
        algorithm=hashes.SHA256(), length=32, salt=b"nanofed-tpu-secagg-share",
        info=b"share-transport",
    ).derive(shared)


def _share_aad(context: str, sender: str, recipient: str) -> bytes:
    """AES-GCM associated data binding a sealed share blob to its cohort session,
    round, sender, and recipient.  Without this a malicious server could replay a
    PRIOR round's inbox (whose self seeds it already learned in that round's unmask)
    and harvest the matching mask keys this round — collecting both secrets of a
    victim across two rounds."""
    return f"secagg-share|{context}|{sender}|{recipient}".encode()


def seal_share_payload(
    my_key: ClientKeyPair, peer_public: bytes, payload: dict,
    aad: bytes = b"secagg-share",
) -> str:
    """Encrypt a share payload to one cohort peer (``TransportBox`` under the pairwise
    transport key, base64 wire form; ``aad`` from ``_share_aad`` binds it to the wire
    context).  The server stores and routes these blobs but cannot read them."""
    import base64
    import json

    box = TransportBox(_transport_key(my_key, peer_public))
    return base64.b64encode(
        box.encrypt(json.dumps(payload).encode(), aad)
    ).decode()


def open_share_payload(
    my_key: ClientKeyPair, sender_public: bytes, blob: str,
    aad: bytes = b"secagg-share",
) -> dict:
    """Decrypt a share blob addressed to this client (raises on tamper or on a wire
    context mismatch — AES-GCM authenticates ``aad``)."""
    import base64
    import json

    box = TransportBox(_transport_key(my_key, sender_public))
    return json.loads(box.decrypt(base64.b64decode(blob), aad))


def open_share_inbox(
    identity_key: ClientKeyPair,
    my_id: str,
    identity_public_keys: dict[str, bytes],
    inbox: dict[str, str],
    epks: dict[str, bytes],
    context: str,
) -> dict[str, dict]:
    """Open this client's full share inbox with replay-bound AADs and cross-check the
    server-relayed ephemeral keys against each sender's SEALED attestation.

    The epk map travels in an unsigned GET response; a server substituting its own
    keypairs could compute every pair seed and strip the pairwise masks, reducing
    double-masking to the self mask alone.  Each sender therefore seals its epk
    inside the authenticated blob; a mismatch with the relayed map aborts the round
    client-side before anything is masked.
    """
    import base64

    held = {}
    for sender, blob in inbox.items():
        payload = open_share_payload(
            identity_key, identity_public_keys[sender], blob,
            aad=_share_aad(context, sender, my_id),
        )
        attested = base64.b64decode(payload.get("epk", ""))
        if attested != epks.get(sender):
            raise AggregationError(
                f"server-relayed ephemeral key for {sender!r} does not match its "
                "sealed attestation — refusing to mask (possible epk substitution)"
            )
        held[sender] = payload
    return held


def make_dropout_shares(
    identity_key: ClientKeyPair,
    mask_key: ClientKeyPair,
    client_order: Sequence[str],
    identity_public_keys: dict[str, bytes],
    threshold: int,
    *,
    my_id: str,
    context: str,
    rng: np.random.Generator | None = None,
) -> tuple[bytes, dict[str, str]]:
    """Client side, start of each round: draw the round's self-mask secret ``b_i^r``
    and Shamir-share it and the round's EPHEMERAL mask key across the active cohort.

    Freshness is the security (Bonawitz §4 is a per-execution protocol): revealing a
    dropped client's mask key burns only THIS round's pairwise seeds, and revealing a
    survivor's self seed burns only this round's self mask — earlier and later rounds
    used different secrets, so the server can never retroactively combine a key reveal
    with an old self-seed reveal to unmask a delivered update.  The long-lived
    ``identity_key`` (enrollment) is used only to SEAL the share blobs to each peer;
    the shared secrets are the per-round ``mask_key`` and ``b``.

    ``my_id`` + ``context`` (cohort session + round, e.g. ``"<session>:<round>"``)
    bind each sealed blob's AAD to the wire context (see ``_share_aad``) — recipients
    open with the same binding, so a replayed blob from another round/cohort fails
    authentication.  The blob also carries this client's ephemeral PUBLIC key as a
    sealed attestation recipients cross-check against the server-relayed epk map
    (``open_share_inbox``).

    Returns ``(self_seed, {recipient_id: sealed_blob})``: the blob for round-roster
    member j carries share x=j+1 of each secret, sealed to j's identity key.  The self
    share (to our own id) keeps the share-count invariant — every cohort member holds
    exactly one share of every secret.
    """
    n = len(client_order)
    if 2 * threshold <= n:
        # With t <= n/2 a MALICIOUS server could partition the cohort into two
        # disjoint groups of >= t survivors, feed each a different unmask request,
        # and collect t shares of a victim's mask KEY from one group and t shares of
        # its SELF seed from the other — both secrets, one round, every per-request
        # refusal in build_unmask_reveals satisfied.  t > n/2 makes two disjoint
        # threshold-sized reveal sets impossible, so the invariant holds against an
        # actively-misbehaving server, not just an honest-but-curious one.
        raise AggregationError(
            f"dropout-tolerance threshold {threshold} must exceed half the cohort "
            f"({n}): smaller thresholds allow a split-view unmask attack"
        )
    self_seed = secrets.token_bytes(32)
    sk_raw = mask_key.private.private_bytes(
        encoding=serialization.Encoding.Raw,
        format=serialization.PrivateFormat.Raw,
        encryption_algorithm=serialization.NoEncryption(),
    )
    sk_shares = share_secret_bytes(sk_raw, n, threshold, rng)
    b_shares = share_secret_bytes(self_seed, n, threshold, rng)
    import base64

    epk_b64 = base64.b64encode(mask_key.public_bytes()).decode()
    sealed = {}
    for j, cid in enumerate(client_order):
        payload = {
            "x": j + 1,
            "sk": sk_shares[j].values.tolist(),
            "b": b_shares[j].values.tolist(),
            "epk": epk_b64,
        }
        sealed[cid] = seal_share_payload(
            identity_key, identity_public_keys[cid], payload,
            aad=_share_aad(context, my_id, cid),
        )
    return self_seed, sealed


def build_unmask_reveals(
    request: dict, my_id: str, held_shares: dict[str, dict]
) -> dict:
    """Client side, unmask round: assemble this survivor's reveals for the server's
    request — shares of SELF-mask seeds for survivors, shares of X25519 KEYS for
    dropped clients.

    Safety refusals (the Bonawitz §4 invariant — never both secrets of one client):
    a request listing any id as both dropped and survivor, or listing *this* client as
    dropped (it is alive and submitted), is rejected outright.
    """
    dropped, survivors = set(request["dropped"]), set(request["survivors"])
    if dropped & survivors:
        raise AggregationError(
            "refusing unmask request: ids listed as both dropped and survivor "
            "(revealing both secrets of one client would unmask its update)"
        )
    if my_id in dropped:
        raise AggregationError(
            "refusing unmask request that lists this live client as dropped"
        )
    if my_id not in survivors:
        raise AggregationError("this client is not in the request's survivor set")
    if (dropped | survivors) != set(held_shares):
        # The request must PARTITION the exact round cohort this client distributed
        # shares to — a subset/superset view is a server trying to carve the cohort
        # into inconsistent reveal groups (see make_dropout_shares on why t > n/2
        # closes the remaining split-partition angle).
        raise AggregationError(
            "refusing unmask request: dropped+survivors must partition the round "
            f"cohort exactly (request covers {sorted(dropped | survivors)}, "
            f"cohort is {sorted(held_shares)})"
        )
    return {
        "sk": {d: {"x": held_shares[d]["x"], "values": held_shares[d]["sk"]}
               for d in sorted(dropped)},
        "b": {s: {"x": held_shares[s]["x"], "values": held_shares[s]["b"]}
              for s in sorted(survivors)},
    }


def recover_unmasked_sum(
    masked_updates: dict[str, np.ndarray],
    client_order: Sequence[str],
    public_keys: dict[str, bytes],
    round_number: int,
    reveals: dict[str, dict],
    config: SecureAggregationConfig | None = None,
    backend: str = "host",
    self_seed_commitments: dict[str, bytes] | None = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Server side, dropout-tolerant unmask: modular sum of the survivors' vectors with
    the orphaned masks reconstructed and removed.

    ``client_order`` / ``public_keys`` are THIS ROUND's active roster and EPHEMERAL
    mask public keys (see ``make_dropout_shares`` on per-round freshness).

    Correction terms (all from ≥ ``threshold`` Shamir shares in ``reveals``):
    * every survivor's SELF mask ``PRG(HKDF(b_s, round))`` is subtracted;
    * for every dropped client d, its pairwise masks with each survivor i are
      re-derived from d's reconstructed ephemeral X25519 key and removed with the sign
      i originally applied (+ if d follows i in the roster order, − otherwise).

    Returns the corrected uint32 sum = the quantized weighted sum of the SURVIVORS'
    updates; the caller dequantizes (``dequantize_sum``) and renormalizes by the
    survivors' weight mass.  With ``backend="cuda"`` every mask is one kernel B7 on
    ``device``: one per survivor's self mask, one per survivor for each dropped client.
    """
    _require_cryptography()
    check_backend(backend)
    config = config or SecureAggregationConfig()
    t = config.threshold
    survivors = [c for c in client_order if c in masked_updates]
    dropped = [c for c in client_order if c not in masked_updates]
    if len(survivors) < config.min_clients:
        # min_clients is the privacy floor every client enforced at mask time: a
        # client that consented to hide in a crowd of >= min_clients must not have
        # its update exposed in a smaller recovered sum.
        raise AggregationError(
            f"only {len(survivors)} survivors; refusing to reveal a sum below the "
            f"min_clients={config.min_clients} privacy floor"
        )
    ctx = f"round:{round_number}".encode()
    size = next(iter(masked_updates.values())).size

    def collect(kind: str, target: str) -> list[Share]:
        shares, seen_x = [], set()
        for rv in reveals.values():
            entry = rv.get(kind, {}).get(target)
            if entry is None:
                continue
            x = int(entry["x"])
            if x in seen_x:
                continue  # duplicate evaluation point adds nothing
            seen_x.add(x)
            shares.append(Share(x=x, values=np.asarray(entry["values"], np.int64)))
        if len(shares) < t:
            raise AggregationError(
                f"only {len(shares)} shares revealed for {kind}:{target}; need {t}"
            )
        return shares

    total = np.zeros_like(next(iter(masked_updates.values())))
    for s in survivors:
        total = total + masked_updates[s]
    # Remove survivors' self masks.  A corrupt/malicious share would make Lagrange
    # interpolation yield a WRONG seed silently (any 32 bytes are "valid"), and the
    # garbage-corrected sum would be installed as the global model with no error —
    # verify each reconstruction against the commitment deposited with the epk.
    for s in survivors:
        b = reconstruct_secret_bytes(collect("b", s), t)
        commit = (self_seed_commitments or {}).get(s)
        if commit is not None:
            digest = hashes.Hash(hashes.SHA256())
            digest.update(b)
            if digest.finalize() != commit:
                raise AggregationError(
                    f"reconstructed self seed for {s!r} fails its commitment "
                    "(corrupt or malicious share) — failing the round"
                )
        total = total - expand_mask(_self_mask_seed(b, ctx), size, backend, device)
    # Remove dropped clients' orphaned pairwise masks.
    index = {c: i for i, c in enumerate(client_order)}
    for d in dropped:
        sk_raw = reconstruct_secret_bytes(collect("sk", d), t)
        d_key = ClientKeyPair(private=X25519PrivateKey.from_private_bytes(sk_raw))
        # Same silent-corruption hazard: verify the reconstructed key against the
        # client's deposited ephemeral PUBLIC key before trusting its pair seeds.
        if d_key.public_bytes() != public_keys[d]:
            raise AggregationError(
                f"reconstructed mask key for {d!r} does not match its deposited "
                "ephemeral public key (corrupt or malicious share) — failing the round"
            )
        for s in survivors:
            seed = _pair_seed(d_key, public_keys[s], ctx)
            mask = expand_mask(seed, size, backend, device)
            if index[d] > index[s]:
                total = total - mask  # survivor s had ADDED this mask
            else:
                total = total + mask  # survivor s had SUBTRACTED it
    return total


# ---------------------------------------------------------------------------------------
# AES-GCM transport encryption
# ---------------------------------------------------------------------------------------


class TransportBox:
    """Authenticated encryption for update payloads on the wire: confidentiality +
    integrity between one client and the server, NOT aggregate privacy (that is the
    masking/Shamir layer's job)."""

    def __init__(self, key: bytes | None = None) -> None:
        _require_cryptography()
        self._key = key if key is not None else AESGCM.generate_key(bit_length=256)

    @property
    def key(self) -> bytes:
        return self._key

    def encrypt(self, payload: bytes, associated_data: bytes = b"") -> bytes:
        nonce = os.urandom(12)
        return nonce + AESGCM(self._key).encrypt(nonce, payload, associated_data)

    def decrypt(self, blob: bytes, associated_data: bytes = b"") -> bytes:
        return AESGCM(self._key).decrypt(blob[:12], blob[12:], associated_data)
