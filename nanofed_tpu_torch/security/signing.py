"""RSA-PSS signing of model updates and secure-aggregation bodies (counterpart of
``nanofed_tpu/security/signing.py``).

Every signed byte string is the JAX package's, byte for byte, so a signature made by
either package verifies in the other: :func:`canonical_bytes` writes each leaf as
``name:dtype:shape:`` plus its raw bytes in sorted-name order, where ``dtype`` is the
numpy type string of the JAX package's leaf (``<f4`` for float32, ``<V2`` for the
``ml_dtypes`` bfloat16 numpy gives a bf16 leaf) and ``shape`` a Python tuple, never a
``torch.Size`` (``(1,)`` for a 0-d leaf, which ``np.ascontiguousarray`` widens).  The
wire context (client id, round, the verbatim metrics header) is bound in as there,
against replay.  ``cryptography`` is needed to sign or verify, not to import this
module.
"""

from __future__ import annotations

import base64
from typing import Any

import numpy as np
import torch

from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.utils.logger import Logger

#: numpy type strings of the leaves numpy cannot hold natively: a JAX bf16 leaf is an
#: ``ml_dtypes`` bfloat16 array, whose ``dtype.str`` is ``<V2``.
_NUMPY_TYPE_STR = {torch.bfloat16: "<V2"}


def _leaf_bytes(leaf: Any) -> tuple[str, tuple[int, ...], bytes]:
    """``(numpy dtype string, shape tuple, C-order raw bytes)`` of one leaf, as the
    JAX package's ``np.asarray(leaf)`` gives them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _NUMPY_TYPE_STR:
            raw = t.view(torch.int16).numpy().tobytes()  # the bf16 bits, little-endian
            # np.ascontiguousarray gives a 0-d leaf one dimension, as below.
            return _NUMPY_TYPE_STR[t.dtype], tuple(t.shape) or (1,), raw
        leaf = t.numpy()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.dtype.str, tuple(arr.shape), arr.tobytes()


def canonical_bytes(params: Params) -> bytes:
    """Deterministic byte serialization of params for signing: ``name:dtype:shape:``
    and the raw bytes of each leaf, in sorted-name order."""
    out = bytearray()
    for name in sorted(params):
        dtype_str, shape, raw = _leaf_bytes(params[name])
        out += f"{name}:{dtype_str}:{shape}:".encode() + raw
    return bytes(out)


def update_signing_bytes(params: Params, client_id: str, round_number: int,
                         metrics_json: str) -> bytes:
    """What an update signature covers: the params plus the update's context (client
    id, round, the verbatim metrics header), so a captured update cannot be replayed
    into another round or have its metrics rewritten."""
    context = f"client={client_id}&round={round_number}&metrics={metrics_json}&params="
    return context.encode() + canonical_bytes(params)


def masked_signing_bytes(body: bytes, client_id: str, round_number: int,
                         metrics_json: str) -> bytes:
    """What a masked (secure-aggregation) update signature covers: the verbatim wire
    body plus the same context as :func:`update_signing_bytes`."""
    context = f"client={client_id}&round={round_number}&metrics={metrics_json}&masked="
    return context.encode() + body


def enrollment_signing_bytes(client_id: str, x25519_public_key: bytes, num_samples: float,
                             session: str, backend: str = "host") -> bytes:
    """What an enrollment signature covers: the identity, its mask key, its sample
    count (as a float, so 10 and 10.0 sign alike), the server's session nonce and the
    mask backend."""
    return (
        f"enroll:session={session}"
        f"&client={client_id}&x25519={base64.b64encode(x25519_public_key).decode()}"
        f"&num_samples={float(num_samples)!r}"
        f"&backend={backend}"
    ).encode()


def secagg_body_signing_bytes(kind: str, body: bytes, client_id: str, context: str) -> bytes:
    """What a share-deposit (``kind="shares"``) or unmask-reveal (``"unmask"``)
    signature covers: the verbatim JSON body, bound to ``context`` (the cohort's
    session nonce and the round)."""
    return f"secagg-{kind}:client={client_id}&ctx={context}&body=".encode() + body


def _pss() -> tuple[Any, Any]:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    pss = padding.PSS(mgf=padding.MGF1(hashes.SHA256()), salt_length=padding.PSS.MAX_LENGTH)
    return pss, hashes.SHA256()


def _verify_bytes(data: bytes, signature: bytes, public_key: bytes) -> bool:
    """Fails closed: a bad signature, a corrupt PEM or a non-RSA key is False."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.rsa import RSAPublicKey

    try:
        key = serialization.load_pem_public_key(public_key)
        if not isinstance(key, RSAPublicKey):
            Logger().error("Unsupported public key type.")
            return False
        key.verify(signature, data, *_pss())
        return True
    except InvalidSignature:
        return False
    except Exception as e:
        Logger().error(f"Signature verification failed: {e}")
        return False


def verify_signature(params: Params, signature: bytes, public_key: bytes) -> bool:
    """Verify a signature over params alone against a PEM public key."""
    return _verify_bytes(canonical_bytes(params), signature, public_key)


def verify_update_signature(params: Params, client_id: str, round_number: int,
                            metrics_json: str, signature: bytes, public_key: bytes) -> bool:
    """Verify an update's signature with its context (:func:`update_signing_bytes`)."""
    return _verify_bytes(update_signing_bytes(params, client_id, round_number, metrics_json),
                         signature, public_key)


def verify_masked_signature(body: bytes, client_id: str, round_number: int,
                            metrics_json: str, signature: bytes, public_key: bytes) -> bool:
    """Verify a masked update's signature (:func:`masked_signing_bytes`)."""
    return _verify_bytes(masked_signing_bytes(body, client_id, round_number, metrics_json),
                         signature, public_key)


def verify_enrollment_signature(client_id: str, x25519_public_key: bytes, num_samples: float,
                                session: str, signature: bytes, public_key: bytes,
                                backend: str = "host") -> bool:
    """Verify an enrollment's signature (:func:`enrollment_signing_bytes`)."""
    return _verify_bytes(
        enrollment_signing_bytes(client_id, x25519_public_key, num_samples, session, backend),
        signature, public_key)


def verify_secagg_body_signature(kind: str, body: bytes, client_id: str, context: str,
                                 signature: bytes, public_key: bytes) -> bool:
    """Verify a share-deposit or unmask-reveal signature
    (:func:`secagg_body_signing_bytes`)."""
    return _verify_bytes(secagg_body_signing_bytes(kind, body, client_id, context),
                         signature, public_key)


class SecurityManager:
    """This party's RSA keypair (2048 bits by default): signs its outgoing updates
    and bodies with RSA-PSS/SHA-256."""

    def __init__(self, key_size: int = 2048) -> None:
        from cryptography.hazmat.primitives.asymmetric import rsa

        self._private_key = rsa.generate_private_key(public_exponent=65537, key_size=key_size)
        self._public_key = self._private_key.public_key()

    def get_public_key(self) -> bytes:
        """PEM-encoded public key for the verifiers (``HTTPServer(client_keys=)``)."""
        from cryptography.hazmat.primitives import serialization

        return self._public_key.public_bytes(
            encoding=serialization.Encoding.PEM,
            format=serialization.PublicFormat.SubjectPublicKeyInfo,
        )

    def _sign(self, data: bytes) -> bytes:
        return self._private_key.sign(data, *_pss())

    def sign_params(self, params: Params) -> bytes:
        return self._sign(canonical_bytes(params))

    def sign_update(self, params: Params, client_id: str, round_number: int,
                    metrics_json: str) -> bytes:
        return self._sign(update_signing_bytes(params, client_id, round_number, metrics_json))

    def sign_masked_update(self, body: bytes, client_id: str, round_number: int,
                           metrics_json: str) -> bytes:
        return self._sign(masked_signing_bytes(body, client_id, round_number, metrics_json))

    def sign_enrollment(self, client_id: str, x25519_public_key: bytes, num_samples: float,
                        session: str, backend: str = "host") -> bytes:
        return self._sign(enrollment_signing_bytes(client_id, x25519_public_key, num_samples,
                                                   session, backend))

    def sign_secagg_body(self, kind: str, body: bytes, client_id: str, context: str) -> bytes:
        return self._sign(secagg_body_signing_bytes(kind, body, client_id, context))

    def verify_signature(self, params: Params, signature: bytes, public_key: bytes) -> bool:
        return verify_signature(params, signature, public_key)
