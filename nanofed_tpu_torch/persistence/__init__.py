"""Persistence (counterpart of ``nanofed_tpu/persistence/``): so far the npz
(de)serialization the wire codec shares with checkpoints."""

from nanofed_tpu_torch.persistence.serialization import (
    DTYPE_TAG,
    flatten_to_arrays,
    from_storable,
    to_storable,
    unflatten_from_arrays,
)

__all__ = ["DTYPE_TAG", "flatten_to_arrays", "from_storable", "to_storable",
           "unflatten_from_arrays"]
