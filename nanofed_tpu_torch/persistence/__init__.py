"""Persistence (counterpart of ``nanofed_tpu/persistence/``): model versioning,
round-state checkpoints and fault-tolerant restart, in the JAX package's formats so
either package resumes from the other's files, and the multi-host generations with
commit markers (``GenerationStore``)."""

from nanofed_tpu_torch.persistence.generation_store import GenerationRecord, GenerationStore
from nanofed_tpu_torch.persistence.model_manager import ModelManager, make_json_serializable
from nanofed_tpu_torch.persistence.serialization import (
    DTYPE_TAG,
    flatten_to_arrays,
    from_storable,
    load_pytree_npz,
    load_state_pickle,
    save_pytree_npz,
    save_state_pickle,
    to_storable,
    tree_to_numpy,
    unflatten_from_arrays,
    write_text_durable,
)
from nanofed_tpu_torch.persistence.state_store import (
    COMPLETED,
    FAILED,
    RECOVERABLE_EXCEPTIONS,
    CheckpointMetadata,
    FileStateStore,
    RestoredState,
    SimpleRecoveryStrategy,
    is_recoverable,
    run_fault_tolerant,
)

__all__ = [
    "COMPLETED",
    "DTYPE_TAG",
    "FAILED",
    "RECOVERABLE_EXCEPTIONS",
    "CheckpointMetadata",
    "FileStateStore",
    "GenerationRecord",
    "GenerationStore",
    "ModelManager",
    "RestoredState",
    "SimpleRecoveryStrategy",
    "flatten_to_arrays",
    "from_storable",
    "is_recoverable",
    "load_pytree_npz",
    "load_state_pickle",
    "make_json_serializable",
    "run_fault_tolerant",
    "save_pytree_npz",
    "save_state_pickle",
    "to_storable",
    "tree_to_numpy",
    "unflatten_from_arrays",
    "write_text_durable",
]
