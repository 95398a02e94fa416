"""nanofed_tpu_torch — the PyTorch/CUDA port of ``nanofed_tpu``.

The JAX package ``nanofed_tpu`` is the reference and stays unchanged; this package
mirrors its subpackage layout module for module, so each module here names its
counterpart there.  It imports ``torch`` and never ``jax`` or ``nanofed_tpu``.

It runs the synchronous simulated FedAvg round on one GPU:
``experiments.run_experiment`` -> ``orchestration.Coordinator`` ->
``parallel.round_step`` (or ``parallel.multi_round``'s fused blocks of R rounds with no
host barrier between them) -> ``trainer.local`` -> the weighted reduce and row norms,
which run in hand-written CUDA kernels (``ops/csrc``); and the network mode
(``communication``): validated, robust, compressed (q8/topk8) and signed
(``security.signing``) rounds, async FedBuff with the device ingest buffer
(``ingest``), and secure aggregation (``security.secure_agg``), whose fixed-point
quantize, dequantize and mask kernels run on the card too; and the
autotuned run (``tuning``, ``observability.profiling``): a sweep that profiles each
candidate round, the aggregation-epilogue table with the int8 dequant-accumulate
kernel, and the online retuner.

Every entry point takes ``device=None``, meaning ``"cuda"``; without a card it
raises unless the caller passes ``device="cpu"`` (see ``core.device``).
"""

from nanofed_tpu_torch.core import (
    ClientData,
    ClientMetrics,
    ClientUpdates,
    ModelUpdate,
    ModelVersion,
    NanoFedError,
)
from nanofed_tpu_torch.experiments import run_experiment
from nanofed_tpu_torch.utils import Logger, LogConfig, get_current_time, log_exec

# The version of the reference whose behaviour the port copies.
__version__ = "0.4.0"

__all__ = [
    "ClientData",
    "ClientMetrics",
    "ClientUpdates",
    "LogConfig",
    "Logger",
    "ModelUpdate",
    "ModelVersion",
    "NanoFedError",
    "__version__",
    "get_current_time",
    "log_exec",
    "run_experiment",
]
