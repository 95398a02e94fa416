"""nanofed_tpu_torch — the PyTorch/CUDA port of ``nanofed_tpu``.

The JAX package ``nanofed_tpu`` is the reference and stays unchanged; this package
mirrors its subpackage layout module for module, so each module here names its
counterpart there.  It imports ``torch`` and never ``jax`` or ``nanofed_tpu``.

It runs the synchronous simulated FedAvg round on one GPU:
``experiments.run_experiment`` -> ``orchestration.Coordinator`` ->
``parallel.round_step`` -> ``trainer.local`` -> the weighted reduce and row norms,
which run in hand-written CUDA kernels (``ops/csrc``); and the network mode
(``communication``) with secure aggregation (``security.secure_agg``), whose
fixed-point quantize, dequantize and mask kernels run on the card too.

Every entry point takes ``device=None``, meaning ``"cuda"``; without a card it
raises unless the caller passes ``device="cpu"`` (see ``core.device``).
"""

from nanofed_tpu_torch.experiments import run_experiment

__all__ = ["run_experiment"]
