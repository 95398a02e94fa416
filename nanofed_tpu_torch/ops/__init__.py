"""Hand-written CUDA kernels for the port's hot data-movement ops.

The convolutions and matrix products of local training stay on cuDNN/cuBLAS, as the
JAX package leaves them to XLA.  The kernels of the TPU package that the port's
paths run are written by hand for Hopper (``csrc/*.cu``, built at first use by
``_build``):

* ``ops.reduce``    — B1, the FedAvg weighted reduce ``[C, P] x [C] -> [P]``, in a
                      normalised and an accumulate form; B2, the validated round's
                      masked, sanitized form of the same reduce;
* ``ops.dp_reduce`` — B3, per-row squared norms ``[C, P] -> [C]``, and the
                      central-DP clipped mean built on B3 and B1;
* ``ops.quantize``  — B5, B6 and B7, secure aggregation's fixed-point quantize and
                      dequantize and its Philox mask add; B4, the q8/topk aggregation
                      epilogue's fused int8 dequant-accumulate.

``KERNELS`` lists each kernel wrapper; ``reset_launch_counts`` zeroes their counts.
Each launch also reports the bytes its function moves to any open
``_common.KernelBytes`` (the profiler's view of the kernels).
"""

from nanofed_tpu_torch.ops.dp_reduce import (
    central_dp_reduce_stacked,
    dp_clipped_mean_flat,
    row_sq_norms,
    row_sq_norms_plain,
)
from nanofed_tpu_torch.ops.quantize import (
    add_mask,
    add_mask_plain,
    dequant_accumulate_flat,
    dequant_accumulate_flat_plain,
    dequantize_u32,
    dequantize_u32_plain,
    quantize_u32,
    quantize_u32_plain,
)
from nanofed_tpu_torch.ops.reduce import (
    masked_weighted_mean_flat,
    masked_weighted_mean_flat_plain,
    weighted_mean_flat,
    weighted_mean_flat_plain,
    weighted_mean_tree,
    weighted_sum_into,
    weighted_sum_into_plain,
)

KERNELS = (weighted_mean_flat, weighted_sum_into, row_sq_norms, masked_weighted_mean_flat,
           quantize_u32, dequantize_u32, add_mask, dequant_accumulate_flat)


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "KERNELS",
    "add_mask",
    "add_mask_plain",
    "central_dp_reduce_stacked",
    "dequant_accumulate_flat",
    "dequant_accumulate_flat_plain",
    "dequantize_u32",
    "dequantize_u32_plain",
    "dp_clipped_mean_flat",
    "launch_counts",
    "masked_weighted_mean_flat",
    "masked_weighted_mean_flat_plain",
    "quantize_u32",
    "quantize_u32_plain",
    "reset_launch_counts",
    "row_sq_norms",
    "row_sq_norms_plain",
    "weighted_mean_flat",
    "weighted_mean_flat_plain",
    "weighted_mean_tree",
    "weighted_sum_into",
    "weighted_sum_into_plain",
]
