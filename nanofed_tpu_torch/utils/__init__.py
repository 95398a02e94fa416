"""Utilities: logging, timing, dates and param arithmetic (counterpart of
``nanofed_tpu/utils/__init__.py``, whose ``__all__`` is exported whole).

The ``tree_*`` helpers act on the port's params, one flat ``dict[str, Tensor]`` keyed
by ``/``-path names in ravel order (``utils.trees``): the JAX package's pytree
arithmetic leaf by leaf.
"""

from nanofed_tpu_torch.utils.dates import get_current_time
from nanofed_tpu_torch.utils.logger import LogConfig, Logger, log_exec
from nanofed_tpu_torch.utils.profiling import annotate, device_time, trace
from nanofed_tpu_torch.utils.trees import (
    tree_add,
    tree_cast,
    tree_clip_by_global_norm,
    tree_flatten_with_names,
    tree_global_norm,
    tree_map_with_path_names,
    tree_ravel,
    tree_scale,
    tree_size,
    tree_sq_norm,
    tree_sub,
    tree_vdot,
    tree_weighted_mean,
    tree_where,
    tree_zeros_like,
)

__all__ = [
    "Logger",
    "LogConfig",
    "annotate",
    "device_time",
    "log_exec",
    "trace",
    "get_current_time",
    "tree_add",
    "tree_cast",
    "tree_clip_by_global_norm",
    "tree_flatten_with_names",
    "tree_global_norm",
    "tree_map_with_path_names",
    "tree_ravel",
    "tree_scale",
    "tree_size",
    "tree_sq_norm",
    "tree_sub",
    "tree_vdot",
    "tree_weighted_mean",
    "tree_where",
    "tree_zeros_like",
]
