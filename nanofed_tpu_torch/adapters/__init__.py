"""Parameter-efficient federation: LoRA adapters over frozen base models (counterpart
of ``nanofed_tpu/adapters``).

* :mod:`~nanofed_tpu_torch.adapters.lora`: the adapter algebra (``AdapterSpec``,
  ``init_adapters``, ``merge_adapters``/``unmerge_adapters``, ``adapter_delta``,
  ``make_adapter_apply``);
* the round hook, :class:`nanofed_tpu_torch.parallel.round_step.FrozenBase`: the
  base is a read-only input of the round step and of the fused block, and only the
  adapter tree is trained and reduced;
* the entry points: ``Coordinator(adapter=AdapterSpec(...))``, ``run_experiment(
  adapter_rank=...)``, ``nanofed-tpu-torch run --adapter-rank`` and the autotuner's
  rank axis;
* :mod:`~nanofed_tpu_torch.adapters.evidence`: the wire-bytes measurement and the
  adapter evidence artifact.
"""

from nanofed_tpu_torch.adapters.lora import (
    AdapterSpec,
    adapter_delta,
    adapter_param_count,
    adapter_wire_ratio,
    init_adapters,
    make_adapter_apply,
    merge_adapters,
    target_paths,
    unmerge_adapters,
)

__all__ = [
    "AdapterSpec",
    "adapter_delta",
    "adapter_param_count",
    "adapter_wire_ratio",
    "init_adapters",
    "make_adapter_apply",
    "merge_adapters",
    "target_paths",
    "unmerge_adapters",
]
