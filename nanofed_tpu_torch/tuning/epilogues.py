"""The compressed-aggregation epilogues as catalogued, profiled programs (counterpart of
``nanofed_tpu/tuning/epilogues.py``).

The q8/topk serving path aggregates in two separate programs: dequantize the int8
client stack to a materialized ``[C, P]`` float32 array, then weighted-reduce it onto
the published base.  ``ops.dequant_accumulate_flat`` (kernel B4) fuses the two: the
per-client scale folds into the reduce coefficients, so the int8 stack is read once
and the float intermediate never exists.  ``ops.masked_weighted_mean_flat`` (kernel
B2) does the same for the validated path's sanitize-then-reduce.

This module registers BOTH forms of each epilogue in a
:class:`~nanofed_tpu_torch.observability.profiling.ProgramCatalog` and profiles them,
so the bytes drop is a counted row of the tuner's table and the time saved a
measured one.  The unfused programs are the plain torch expressions the JAX module
jits; the fused ones are the kernels.  Their inputs are real tensors made on the
device from a fixed seed; the int8 stack has a 16-byte row stride (the width B4's
widest loads need, P = 1,199,882 is 10 mod 16) and the float stacks a 4-float one.
"""

from __future__ import annotations

from typing import Any

import torch

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.observability.profiling import ProgramCatalog
from nanofed_tpu_torch.ops import dequant_accumulate_flat, masked_weighted_mean_flat

__all__ = ["profile_aggregation_epilogues", "register_epilogue_programs"]

#: Default stacked-client count the epilogues are profiled at: the JAX package's, its
#: ingest pipeline's default drain batch.
DEFAULT_EPILOGUE_CLIENTS = 64


def _padded(rows: int, cols: int, multiple: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A ``[rows, cols]`` view whose row stride is ``cols`` rounded up to ``multiple``."""
    return torch.empty((rows, -(-cols // multiple) * multiple), dtype=dtype,
                       device=device)[:, :cols]


def _dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s[:, None]


def _reduce(x: torch.Tensor, w: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    return base + (w / w.sum()) @ x


def _sanitize(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _masked_reduce(x: torch.Tensor, w: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    wv = w * valid
    return (wv / torch.clamp(wv.sum(), min=1e-12)) @ x


def register_epilogue_programs(
    catalog: ProgramCatalog, flat_size: int, clients: int = DEFAULT_EPILOGUE_CLIENTS,
    device: DeviceLike = None,
) -> None:
    """Register the fused epilogues next to their unfused counterparts, on ``device``
    (default: the GPU).  Unfused entries are the separate programs the serving path
    runs (``q8_epilogue_dequant`` then ``q8_epilogue_reduce``;
    ``validated_epilogue_sanitize`` then ``validated_epilogue_reduce``): their SUM is
    the baseline one fused program competes against.  Registration makes nothing;
    the inputs are drawn when the catalog profiles."""
    dev = resolve_device(device)
    c, p = int(clients), int(flat_size)
    attrs = {"clients": c, "flat_size": p}
    inputs: dict[str, torch.Tensor] = {}

    def made() -> dict[str, torch.Tensor]:
        """The inputs, drawn once from a fixed seed on first use."""
        if not inputs:
            gen = torch.Generator(device=dev).manual_seed(0)
            q = _padded(c, p, 16, torch.int8, dev)
            q.copy_(torch.randint(-127, 128, (c, p), generator=gen, device=dev,
                                  dtype=torch.int8))
            stack = _padded(c, p, 4, torch.float32, dev)
            stack.normal_(generator=gen)
            inputs.update(
                q=q, stack=stack,
                scales=torch.rand(c, generator=gen, device=dev) * 1e-2 + 1e-4,
                weights=torch.rand(c, generator=gen, device=dev) + 0.5,
                base=torch.randn(p, generator=gen, device=dev),
                valid=torch.rand(c, generator=gen, device=dev) > 0.1,
            )
        return inputs

    def args(*names: str):
        return lambda: (tuple(made()[n] for n in names), {})

    # --- q8/topk path: dequant (materializing) then reduce, vs fused (B4) ----------
    catalog.register(
        "q8_epilogue_dequant", _dequant, args_factory=args("q", "scales"),
        attrs={**attrs, "stage": "unfused 1/2: int8 -> materialized f32 stack"},
    )
    catalog.register(
        "q8_epilogue_reduce", _reduce, args_factory=args("stack", "weights", "base"),
        attrs={**attrs, "stage": "unfused 2/2: weighted reduce of the f32 stack"},
    )
    catalog.register(
        "q8_epilogue_fused", dequant_accumulate_flat,
        args_factory=args("q", "scales", "weights", "base"),
        attrs={**attrs, "stage": "fused: dequant folded into reduce coefficients"},
    )

    # --- validated path: sanitize (materializing) then reduce, vs fused (B2) -------
    catalog.register(
        "validated_epilogue_sanitize", _sanitize, args_factory=args("stack"),
        attrs={**attrs, "stage": "unfused 1/2: non-finite -> 0, materialized"},
    )
    catalog.register(
        "validated_epilogue_reduce", _masked_reduce,
        args_factory=args("stack", "weights", "valid"),
        attrs={**attrs, "stage": "unfused 2/2: mask-weighted reduce"},
    )
    catalog.register(
        "validated_epilogue_fused", masked_weighted_mean_flat,
        args_factory=args("stack", "weights", "valid"),
        attrs={**attrs, "stage": "fused: sanitize in-register + reduce, one pass"},
    )


def profile_aggregation_epilogues(
    flat_size: int,
    clients: int = DEFAULT_EPILOGUE_CLIENTS,
    catalog: ProgramCatalog | None = None,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """Profile both forms of both epilogues on ``device`` (default: the GPU) and return
    the comparison record the autotune artifact embeds: the JAX record's keys (per
    program reports, and each fused kernel's bytes against its unfused two-program
    sum) plus each program's measured milliseconds."""
    dev = resolve_device(device)
    catalog = catalog or ProgramCatalog()
    register_epilogue_programs(catalog, flat_size=flat_size, clients=clients, device=dev)
    reports = {name: catalog.profile(name) for name in catalog.names()}

    def _compare(fused: str, unfused: tuple[str, ...]) -> dict[str, Any]:
        fused_bytes = reports[fused].bytes_accessed
        unfused_bytes = sum(reports[n].bytes_accessed for n in unfused)
        out: dict[str, Any] = {
            "fused_bytes_accessed": fused_bytes,
            "unfused_bytes_accessed": unfused_bytes,
            "unfused_programs": list(unfused),
            "fused_measured_ms": reports[fused].measured_s * 1e3,
            "unfused_measured_ms": sum(reports[n].measured_s for n in unfused) * 1e3,
        }
        if unfused_bytes > 0:
            out["bytes_accessed_reduction_pct"] = round(
                100.0 * (1.0 - fused_bytes / unfused_bytes), 2
            )
        return out

    return {
        "flat_size": int(flat_size),
        "clients": int(clients),
        "platform": dev.type,
        "q8": _compare(
            "q8_epilogue_fused", ("q8_epilogue_dequant", "q8_epilogue_reduce")
        ),
        "validated": _compare(
            "validated_epilogue_fused",
            ("validated_epilogue_sanitize", "validated_epilogue_reduce"),
        ),
        "reports": {name: r.to_dict() for name, r in reports.items()},
        "measured_ms": {name: r.measured_s * 1e3 for name, r in reports.items()},
        "basis": (
            "counted bytes of one execution: one fused program against the SUM of the "
            "two separate programs the serving path runs.  Unfused programs count "
            "eager op-level bytes (every aten op's inputs and outputs); "
            + ("the fused ones the bytes their hand-written kernel reports (each "
               "input read once, each output written once).  measured_ms: the median "
               "of the timed calls, CUDA events."
               if dev.type == "cuda" else
               "on the CPU the fused wrappers run their plain versions, so their "
               "bytes are eager op-level too and the drop shows the fusion only on "
               "the card.  measured_ms: the host clock of the CPU, no device metric.")
        ),
    }
