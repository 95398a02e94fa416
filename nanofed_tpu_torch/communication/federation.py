"""The wire-to-mesh bridge: host ingest drains into the cross-host reduce (counterpart
of ``nanofed_tpu/communication/federation.py``).

Each host of a hierarchical federation runs a listener with an ingest buffer
(``HTTPServer(ingest=...)``).  The buffer's batched product is the host-local stage,
drained unnormalised (``DeviceIngestBuffer.drain_fedavg_partial``: ``Σ w_i δ_i`` and
the weight mass), because the FedAvg normaliser is global.  Then ONE all-reduce over
the hosts moves one ``[P+1+E]`` row a round (numerator ‖ mass ‖ control lanes), and
``base + num / max(mass, 1e-12)`` lands the same on every host:
``Σ_h Σ_{i∈h} w_i δ_i / Σ_h Σ_{i∈h} w_i`` is the union's weighted mean under any
partition of clients into hosts.

Here a host is a rank of a world (``parallel.mesh``): the cross-host all-reduce runs
over the hosts group of the rank's ``MeshLayout`` (one rank a host on an ``(H, 1, 1)``
mesh; on an ``(H, C, M)`` mesh each hosts line all-reduces its own rows).  The
builders return plain functions of tensors on the rank's device; nothing is compiled.

Stated difference: the JAX package's ``assemble_host_rows`` builds the global
``[H, P+1]`` array, hosts-axis sharded, from each process's local rows.  With one
process a device each rank hands its own row to the all-reduce, so there is nothing to
assemble and the port has no such function: :func:`build_cross_host_row_psum` and
:func:`build_cross_host_reduce` take the rank's local row (or rows, summed first).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from nanofed_tpu_torch.core.device import resolve_device
from nanofed_tpu_torch.parallel.mesh import HOST_AXIS, Mesh, MeshLayout

__all__ = [
    "MASS_LANE",
    "apply_summed_row",
    "build_cross_host_reduce",
    "build_cross_host_row_psum",
    "build_drained_ingest_reduce",
    "host_partial_row",
]

#: Trailing lanes of a host partial row beyond the P model lanes: the weight mass
#: (FedAvg) or live count (FedBuff) that makes the partial composable.
MASS_LANE = 1

#: Division floor for the global mass: a round where every host drained empty divides
#: zero by this instead of turning the model into NaN (the caller reads the mass).
_MASS_FLOOR = 1e-12


def _require_hosts(mesh: Mesh) -> None:
    if HOST_AXIS not in mesh.axis_names:
        raise ValueError(
            f"the wire→mesh bridge needs a mesh with a {HOST_AXIS!r} axis "
            f"(got axes {mesh.axis_names}); build one with "
            "make_mesh(shape=(hosts, clients, model))"
        )


def host_partial_row(
    partial: Any | None,
    mass: float,
    flat_size: int,
    extra: Sequence[float] = (),
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """One host's ``[P+1+E]`` float32 contribution to the cross-host reduce: the
    unnormalised drain numerator ‖ its mass ‖ ``extra`` control lanes (summed across
    hosts like the rest; the JAX harness uses one as a stop vote).  An empty drain
    (``partial is None``) contributes exact zeros in the model and mass lanes: the
    host still joins the all-reduce, it just adds nothing.  The row lives on
    ``partial``'s device, or for an empty drain on ``device`` (default the card)."""
    device = resolve_device(device) if partial is None else torch.as_tensor(partial).device
    row = torch.zeros(flat_size + MASS_LANE + len(extra), dtype=torch.float32,
                      device=device)
    if partial is not None:
        row[:flat_size] = torch.as_tensor(partial, dtype=torch.float32)
        row[flat_size] = float(mass)
    for i, v in enumerate(extra):
        row[flat_size + MASS_LANE + i] = float(v)
    return row


def _local_sum(rows: torch.Tensor) -> torch.Tensor:
    """A rank's local rows ``[k, L]`` (or one row ``[L]``) summed to one row."""
    return rows.sum(0) if rows.ndim == 2 else rows.clone()


def build_cross_host_row_psum(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The single-collective runtime path: ``fn(rows) -> total``, exactly ONE
    all-reduce of the rank's ``[P+1+E]`` row over the hosts group of ``mesh`` (rows
    ``[k, P+1+E]`` are summed locally first).  The apply stays on each host
    (:func:`apply_summed_row`); every rank holds the same summed row."""
    _require_hosts(mesh)
    layout = MeshLayout(mesh, params_like={})  # no params: the rows are the state

    def row_psum(rows: torch.Tensor) -> torch.Tensor:
        return layout.hosts_all_reduce(_local_sum(rows))

    return row_psum


def apply_summed_row(
    base: Any, total: Any, flat_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The FedAvg apply after the cross-host all-reduce: ``(base + num / max(mass,
    1e-12), tail)`` in float32, where ``num`` and ``mass`` are the summed row's model
    and mass lanes and ``tail`` its mass and control lanes.  Every host computes it
    from the same summed row and the same base, so the new params are the same bits
    on every host with no second collective; ``tail[0] == 0`` means every host
    drained empty, and then ``new == base`` exactly."""
    total = torch.as_tensor(total, dtype=torch.float32)
    base = torch.as_tensor(base, dtype=torch.float32).to(total.device)
    num, den = total[:flat_size], total[flat_size]
    return base + num / torch.clamp(den, min=_MASS_FLOOR), total[flat_size:]


def build_cross_host_reduce(
    mesh: Mesh, flat_size: int
) -> Callable[[torch.Tensor, Any], tuple[torch.Tensor, torch.Tensor]]:
    """The one cross-host collective of a federated round with its apply:
    ``fn(rows, base) -> (new_flat, tail)``: one all-reduce of the rank's row over the
    hosts, then :func:`apply_summed_row`.  ``tail[0]`` is the global mass (0: the
    round failed and ``new_flat == base``), ``tail[1:]`` the extra lanes."""
    row_psum = build_cross_host_row_psum(mesh)

    def reduce(rows: torch.Tensor, base: Any) -> tuple[torch.Tensor, torch.Tensor]:
        return apply_summed_row(base, row_psum(rows), flat_size)

    return reduce


def build_drained_ingest_reduce(
    mesh: Mesh, capacity: int, flat_size: int
) -> Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]:
    """The fused form of the round's reduce: ``fn(buf, coefs, base) -> new_flat`` for
    this rank's ingest slab ``buf [capacity, P]`` and raw FedAvg weights ``coefs
    [capacity]`` (unused slots exactly 0.0): the drain's product ``coefs @ buf`` and
    the mass ``Σ coefs`` as one row, the client all-reduce (host-local first, then one
    across hosts: ``MeshLayout.client_psum``), and the apply."""
    _require_hosts(mesh)
    layout = MeshLayout(mesh, params_like={})  # no params: the rows are the state

    def reduce(buf: torch.Tensor, coefs: torch.Tensor, base: Any) -> torch.Tensor:
        if tuple(buf.shape) != (capacity, flat_size) or tuple(coefs.shape) != (capacity,):
            raise ValueError(f"need buf [{capacity}, {flat_size}] and coefs [{capacity}], "
                             f"got {tuple(buf.shape)} and {tuple(coefs.shape)}")
        row = torch.cat([torch.mv(buf.t(), coefs), coefs.sum()[None]])
        new, _ = apply_summed_row(base, layout.client_psum(row), flat_size)
        return new

    return reduce
