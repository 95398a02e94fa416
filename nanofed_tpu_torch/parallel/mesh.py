"""Process meshes and the clients, model and hosts axes over ``torch.distributed``
(counterpart of ``nanofed_tpu/parallel/mesh.py``).

The JAX package spreads a round over a ``jax.sharding.Mesh`` of devices inside one
program.  Here one rank is one process is one device, and a :class:`Mesh` is this
rank's place in a grid of ranks plus one process group per axis line:

* ``clients`` — data parallelism: each rank fits its ``C / n`` client rows and the
  FedAvg reduce is an all-reduce of weighted delta sums (:meth:`MeshLayout.client_psum`);
* ``model`` — FSDP-style sharding: params and the server state live split over the
  model axis (each leaf's largest divisible dimension, :func:`param_partition_spec`),
  are gathered once a round for the clients' fits (:meth:`MeshLayout.gather_full`) and
  the aggregate is sliced back before the server update (:meth:`MeshLayout.slice_shard`);
* ``hosts`` — the reduce becomes two-stage: over the ranks of one host row first, then
  one all-reduce across hosts of the already-reduced value.

Ranks go in row-major order over ``(hosts, clients, model)``, as the JAX package
reshapes its device list.  Under ``torchrun`` a hosts row is whole nodes (contiguous
ranks); in a world on one machine the hosts axis slices the ranks into virtual hosts,
as the JAX package's single-process path slices its devices.

Without an initialised process group :func:`make_mesh` is a one-rank mesh and every
collective is the identity.  The backend is always the caller's explicit choice
(:func:`initialize_distributed`): ``"nccl"`` where each rank has its own card,
``"gloo"`` on the CPU or where ranks share a card.  torch's gloo backend runs every
collective used here (all-reduce, all-gather into a tensor, broadcast) on CUDA tensors
itself (checked on an H100 by ``scripts/probe_gloo_cuda_collectives.py``), so no
collective is staged through host memory by this module.
"""

from __future__ import annotations

import contextvars
import math
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from nanofed_tpu_torch.core.types import ClientData, Params

CLIENT_AXIS = "clients"
MODEL_AXIS = "model"
HOST_AXIS = "hosts"
BACKENDS = ("nccl", "gloo")
# torch renamed all_gather_into_tensor; the chip machine's torch may predate the new name.
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
# Row-major order of the ranks, outermost first.
_GRID = (HOST_AXIS, CLIENT_AXIS, MODEL_AXIS)


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize_distributed(
    backend: str | None = None,
    *,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    local_rank: int | None = None,
    local_world_size: int | None = None,
    device: str | torch.device | None = None,
    timeout_s: float | None = None,
) -> dict[str, Any]:
    """Join this process to its world: call once per process, before any mesh.

    The world comes from explicit arguments or from ``torchrun``'s variables
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  With no rendezvous address at all the call is a no-op that
    returns ``{"process_index": 0, "process_count": 1}`` (one process, as the JAX
    package's single-process path); a world size or rank WITHOUT an address raises,
    because N processes that each train alone look healthy.

    ``backend`` must be ``"nccl"`` (one card per rank) or ``"gloo"`` (the CPU, or
    ranks that share a card); nothing switches it.  The rank's device is ``cpu``
    when ``device="cpu"`` and otherwise ``cuda:{local_rank % device_count}``, made
    the current device.  NCCL refuses two ranks of one communicator on one card, so
    ``"nccl"`` with more ranks on this machine than cards raises here, naming the
    card, before the process group exists."""
    address = init_method
    if address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        address = "env://"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if address is None:
        if world_size is not None or rank is not None:
            raise ValueError(
                "world_size/rank configured but no rendezvous address: pass "
                "init_method= (or run under torchrun, which sets MASTER_ADDR and "
                "MASTER_PORT) — refusing to silently run single-process"
            )
        return {"process_index": 0, "process_count": 1}
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world_size is None or rank is None:
        raise ValueError("a rendezvous address needs world_size= and rank= (or "
                         "WORLD_SIZE and RANK)")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE")
    if local_world_size is None and address.startswith("file://"):
        local_world_size = world_size  # a file rendezvous is one machine's
    dev = _rank_device(backend, device, local_rank, local_world_size or 1)
    dist.init_process_group(
        backend, init_method=address, world_size=world_size, rank=rank,
        **({"timeout": timedelta(seconds=timeout_s)} if timeout_s is not None else {}),
    )
    return {
        "process_index": rank, "process_count": world_size, "local_rank": local_rank,
        "node_count": node_count(), "backend": backend, "device": str(dev),
    }


def _rank_device(backend: str, device: Any, local_rank: int,
                 local_world_size: int) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' runs on CUDA devices; the CPU needs 'gloo'")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: a rank runs on the GPU by default; pass "
            "device='cpu' (with backend='gloo') to run on the CPU"
        )
    count = torch.cuda.device_count()
    dev = torch.device("cuda", local_rank % count)
    if backend == "nccl" and local_world_size > count:
        raise RuntimeError(
            f"backend='nccl' needs one card per rank, but {local_world_size} ranks on "
            f"this machine share {count} card(s): rank {local_rank} would share "
            f"cuda:{dev.index} ({torch.cuda.get_device_name(dev)}) and NCCL refuses "
            "two ranks of one communicator on one card; use backend='gloo' for ranks "
            "that share a card"
        )
    torch.cuda.set_device(dev)
    return dev


def node_count() -> int:
    """Machines in the world: ``WORLD_SIZE / LOCAL_WORLD_SIZE`` under ``torchrun``,
    else 1 (a world started on one machine)."""
    local = _env_int("LOCAL_WORLD_SIZE")
    if not dist.is_initialized() or not local:
        return 1
    return max(1, dist.get_world_size() // local)


@dataclass
class Mesh:
    """This rank's place in a ``hosts x clients x model`` grid of ranks.

    ``shape`` is the mesh as given (``(clients,)``, ``(clients, model)`` or
    ``(hosts, clients, model)``) and ``axis_names`` names its axes, as the JAX
    mesh's do; ``dims`` is always the full ``(hosts, clients, model)`` grid and
    ``coords`` this rank's index on each axis.  ``groups`` holds the process group
    of this rank's line along each axis of more than one rank (None otherwise).
    ``device`` is where this rank's tensors live."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    device: torch.device
    groups: dict[str, Any] = field(default_factory=dict)
    backend: str | None = None

    @property
    def dims(self) -> tuple[int, int, int]:
        sizes = dict(zip(self.axis_names, self.shape))
        return (sizes.get(HOST_AXIS, 1), _client_dim(self), sizes.get(MODEL_AXIS, 1))

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> dict[str, int]:
        return dict(zip(_GRID, (int(i) for i in np.unravel_index(self.rank, self.dims))))

    @property
    def client_shard_index(self) -> int:
        """This rank's index among the ``hosts x clients`` client shards (hosts-major,
        the order of the client rows)."""
        c = self.coords
        return c[HOST_AXIS] * self.dims[1] + c[CLIENT_AXIS]

    @property
    def described(self) -> bool:
        """True for a mesh made by :meth:`describe` (no process group behind it)."""
        return any(isinstance(g, _NoGroup) for g in self.groups.values())

    @classmethod
    def describe(cls, shape: tuple[int, ...], rank: int,
                 device: torch.device | str = "cpu") -> "Mesh":
        """The mesh a rank of a world of ``prod(shape)`` would build, without a process
        group: for the layout arithmetic (slices, shards) only; its collectives raise."""
        mesh = cls(tuple(int(d) for d in shape), _axis_names(len(shape)), int(rank),
                   torch.device(device))
        mesh.groups = {axis: _NoGroup(n) for axis, n in zip(_GRID, mesh.dims) if n > 1}
        return mesh


class _NoGroup:
    """Stands for a process group of ``size`` ranks on a described mesh: any collective
    over it raises, unless a :class:`CollectiveRecorder` is active."""

    def __init__(self, size: int) -> None:
        self.size = int(size)


def _axis_names(ndim: int, axis_name: str = CLIENT_AXIS, model_axis: str = MODEL_AXIS,
                host_axis: str = HOST_AXIS) -> tuple[str, ...]:
    return {1: (axis_name,), 2: (axis_name, model_axis),
            3: (host_axis, axis_name, model_axis)}[ndim]


def _client_dim(mesh: Mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if CLIENT_AXIS in sizes:
        return sizes[CLIENT_AXIS]
    return mesh.shape[0] if len(mesh.shape) == 1 else 1


def make_mesh(
    shape: tuple[int, ...] | None = None,
    *,
    device: str | torch.device | None = None,
) -> Mesh:
    """This rank's mesh over the world (one rank without a process group).

    Without ``shape``: the 1-D mesh with only the client axis.  ``(n_client_shards,
    n_model_shards)``: the 2-D clients x model mesh.  ``(n_hosts, n_client_shards,
    n_model_shards)``: the 3-D hosts x clients x model mesh, whose host rows must be
    whole nodes.  The product must equal the world size.  Every rank of the world
    must call this with the same shape, in the same order as its other meshes: each
    call creates the process groups of every axis line on every rank.

    ``device`` (default: the current CUDA device) is where this rank's tensors live;
    pass ``"cpu"`` for a CPU world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device is None or torch.device(device).type == "cuda" and torch.device(device).index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a mesh lives on the GPU by default; pass "
                "device='cpu' for a CPU world"
            )
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
    dims = (world,) if shape is None else tuple(int(d) for d in shape)
    if any(d < 1 for d in dims):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    if math.prod(dims) != world:
        raise ValueError(
            f"mesh shape {shape} needs {math.prod(dims)} devices "
            f"but {world} are available"
        )
    if len(dims) not in (1, 2, 3):
        raise ValueError(
            f"mesh shape must be (clients, model) or (hosts, clients, model), "
            f"got {shape}"
        )
    nodes = node_count()
    if len(dims) == 3 and dims[0] % nodes != 0:
        raise ValueError(
            f"hosts axis of {dims[0]} cannot group {nodes} nodes into whole rows "
            "— n_hosts must be a multiple of the node count (each node's ranks "
            "fill complete host rows)"
        )
    mesh = Mesh(dims, _axis_names(len(dims)), rank, dev,
                backend=dist.get_backend() if dist.is_initialized() else None)
    grid = np.arange(world).reshape(mesh.dims)
    # Every rank creates every group, axis by axis, in the same order.
    for axis_i, axis in enumerate(_GRID):
        if mesh.dims[axis_i] == 1:
            continue
        lines = np.moveaxis(grid, axis_i, -1).reshape(-1, mesh.dims[axis_i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                mesh.groups[axis] = group
    return mesh


def mesh_shape_for_model_shards(
    model_shards: int, n_devices: int
) -> tuple[int, int] | None:
    """Validate a ``--model-shards`` request against the device count and
    return the 2-D mesh shape it implies (None for the classic 1-D layout).
    The single source of truth for the CLI and ``run_experiment``."""
    if model_shards < 1:
        raise ValueError(f"model_shards must be >= 1, got {model_shards}")
    if model_shards == 1:
        return None
    if n_devices % model_shards != 0:
        raise ValueError(
            f"model_shards={model_shards} does not divide the {n_devices} "
            "available devices — the 2-D mesh needs a full "
            "(devices/N, N) clients x model grid"
        )
    return (n_devices // model_shards, model_shards)


def mesh_shape_for_topology(
    hosts: int, model_shards: int, n_devices: int
) -> tuple[int, ...] | None:
    """Validate a ``--hosts`` x ``--model-shards`` request against the device
    count and return the mesh shape it implies: None for the classic 1-D
    layout, ``(clients, model)`` for a single-host FSDP mesh, and ``(hosts,
    clients, model)`` once the hosts axis engages.  ``n_devices`` is the world
    size."""
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if hosts == 1:
        return mesh_shape_for_model_shards(model_shards, n_devices)
    if model_shards < 1:
        raise ValueError(f"model_shards must be >= 1, got {model_shards}")
    if n_devices % (hosts * model_shards) != 0:
        raise ValueError(
            f"hosts={hosts} x model_shards={model_shards} does not divide the "
            f"{n_devices} available devices — the 3-D mesh needs a full "
            "(hosts, devices/(hosts*model_shards), model_shards) grid"
        )
    return (hosts, n_devices // (hosts * model_shards), model_shards)


def world_size() -> int:
    """Ranks in the world: 1 without a process group (the JAX ``len(jax.devices())``
    of the mesh validators)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def model_axis_size(mesh: Mesh) -> int:
    """Number of model (parameter) shards: 1 on any mesh without a model axis."""
    return mesh.dims[2]


def host_axis_size(mesh: Mesh) -> int:
    """Number of hosts-axis rows: 1 on any mesh without a hosts axis."""
    return mesh.dims[0]


def client_axis_size(mesh: Mesh) -> int:
    """Size of the ``clients`` axis alone (per-host client shards on a 3-axis mesh; use
    :func:`client_shard_count` for the padding divisor)."""
    return mesh.dims[1]


def mesh_shape(mesh: Mesh) -> tuple[int, ...]:
    """The mesh's per-axis sizes in axis order (``(clients,)``, ``(clients, model)`` or
    ``(hosts, clients, model)``)."""
    return tuple(mesh.shape)


def client_shard_count(mesh: Mesh) -> int:
    """Total shards of the client data axis: ``hosts x clients``, the divisor for
    client padding."""
    return mesh.dims[0] * mesh.dims[1]


def client_axes(mesh: Mesh) -> str | tuple[str, ...]:
    """The axis name(s) the client dimension spans: ``(hosts, clients)`` on the
    3-axis mesh, else the client axis."""
    return (HOST_AXIS, CLIENT_AXIS) if HOST_AXIS in mesh.axis_names else CLIENT_AXIS


def param_partition_spec(
    shape: tuple[int, ...], n_model_shards: int, model_axis: str = MODEL_AXIS
) -> tuple[str | None, ...]:
    """FSDP layout rule for ONE leaf, the JAX ``PartitionSpec``'s entries as a tuple:
    shard the largest dimension divisible by ``n_model_shards`` over the model axis
    (ties pick the first), never the leading dimension of a rank >= 3 leaf (a
    stacking or window dimension); replicate a leaf with no divisible dimension
    (``()``)."""
    if n_model_shards <= 1:
        return ()
    best_dim, best_size = -1, 0
    for i, d in enumerate(shape):
        if i == 0 and len(shape) >= 3:
            continue
        if d % n_model_shards == 0 and d > best_size:
            best_dim, best_size = i, int(d)
    if best_dim < 0:
        return ()
    return tuple([None] * best_dim + [model_axis])


def model_spec_dim(spec: tuple, model_axis: str = MODEL_AXIS) -> int | None:
    """The dimension a :func:`param_partition_spec` shards, or None (replicated)."""
    for i, entry in enumerate(spec):
        if entry == model_axis:
            return i
    return None


def pad_client_count(num_clients: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= ``num_clients``.  Equal shards need it;
    padding clients carry zero weight, so they are aggregation no-ops."""
    return ((num_clients + n_devices - 1) // n_devices) * n_devices


def pad_clients(data: ClientData, target: int) -> ClientData:
    """Pad the leading client axis to ``target`` with zero-mask (dummy) clients."""
    c = data.x.shape[0]
    if c == target:
        return data
    if c > target:
        raise ValueError(f"cannot pad {c} clients down to {target}")
    extra = target - c

    def pad(arr):
        arr = arr.cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
        widths = [(0, extra)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, widths)

    return ClientData(x=pad(data.x), y=pad(data.y), mask=pad(data.mask))


def client_slice(num_padded_clients: int, mesh: Mesh) -> tuple[int, int]:
    """This RANK's contiguous row range ``[start, stop)`` of the padded client axis:
    the rows it fits each round, hosts-major, replicated over the model axis (the
    JAX client sharding's block for this rank's device)."""
    per = num_padded_clients // client_shard_count(mesh)
    j = mesh.client_shard_index
    return j * per, (j + 1) * per


def host_client_slice(num_padded_clients: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's HOST row's contiguous range ``[start, stop)`` of the padded client
    axis: what a rank materialises of the population (the JAX function's process
    range, with one host row to a process).  A cohort slot of this host only ever
    references these rows (host-local sampling), so the cohort gather reads nothing
    of another host."""
    per_host = num_padded_clients // host_axis_size(mesh)
    h = mesh.coords[HOST_AXIS]
    return h * per_host, (h + 1) * per_host


class _LeafSlot(NamedTuple):
    name: str
    shape: tuple[int, ...]
    dim: int | None  # the model-sharded dimension, or None (replicated)
    shard_shape: tuple[int, ...]


def psum_stages(mesh: Mesh) -> list[tuple[str, Any]]:
    """The ``(axis, process group)`` stages of the client reduce, innermost first: the
    clients line, then the hosts line (each only where it has more than one rank)."""
    return [(axis, mesh.groups[axis]) for axis in (CLIENT_AXIS, HOST_AXIS)
            if mesh.groups.get(axis) is not None]


#: The axis a world-wide object collective (:func:`broadcast_object`,
#: :func:`all_gather_object`) is recorded under: it spans every mesh axis at once.
WORLD_AXIS = "world"


class CollectiveRecord(NamedTuple):
    """One collective as a :class:`CollectiveRecorder` saw it: the op, the mesh axis
    of its process group, the operand's shape and dtype (``()`` and None for an
    object collective) and the operand's bytes."""

    op: str
    axis: str
    shape: tuple[int, ...]
    dtype: torch.dtype | None
    bytes: int


_recorder: contextvars.ContextVar["CollectiveRecorder | None"] = contextvars.ContextVar(
    "nanofed_collective_recorder", default=None)


class CollectiveRecorder:
    """While entered (in this thread or task: the recorder is context-local), every
    collective of this module appends a :class:`CollectiveRecord` to ``records`` and
    moves no data: an all-reduce leaves its operand as it is, an all-gather returns an
    empty tensor of the gathered shape on the operand's device, an object collective
    returns this rank's object.  A described mesh (:meth:`Mesh.describe`), whose
    collectives otherwise raise, then stands in for a world of ranks: one process runs
    each rank's program in turn (``analysis.program_audit``)."""

    def __init__(self) -> None:
        self.records: list[CollectiveRecord] = []
        self._token: contextvars.Token | None = None

    def __enter__(self) -> "CollectiveRecorder":
        self._token = _recorder.set(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        _recorder.reset(self._token)

    def record(self, op: str, axis: str, x: torch.Tensor | None) -> None:
        if x is None:
            self.records.append(CollectiveRecord(op, axis, (), None, 0))
            return
        self.records.append(CollectiveRecord(
            op, axis, tuple(int(d) for d in x.shape), x.dtype, x.numel() * x.element_size()))


def _group_size(group: Any) -> int:
    return group.size if isinstance(group, _NoGroup) else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group: Any, axis: str) -> None:
    recorder = _recorder.get()
    if recorder is not None:
        recorder.record("all_reduce", axis, x)
        return
    if isinstance(group, _NoGroup):
        raise RuntimeError("a described mesh (Mesh.describe) runs no collective")
    dist.all_reduce(x, group=group)


def _all_gather(x: torch.Tensor, group: Any, axis: str) -> torch.Tensor:
    """``[n * rows, ...]``: the group's ranks' ``x`` in group-rank order."""
    recorder = _recorder.get()
    if recorder is not None:
        recorder.record("all_gather", axis, x)
        return torch.empty((_group_size(group) * x.shape[0], *x.shape[1:]),
                           dtype=x.dtype, device=x.device)
    if isinstance(group, _NoGroup):
        raise RuntimeError("a described mesh (Mesh.describe) runs no collective")
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _gather_into(out, x, group=group)
    return out


class MeshLayout:
    """The sharding boundary of a round program, shared by the round step and the
    fused block (JAX ``MeshLayout``).

    Client axes: :meth:`client_psum` (one all-reduce over the clients line, then
    one over the hosts line), :meth:`client_all_gather` (the same two stages as
    gathers, so every rank holds every client's row in global row order).

    Model axis (``params_like`` given, more than one model shard): params and any
    params-shaped flat state live as this rank's SHARD, the concatenation of its
    leaves' slices in ravel order (a replicated leaf whole); :meth:`shard_params`
    cuts full params into it, :meth:`gather_full` gathers full params from it with
    one all-gather, :meth:`slice_shard` cuts a full ``[P]`` vector down to it.  On a
    mesh without model shards the three are the identity."""

    def __init__(self, mesh: Mesh, params_like: Params | None = None) -> None:
        self.mesh = mesh
        self.n_model_shards = model_axis_size(mesh)
        self.n_hosts = host_axis_size(mesh)
        self.client_axes = client_axes(mesh)
        self.multi_axis = len(mesh.axis_names) > 1
        self.model_sharded = self.n_model_shards > 1
        if self.model_sharded and params_like is None:
            raise ValueError(
                "a mesh with a model axis needs params_like= at build time: the "
                "per-leaf model-axis layout decides every rank's shard"
            )
        self._slots: list[_LeafSlot] = []
        if params_like is not None:
            for name, leaf in params_like.items():
                shape = tuple(int(d) for d in leaf.shape)
                dim = model_spec_dim(param_partition_spec(shape, self.n_model_shards))
                shard = list(shape)
                if dim is not None:
                    shard[dim] //= self.n_model_shards
                self._slots.append(_LeafSlot(name, shape, dim, tuple(shard)))

    # -- client axes ---------------------------------------------------------------

    def client_psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over every client shard: host-local first, then across
        hosts.  ``x`` itself is left as it was."""
        stages = psum_stages(self.mesh)
        if not stages:
            return x
        y = x.reshape(-1).clone()
        for axis, group in stages:
            _all_reduce(y, group, axis)
        return y.view(x.shape)

    def client_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[C_local, ...] -> [C, ...]``: every client shard's rows in global row order
        (hosts-major), on every rank."""
        for axis, group in psum_stages(self.mesh):
            x = _all_gather(x, group, axis)
        return x

    def host_local_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[rows, ...] -> [n_clients_line * rows, ...]``: the rows of every rank of
        this rank's clients line (one host row's client shards, in client order) —
        the first stage of :meth:`client_all_gather` alone, which moves nothing
        across hosts.  The identity where the line has one rank."""
        group = self.mesh.groups.get(CLIENT_AXIS)
        return x if group is None else _all_gather(x, group, CLIENT_AXIS)

    def hosts_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over this rank's hosts line: ONE all-reduce, in place on
        ``x``, which is returned (the identity without a hosts axis)."""
        group = self.mesh.groups.get(HOST_AXIS)
        if group is not None:
            _all_reduce(x, group, HOST_AXIS)
        return x

    def hosts_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[rows, ...] -> [n_hosts * rows, ...]``: the rows of every rank of this
        rank's hosts line (one rank a host, the same client and model coordinates), in
        host order.  The identity without a hosts axis."""
        group = self.mesh.groups.get(HOST_AXIS)
        return x if group is None else _all_gather(x, group, HOST_AXIS)

    # -- model axis ----------------------------------------------------------------

    def shard_params(self, full: Params) -> Params:
        """This rank's shard of full params (copies; a replicated leaf whole)."""
        if not self.model_sharded:
            return full
        m = self.mesh.coords[MODEL_AXIS]
        out = {}
        for slot in self._slots:
            leaf = full[slot.name]
            if slot.dim is not None:
                size = slot.shard_shape[slot.dim]
                leaf = leaf.narrow(slot.dim, m * size, size)
            out[slot.name] = leaf.contiguous().clone()
        return out

    def gather_full(self, shard: Params) -> Params:
        """Full params from every model shard's piece: ONE all-gather of the flat
        shards over the model line, then each leaf's pieces joined on its sharded
        dimension (exact copies)."""
        if not self.model_sharded:
            return shard
        flat = torch.cat([shard[s.name].reshape(-1) for s in self._slots])
        rows = _all_gather(flat[None], self.mesh.groups[MODEL_AXIS], MODEL_AXIS)
        out, offset = {}, 0
        for slot in self._slots:
            n = math.prod(slot.shard_shape)
            if slot.dim is None:
                out[slot.name] = shard[slot.name]
            else:
                pieces = [rows[r, offset: offset + n].view(slot.shard_shape)
                          for r in range(self.n_model_shards)]
                out[slot.name] = torch.cat(pieces, dim=slot.dim)
            offset += n
        return out

    def slice_shard(self, full_flat: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full ``[P]`` vector in ravel order, as one flat
        vector (the reduce-scatter half of FSDP: the client reduce already left the
        full value on every model column, so a slice suffices)."""
        if not self.model_sharded:
            return full_flat
        m = self.mesh.coords[MODEL_AXIS]
        parts, offset = [], 0
        for slot in self._slots:
            n = math.prod(slot.shape)
            leaf = full_flat[offset: offset + n].view(slot.shape)
            if slot.dim is not None:
                size = slot.shard_shape[slot.dim]
                leaf = leaf.narrow(slot.dim, m * size, size)
            parts.append(leaf.reshape(-1))
            offset += n
        return torch.cat(parts)


def hierarchical_psum(x: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    """The sum of ``x`` over every client shard, innermost first (the JAX function's
    torch meaning: :meth:`MeshLayout.client_psum`; it takes the layout, which owns the
    axes, where the JAX one takes axis names)."""
    return layout.client_psum(x)


def hierarchical_pmean(x: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    """The mean of ``x`` over every client shard (:func:`hierarchical_psum` divided by
    the shard count)."""
    return layout.client_psum(x) / client_shard_count(layout.mesh)


def hierarchical_all_gather(x: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    """Every client shard's rows, innermost first (:meth:`MeshLayout.client_all_gather`)."""
    return layout.client_all_gather(x)


def sum_fn_of(layout: MeshLayout | None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> sum(x)`` over this rank's rows and then every client shard (the
    validation z-score's ``sum_fn``); the local sum without a layout."""
    if layout is None:
        return lambda x: x.sum()
    return lambda x: layout.client_psum(x.sum())


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` as rank ``src`` holds it, on every rank (the identity without a process
    group): how one rank's pick (the autotuner's winner, a retune verdict) reaches
    every rank, so they all build the same mesh and program.  Under a
    :class:`CollectiveRecorder` it is recorded and returns ``obj``."""
    recorder = _recorder.get()
    if recorder is not None:
        recorder.record("broadcast_object", WORLD_AXIS, None)
        return obj
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any) -> list[Any]:
    """Every rank's ``obj``, in rank order, on every rank (``[obj]`` without a process
    group; recorded, and ``[obj]``, under a :class:`CollectiveRecorder`)."""
    recorder = _recorder.get()
    if recorder is not None:
        recorder.record("all_gather_object", WORLD_AXIS, None)
        return [obj]
    if not dist.is_initialized():
        return [obj]
    out: list[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def is_primary() -> bool:
    """True on rank 0 and without a process group: the rank that writes the run's
    files (metrics JSON, checkpoints, versioned models, telemetry)."""
    return not dist.is_initialized() or dist.get_rank() == 0
