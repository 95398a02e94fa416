"""Runtime contracts for round programs, the dynamic half of fedlint (counterpart of
``nanofed_tpu/analysis/contracts.py``).

Static analysis (``analysis.fedlint``) proves properties of the source; these helpers
prove properties of the built program without running it on data:

* :func:`check_round_step` / :func:`check_round_block` run the round program on
  ``meta`` copies of its arguments (nothing executes, nothing is allocated; the
  kernels' wrappers take their plain versions, which compute only shapes) and hold
  the execution contract the ``Coordinator`` relies on: output params and server
  state match the inputs leaf for leaf (structure, shape, dtype), metrics are scalars
  (``[R]`` stacks for a fused block), per-client stacks carry the cohort width.  A
  drifted program fails here, at build time, naming the leaf by its ``/``-path (the
  JAX package names it by ``keystr``).  A program that reads a device value on the
  host cannot run on meta tensors: that read is itself the finding, named by the op
  and the source line.  Collectives run under ``parallel.mesh.CollectiveRecorder``,
  so a mesh program's trace moves nothing between ranks.
* :func:`strict_mode` arms ``torch.cuda.set_sync_debug_mode("error")`` for the
  enclosed dispatch (the twin of ``jax.transfer_guard("disallow")``): any
  synchronizing call through c10 raises, explicit ones too (``.item()``, ``bool()``
  of a device tensor, ``nonzero``, a copy to the host, a pageable copy to the card
  with ``non_blocking=False``).  It cannot see a synchronize inside a C entry loaded
  through ctypes (the port's kernels call none), and it is a no-op on the CPU.
* :func:`check_input_shardings` holds a rank's concrete tensors to the mesh layout:
  its data rows are its ``client_slice`` or its host's ``host_client_slice``, and
  params (and a frozen base) are full or this rank's model shard per
  ``param_partition_spec``, never cut on the client or hosts axis.

Stated differences: the contract runs the program on meta tensors where JAX traces a
jaxpr (``jax.eval_shape``), so a host read is a finding rather than a tracer error;
leaves are named by ``/``-path; the round step's randomness arrives as permutations
and dropout keys, not keys to split; a fused block's device draws run with host
generators on meta tensors (a meta draw is a shape); and a Python-int server counter
is held as a 0-d int64 leaf, the form the port's round step returns it in.
"""

from __future__ import annotations

import contextlib
import traceback
from pathlib import Path
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.parallel.mesh import (
    CLIENT_AXIS,
    HOST_AXIS,
    MODEL_AXIS,
    CollectiveRecorder,
    Mesh,
    client_slice,
    host_client_slice,
    model_axis_size,
    model_spec_dim,
    param_partition_spec,
)

__all__ = [
    "ContractViolation",
    "check_input_shardings",
    "check_round_block",
    "check_round_step",
    "strict_mode",
]

aten = torch.ops.aten


class ContractViolation(NanoFedError):
    """A built round program does not satisfy the round-engine contract."""


# ---------------------------------------------------------------------------
# Trees, meta copies and host reads (shared with analysis.program_audit)
# ---------------------------------------------------------------------------


def leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of a tree of dicts, named tuples, lists and
    tuples, the path ``/``-joined from the root (``"w"``, ``"loss"``, ``"0/b"``)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for key, value in items:
        out.extend(leaves_with_paths(value, f"{prefix}/{key}" if prefix else key))
    return out


def to_meta(tree: Any) -> Any:
    """The tree with every tensor replaced by a ``meta`` tensor of its shape, dtype and
    strides (no data is read or copied; a meta tensor stays itself); everything else
    as it is."""
    if torch.is_tensor(tree):
        if tree.device.type == "meta":
            return tree
        return torch.empty_strided(tuple(tree.shape), tuple(tree.stride()),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return type(tree)((k, to_meta(v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


#: Ops that read a device value on the host: a scalar read (``.item()``, ``bool()``,
#: ``int()``, ``float()``), or a result whose shape depends on the data.
HOST_READ_OPS = frozenset({
    aten._local_scalar_dense, aten.nonzero, aten.equal, aten.is_nonzero,
    aten.masked_select, aten._unique2, aten.unique_consecutive, aten.unique_dim,
})


def source_line() -> str:
    """The innermost frame of the program being traced (outside torch and this
    package's analysis), as ``path:line (function)``."""
    for frame in reversed(traceback.extract_stack()):
        path = Path(frame.filename).as_posix()
        if "/torch/" in path or "/nanofed_tpu_torch/analysis/" in path:
            continue
        for pkg in ("nanofed_tpu_torch/", "tests/", "scripts/"):
            if pkg in path:
                path = pkg + path.split(pkg, 1)[1]
                break
        return f"{path}:{frame.lineno} ({frame.name})"
    return "<unknown>"


def _stand_in(packet: Any, args: tuple) -> Any:
    """What a host read returns under a recording trace, so the program runs on."""
    x = args[0] if args and torch.is_tensor(args[0]) else None
    if packet is aten._local_scalar_dense:
        if x is not None and x.dtype == torch.bool:
            return False
        return 0.0 if x is not None and x.is_floating_point() else 0
    if packet in (aten.equal, aten.is_nonzero):
        return False
    if packet is aten.nonzero:
        return torch.empty((0, x.ndim), dtype=torch.int64, device=x.device)
    device = x.device if x is not None else "meta"
    return torch.empty((0,), dtype=x.dtype if x is not None else torch.int64, device=device)


class MetaTrace(TorchDispatchMode):
    """A dispatch mode for a program run on meta tensors.  A host read of a device
    value (:data:`HOST_READ_OPS`, or a copy to the CPU) raises
    :class:`ContractViolation` naming the op and the source line, or with
    ``record=True`` is noted in ``host_reads`` and answered with a stand-in so the
    run goes on.  ``on_op(func, args, kwargs, out)``, when given, sees every other
    op.  Host arithmetic on CPU tensors is not a device read and passes."""

    def __init__(self, program: str, record: bool = False,
                 on_op: Callable[..., None] | None = None) -> None:
        super().__init__()
        self.program = program
        self.record = record
        self.on_op = on_op
        self.host_reads: list[tuple[str, str]] = []

    def _read(self, what: str, stand_in: Callable[[], Any]) -> Any:
        where = source_line()
        if not self.record:
            raise ContractViolation(
                f"{self.program}: {what} at {where} reads a device value on the host "
                "— a round program's dispatch must not wait for the device (keep the "
                "value a tensor: torch.where, a 0-d counter)"
            )
        self.host_reads.append((what, where))
        return stand_in()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        tensors = [a for a in args if torch.is_tensor(a)]
        on_device = any(t.device.type != "cpu" for t in tensors)
        if packet in HOST_READ_OPS and on_device:
            return self._read(f"aten.{packet.__name__}", lambda: _stand_in(packet, args))
        if packet is aten._to_copy and on_device and \
                torch.device(kwargs.get("device") or tensors[0].device).type == "cpu":
            x = tensors[0]
            return self._read("a copy to the host (aten._to_copy)", lambda: torch.zeros(
                x.shape, dtype=kwargs.get("dtype") or x.dtype))
        if packet is aten.copy_ and len(tensors) == 2 and \
                tensors[0].device.type == "cpu" and tensors[1].device.type != "cpu":
            return self._read("a copy to the host (aten.copy_)", lambda: tensors[0])
        out = func(*args, **kwargs)
        if self.on_op is not None:
            self.on_op(func, args, kwargs, out)
        return out


def run_on_meta(program: str, fn: Callable, args: tuple, kwargs: dict | None = None,
                record: bool = False, on_op: Callable[..., None] | None = None
                ) -> tuple[Any, MetaTrace, CollectiveRecorder]:
    """``fn(*args, **kwargs)`` on meta tensors (the caller's tensors are converted, so
    nothing of theirs is touched) under a :class:`MetaTrace` and a
    ``CollectiveRecorder``.  Returns the output, the trace and the recorder.  A
    program that fails on meta tensors (an op without a meta kernel, a read of a
    meta tensor's data outside dispatch) raises :class:`ContractViolation` naming the
    error and the source line, unless ``record`` is set: then that read is noted and
    the output is None."""
    trace = MetaTrace(program, record=record, on_op=on_op)
    recorder = CollectiveRecorder()
    args, kwargs = to_meta(tuple(args)), to_meta(dict(kwargs or {}))
    with recorder, trace:
        try:
            out = fn(*args, **kwargs)
        except ContractViolation:
            raise
        except (RuntimeError, NotImplementedError) as e:
            where = _error_line(e)
            if not record:
                raise ContractViolation(
                    f"{program}: the program cannot run on meta tensors ({e}) at {where}"
                ) from e
            trace.host_reads.append((f"{type(e).__name__}: {str(e).splitlines()[0]}", where))
            out = None
    return out, trace, recorder


def _error_line(e: BaseException) -> str:
    for frame in reversed(traceback.extract_tb(e.__traceback__)):
        path = Path(frame.filename).as_posix()
        if "/torch/" not in path and "/nanofed_tpu_torch/analysis/" not in path:
            return f"{path}:{frame.lineno} ({frame.name})"
    return "<unknown>"


# ---------------------------------------------------------------------------
# The round-engine contract
# ---------------------------------------------------------------------------


def _spec(x: Any) -> tuple[tuple[int, ...], Any]:
    if isinstance(x, bool):
        return (), torch.bool
    if isinstance(x, int):
        return (), torch.int64
    if isinstance(x, float):
        return (), torch.float64
    return tuple(int(d) for d in x.shape), x.dtype


def _assert_tree_matches(got: Any, want: Any, what: str) -> None:
    """Leaf-for-leaf structure + shape + dtype equality, named on failure."""
    got_leaves, want_leaves = leaves_with_paths(got), leaves_with_paths(want)
    got_paths, want_paths = [p for p, _ in got_leaves], [p for p, _ in want_leaves]
    if got_paths != want_paths:
        raise ContractViolation(
            f"{what}: output tree structure {got_paths} does not match the input "
            f"structure {want_paths} — the round program must return {what} with the "
            "exact tree it was given"
        )
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        (gs, gd), (ws, wd) = _spec(g), _spec(w)
        if (gs, gd) != (ws, wd):
            raise ContractViolation(
                f"{what}/{path}: output is {gd}{gs} but the input leaf is {wd}{ws} — a "
                "round program must be shape/dtype-stable from round to round"
            )


def _assert_leading_dim(tree: Any, dim: int, what: str) -> None:
    for path, leaf in leaves_with_paths(tree):
        shape = _spec(leaf)[0]
        if len(shape) < 1 or shape[0] != dim:
            name = f"{what}/{path}" if path else what
            raise ContractViolation(
                f"{name}: expected leading dimension {dim}, got shape {shape}")


def _n_leaves(tree: Any) -> int:
    return len(leaves_with_paths(tree))


def check_round_step(
    step: Callable,
    params: Any,
    server_opt_state: Any,
    data: Any,
    weights: Any,
    perms: Any,
    keys: Any = None,
    noise: Any = None,
    lr_scale: float = 1.0,
    frozen_base: Any = None,
    clients: int | None = None,
) -> dict[str, Any]:
    """Validate a ``build_round_step`` program against the round-engine contract.

    Runs ``step(params, server_opt_state, [frozen_base,] data, weights, perms, keys,
    noise, lr_scale)`` on meta copies (nothing executes) and checks:

    * ``result.params`` / ``result.server_opt_state`` match the input trees leaf for
      leaf (structure, shape, dtype): the fixed point the Coordinator threads from
      round to round;
    * every entry of ``result.metrics`` is a scalar;
    * ``result.client_metrics`` / ``result.update_sq_norms`` lead with the step's
      client width: ``clients``, default ``weights.shape[0]`` (a mesh rank passes the
      whole step's width, since the per-client rows come back gathered).

    ``frozen_base`` is the adapter round's read-only base, the third argument, absent
    from the fixed point (as in the JAX package).  Returns a small report dict;
    raises :class:`ContractViolation` with the offending leaf's path otherwise."""
    n_clients = int(weights.shape[0] if clients is None else clients)
    base = () if frozen_base is None else (frozen_base,)
    out, _, _ = run_on_meta(
        "round_step", step,
        (params, server_opt_state, *base, data, weights, perms, keys, noise, lr_scale))
    _assert_tree_matches(out.params, params, "params")
    _assert_tree_matches(out.server_opt_state, server_opt_state, "server_opt_state")
    for path, leaf in leaves_with_paths(out.metrics):
        if _spec(leaf)[0] != ():
            raise ContractViolation(
                f"metrics/{path}: round metrics must be weighted scalars, got shape "
                f"{_spec(leaf)[0]}"
            )
    _assert_leading_dim(out.client_metrics, n_clients, "client_metrics")
    _assert_leading_dim(out.update_sq_norms, n_clients, "update_sq_norms")
    return {
        "program": "round_step",
        "params_leaves": _n_leaves(params),
        "metrics": sorted(out.metrics),
        "clients": n_clients,
        **({"frozen_base_leaves": _n_leaves(frozen_base)}
           if frozen_base is not None else {}),
    }


def check_round_block(
    block: Callable,
    params: Any,
    server_opt_state: Any,
    data: Any,
    num_samples: Any,
    round_seeds: Any,
    lr_scales: Any,
    cohort_idx: Any = None,
    cohort_mask: Any = None,
    frozen_base: Any = None,
) -> dict[str, Any]:
    """Validate a fused ``build_round_block`` program (R rounds, one per round seed).

    The contract of :func:`check_round_step` lifted over the block: params and server
    state are a fixed point of the whole block, per-round metrics stack ``[R]``,
    survivors is an ``[R]`` integer vector, and the per-client detail stacks lead
    with R.  ``round_seeds`` and ``lr_scales`` are the block's host ints and floats;
    ``frozen_base`` is the adapter mode's base (``base_params=``), absent from the
    fixed point.  Raises :class:`ContractViolation` with the offending leaf's path;
    returns a report dict."""
    rounds = len(round_seeds)
    kwargs = {} if frozen_base is None else {"base_params": frozen_base}
    out, _, _ = run_on_meta(
        "round_block", block,
        (params, server_opt_state, data, num_samples, list(round_seeds), list(lr_scales),
         cohort_idx, cohort_mask), kwargs)
    _assert_tree_matches(out.params, params, "params")
    _assert_tree_matches(out.server_opt_state, server_opt_state, "server_opt_state")
    _assert_leading_dim(out.metrics, rounds, "metrics")
    if tuple(out.survivors.shape) != (rounds,):
        raise ContractViolation(
            f"survivors: expected shape ({rounds},), got {tuple(out.survivors.shape)}")
    if out.survivors.dtype.is_floating_point or out.survivors.dtype == torch.bool:
        raise ContractViolation(
            f"survivors: expected an integer dtype, got {out.survivors.dtype}")
    for name in ("client_metrics", "update_sq_norms", "weights", "cohort_ids"):
        detail = getattr(out, name)
        if detail is not None:
            _assert_leading_dim(detail, rounds, name)
    return {
        "program": "round_block",
        "rounds": rounds,
        "params_leaves": _n_leaves(params),
        "metrics": sorted(out.metrics),
        "client_detail": out.client_metrics is not None,
    }


# ---------------------------------------------------------------------------
# The mesh layout of a rank's concrete inputs
# ---------------------------------------------------------------------------


def _model_shard(full: torch.Tensor, spec_dim: int | None, mesh: Mesh) -> torch.Tensor:
    if spec_dim is None:
        return full
    size = full.shape[spec_dim] // model_axis_size(mesh)
    return full.narrow(spec_dim, mesh.coords[MODEL_AXIS] * size, size)


def _check_model_state(tree: Any, like: Any, mesh: Mesh | None, what: str) -> None:
    """Every leaf of ``tree`` is its full leaf in ``like`` or this rank's model shard
    of it (checked by value where ``like`` holds values, by shape on meta tensors)."""
    if like is None and mesh is None:
        return  # full params by construction: nothing to hold them to
    like_leaves = dict(leaves_with_paths(like)) if like is not None else {}
    n_model = 1 if mesh is None else model_axis_size(mesh)
    for path, leaf in leaves_with_paths(tree):
        full = like_leaves.get(path, leaf)
        shape, full_shape = tuple(leaf.shape), tuple(full.shape)
        dim = model_spec_dim(param_partition_spec(full_shape, n_model))
        if shape == full_shape and (dim is None or n_model == 1):
            candidates = [full]
        else:
            candidates = [full, _model_shard(full, dim, mesh)] if mesh is not None else [full]
        allowed = [c for c in candidates if tuple(c.shape) == shape]
        if not allowed:
            raise ContractViolation(
                f"{what}/{path}: shape {shape} is neither the full leaf {full_shape} nor "
                f"this rank's {MODEL_AXIS!r}-axis shard — model state rides every rank "
                "whole or split over the model axis only; a leaf cut on the "
                f"{CLIENT_AXIS!r} or {HOST_AXIS!r} axis is never valid"
            )
        if full.device.type != "meta" and leaf.device.type != "meta" and not any(
                torch.equal(leaf.to(c.device), c) for c in allowed):
            raise ContractViolation(
                f"{what}/{path}: holds values of another rank's piece — on this rank "
                f"(coords {None if mesh is None else mesh.coords}) it must be the full "
                f"leaf or its own {MODEL_AXIS!r}-axis shard, never a {CLIENT_AXIS!r}- or "
                f"{HOST_AXIS!r}-axis cut"
            )


def check_input_shardings(
    data: Any,
    params: Any,
    mesh: Mesh | None = None,
    *,
    padded_clients: int | None = None,
    params_like: Any = None,
    base_params: Any = None,
    base_like: Any = None,
) -> None:
    """Hold a rank's concrete inputs to the mesh layout (the JAX function checks the
    ``NamedSharding`` of global arrays; here one rank holds its own tensors).

    Client data (``ClientData`` or any tree of ``[rows, ...]`` tensors): ``rows`` is
    the size of this rank's ``client_slice`` of the ``padded_clients`` rows or of its
    host row's ``host_client_slice`` (what a ``Coordinator`` rank holds), so data cut
    over the model axis too, or not cut at all, is refused.  Params: every
    leaf is full (``params_like``'s leaf, default itself) or this rank's model shard
    per ``param_partition_spec``, never a client- or hosts-axis cut.  ``base_params``
    (adapter mode's frozen base) follows the same rule against ``base_like``.
    Without a mesh the data holds every row and the params are full."""
    leaves = leaves_with_paths(data)
    if leaves:
        rows = int(leaves[0][1].shape[0])
        padded = rows if padded_clients is None and mesh is None else padded_clients
        if padded is None:
            raise ValueError("check_input_shardings on a mesh needs padded_clients=")
        ranges = [(0, padded)] if mesh is None else sorted(
            {client_slice(padded, mesh), host_client_slice(padded, mesh)})
        for path, leaf in leaves:
            n = int(leaf.shape[0]) if leaf.ndim else -1
            matching = [r for r in ranges if r[1] - r[0] == n]
            if not matching:
                raise ContractViolation(
                    f"data/{path}: {n} client rows, but this rank's rows are "
                    f"{' or '.join(f'[{a}, {b})' for a, b in ranges)} of {padded} — the "
                    "client axis is sharded hosts-major over the ranks"
                )
    _check_model_state(params, params_like, mesh, "params")
    if base_params is not None:
        _check_model_state(base_params, base_like, mesh, "base_params")


# ---------------------------------------------------------------------------
# The sync guard
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def strict_mode(device: torch.device | str | None = None) -> Iterator[None]:
    """Refuse every synchronizing CUDA call for the enclosed dispatch.

    Arms ``torch.cuda.set_sync_debug_mode("error")`` and restores the previous mode
    on exit, also after an exception.  Inside, any call that makes the host wait for
    the card through c10 raises: ``.item()``, ``bool()``/``int()``/``float()`` of a
    device tensor, ``nonzero``, a copy to the host, a pageable host tensor copied to
    the card with ``non_blocking=False``.  Unlike the JAX guard, which refuses only
    IMPLICIT transfers, it refuses explicit ones too: strict mode proves the dispatch
    never waits for the card.  It cannot see a synchronize inside a C entry loaded
    through ctypes (the port's kernels call none).  The mode is process-global.

    On the CPU (no CUDA, or ``device`` a CPU device) it is a no-op: nothing there
    waits for a card.  This is the runtime half of fedlint's FED001."""
    dev = None if device is None else torch.device(device)
    if not torch.cuda.is_available() or (dev is not None and dev.type != "cuda"):
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)
