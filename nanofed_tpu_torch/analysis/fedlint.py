"""fedlint — a torch- and concurrency-aware static analysis pass for round programs
(counterpart of ``nanofed_tpu/analysis/fedlint.py``).

The port's performance story (a round step and a fused block that enqueue the whole
round on the card and read nothing back between rounds) rests on invariants ordinary
linters cannot see: no synchronizing call inside the round's dispatch, no Python
branch on a device tensor there, collectives only through the mesh's axes, and no
unlocked mutation of the HTTP server's shared round state.  fedlint turns them into
rules the package is held to (``tests/test_torch_analysis.py``'s self-lint gate).

Pure stdlib (``ast`` + ``re``): no third-party dependency, importable anywhere.  The
rule codes, the suppression syntax and ``Diagnostic``/``lint_paths``/``lint_source``/
``render_text`` are the JAX package's.

Rules
-----
- **FED000** — malformed suppression: every ``# fedlint: disable=FEDxxx`` must
  carry a parenthesized reason.
- **FED001** — host synchronization inside a round program's dispatch scope
  (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``,
  ``np.asarray``/``np.array`` of a tensor, ``bool()``/``int()``/``float()`` of a
  tensor value), or a ``torch.cuda.synchronize()`` in the round-dispatch hot path
  (``orchestration``/``parallel``) outside it, the twin of JAX's
  ``block_until_ready``.  Intentional block-boundary syncs need a documented
  suppression.
- **FED002** — Python ``if``/``while`` on a tensor value inside the dispatch scope:
  the branch reads the value back, a host sync in the middle of the round — use
  ``torch.where`` or keep the count on the device.
- **FED005** — unlocked mutation of lock-guarded shared state: in a class that owns
  an ``asyncio.Lock`` (``self._lock``), any attribute mutated somewhere under
  ``async with self._lock`` must be mutated under it everywhere.
- **FED006** — blocking call inside ``async def`` (``time.sleep``, synchronous file
  IO, ``requests``, ``subprocess``); in ``communication`` request handlers
  (``_handle_*``) also an unbounded await of the request body (``await
  request.read()``/``.json()``/``.text()`` without ``asyncio.wait_for``).
- **FED007** — a raw ``torch.distributed`` collective, or an axis-name string
  literal indexing ``mesh.groups``, in the ``parallel``/``aggregation``/
  ``orchestration``/``communication`` layers outside ``parallel/mesh.py``: every
  collective goes through the mesh (``MeshLayout``, ``broadcast_object``,
  ``all_gather_object``), which owns the axes, records collectives for the program
  audit and is where a described mesh stands in for a world.
- **FED008** — fire-and-forget task: an ``asyncio.create_task``/``ensure_future``
  whose reference is dropped, or whose exceptions have no sink.  Use
  ``utils.aio.spawn_logged`` or attach an explicit sink.
- **FED009** — blocking file I/O inside ``async def`` (``json.dump``, ``pickle``,
  ``os.replace``, ``shutil``, ``Path.mkdir``/``unlink``) outside
  ``asyncio.to_thread``.  Nested ``def``s are exempt.
- **FED010** — wall-clock time (``time.time()``/``datetime.now()``) in the
  Clock-injected subsystems (``communication``/``loadgen``/``faults``/``service``/
  ``observability``); ``observability.tracing.forensic_now`` is the sanctioned
  doorway for forensic stamps.

The dispatch scope (FED001/FED002; the JAX package's "traced scope") is rooted at
the closures that the round-program builders return (:data:`DISPATCH_BUILDERS`:
``build_round_step``, ``build_round_block``, ``build_scaffold_round_step``) and
propagates over call edges within the analysed files, as the JAX pass propagates
traced scope.  A value is a tensor when it comes from a ``torch`` producer, a method
of a tensor, arithmetic or a comparison on one, a subscript or non-static attribute
of one, a call fed one (unless the callee is an analysed function annotated to
return a host type, or a host builtin such as ``len``), or is a parameter of a
dispatch-scope function annotated as a ``Tensor``; it propagates through
assignments as the JAX pass propagates traced values.  Roots are the builders'
returned closures, all of whose parameters are tensor-valued unless annotated with
a host type.

Dropped, as stated differences: **FED003** (PRNG key reuse) — the port's randomness
is counter-based hashes of explicit integers (``trainer.local.client_keys``,
``nn.keep_mask``) and seeded ``torch.Generator`` streams, which advance on every
draw, so there is no key to reuse; **FED004** (``jit`` without ``donate_argnums``)
— torch has no buffer donation: the eager port frees an input buffer when its last
reference goes.

Suppressions: ``# fedlint: disable=FED001,FED002 (why this site is intentional)``
on the flagged line or on a standalone comment line directly above it;
``# fedlint: disable-file=FEDxxx (why the whole file is exempt)`` anywhere
suppresses for the whole file.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

__all__ = [
    "DISPATCH_BUILDERS",
    "DROPPED_RULES",
    "RULES",
    "Diagnostic",
    "lint_paths",
    "lint_source",
    "render_text",
]

RULES: dict[str, str] = {
    "FED000": "suppression comment without a parenthesized reason",
    "FED001": "host synchronization inside a round program's dispatch / hot dispatch path",
    "FED002": "Python control flow on a tensor value inside a round program's dispatch",
    "FED005": "unlocked mutation of lock-guarded shared state",
    "FED006": "blocking call inside async code / unbounded await in a request handler",
    "FED007": "raw torch.distributed collective or axis-name string outside parallel/mesh.py",
    "FED008": "fire-and-forget task without an exception sink",
    "FED009": "blocking file I/O inside async code outside to_thread",
    "FED010": "wall-clock time in a Clock-injected subsystem",
}

#: The JAX package's rules the port does not keep, with the reason (module docstring).
DROPPED_RULES: dict[str, str] = {
    "FED003": "no PRNG keys: counter-based hashes of explicit integers and seeded "
              "torch.Generator streams, which advance on every draw",
    "FED004": "torch has no buffer donation: an eager input buffer is freed when its "
              "last reference goes",
}

#: Round-program builders whose returned closures root the dispatch scope.
DISPATCH_BUILDERS = frozenset({
    "build_round_step", "build_round_block", "build_scaffold_round_step",
})

#: The port's package and the JAX package: a module's layer is its path below either.
_PACKAGES = ("nanofed_tpu_torch", "nanofed_tpu")

#: Attribute accesses that stay on the host even on a tensor.
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "is_meta", "layout",
    "requires_grad", "grad_fn", "names", "sharding", "aval", "size",
}

#: Tensor methods that return host values without reading the tensor's data.
_STATIC_METHODS = {
    "size", "dim", "numel", "stride", "element_size", "data_ptr", "is_contiguous",
    "get_device", "nelement", "storage_offset", "is_floating_point", "is_complex",
    "untyped_storage",
}

#: Tensor methods that synchronize (FED001).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: ``torch.<name>`` callables that do not produce tensors.
_TORCH_HOST = {
    "is_tensor", "device", "Generator", "Size", "dtype", "get_default_dtype",
    "is_floating_point", "is_complex", "numel", "finfo", "iinfo", "no_grad",
    "enable_grad", "inference_mode", "manual_seed", "set_grad_enabled",
    "is_grad_enabled", "use_deterministic_algorithms", "typename", "result_type",
    "promote_types", "can_cast", "compile", "get_device",
}

#: ``torch.`` submodules whose functions produce tensors.
_TORCH_PRODUCER_MODULES = ("torch.nn.functional.", "torch.linalg.", "torch.fft.",
                           "torch.special.")

#: Builtins that return host values whatever they are fed (a cast of a tensor is
#: itself a FED001 finding; what it returns is a host number).
_HOST_BUILTINS = {
    "len", "isinstance", "issubclass", "range", "hasattr", "id", "type", "callable",
    "repr", "str", "print", "sorted", "enumerate", "zip", "int", "float", "bool",
}

#: Annotation names of host values (a parameter or return annotated so is no tensor).
_HOST_ANNOTATIONS = {
    "int", "float", "bool", "str", "bytes", "None", "slice", "range", "Sequence",
    "Mapping", "Iterable", "Callable", "Path", "dtype", "device",
}

#: Mutating container methods (FED005 mutation detection).
_MUTATORS = {
    "clear", "pop", "popitem", "update", "setdefault", "append", "extend",
    "add", "remove", "discard", "insert",
}

#: Blocking calls inside ``async def`` (FED006).
_BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
    "urllib.request.urlopen",
}
_BLOCKING_PREFIXES = ("requests.",)
_SYNC_IO_METHODS = {"write_text", "read_text", "write_bytes", "read_bytes"}

#: Request-body awaits with NO internal timeout (FED006's unbounded-await
#: extension): in ``communication`` request handlers these must be wrapped in
#: ``asyncio.wait_for`` — the peer controls how long they take.
_UNBOUNDED_AWAIT_METHODS = {"read", "json", "text", "receive"}

#: Layers whose code OUTSIDE the dispatch scope is still held to the no-hidden-sync
#: bar (the round-dispatch hot path): ``torch.cuda.synchronize`` there must carry a
#: documented suppression.
_HOT_PATH_LAYERS = ("orchestration", "parallel")

#: Layers where collectives go through ``parallel/mesh.py`` (FED007), and the module
#: that owns them.
_COLLECTIVE_LAYERS = ("parallel", "aggregation", "orchestration", "communication")
_MESH_MODULE = "parallel.mesh"

#: ``torch.distributed`` collectives FED007 flags.
_RAW_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_single",
    "_all_gather_base", "all_gather_object", "broadcast", "broadcast_object_list",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "gather", "gather_object", "scatter", "scatter_object_list",
    "barrier", "send", "recv", "isend", "irecv", "monitored_barrier",
}

#: Task-spawning call names (last dotted segment) tracked by FED008.
_TASK_SPAWNERS = {"create_task", "ensure_future"}

#: Awaits that count as an exception sink for a task passed as a direct
#: argument (FED008).  ``shield`` is deliberately absent: a shield-wrapped
#: await abandons the task's exception on timeout-cancel.
_TASK_AWAITERS = {"gather", "wait", "wait_for"}

#: Blocking file-I/O calls inside ``async def`` (FED009).
_BLOCKING_IO_CALLS = {
    "json.dump", "json.load", "pickle.dump", "pickle.load",
    "os.replace", "os.rename", "os.remove", "os.unlink",
    "os.makedirs", "os.mkdir", "os.rmdir",
    "shutil.copy", "shutil.copy2", "shutil.copyfile", "shutil.copytree",
    "shutil.move", "shutil.rmtree",
}
_BLOCKING_IO_METHODS = {"mkdir", "unlink", "rmdir", "touch", "rename"}

#: Layers built around the injectable ``utils.clock.Clock`` (FED010).
_CLOCKED_LAYERS = ("communication", "loadgen", "faults", "service", "observability")

#: Wall-clock reads FED010 flags in the clocked layers.
_WALL_CLOCK_CALLS = {
    "time.time", "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}

#: FED010 allowlist: ``(layer module, function)`` bodies whose wall-clock reads are
#: sanctioned: ``observability.tracing.forensic_now`` is the forensic-stamp doorway.
_FORENSIC_CLOCK_FUNCS = {
    ("observability.tracing", "forensic_now"),
}

_SUPPRESS_RE = re.compile(
    r"#\s*fedlint:\s*(disable|disable-file)\s*=\s*([A-Z0-9,\s]+?)\s*(?:\(([^)]*)\))?\s*$"
)


def _layer(module: str) -> str:
    """A module's path below the package (``nanofed_tpu_torch.parallel.mesh`` ->
    ``parallel.mesh``); the module itself when it is in neither package."""
    for pkg in _PACKAGES:
        if module == pkg:
            return ""
        if module.startswith(pkg + "."):
            return module[len(pkg) + 1:]
    return module


def _in_layers(module: str, layers: tuple[str, ...]) -> bool:
    layer = _layer(module)
    return module != layer and any(layer == x or layer.startswith(x + ".") for x in layers)


@dataclass(frozen=True, order=True)
class Diagnostic:
    """One finding: ``path:line:col  CODE  message``."""

    path: str
    line: int
    col: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


@dataclass
class _Suppressions:
    by_line: dict[int, set[str]] = field(default_factory=dict)
    whole_file: set[str] = field(default_factory=set)
    malformed: list[int] = field(default_factory=list)

    def covers(self, line: int, code: str) -> bool:
        return code in self.whole_file or code in self.by_line.get(line, set())


def _parse_suppressions(source_lines: list[str]) -> _Suppressions:
    sup = _Suppressions()
    for i, raw in enumerate(source_lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        kind, codes_raw, reason = m.group(1), m.group(2), m.group(3)
        codes = {c.strip() for c in codes_raw.split(",") if c.strip()}
        if not reason or not reason.strip():
            sup.malformed.append(i)
            continue
        if kind == "disable-file":
            sup.whole_file |= codes
            continue
        sup.by_line.setdefault(i, set()).update(codes)
        if raw.lstrip().startswith("#"):
            # Standalone comment: the suppression targets the statement below it.
            sup.by_line.setdefault(i + 1, set()).update(codes)
    return sup


# ---------------------------------------------------------------------------
# Per-file model: imports, functions, call edges
# ---------------------------------------------------------------------------


@dataclass
class _FunctionInfo:
    module: str
    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    scopes: tuple[str, ...]  # enclosing function qualnames, outermost first
    calls: list[str] = field(default_factory=list)  # resolved dotted names
    local_calls: list[str] = field(default_factory=list)  # bare called names
    traced: bool = False  # in a round program's dispatch scope
    root: bool = False  # a closure a round-program builder returns

    @property
    def params(self) -> list[str]:
        a = self.node.args
        return [p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]]


class _FileModel:
    """Everything fedlint knows about one source file."""

    def __init__(self, path: str, module: str, source: str) -> None:
        self.path = path
        self.module = module
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.suppressions = _parse_suppressions(self.source_lines)
        self.aliases: dict[str, str] = {}
        self.functions: dict[str, _FunctionInfo] = {}
        self._collect_imports()
        self._collect_functions()

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted name of an expression (``jnp.sum`` -> ``jax.numpy.sum``)."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def _collect_functions(self) -> None:
        model = self

        class Collector(ast.NodeVisitor):
            def __init__(self) -> None:
                self.scopes: list[str] = []

            def _register(self, node: ast.AST, name: str) -> None:
                qual = ".".join([*self.scopes, name])
                model.functions[qual] = _FunctionInfo(
                    model.module, qual, node, tuple(self.scopes)
                )
                self.scopes.append(name)
                self.generic_visit(node)
                self.scopes.pop()

            def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
                self._register(node, node.name)

            def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
                self._register(node, node.name)

            def visit_Lambda(self, node: ast.Lambda) -> None:
                self._register(node, f"<lambda:{node.lineno}>")

            def visit_ClassDef(self, node: ast.ClassDef) -> None:
                self.scopes.append(node.name)
                self.generic_visit(node)
                self.scopes.pop()

        Collector().visit(self.tree)
        for info in self.functions.values():
            self._collect_calls(info)

    def _collect_calls(self, info: _FunctionInfo) -> None:
        """Record the calls made DIRECTLY by ``info`` (not by nested functions)."""
        nested = {
            f.node for q, f in self.functions.items()
            if q != info.qualname and q.startswith(info.qualname + ".")
        }

        def walk(node: ast.AST) -> Iterable[ast.AST]:
            for child in ast.iter_child_nodes(node):
                if child in nested:
                    continue
                yield child
                yield from walk(child)

        for node in walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            name = self.resolve(node.func)
            if name:
                info.calls.append(name)
            if isinstance(node.func, ast.Name):
                info.local_calls.append(node.func.id)

    def lookup_local(self, scopes: tuple[str, ...], name: str) -> _FunctionInfo | None:
        """Resolve a bare function name from innermost enclosing scope outward."""
        for depth in range(len(scopes), -1, -1):
            qual = ".".join([*scopes[:depth], name])
            if qual in self.functions:
                return self.functions[qual]
        return None


def info_last(info: _FunctionInfo) -> str:
    return info.qualname.rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# Dispatch-scope resolution across the analysed file set
# ---------------------------------------------------------------------------


def _returned_names(fn: ast.AST) -> set[str]:
    """Bare names a function returns directly (``return round_step``)."""
    return {
        node.value.id for node in ast.walk(fn)
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Name)
    }


def _seed_dispatch(models: dict[str, _FileModel]) -> None:
    """Mark the roots: each closure a round-program builder defines and returns."""
    for model in models.values():
        for info in model.functions.values():
            if isinstance(info.node, ast.Lambda) or info_last(info) not in DISPATCH_BUILDERS:
                continue
            returned = _returned_names(info.node)
            for child in model.functions.values():
                if child.scopes == (*info.scopes, info_last(info)) and \
                        info_last(child) in returned:
                    child.traced = True
                    child.root = True


def _module_functions(models: dict[str, _FileModel]) -> dict[tuple[str, str], _FunctionInfo]:
    return {
        (model.module, qual): info
        for model in models.values() for qual, info in model.functions.items()
    }


def _callee(model: _FileModel, info_scopes: tuple[str, ...], call: ast.Call,
            by_module_func: dict[tuple[str, str], _FunctionInfo]) -> _FunctionInfo | None:
    """The analysed function a call resolves to (a local name through the enclosing
    scopes, or an import from an analysed module), or None."""
    if isinstance(call.func, ast.Name):
        target = model.lookup_local(info_scopes, call.func.id)
        if target is not None:
            return target
        dotted = model.aliases.get(call.func.id)
    else:
        dotted = model.resolve(call.func)
    if dotted and "." in dotted:
        mod, fname = dotted.rsplit(".", 1)
        return by_module_func.get((mod, fname))
    return None


def _propagate_dispatch(models: dict[str, _FileModel]) -> None:
    """BFS dispatch scope over call edges (local names + cross-module imports)."""
    by_module_func = _module_functions(models)
    changed = True
    while changed:
        changed = False
        for model in models.values():
            for info in model.functions.values():
                if not info.traced:
                    continue
                for name in info.local_calls:
                    target = model.lookup_local((*info.scopes, info_last(info)), name)
                    if target is None:
                        dotted = model.aliases.get(name)
                        if dotted and "." in dotted:
                            mod, fname = dotted.rsplit(".", 1)
                            target = by_module_func.get((mod, fname))
                    if target is not None and not target.traced:
                        target.traced = True
                        changed = True
                for dotted in info.calls:
                    if "." not in dotted:
                        continue
                    mod, fname = dotted.rsplit(".", 1)
                    target = by_module_func.get((mod, fname))
                    if target is not None and not target.traced:
                        target.traced = True
                        changed = True


# ---------------------------------------------------------------------------
# Tensor-value analysis (shared by FED001's casts and FED002)
# ---------------------------------------------------------------------------


def _annotation_names(ann: ast.AST | None) -> set[str]:
    if ann is None:
        return set()
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return set()
    names = set()
    for node in ast.walk(ann):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Constant) and node.value is None:
            names.add("None")
    return names


def _host_annotated(ann: ast.AST | None) -> bool:
    """An annotation naming only host types (``int``, ``float | None``, ``tuple[int,
    int]``): such a value is no tensor."""
    names = _annotation_names(ann) - {"tuple", "list", "dict", "Optional", "Union"}
    return bool(names) and names <= _HOST_ANNOTATIONS


def _tensor_annotated(ann: ast.AST | None) -> bool:
    return "Tensor" in _annotation_names(ann)


def _is_tensor_producer(name: str | None) -> bool:
    if name is None or not name.startswith("torch."):
        return False
    if name.startswith(_TORCH_PRODUCER_MODULES):
        return True
    rest = name[len("torch."):]
    return "." not in rest and rest not in _TORCH_HOST and not rest[:1].isupper()


class _Values:
    """Which expressions of one dispatch-scope function are tensors."""

    def __init__(self, model: _FileModel, info: _FunctionInfo,
                 by_module_func: dict[tuple[str, str], _FunctionInfo]) -> None:
        self.model = model
        self.scopes = (*info.scopes, info_last(info))
        self.by_module_func = by_module_func
        self.names: set[str] = set()
        for fn in ast.walk(info.node):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            root = getattr(self._info_of(fn), "root", False)
            args = fn.args
            for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
                if a.arg in ("self", "cls"):
                    continue
                if _tensor_annotated(a.annotation) or (
                        root and not _host_annotated(a.annotation)):
                    self.names.add(a.arg)
        changed = True
        while changed:
            changed = False
            for node in ast.walk(info.node):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
                    targets, value = [node.target], node.value
                else:
                    continue
                if not self.tensor(value):
                    continue
                for target in targets:
                    for name_node in ast.walk(target):
                        if isinstance(name_node, ast.Name) and name_node.id not in self.names:
                            self.names.add(name_node.id)
                            changed = True

    def _info_of(self, fn: ast.AST) -> _FunctionInfo | None:
        for info in self.model.functions.values():
            if info.node is fn:
                return info
        return None

    def _host_call(self, call: ast.Call) -> bool:
        """A call known to return a host value: a host builtin, or an analysed
        function annotated to return a host type."""
        if isinstance(call.func, ast.Name) and call.func.id in _HOST_BUILTINS \
                and call.func.id not in self.model.aliases:
            return True
        target = _callee(self.model, self.scopes, call, self.by_module_func)
        if target is None or isinstance(target.node, ast.Lambda):
            return False
        return _host_annotated(target.node.returns)

    def tensor(self, expr: ast.AST) -> bool:
        model = self.model
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            return self.tensor(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.tensor(expr.value)
        if isinstance(expr, ast.Call):
            name = model.resolve(expr.func)
            if _is_tensor_producer(name):
                return True
            if name is not None and name.startswith("torch."):
                return False  # torch.is_tensor, torch.device, torch.cuda.*: host values
            if isinstance(expr.func, ast.Attribute) and self.tensor(expr.func.value):
                return expr.func.attr not in _STATIC_METHODS | _SYNC_METHODS
            if self._host_call(expr):
                return False
            return any(self.tensor(a) for a in expr.args) or any(
                kw.arg is not None and self.tensor(kw.value) for kw in expr.keywords
            )
        if isinstance(expr, ast.BinOp):
            return self.tensor(expr.left) or self.tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.tensor(expr.operand)
        if isinstance(expr, (ast.Tuple, ast.List)):
            # ``a, b = t, u``: the names take the pair's values (coarsely, any).
            return any(self.tensor(e) for e in expr.elts)
        if isinstance(expr, ast.BoolOp):
            return any(self.tensor(v) for v in expr.values)
        if isinstance(expr, ast.Compare):
            # ``x is None`` and ``k in d`` stay host checks even on a tensor name.
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops):
                return False
            return self.tensor(expr.left) or any(self.tensor(c) for c in expr.comparators)
        if isinstance(expr, ast.IfExp):
            return any(self.tensor(e) for e in (expr.test, expr.body, expr.orelse))
        return False


# ---------------------------------------------------------------------------
# Rule implementations
# ---------------------------------------------------------------------------


def _check_dispatch_function(
    model: _FileModel, info: _FunctionInfo,
    by_module_func: dict[tuple[str, str], _FunctionInfo], out: list[Diagnostic],
) -> None:
    """FED001 + FED002 on one dispatch-scope function (its full body, nested code
    included: what is lexically inside the round's dispatch runs there)."""
    values = _Values(model, info, by_module_func)
    for node in ast.walk(info.node):
        if isinstance(node, ast.Call):
            name = model.resolve(node.func)
            if name == "torch.cuda.synchronize":
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED001",
                    f"torch.cuda.synchronize() inside the dispatch of {info.qualname!r}: "
                    "the host waits for the card in the middle of the round",
                ))
            elif name in ("numpy.asarray", "numpy.array") and node.args \
                    and values.tensor(node.args[0]):
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED001",
                    f"{name} of a tensor inside the dispatch of {info.qualname!r}: "
                    "copies the device value to the host",
                ))
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
                and not node.args
                and values.tensor(node.func.value)
            ):
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED001",
                    f".{node.func.attr}() inside the dispatch of {info.qualname!r}: "
                    "reads the device value back on the host",
                ))
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and node.func.id not in model.aliases
                and len(node.args) == 1
                and values.tensor(node.args[0])
            ):
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED001",
                    f"{node.func.id}() on a tensor value inside the dispatch of "
                    f"{info.qualname!r}: reading it waits for the card — keep it a "
                    "tensor (torch.where, a 0-d counter) or compute it on the host",
                ))
        elif isinstance(node, (ast.If, ast.While)) and values.tensor(node.test):
            kind = "if" if isinstance(node, ast.If) else "while"
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "FED002",
                f"Python `{kind}` on a tensor value inside the dispatch of "
                f"{info.qualname!r}: the branch reads the value back (a host sync) — "
                "use torch.where or a device-side select",
            ))


def _check_hot_path_sync(model: _FileModel, out: list[Diagnostic]) -> None:
    """FED001 (hot-path form): ``torch.cuda.synchronize`` in the round-dispatch layers
    outside the dispatch scope must be a documented block-boundary sync."""
    if not _in_layers(model.module, _HOT_PATH_LAYERS):
        return
    scoped = {
        n for info in model.functions.values() if info.traced
        for n in ast.walk(info.node)
    }
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call) or node in scoped:
            continue
        if model.resolve(node.func) == "torch.cuda.synchronize":
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "FED001",
                f"torch.cuda.synchronize() in round-dispatch hot path ({model.module}): "
                "host syncs here serialize dispatch — if this is a deliberate "
                "block-boundary sync, suppress with the reason",
            ))


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mutations_in(stmt: ast.stmt) -> list[tuple[int, int, str]]:
    """(line, col, attr) for every ``self._x`` mutation in one statement."""
    found: list[tuple[int, int, str]] = []
    for node in ast.walk(stmt):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            base = t
            while isinstance(base, ast.Subscript):
                base = base.value
            attr = _self_attr(base)
            if attr:
                found.append((t.lineno, t.col_offset, attr))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr:
                    found.append((node.lineno, node.col_offset, attr))
    return found


def _is_lock_ctx(item: ast.withitem) -> bool:
    return _self_attr(item.context_expr) == "_lock"


def _check_lock_discipline(model: _FileModel, out: list[Diagnostic]) -> None:
    """FED005 on every class that owns ``self._lock = asyncio.Lock()``."""
    for cls in ast.walk(model.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        owns_lock = any(
            isinstance(n, ast.Assign)
            and any(_self_attr(t) == "_lock" for t in n.targets)
            and isinstance(n.value, ast.Call)
            and model.resolve(n.value.func) in ("asyncio.Lock", "threading.Lock")
            for n in ast.walk(cls)
        )
        if not owns_lock:
            continue
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        guarded: set[str] = set()
        unguarded: list[tuple[int, int, str, str]] = []

        def scan(stmts: list[ast.stmt], in_lock: bool, method: str) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    locked = in_lock or any(_is_lock_ctx(i) for i in stmt.items)
                    scan(stmt.body, locked, method)
                    continue
                own = _mutations_in_shallow(stmt)
                for line, col, attr in own:
                    if not attr.startswith("_") or attr == "_lock":
                        continue
                    if in_lock:
                        guarded.add(attr)
                    else:
                        unguarded.append((line, col, attr, method))
                for sub in _sub_blocks(stmt):
                    scan(sub, in_lock, method)

        for m in methods:
            if m.name in ("__init__", "__post_init__"):
                continue
            scan(m.body, False, m.name)
        for line, col, attr, method in unguarded:
            if attr in guarded:
                out.append(Diagnostic(
                    model.path, line, col, "FED005",
                    f"self.{attr} is mutated under `async with self._lock` "
                    f"elsewhere in {cls.name} but {method}() mutates it without "
                    "the lock: handlers interleave at every await — lock it, or "
                    "suppress with the invariant that makes it safe",
                ))


def _mutations_in_shallow(stmt: ast.stmt) -> list[tuple[int, int, str]]:
    """Mutations attributable to THIS statement (not its nested blocks)."""
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr)):
        return _mutations_in(stmt)
    # Compound statements: only their header expressions, bodies are scanned
    # recursively by the caller with the right lock context.
    return []


def _sub_blocks(stmt: ast.stmt) -> list[list[ast.stmt]]:
    blocks = []
    for name in ("body", "orelse", "finalbody"):
        sub = getattr(stmt, name, None)
        if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
            blocks.append(sub)
    for handler in getattr(stmt, "handlers", []):
        blocks.append(handler.body)
    return blocks


def _check_async_blocking(model: _FileModel, out: list[Diagnostic]) -> None:
    """FED006: blocking calls lexically inside ``async def``."""
    for info in model.functions.values():
        if not isinstance(info.node, ast.AsyncFunctionDef):
            continue
        nested_async = {
            f.node for q, f in model.functions.items()
            if q != info.qualname and q.startswith(info.qualname + ".")
            and isinstance(f.node, ast.AsyncFunctionDef)
        }
        for node in ast.walk(info.node):
            if node in nested_async or not isinstance(node, ast.Call):
                continue
            name = model.resolve(node.func)
            blocking = None
            if name in _BLOCKING_CALLS:
                blocking = name
            elif name and name.startswith(_BLOCKING_PREFIXES):
                blocking = name
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id == "open"
                and "open" not in model.aliases
            ):
                blocking = "open()"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_IO_METHODS
            ):
                blocking = f".{node.func.attr}()"
            if blocking:
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED006",
                    f"blocking call {blocking} inside async function "
                    f"{info.qualname!r}: stalls the whole event loop — use "
                    "asyncio.sleep/aiohttp/asyncio.to_thread",
                ))
        # Unbounded-await extension: request handlers in the communication
        # layer must bound body reads with asyncio.wait_for — the size cap
        # (client_max_size) does not bound TIME, and a slowloris peer would
        # hold the handler (and its admission-control slot) open forever.
        if not (
            _in_layers(model.module, ("communication",))
            and info.qualname.split(".")[-1].startswith("_handle")
        ):
            continue
        handler_params = set(info.params)
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Await):
                continue
            call = node.value
            if (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr in _UNBOUNDED_AWAIT_METHODS
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id in handler_params
            ):
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED006",
                    f"unbounded `await {call.func.value.id}."
                    f"{call.func.attr}()` in request handler "
                    f"{info.qualname!r}: the peer controls how long this "
                    "takes (slowloris) — bound it with asyncio.wait_for",
                ))


def _axis_literal(expr: ast.AST) -> bool:
    return isinstance(expr, ast.Constant) and isinstance(expr.value, str)


def _is_groups(expr: ast.AST) -> bool:
    """``<anything>.groups`` — a mesh's per-axis process groups."""
    return isinstance(expr, ast.Attribute) and expr.attr == "groups"


def _check_raw_collective(model: _FileModel, out: list[Diagnostic]) -> None:
    """FED007: a raw ``torch.distributed`` collective, or an axis-name string literal
    indexing ``mesh.groups``, in the layers whose collectives go through the mesh."""
    if not _in_layers(model.module, _COLLECTIVE_LAYERS) or _layer(model.module) == _MESH_MODULE:
        return
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Call):
            name = model.resolve(node.func)
            if name and name.startswith("torch.distributed.") \
                    and name.rsplit(".", 1)[-1] in _RAW_COLLECTIVES:
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED007",
                    f"raw {name} in {model.module}: collectives go through "
                    "parallel/mesh.py (MeshLayout, broadcast_object, all_gather_object), "
                    "which owns the axes and records them for the program audit",
                ))
            elif (
                isinstance(node.func, ast.Attribute) and node.func.attr == "get"
                and _is_groups(node.func.value) and node.args and _axis_literal(node.args[0])
            ):
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED007",
                    f"mesh.groups.get({node.args[0].value!r}) with a hardcoded axis name in "
                    f"{model.module}: take the axis from the mesh.py constants or go "
                    "through MeshLayout, so the code follows the mesh it runs on",
                ))
        elif isinstance(node, ast.Subscript) and _is_groups(node.value) \
                and _axis_literal(node.slice):
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "FED007",
                f"mesh.groups[{node.slice.value!r}] with a hardcoded axis name in "
                f"{model.module}: take the axis from the mesh.py constants or go "
                "through MeshLayout, so the code follows the mesh it runs on",
            ))


def _spawner_name(model: _FileModel, node: ast.Call) -> str | None:
    """The resolved name when ``node`` spawns a task (create_task/
    ensure_future on asyncio or a loop object), else None."""
    name = model.resolve(node.func)
    if name and "." in name and name.rsplit(".", 1)[-1] in _TASK_SPAWNERS:
        return name
    return None


def _broadly_swallowed(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> bool:
    """Is ``node`` inside a ``try`` whose handler catches Exception (or bare)
    and does nothing?  Such an await retrieves the task's exception only to
    drop it — not a sink."""
    cur = node
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, ast.Try) and cur in parent.body:
            for handler in parent.handlers:
                broad = handler.type is None or any(
                    isinstance(n, ast.Name)
                    and n.id in ("Exception", "BaseException")
                    for n in ast.walk(handler.type)
                )
                inert = all(
                    isinstance(s, ast.Pass)
                    or (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))
                    for s in handler.body
                )
                if broad and inert:
                    return True
        cur = parent
    return False


def _direct_args(call: ast.Call) -> list[ast.AST]:
    """A call's positional args, flattened through container literals (for
    ``asyncio.wait({task, timer})``)."""
    flat: list[ast.AST] = []
    for a in call.args:
        if isinstance(a, (ast.Tuple, ast.List, ast.Set)):
            flat.extend(a.elts)
        elif isinstance(a, ast.Starred):
            flat.append(a.value)
        else:
            flat.append(a)
    return flat


def _check_task_sink(model: _FileModel, out: list[Diagnostic]) -> None:
    """FED008: every spawned task needs an exception sink somewhere."""
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(model.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    def matches(expr: ast.AST, var: str | None, attr: str | None) -> bool:
        if var is not None:
            return isinstance(expr, ast.Name) and expr.id == var
        return _self_attr(expr) == attr

    def has_sink(scope: ast.AST, var: str | None, attr: str | None) -> bool:
        for node in ast.walk(scope):
            if isinstance(node, ast.Await):
                val = node.value
                if matches(val, var, attr):
                    if not _broadly_swallowed(node, parents):
                        return True
                elif isinstance(val, ast.Call):
                    fname = model.resolve(val.func) or ""
                    if fname.rsplit(".", 1)[-1] in _TASK_AWAITERS and any(
                        matches(a, var, attr) for a in _direct_args(val)
                    ):
                        return True
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr in ("add_done_callback", "result") and \
                        matches(node.func.value, var, attr):
                    return True
            elif isinstance(node, ast.Return) and node.value is not None \
                    and matches(node.value, var, attr):
                return True
        return False

    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        spawner = _spawner_name(model, node)
        if spawner is None:
            continue
        stmt = parents.get(node)
        if isinstance(stmt, ast.Expr):
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "FED008",
                f"{spawner.rsplit('.', 1)[-1]} result dropped: the task runs "
                "unreferenced (eligible for GC mid-flight) and its exception "
                "is never retrieved — keep the reference and give it a sink "
                "(utils.aio.spawn_logged)",
            ))
            continue
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        target = stmt.targets[0]
        var: str | None = None
        attr: str | None = None
        scope: ast.AST | None = None
        if isinstance(target, ast.Name):
            var = target.id
            cur = stmt
            while cur in parents and scope is None:
                cur = parents[cur]
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scope = cur
            scope = scope or model.tree
        elif _self_attr(target) is not None:
            attr = _self_attr(target)
            scope = model.tree
        else:
            continue
        if not has_sink(scope, var, attr):
            what = var or f"self.{attr}"
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "FED008",
                f"task {what!r} has no exception sink: no add_done_callback, "
                "and no await that could surface its exception (shield-"
                "wrapped and except-Exception-pass awaits do not count) — "
                "its traceback vanishes into 'exception was never retrieved'; "
                "use utils.aio.spawn_logged or attach a sink",
            ))


def _check_async_file_io(model: _FileModel, out: list[Diagnostic]) -> None:
    """FED009: blocking file I/O lexically inside ``async def``, nested
    functions exempt (they are to_thread/executor payloads)."""
    for info in model.functions.values():
        if not isinstance(info.node, ast.AsyncFunctionDef):
            continue
        nested = {
            n for q, f in model.functions.items()
            if q != info.qualname and q.startswith(info.qualname + ".")
            for n in ast.walk(f.node)
        }
        for node in ast.walk(info.node):
            if node in nested or not isinstance(node, ast.Call):
                continue
            name = model.resolve(node.func)
            blocking = None
            if name in _BLOCKING_IO_CALLS:
                blocking = name
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _BLOCKING_IO_METHODS
                and not (name and name.startswith(("os.", "shutil.")))
            ):
                blocking = f".{node.func.attr}()"
            if blocking:
                out.append(Diagnostic(
                    model.path, node.lineno, node.col_offset, "FED009",
                    f"blocking file I/O {blocking} inside async function "
                    f"{info.qualname!r}: the dump/rename blocks the event "
                    "loop even though the file object came from elsewhere — "
                    "ship it to asyncio.to_thread",
                ))


def _check_wall_clock(model: _FileModel, out: list[Diagnostic]) -> None:
    """FED010: wall-clock reads in the Clock-injected subsystems."""
    if not _in_layers(model.module, _CLOCKED_LAYERS):
        return
    # Line ranges of this module's allowlisted forensic-clock functions: a
    # wall-clock call INSIDE one is the sanctioned doorway, not a finding.
    allowed_names = {
        fn for mod, fn in _FORENSIC_CLOCK_FUNCS if mod == _layer(model.module)
    }
    allowed_ranges: list[tuple[int, int]] = []
    if allowed_names:
        for node in ast.walk(model.tree):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in allowed_names
            ):
                allowed_ranges.append(
                    (node.lineno, node.end_lineno or node.lineno)
                )
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        name = model.resolve(node.func)
        if name in _WALL_CLOCK_CALLS:
            if any(lo <= node.lineno <= hi for lo, hi in allowed_ranges):
                continue
            out.append(Diagnostic(
                model.path, node.lineno, node.col_offset, "FED010",
                f"{name}() in {model.module}: this subsystem takes an "
                "injectable utils.clock.Clock so virtual-clock tests and "
                "deterministic replays hold — read the injected clock, or "
                "suppress with the reason this stamp is forensics-only",
            ))


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _module_name(path: Path, root_hint: Path | None = None) -> str:
    parts = list(path.with_suffix("").parts)
    for pkg in _PACKAGES:
        if pkg in parts:
            parts = parts[len(parts) - 1 - parts[::-1].index(pkg):]
            break
    else:
        if root_hint is not None:
            try:
                parts = list(path.relative_to(root_hint).with_suffix("").parts)
            except ValueError:
                parts = [path.stem]
        else:
            parts = [path.stem]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or path.stem


def _lint_models(
    models: dict[str, _FileModel], select: set[str] | None = None
) -> list[Diagnostic]:
    _seed_dispatch(models)
    _propagate_dispatch(models)
    by_module_func = _module_functions(models)
    raw: list[Diagnostic] = []
    for model in models.values():
        for line in model.suppressions.malformed:
            raw.append(Diagnostic(
                model.path, line, 0, "FED000",
                "fedlint suppression without a parenthesized reason: write "
                "`# fedlint: disable=FEDxxx (why this site is intentional)`",
            ))
        for info in model.functions.values():
            if info.traced:
                _check_dispatch_function(model, info, by_module_func, raw)
        _check_hot_path_sync(model, raw)
        _check_lock_discipline(model, raw)
        _check_async_blocking(model, raw)
        _check_raw_collective(model, raw)
        _check_task_sink(model, raw)
        _check_async_file_io(model, raw)
        _check_wall_clock(model, raw)

    by_path = {m.path: m for m in models.values()}
    final: list[Diagnostic] = []
    seen: set[tuple[str, int, int, str]] = set()
    for d in sorted(raw):
        key = (d.path, d.line, d.col, d.code)
        if key in seen:
            continue
        seen.add(key)
        sup = by_path[d.path].suppressions
        if d.code != "FED000" and sup.covers(d.line, d.code):
            continue
        if select is not None and d.code not in select:
            continue
        final.append(d)
    return final


def lint_paths(
    paths: Iterable[str | Path], select: Iterable[str] | None = None
) -> list[Diagnostic]:
    """Lint files and/or directory trees; returns sorted diagnostics."""
    files: list[Path] = []
    roots: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            roots.append(p)
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    models: dict[str, _FileModel] = {}
    root_hint = roots[0] if roots else None
    for f in files:
        source = f.read_text(encoding="utf-8")
        module = _module_name(f, root_hint)
        models[str(f)] = _FileModel(str(f), module, source)
    return _lint_models(models, set(select) if select is not None else None)


def lint_source(
    source: str,
    path: str = "<fixture>",
    module: str = "fixture",
    select: Iterable[str] | None = None,
) -> list[Diagnostic]:
    """Lint one in-memory source string (the unit-test fixture entry point)."""
    models = {path: _FileModel(path, module, source)}
    return _lint_models(models, set(select) if select is not None else None)


def render_text(diagnostics: list[Diagnostic]) -> str:
    lines = [d.render() for d in diagnostics]
    if diagnostics:
        by_code: dict[str, int] = {}
        for d in diagnostics:
            by_code[d.code] = by_code.get(d.code, 0) + 1
        summary = ", ".join(f"{c}: {n}" for c, n in sorted(by_code.items()))
        lines.append(f"fedlint: {len(diagnostics)} finding(s) ({summary})")
    else:
        lines.append("fedlint: clean")
    return "\n".join(lines)
