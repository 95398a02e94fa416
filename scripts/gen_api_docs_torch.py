#!/usr/bin/env python
"""Generate the PyTorch/CUDA port's API reference (``docs/api_torch/*.md``) from its
docstrings (counterpart of ``scripts/gen_api_docs.py``, whose method it keeps).

Every public module, class, function and dataclass of ``nanofed_tpu_torch`` with its
signature and docstring, straight from ``inspect``; the groups and modules mirror the
reference generator's ``MODULES``, plus the port's own ``core.device``, ``ops._build``
and ``parallel.launch``.  A module with an ``__all__`` also lists the names of it that
are not documented above them on the page: constants, and names whose home is another
module.  Regenerate with ``python scripts/gen_api_docs_torch.py`` after API changes.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

PKG = "nanofed_tpu_torch"
OUT_DIR = REPO / "docs" / "api_torch"

# The reference generator's groups and modules, under the port's package, with the
# port's own modules in their groups.
MODULES = [
    ("core", ["core.types", "core.interfaces", "core.exceptions", "core.device"]),
    ("data", ["data.datasets", "data.partition", "data.batching"]),
    ("models", ["models.base", "models.linear", "models.mnist", "models.resnet",
                "models.transformer", "nn"]),
    ("adapters", ["adapters.lora", "adapters.evidence"]),
    ("fleet", ["fleet.profile", "fleet.aggregate", "fleet.wire", "fleet.gateway",
               "fleet.swarm", "fleet.tuning", "fleet.evidence"]),
    ("trainer", ["trainer.config", "trainer.local", "trainer.private", "trainer.scaffold",
                 "trainer.schedules", "trainer.personalization", "trainer.callbacks",
                 "trainer.api"]),
    ("aggregation", ["aggregation.base", "aggregation.fedavg", "aggregation.privacy",
                     "aggregation.robust"]),
    ("parallel", ["parallel.mesh", "parallel.round_step", "parallel.multi_round",
                  "parallel.scaffold_step", "parallel.resilience", "parallel.launch"]),
    ("privacy", ["privacy.config", "privacy.noise", "privacy.accounting",
                 "privacy.mechanisms"]),
    ("security", ["security.validation", "security.signing", "security.secure_agg"]),
    ("persistence", ["persistence.serialization", "persistence.model_manager",
                     "persistence.state_store", "persistence.generation_store"]),
    ("orchestration", ["orchestration.types", "orchestration.coordinator"]),
    ("communication", ["communication.codec", "communication.transport",
                       "communication.http_server", "communication.http_client",
                       "communication.retry", "communication.network_coordinator"]),
    ("faults", ["faults.plan", "faults.injector", "faults.host_injector"]),
    ("ingest", ["ingest.buffer", "ingest.pipeline"]),
    ("loadgen", ["loadgen.swarm", "loadgen.harness"]),
    ("service", ["service.scheduler", "service.tenant", "service.service",
                 "service.harness"]),
    ("observability", ["observability.registry", "observability.spans",
                       "observability.telemetry", "observability.profiling",
                       "observability.tracing", "observability.critical_path"]),
    ("tuning", ["tuning.autotuner", "tuning.epilogues"]),
    ("analysis", ["analysis.fedlint", "analysis.program_audit", "analysis.contracts"]),
    ("ops", ["ops.reduce", "ops.dp_reduce", "ops.quantize", "ops._build"]),
    ("utils", ["utils.logger", "utils.profiling", "utils.trees", "utils.platform",
               "utils.clock", "utils.aio", "utils.dates"]),
    ("top-level", ["experiments", "benchmarks", "cli"]),
]


def _sig(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Function and method defaults repr with a memory address, which would churn the
    # generated files on every run; keep just the name.
    return re.sub(r" at 0x[0-9a-f]+>", ">", sig)


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(undocumented)*"


def _summary(obj) -> str:
    """First paragraph of the docstring as one line."""
    return " ".join(_doc(obj).split("\n\n")[0].split())


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _value(obj) -> str:
    """A short rendering of a module constant, free of addresses and of a set's
    hash order."""
    if isinstance(obj, (set, frozenset)):
        text = f"{type(obj).__name__}({sorted(obj, key=repr)!r})"
    else:
        text = re.sub(r" at 0x[0-9a-f]+", "", repr(obj))
    return text if len(text) <= 80 else text[:77] + "..."


def document_module(modname: str) -> str:
    try:
        mod = importlib.import_module(modname)
    except ImportError as e:
        print(f"  SKIPPED {modname}: {e}", file=sys.stderr)
        return "\n".join([
            f"## `{modname}`", "",
            f"*(not regenerated here — import failed: `{e}`)*", "",
        ])
    lines = [f"## `{modname}`", "", _doc(mod), ""]
    members = []
    for name, obj in vars(mod).items():
        if not _is_public(name):
            continue
        wrapped_fn = inspect.isfunction(getattr(obj, "__wrapped__", None))
        if inspect.isclass(obj) or inspect.isfunction(obj) or (callable(obj) and wrapped_fn):
            if getattr(obj, "__module__", None) != modname:
                continue  # re-exports documented at their home module
            members.append((name, obj))
    for name, obj in members:
        if inspect.isclass(obj):
            kind = "dataclass" if dataclasses.is_dataclass(obj) else "class"
            lines += [f"### {kind} `{name}{_sig(obj)}`", "", _doc(obj), ""]
            if dataclasses.is_dataclass(obj):
                rows = [
                    f"| `{f.name}` | `{getattr(f.type, '__name__', f.type)}` | "
                    f"`{f.default if f.default is not dataclasses.MISSING else '—'}` |"
                    for f in dataclasses.fields(obj)
                ]
                lines += ["| field | type | default |", "|---|---|---|", *rows, ""]
            for mname, meth in vars(obj).items():
                if not _is_public(mname):
                    continue
                func = meth.__func__ if isinstance(meth, (classmethod, staticmethod)) else meth
                if inspect.isfunction(func) and inspect.getdoc(func):
                    lines += [f"- **`{mname}{_sig(func)}`** — {_summary(func)}"]
            lines += [""]
        else:
            lines += [f"### `{name}{_sig(obj)}`", "", _doc(obj), ""]
    documented = {name for name, _ in members}
    rest = [name for name in getattr(mod, "__all__", ()) if name not in documented]
    if rest:
        lines += ["### Other exported names", ""]
        for name in rest:
            obj = getattr(mod, name)
            home = getattr(obj, "__module__", None)
            if (inspect.isclass(obj) or callable(obj)) and home and home != modname:
                lines.append(f"- `{name}`: from `{home}`")
            else:
                lines.append(f"- `{name}` = `{_value(obj)}`")
        lines.append("")
    return "\n".join(lines)


def generate(out_dir: Path = OUT_DIR) -> list[Path]:
    """Write one page a group and the index under ``out_dir``; returns the pages."""
    out_dir.mkdir(parents=True, exist_ok=True)
    index = ["# API reference of the PyTorch/CUDA port", "",
             "Generated from docstrings by `scripts/gen_api_docs_torch.py` — do not edit",
             "by hand; rerun it after API changes.  The JAX package's reference is",
             "`docs/api/`.", ""]
    pages = []
    for group, mods in MODULES:
        fname = f"{group.replace('-', '_')}.md"
        names = [f"{PKG}.{m}" for m in mods]
        parts = [f"# `{group}` API (PyTorch/CUDA port)", ""]
        parts += [document_module(m) for m in names]
        page = out_dir / fname
        page.write_text("\n".join(parts).rstrip("\n") + "\n")
        pages.append(page)
        index.append(f"- [{group}]({fname}): " + ", ".join(f"`{m}`" for m in names))
        print(f"  wrote {page}")
    (out_dir / "index.md").write_text("\n".join(index) + "\n")
    return pages


def main() -> int:
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else OUT_DIR
    generate(out.resolve())
    print(f"wrote {out / 'index.md'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
