"""The port's API reference (``scripts/gen_api_docs_torch.py`` -> ``docs/api_torch/``):
generated in a process where JAX and the JAX package cannot be imported, one page a
group of the JAX generator's ``MODULES`` with the port's own modules added, every
module importing (no "import failed" marker), every name of a module's ``__all__`` on
its page, and the committed pages equal to a fresh generation."""

import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
GENERATOR = REPO / "scripts" / "gen_api_docs_torch.py"
COMMITTED = REPO / "docs" / "api_torch"
PORT_ONLY = {"core.device", "ops._build", "parallel.launch"}

_BLOCKED = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["nanofed_tpu"] = None
sys.argv = ["gen_api_docs_torch.py", sys.argv[1]]
runpy.run_path({path!r}, run_name="__main__")
bad = sorted(m for m in sys.modules if (m == "jax" or m.startswith(("jax.", "nanofed_tpu.")))
             and sys.modules[m] is not None)
assert not bad, bad
"""


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def generated(tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("api_torch")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED.format(path=str(GENERATOR)),
                           str(out)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SKIPPED" not in proc.stderr
    return out


@pytest.fixture(scope="module")
def gen():
    return _load(GENERATOR, "gen_api_docs_torch")


def test_groups_mirror_the_jax_generator(gen):
    jax_gen = _load(REPO / "scripts" / "gen_api_docs.py", "gen_api_docs")
    jax_groups = [(g, [m.removeprefix("nanofed_tpu.") for m in mods])
                  for g, mods in jax_gen.MODULES]
    assert [g for g, _ in gen.MODULES] == [g for g, _ in jax_groups]
    for (group, mods), (_, jax_mods) in zip(gen.MODULES, jax_groups):
        assert set(mods) - set(jax_mods) <= PORT_ONLY, group
        assert [m for m in mods if m not in PORT_ONLY] == jax_mods, group
    assert PORT_ONLY <= {m for _, mods in gen.MODULES for m in mods}


def test_one_page_a_group_and_no_import_failed(gen, generated):
    pages = sorted(p.name for p in generated.glob("*.md"))
    want = sorted([f"{g.replace('-', '_')}.md" for g, _ in gen.MODULES] + ["index.md"])
    assert pages == want
    for page in generated.glob("*.md"):
        assert "import failed" not in page.read_text(), page.name


def test_every_exported_name_is_on_its_page(gen, generated):
    for group, mods in gen.MODULES:
        text = (generated / f"{group.replace('-', '_')}.md").read_text()
        for mod in mods:
            name = f"{gen.PKG}.{mod}"
            assert f"## `{name}`" in text
            for export in getattr(importlib.import_module(name), "__all__", ()):
                assert f"`{export}" in text, (name, export)


def test_committed_pages_are_a_fresh_generation(generated):
    committed = {p.name: p.read_text() for p in COMMITTED.glob("*.md")}
    fresh = {p.name: p.read_text() for p in generated.glob("*.md")}
    assert committed.keys() == fresh.keys()
    stale = [name for name in fresh if committed[name] != fresh[name]]
    assert not stale, f"rerun scripts/gen_api_docs_torch.py: {stale} differ"
