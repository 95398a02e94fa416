"""The port's tutorial notebook (``scripts/build_notebook_torch.py`` and its executed
``examples/mnist/tutorial_torch.ipynb``): the JAX builder's sections in its order,
every code cell compiling with top-level ``await`` and importing nothing of JAX, the
in-process runner's one namespace and one event loop, a raising cell failing the run,
the whole notebook executed on the CPU, and the committed notebook run on a card."""

import ast
import asyncio
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BUILDER = REPO / "scripts" / "build_notebook_torch.py"
JAX_BUILDER = REPO / "scripts" / "build_notebook.py"
COMMITTED = REPO / "examples" / "mnist" / "tutorial_torch.ipynb"
LETTERS = "ABCDEFGHIJKLMNOP"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def nbt():
    return _load(BUILDER, "build_notebook_torch")


def _notebook(nbt, sources: list[str]) -> dict:
    return {"cells": [{"cell_type": "code", "id": f"c{i}", "execution_count": None,
                       "metadata": {}, "outputs": [], "source": src}
                      for i, src in enumerate(sources)],
            "metadata": {}, "nbformat": 4, "nbformat_minor": 5}


def _text(cell: dict, name: str | None = None) -> str:
    return "".join("".join(o.get("text", "")) for o in cell["outputs"]
                   if o["output_type"] == "stream" and name in (None, o["name"]))


def test_no_execute_writes_a_valid_nbformat_notebook(nbt, tmp_path):
    nbformat = pytest.importorskip("nbformat")
    out = tmp_path / "nb.ipynb"
    proc = subprocess.run([sys.executable, str(BUILDER), "--no-execute", "--out", str(out)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    nb = nbformat.read(out, as_version=4)
    nbformat.validate(nb)
    assert (nb.nbformat, nb.nbformat_minor) == (4, 5)
    assert all(c.get("id") for c in nb.cells)


def test_cells_pair_as_the_jax_builder_pairs_them(nbt):
    pytest.importorskip("nbformat")
    jax_builder = _load(JAX_BUILDER, "build_notebook")
    assert (len(nbt.MD), len(nbt.CODE)) == (len(jax_builder.MD), len(jax_builder.CODE))
    ours = [c["cell_type"] for c in nbt.build()["cells"]]
    theirs = [c.cell_type for c in jax_builder.build().cells]
    assert ours == theirs
    assert ours.count("code") == len(LETTERS) == 16 and ours.count("markdown") == 18


@pytest.mark.parametrize("letter", list(LETTERS))
def test_code_cell_compiles_and_imports_no_jax(nbt, letter):
    src = nbt.code_sources("cuda")[LETTERS.index(letter)]
    compile(src, f"<cell {letter}>", "exec", flags=ast.PyCF_ALLOW_TOP_LEVEL_AWAIT)
    tree = ast.parse(src.replace("await ", ""))
    names = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert not any(m == "jax" or m.startswith(("jax.", "nanofed_tpu."))
                   or m == "nanofed_tpu" for m in names), names
    if any(call in src for call in ("Coordinator(", "mask_update(", "model.init(")):
        assert "DEVICE" in src  # what a cell places, it places on cell A's device


def test_device_selects_cell_a_only(nbt):
    cuda, cpu = nbt.code_sources("cuda"), nbt.code_sources("cpu")
    assert 'resolve_device("cuda")' in cuda[0] and 'resolve_device("cpu")' in cpu[0]
    assert cuda[1:] == cpu[1:]
    with pytest.raises(ValueError):
        nbt.code_sources("tpu")


def test_runner_shares_one_namespace_and_one_loop(nbt, tmp_path):
    nb = _notebook(nbt, [
        "import asyncio\nx = 41\nasync def bump(v):\n    await asyncio.sleep(0)\n"
        "    return v + 1",
        "loop_a = asyncio.get_running_loop()\ny = await bump(x)\nprint('y', y)",
        "loop_b = asyncio.get_running_loop()\nprint('same loop', loop_a is loop_b)\n"
        "import pathlib\nprint(pathlib.Path.cwd().name)",
    ])
    seen = []
    ns = {"__name__": "__main__"}
    nbt.run_inprocess(nb, tmp_path, on_cell=lambda i, c: seen.append(i), namespace=ns)
    assert seen == [0, 1, 2]
    assert ns["y"] == 42 and ns["loop_a"] is ns["loop_b"]
    assert _text(nb["cells"][1]) == "y 42\n"
    assert _text(nb["cells"][2]) == f"same loop True\n{tmp_path.name}\n"
    assert [c["execution_count"] for c in nb["cells"]] == [1, 2, 3]
    assert Path.cwd() != tmp_path  # the working directory is restored


def test_runner_captures_stderr_and_the_port_log(nbt, tmp_path):
    nb = _notebook(nbt, [
        "import sys\nfrom nanofed_tpu_torch.utils.logger import Logger\n"
        "print('to out')\nprint('to err', file=sys.stderr)\nLogger().info('from the log')",
    ])
    nbt.run_inprocess(nb, tmp_path)
    cell = nb["cells"][0]
    assert _text(cell, "stdout") == "to out\n"
    err = _text(cell, "stderr")
    assert "to err" in err and "from the log" in err


def test_a_raising_cell_fails_the_run(nbt, tmp_path):
    nb = _notebook(nbt, ["a = 1", "assert a == 2, 'its own check'", "b = 3"])
    ns = {"__name__": "__main__"}
    with pytest.raises(nbt.CellError) as info:
        nbt.run_inprocess(nb, tmp_path, namespace=ns)
    assert info.value.index == 2 and isinstance(info.value.error, AssertionError)
    assert [o["output_type"] for o in nb["cells"][1]["outputs"]] == ["error"]
    assert nb["cells"][2]["outputs"] == [] and "b" not in ns  # nothing after it ran


def test_a_failing_await_fails_the_run(nbt, tmp_path):
    nb = _notebook(nbt, ["import asyncio\nasync def boom():\n    raise KeyError('k')",
                         "await boom()"])
    with pytest.raises(nbt.CellError) as info:
        nbt.run_inprocess(nb, tmp_path)
    assert isinstance(info.value.error, KeyError)


def test_execute_raises_without_a_card(nbt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    nb = nbt.build("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nbt.execute(nb, "cuda", tmp_path)
    assert all(not c.get("outputs") for c in nb["cells"])  # no cell ran


@pytest.fixture(scope="module")
def cpu_notebook(nbt, tmp_path_factory):
    """The whole notebook executed on the CPU by the in-process runner (which
    ``on_cell`` asks for), with the code cells it reported."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    seen = []
    try:
        t0 = time.perf_counter()
        nb = nbt.execute(nbt.build("cpu"), "cpu", tmp_path_factory.mktemp("nb"),
                         on_cell=lambda i, cell: seen.append(i))
        return nb, time.perf_counter() - t0, seen
    finally:
        torch.set_num_threads(threads)


def test_notebook_executes_on_the_cpu(cpu_notebook):
    """Every cell, its own asserts included (K's recovered round, L's schedule, P's
    stale updates); about 25 s on two threads of a development CPU."""
    nb, seconds, seen = cpu_notebook
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert seen == list(range(len(LETTERS)))
    assert [c["metadata"]["nanofed_cell"] for c in code] == list(LETTERS)
    for cell in code:
        kinds = [o["output_type"] for o in cell["outputs"]]
        assert kinds and "error" not in kinds, cell["metadata"]
    meta = nb["metadata"]["nanofed"]
    assert meta["runner"] == "inprocess" and meta["device"]["type"] == "cpu"
    assert "kernel_launches" not in meta["device"]
    final = json.loads(_text(code[4]).split("\nper-client")[0])
    assert final["round_id"] == 9 and final["eval_metrics"]["accuracy"] > 0.95
    assert "'num_dropped': 1" in _text(code[10], "stdout")
    assert seconds < 600


def test_committed_notebook_ran_on_a_card(nbt):
    nb = json.loads(COMMITTED.read_text())
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert ["".join(c["source"]) for c in code] == nbt.code_sources("cuda")
    assert ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "markdown"] == (
        nbt.MD)
    for cell in code:
        kinds = [o["output_type"] for o in cell["outputs"]]
        assert kinds and "error" not in kinds and cell["execution_count"], cell["metadata"]
    first = _text(code[0])
    assert first.startswith("device: NVIDIA ") and "CUDA 12" in first
    meta = nb["metadata"]["nanofed"]
    assert meta["device"]["type"] == "cuda" and meta["device"]["name"].startswith("NVIDIA")
    assert meta["device"]["nvidia_smi"].startswith(meta["device"]["name"])
    launches = _text(code[9], "stdout")  # J: the card backend's kernels ran
    assert "'quantize_u32': 3, 'add_mask': 3, 'dequantize_u32': 1" in launches


def test_event_loop_is_released(nbt, tmp_path):
    """The runner closes its loop: a later ``asyncio.run`` in the same process works."""
    nbt.run_inprocess(_notebook(nbt, ["import asyncio\nawait asyncio.sleep(0)"]), tmp_path)
    assert asyncio.run(asyncio.sleep(0, result=7)) == 7


def test_nbclient_runner_shares_a_kernel_and_the_workdir(nbt, tmp_path):
    """Where nbclient and ipykernel import, ``execute`` runs the cells in one kernel
    started in the working directory, with the port importable, and a raising cell
    fails the run; this process's ``PYTHONPATH`` is left as it was."""
    pytest.importorskip("nbclient")
    pytest.importorskip("ipykernel")
    before = os.environ.get("PYTHONPATH")
    nb = nbt.execute(_notebook(nbt, [
        "import asyncio, pathlib\nimport nanofed_tpu_torch\nx = 41",
        "await asyncio.sleep(0)\nprint(x + 1, pathlib.Path.cwd().name)",
    ]), "cpu", tmp_path)
    assert nb["metadata"]["nanofed"]["runner"] == "nbclient"
    assert _text(nb["cells"][1], "stdout") == f"42 {tmp_path.name}\n"
    assert os.environ.get("PYTHONPATH") == before
    with pytest.raises(nbt.CellError) as info:
        nbt.execute(_notebook(nbt, ["a = 1", "assert a == 2", "b = 3"]), "cpu", tmp_path)
    assert info.value.index == 2
