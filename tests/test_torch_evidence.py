"""The port's recorded evidence on the CPU at the smallest depth: the digits bundled
with the port (``nanofed_tpu_torch/data/digits.csv.gz``) against the JAX package's
loader, which reads them through scikit-learn; ``scripts/record_accuracy_torch.py``
beside the JAX ``Coordinator`` at the same configuration; and every mode of the four
``scripts/*_torch.py`` evidence scripts writing the key set of its committed JAX
artifact plus ``device``.  None of the scripts imports JAX or anything of
``nanofed_tpu``."""

import ast
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nanofed_tpu_torch.data import datasets

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {name: REPO / "scripts" / f"{name}.py" for name in (
    "record_accuracy_torch", "record_evidence_torch", "measure_wire_compression_torch",
    "measure_cohort_gather_torch")}
# Per-round held-out accuracy of digits_mlp(96), 8 IID clients, port against JAX: the
# packages draw their permutations from different generators (Philox against
# Threefry), so the trajectories are close, not equal.  On this configuration they lie
# 0.033 apart at most in rounds 0-2 (round 1) and 0.014 from round 3 on.
ACCURACY_TOL = 0.04
ACCURACY_TOL_LATE = 0.02  # from round ACCURACY_LATE on
ACCURACY_LATE = 3
DEVICE_KEYS = {"type", "name", "nvidia_smi", "torch", "cuda", "kernel_launches"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every run here is tiny: torch's thread pool only contends with the suite's
    other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("test_fraction", [0.2, 0.3])
def test_bundled_digits_equal_the_jax_loader(test_fraction):
    pytest.importorskip("sklearn")
    from nanofed_tpu.data import datasets as jax_datasets

    for split in ("train", "test"):
        got = datasets.load_digits_dataset(split, test_fraction)
        want = jax_datasets.load_digits_dataset(split, test_fraction)
        assert got.x.dtype == want.x.dtype and got.y.dtype == want.y.dtype
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.y, want.y)
        assert (got.num_classes, got.name) == (want.num_classes, want.name)
    resized = datasets.resize_images(got, 28, 28)
    want_resized = jax_datasets.resize_images(want, 28, 28)
    np.testing.assert_array_equal(resized.x, want_resized.x)
    assert resized.name == want_resized.name


_NO_SKLEARN = """
import sys
sys.modules["sklearn"] = None
sys.modules["sklearn.datasets"] = None
from nanofed_tpu_torch.data import load_digits_dataset
assert len(load_digits_dataset("train")) == 1437 and len(load_digits_dataset("test")) == 360
import importlib.util
# The JAX package's loader module alone (it imports numpy only), not the package.
spec = importlib.util.spec_from_file_location("jax_datasets", "nanofed_tpu/data/datasets.py")
jax_datasets = sys.modules["jax_datasets"] = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_datasets)
try:
    jax_datasets.load_digits_dataset("train")
except FileNotFoundError:
    print("the JAX loader raised FileNotFoundError")
"""


def test_port_loader_needs_no_sklearn_and_the_jax_loader_does():
    proc = subprocess.run([sys.executable, "-c", _NO_SKLEARN], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "the JAX loader raised FileNotFoundError" in proc.stdout


def test_a_flipped_byte_raises_with_no_fallback(tmp_path, monkeypatch):
    raw = bytearray(datasets.DIGITS_FILE.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    copy = tmp_path / "digits.csv.gz"
    copy.write_bytes(bytes(raw))
    monkeypatch.setattr(datasets, "DIGITS_FILE", copy)
    with pytest.raises(ValueError, match="sha256"):
        datasets.load_digits_dataset()
    shutil.copyfile(REPO / "nanofed_tpu_torch" / "data" / "digits.csv.gz", copy)
    assert len(datasets.load_digits_dataset()) == 1437


def _jax_accuracies(tmp_path, rounds: int) -> list[float]:
    from nanofed_tpu.data import federate, load_digits_dataset, pack_eval
    from nanofed_tpu.models import get_model
    from nanofed_tpu.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu.trainer import TrainingConfig

    train, test = load_digits_dataset("train"), load_digits_dataset("test")
    coord = Coordinator(
        model=get_model("digits_mlp", hidden=96),
        train_data=federate(train, num_clients=8, scheme="iid", batch_size=16, seed=0),
        config=CoordinatorConfig(num_rounds=rounds, seed=0, base_dir=str(tmp_path),
                                 eval_every=1, save_metrics=False),
        training=TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.5),
        eval_data=pack_eval(test, batch_size=128),
    )
    return [float(m.eval_metrics["accuracy"]) for m in coord.start_training()]


@pytest.fixture(scope="module")
def accuracy_mlp(tmp_path_factory):
    return _load("record_accuracy_torch").record_accuracy(
        model="mlp", max_rounds=8, device="cpu",
        base_dir=tmp_path_factory.mktemp("accuracy"))


def test_record_accuracy_reaches_97_beside_the_jax_coordinator(accuracy_mlp, tmp_path):
    pytest.importorskip("sklearn")
    ours = [row["test_accuracy"] for row in accuracy_mlp["trajectory"]]
    theirs = _jax_accuracies(tmp_path, 8)
    assert accuracy_mlp["reached"] and accuracy_mlp["reached_at_round"] <= 7
    assert max(theirs) >= 0.97
    assert [row["round"] for row in accuracy_mlp["trajectory"]] == list(range(len(ours)))
    gaps = np.abs(np.asarray(ours) - np.asarray(theirs[:len(ours)]))
    assert gaps.max() <= ACCURACY_TOL, (ours, theirs)
    assert gaps[ACCURACY_LATE:].max() <= ACCURACY_TOL_LATE, (ours, theirs)


def _evidence(mode: str, **kw):
    def run(tmp_path):
        module = _load("record_evidence_torch")
        if mode != "run_asyncfed":
            kw["base_dir"] = tmp_path
        return getattr(module, mode)(device="cpu", **kw)
    return run


def _wire(tmp_path):
    return _load("measure_wire_compression_torch").measure_wire_compression(
        rounds=1, device="cpu")


def _cohort(tmp_path):
    return _load("measure_cohort_gather_torch").measure_cohort_gather(
        clients=40, reps=1, samples_per_client=16, hidden=32, device="cpu",
        base_dir=tmp_path)


CASES = {
    "accuracy_digits_cnn28_r03": None,  # the accuracy_mlp fixture's artifact: same keys
    "byzantine_r05": _evidence("run_byzantine", num_clients=8, rounds=1, eval_every=1),
    "dp_fedavg_cnn_r05": _evidence("run_dp", model_name="cnn", num_rounds=1,
                                   num_clients=40, budgets=(8.0,)),
    "labelskew_r05": _evidence("run_labelskew", num_rounds=1, num_clients=40),
    "personalization_r05": _evidence("run_personalization", num_clients=4, rounds=1),
    "noniid_fedprox_r05": _evidence("run_fedprox", mus=(0.0, 0.2), seeds=(0,),
                                    local_epochs=1, rounds=1),
    "scaffold_r05": _evidence("run_scaffold", seeds=(0,), local_epochs=1, rounds=1),
    "asyncfed_r05": _evidence("run_asyncfed", num_clients=3, sync_rounds=1,
                              straggler_delay=0.05, fast_delay=0.01),
    "wire_compression_r05": _wire,
    "cohort_gather_r05": _cohort,
}


@pytest.mark.parametrize("reference", sorted(CASES))
def test_artifact_carries_the_jax_artifact_keys_and_device(reference, tmp_path, request):
    run = CASES[reference]
    artifact = run(tmp_path) if run else request.getfixturevalue("accuracy_mlp")
    want = json.loads((REPO / "runs" / f"{reference}.json").read_text())
    assert set(artifact) == set(want) | {"device"}
    for nested in ("regime", "config"):
        if nested in want:
            assert set(artifact[nested]) == set(want[nested])
    assert artifact["artifact"].endswith("_torch")
    assert set(artifact["device"]) == DEVICE_KEYS
    assert artifact["device"]["type"] == artifact["platform"] == "cpu"
    json.dumps(artifact)  # what main writes


def test_accuracy_artifact_name_records_the_clients(accuracy_mlp):
    assert accuracy_mlp["artifact"] == "accuracy_digits_torch"
    assert accuracy_mlp["model"] == "digits_mlp(hidden=96)"
    want = json.loads((REPO / "runs" / "accuracy_digits_100c_r05.json").read_text())
    assert set(accuracy_mlp) == set(want) | {"device"}


_IMPORT_SCRIPTS = """
import ast, importlib, importlib.util, sys
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("script", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            importlib.import_module(node.module)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                importlib.import_module(alias.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
assert "nanofed_tpu_torch.orchestration" in sys.modules
assert not bad, bad
"""


def test_evidence_scripts_import_no_jax():
    """Every module each script imports, at its top or inside its functions, loads in a
    process that then holds nothing of JAX or of the JAX package."""
    for path in SCRIPTS.values():
        names = {n.module for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.ImportFrom)}
        assert not any(m == "jax" or m.startswith(("jax.", "nanofed_tpu."))
                       or m == "nanofed_tpu" for m in names), path
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPTS,
                           *map(str, SCRIPTS.values())],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", ["build_notebook_torch", "record_retune_evidence_torch",
                                  "record_compile_evidence_torch", "gen_api_docs_torch"])
def test_later_scripts_import_no_jax(name):
    """The tutorial builder, the retune and time-to-ready evidence and the API
    generator: none names JAX or the JAX package in an import, and every module each
    of the first three imports loads without them (the generator's run over the
    port's modules, with JAX blocked, is tests/test_torch_api_docs.py's)."""
    path = REPO / "scripts" / f"{name}.py"
    names = {n.module for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.ImportFrom)}
    assert not any(m == "jax" or m.startswith(("jax.", "nanofed_tpu."))
                   or m == "nanofed_tpu" for m in names), path
    if name == "gen_api_docs_torch":
        return  # it imports the port's modules as it documents them: see the docs test
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPTS, str(path)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
