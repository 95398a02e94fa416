"""The port's retune and time-to-ready evidence on the CPU
(``scripts/record_retune_evidence_torch.py``, ``scripts/record_compile_evidence_torch.py``):
each artifact carries the committed JAX artifact's keys plus ``device`` (and the
retune's ``premise``), the retune lifecycle's structural checks hold, and the port's
AOT ranking at the reference configuration is recorded as it is.  Nothing asserted
here depends on a measured time."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
JAX_RETUNE = REPO / "runs" / "retune_r17_20260807T000319.json"
JAX_COMPILE = REPO / "runs" / "compile_r17_20260806T234722.json"
# The port's counted bytes a round of the two candidates at the reference configuration
# (digits_mlp, 32 clients, rounds_per_block 2): the AOT ranking puts client_chunk=None
# first, where the JAX package's puts client_chunk=1 first (220,476.5 against
# 3,654,518.0 bytes accessed).
PORT_SCORES = {"cand_chunk0_rpb2_m1_b16_h1": 2.8256912e7, "cand_chunk1_rpb2_m1_b16_h1": 3.1353052e7}
SCORE_RTOL = 1e-6


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def retune(tmp_path_factory):
    return _load("record_retune_evidence_torch").record_retune(
        device="cpu", work=tmp_path_factory.mktemp("retune"), check_outcome=False)


def test_retune_artifact_has_the_jax_keys_plus_device_and_premise(retune):
    want = json.loads(JAX_RETUNE.read_text())
    assert set(retune) == set(want) | {"device", "premise", "config"}
    assert retune["device"]["type"] == "cpu" and retune["config"] == "reference"
    json.dumps(retune)


def test_retune_premise_records_the_ports_cpu_ranking(retune):
    premise = retune["premise"]
    assert premise["aot_winner"] == "cand_chunk0_rpb2_m1_b16_h1"
    assert [r["program"] for r in retune["aot_ranking"]] == list(PORT_SCORES)
    for name, score in PORT_SCORES.items():
        assert premise["aot_scores"][name] == pytest.approx(score, rel=SCORE_RTOL)
    assert set(premise["steady_state_s_per_round"]) == set(PORT_SCORES)
    assert premise["measured_winner"] in PORT_SCORES
    assert premise["differ"] == (premise["measured_winner"] != premise["aot_winner"])
    assert set(retune["probe"]) == {"cand_chunk1_rpb2_m1_b16_h1"}


def test_retune_lifecycle_holds_its_structural_checks(retune):
    applied = [d for d in retune["decisions"] if d.get("swap") and d.get("applied")]
    assert len(applied) <= 1
    assert [d["round"] for d in retune["decisions"]] == [4, 8, 12]
    if retune["swap"] is not None:
        assert retune["swap"]["round"] % 2 == 0 and retune["swap"]["block_boundary"]
    assert retune["write_back"]["measured"]


def test_retune_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load("record_retune_evidence_torch").record_retune()


@pytest.fixture(scope="module")
def compile_artifact():
    return _load("record_compile_evidence_torch").record_compile(
        device="cpu", depths=(2, 4), with_cold_start=False)


def test_compile_artifact_has_the_jax_keys_plus_device(compile_artifact):
    want = json.loads(JAX_COMPILE.read_text())
    assert set(compile_artifact) == set(want) | {"device", "cold_start",
                                                 "scan_near_constant", "unrolled_grows"}
    assert compile_artifact["model"] == {**want["model"], "depths": [2, 4]}
    assert [r["depth"] for r in compile_artifact["depths"]] == [2, 4]
    for row in compile_artifact["depths"]:
        assert set(want["depths"][0]) <= set(row)
        assert row["unrolled_compile_s"] > 0 and row["scan_compile_s"] > 0
    assert set(want["growth"]) <= set(compile_artifact["growth"])
    assert compile_artifact["device"]["type"] == "cpu"
    assert "not_measured" in compile_artifact["cold_start"]
    json.dumps(compile_artifact)


def test_compile_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load("record_compile_evidence_torch").record_compile()
