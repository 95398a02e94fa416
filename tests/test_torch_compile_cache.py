"""The port's kernel-build cache (``tuning.compile_cache``), the build module's events and
the autotuner's telemetry records, on the CPU.

This host has no ``nvcc``, so the manifest is tested over fake build directories:
files named as ``ops._build`` names them (``lib<name>-<hash>.so``), with today's hash or
another, and toolchains swapped in.  The build events are driven through
``ops._build``'s listener list.  ``autotune(telemetry=)`` writes records with the JAX
package's types and keys (compared with a JAX sweep over the same tiny space)."""

import json

import pytest

import nanofed_tpu.observability as jax_obs
import nanofed_tpu_torch.observability as obs
from nanofed_tpu.data import federate as jax_federate
from nanofed_tpu.data import synthetic_classification as jax_synthetic
from nanofed_tpu.models import get_model as jax_get_model
from nanofed_tpu.trainer import TrainingConfig as JaxTrainingConfig
from nanofed_tpu.tuning import TuningSpace as JaxTuningSpace
from nanofed_tpu.tuning import autotune as jax_autotune
from nanofed_tpu.tuning import compile_cache as jax_compile_cache
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.trainer import TrainingConfig
from nanofed_tpu_torch.tuning import (
    AutotuneResult,
    PopulationSpec,
    TuningSpace,
    autotune,
    compile_cache,
)

TINY = dict(client_chunks=(None,), rounds_per_blocks=(1,), model_shards=(1,),
            batch_sizes=(16,))


def _fake_build_dir(root, stale=()):
    """A build directory as ``ops._build`` leaves it: every source's library under
    today's hash (or a stale one for the names in ``stale``), and a temp file."""
    root.mkdir(parents=True, exist_ok=True)
    for name in _build.SOURCES:
        current = _build.library_path(name).name
        file = f"lib{name}-{'0' * 16}.so" if name in stale else current
        (root / file).write_bytes(b"\x7fELF" + name.encode() * 100)
    (root / "libreduce-0123.1234.tmp").write_bytes(b"partial")
    return root


def test_the_manifest_lists_each_library_and_the_toolchain(tmp_path):
    root = _fake_build_dir(tmp_path / "build")
    (tmp_path / "tables").mkdir()
    (tmp_path / "tables" / "autotune_abcd.json").write_text(json.dumps(
        {"cache_key": "f" * 64, "winner": {"client_chunk": 2}}))
    manifest = compile_cache.build_manifest(root, tmp_path / "tables")
    libs = {lib["name"]: lib for lib in manifest["libraries"]}
    assert set(libs) == set(_build.SOURCES) and all(lib["current"] for lib in libs.values())
    assert libs["reduce"]["bytes"] == 4 + 6 * 100
    assert manifest["other_entries"] == 1
    assert manifest["autotune_entries"] == [
        {"file": "autotune_abcd.json", "cache_key": "f" * 16, "winner": {"client_chunk": 2}}]
    assert set(manifest["toolchain"]) >= {"torch", "cuda", "nvcc", "arch", "device_kind"}
    assert manifest["toolchain"]["arch"] == "sm_90a"
    # The JAX manifest's common keys are there too.
    assert {"version", "created_unix", "cache_dir", "toolchain", "autotune_entries"} <= \
        set(manifest) & set(jax_compile_cache.build_manifest(tmp_path / "empty"))


def test_a_verified_directory_is_compatible(tmp_path):
    root = _fake_build_dir(tmp_path / "build")
    compile_cache.write_manifest(root, extra={"note": "shipped"})
    report = compile_cache.verify_manifest(root)
    assert report["compatible"] and report["reasons"] == [] and report["dead_weight"] == []
    assert report["manifest"]["note"] == "shipped"


@pytest.mark.parametrize("dim", ["torch", "cuda", "nvcc", "arch"])
def test_a_changed_toolchain_makes_every_library_dead_weight(tmp_path, monkeypatch, dim):
    root = _fake_build_dir(tmp_path / "build")
    compile_cache.write_manifest(root)
    here = compile_cache._toolchain()
    monkeypatch.setattr(compile_cache, "_toolchain", lambda: {**here, dim: "elsewhere"})
    report = compile_cache.verify_manifest(root)
    assert not report["compatible"]
    assert any(r.startswith(f"{dim} mismatch") for r in report["reasons"])
    assert len(report["dead_weight"]) == len(_build.SOURCES)


def test_changed_sources_make_their_library_dead_weight(tmp_path):
    root = _fake_build_dir(tmp_path / "build", stale=("dp_reduce",))
    compile_cache.write_manifest(root)
    report = compile_cache.verify_manifest(root)
    assert not report["compatible"]
    assert report["dead_weight"] == [f"libdp_reduce-{'0' * 16}.so"]
    assert "built from other sources" in report["reasons"][0]
    libs = {lib["name"]: lib["current"] for lib in report["manifest"]["libraries"]}
    assert libs == {"reduce": True, "dp_reduce": False, "quantize": True}


def test_a_missing_or_corrupt_manifest_is_a_reason_not_an_error(tmp_path):
    assert "no manifest" in compile_cache.verify_manifest(tmp_path)["reasons"][0]
    (tmp_path / compile_cache.MANIFEST_NAME).write_text("{torn")
    report = compile_cache.verify_manifest(tmp_path)
    assert not report["compatible"] and "unreadable" in report["reasons"][0]


def test_hits_and_misses_count_the_build_events(monkeypatch):
    assert compile_cache.install_compile_cache_metrics() is True
    reg = compile_cache._metrics_registry
    hits = reg.counter(compile_cache.COMPILE_CACHE_HITS)
    misses = reg.counter(compile_cache.COMPILE_CACHE_MISSES)
    h0, m0 = hits.value(), misses.value()
    # Every library found by its content hash is a hit and builds nothing.
    monkeypatch.setattr(_build.Path, "exists", lambda self: True)
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("nvcc was asked for"))
    assert _build.build() == {}
    assert (hits.value(), misses.value()) == (h0 + len(_build.SOURCES), m0)
    _build._emit(_build.BUILD_MISS_EVENT, name="reduce", seconds=1.0)
    assert misses.value() == m0 + 1
    assert compile_cache.COMPILE_CACHE_HITS == jax_compile_cache.COMPILE_CACHE_HITS
    assert compile_cache.COMPILE_CACHE_MISSES == jax_compile_cache.COMPILE_CACHE_MISSES


def _data():
    return federate(synthetic_classification(64, 2, (10,), seed=0), 4, batch_size=16)


def test_autotune_telemetry_records_have_the_jax_keys(tmp_path):
    port_tel = obs.RunTelemetry(tmp_path / "port", annotate_device=False)
    autotune(get_model("linear"), _data(), TrainingConfig(batch_size=16), num_rounds=2,
             space=TuningSpace(**TINY), cache_dir=tmp_path / "pc", out_dir=None,
             telemetry=port_tel, include_epilogues=False, device="cpu")
    port_tel.close()
    jax_tel = jax_obs.RunTelemetry(tmp_path / "jax", annotate_device=False)
    jax_autotune(jax_get_model("linear"),
                 jax_federate(jax_synthetic(64, 2, (10,), seed=0), 4, batch_size=16),
                 JaxTrainingConfig(batch_size=16), num_rounds=2,
                 space=JaxTuningSpace(**TINY), cache_dir=tmp_path / "jc", out_dir=None,
                 telemetry=jax_tel, include_epilogues=False)
    jax_tel.close()

    def shape(sub):
        lines = (tmp_path / sub / "telemetry.jsonl").read_text().splitlines()
        return [(r["type"], sorted(r)) for r in map(json.loads, lines)
                if r["type"] != "metrics_snapshot"]

    got, want = shape("port"), shape("jax")
    assert got == want and [t for t, _ in got] == ["compile", "autotune"]
    # A cache hit still leaves its autotune record.
    hit_tel = obs.RunTelemetry(tmp_path / "hit", annotate_device=False)
    res = autotune(get_model("linear"), _data(), TrainingConfig(batch_size=16), num_rounds=2,
                   space=TuningSpace(**TINY), cache_dir=tmp_path / "pc", out_dir=None,
                   telemetry=hit_tel, include_epilogues=False, device="cpu")
    hit_tel.close()
    records = [json.loads(x) for x in (tmp_path / "hit" / "telemetry.jsonl").read_text()
               .splitlines()]
    assert res.cache_hit and [r["type"] for r in records] == ["autotune", "metrics_snapshot"]
    assert records[0]["cache_hit"] is True and records[0]["compiles"] == 0


def test_the_telemetry_payload_equals_the_jax_one():
    from nanofed_tpu.tuning import AutotuneResult as JaxAutotuneResult

    d = {
        "winner": {"client_chunk": None, "rounds_per_block": 1, "model_shards": 1,
                   "batch_size": 16},
        "candidates": [{"config": {"client_chunk": None, "rounds_per_block": 1,
                                   "model_shards": 1, "batch_size": 16},
                        "feasible": True, "score": 2.5, "cost": {"peak_bytes": 10}}],
        "scoring_basis": "basis", "platform": "cpu", "device_kind": "cpu",
        "num_devices": 1, "hbm_budget_bytes": None, "budget_basis": "unbounded",
        "cache_key": "k" * 64, "cache_hit": True, "compiles": 3,
        "compile_seconds_total": 1.75, "skipped": 2, "wedged_at": "cand_x",
        "space": {}, "population": {},
    }
    assert AutotuneResult.from_dict(d).telemetry_payload() == \
        JaxAutotuneResult.from_dict(d).telemetry_payload()


def test_warm_runs_the_sweep_and_stamps_the_manifest(tmp_path):
    tel = obs.RunTelemetry(tmp_path / "tel", annotate_device=False)
    result = compile_cache.warm(
        get_model("linear"), PopulationSpec(4, 16, (10,)), TrainingConfig(batch_size=16),
        num_rounds=2, space=TuningSpace(**TINY), cache_dir=tmp_path / "tables",
        build_dir=tmp_path / "build", telemetry=tel, device="cpu")
    tel.close()
    assert result.manifest["warmed"]["compiles"] == 1 and not result.autotune.cache_hit
    assert [p["program"] for p in result.programs] == [
        p["program"] for p in result.manifest["warmed"]["programs"]]
    assert result.manifest["autotune_entries"][0]["cache_key"] == result.autotune.cache_key[:16]
    assert set(result.to_dict()) == {"cache_dir", "manifest_path", "manifest", "programs",
                                     "autotune"}
    types = [json.loads(x)["type"] for x in (tmp_path / "tel" / "telemetry.jsonl")
             .read_text().splitlines()]
    assert types == ["compile", "autotune", "metrics_snapshot"]
    again = compile_cache.warm(
        get_model("linear"), PopulationSpec(4, 16, (10,)), TrainingConfig(batch_size=16),
        num_rounds=2, space=TuningSpace(**TINY), cache_dir=tmp_path / "tables",
        build_dir=tmp_path / "build", device="cpu")
    assert again.autotune.cache_hit and again.programs == []
