"""The port imports neither JAX nor anything of ``nanofed_tpu`` (every module of the
package, the fault plans and injectors, the multi-host harness's worker, the load
generator, the multi-tenant service, the fleet and the analysis (fedlint, the
contract checks, the program audit and strict mode) when they run, fused
multi-round blocks, the network mode, secure aggregation, signing, the ingest buffer,
observability and tuning, the ResNets, the benchmark suite and the command line
included, and the compressed codec, signing and ingest paths when they run), nor does
any rank of a world it spawns (``parallel.launch.spawn_world``), the federation's
cross-host reduce, generation store and watchdog included, and its entry points run on
the GPU unless the caller asks for the CPU."""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nanofed_tpu_torch
from nanofed_tpu_torch import cli, run_experiment
from nanofed_tpu_torch.analysis import program_audit
from nanofed_tpu_torch.analysis.__main__ import main as analysis_main
from nanofed_tpu_torch.benchmarks import run_benchmark
from nanofed_tpu_torch.communication import (
    HTTPServer,
    NetworkCoordinator,
    NetworkRoundConfig,
    fedbuff_combine,
)
from nanofed_tpu_torch.communication.federation import host_partial_row
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.core import resolve_device
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.ingest import DeviceIngestBuffer, IngestConfig, IngestPipeline
from nanofed_tpu_torch.loadgen import run_loadtest
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.parallel import build_round_block, build_scaffold_round_step
from nanofed_tpu_torch.security import secure_agg
from nanofed_tpu_torch.service import FederationService, RoundScheduler, run_tenant_service
from nanofed_tpu_torch.trainer import Trainer, TrainingConfig
from nanofed_tpu_torch.tuning import PopulationSpec, autotune, profile_aggregation_epilogues
from nanofed_tpu_torch.utils.trees import from_numpy_params

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import pkgutil, sys, importlib
import nanofed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nanofed_tpu_torch.__path__, "nanofed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
print(len(names))
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_nanofed_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40  # every module of the package was imported


def test_spawned_ranks_import_no_jax():
    """Every rank of a gloo world imports every module of the port and runs a
    collective; none loads JAX or the JAX package (the parent test process has both)."""
    import torch_world_ranks

    from nanofed_tpu_torch.parallel.launch import spawn_world

    assert spawn_world(torch_world_ranks.imported_modules, 2, backend="gloo", device="cpu",
                       timeout_s=120) == [[], []]


def test_spawned_hosts_run_the_federation_modules_without_jax(tmp_path):
    """Two ranks as hosts run ``communication.federation``'s row all-reduce under
    ``parallel.resilience``'s watchdog and commit a ``persistence.generation_store``
    generation; neither loads JAX or the JAX package."""
    import torch_world_ranks

    from nanofed_tpu_torch.parallel.launch import spawn_world

    assert spawn_world(torch_world_ranks.federation_modules, 2, backend="gloo",
                       device="cpu", timeout_s=120, args=(str(tmp_path),)) == [[], []]


_RUN_WIRE_PATHS = """
import sys
import numpy as np
import torch
from nanofed_tpu_torch.communication import codec
from nanofed_tpu_torch.ingest import DeviceIngestBuffer
from nanofed_tpu_torch.security import signing
params = {"a/bias": torch.zeros(3), "a/kernel": torch.ones(2, 3, dtype=torch.bfloat16)}
delta = {"a/bias": torch.full((3,), 0.1), "a/kernel": torch.full((2, 3), -0.2)}
codec.reconstruct_q8(params, codec.encode_delta_q8(delta, seed=0))
codec.reconstruct_topk8(params, codec.encode_delta_topk8(delta, 0.5, seed=0))
signing.update_signing_bytes(params, "c", 0, "{}")
buf = DeviceIngestBuffer(params, 2, device="cpu")
buf.offer(np.ones(9, np.float32), client_id="c", round_number=0, weight=1.0)
buf.drain_fedavg(np.zeros(9, np.float32))
for name in ("cryptography", "cryptography.hazmat.primitives.asymmetric.rsa"):
    try:
        __import__(name)
    except ImportError:
        break
else:
    manager = signing.SecurityManager(key_size=1024)
    sig = manager.sign_update(params, "c", 0, "{}")
    assert signing.verify_update_signature(params, "c", 0, "{}", sig,
                                           manager.get_public_key())
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "ml_dtypes" or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
assert not bad, bad
print("ok")
"""


def test_wire_paths_run_without_jax_or_ml_dtypes():
    """The compressed codec, signing (bf16 leaves included) and the ingest buffer run
    with no JAX, no ``ml_dtypes`` and nothing of the JAX package loaded."""
    proc = subprocess.run([sys.executable, "-c", _RUN_WIRE_PATHS], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr


_RUN_FAULTS_AND_HARNESS_WORKER = """
import importlib.util, json, sys
from pathlib import Path
import nanofed_tpu_torch.faults as faults
tmp = Path(sys.argv[1])
plan = faults.FaultPlan.generate(3, [f"c{i}" for i in range(8)], 4, crash_fraction=0.25,
                                 hosts=2, dcn_degrade_fraction=0.5, dcn_delay_s=0.01)
schedule = faults.ChaosSchedule(plan)
assert [c for c in range(8) if schedule.crashed(f"c{c}", 3)]
plan.save(tmp / "plan.json")
spec = importlib.util.spec_from_file_location("harness", "scripts/multihost_harness_torch.py")
harness = importlib.util.module_from_spec(spec)
spec.loader.exec_module(harness)
rc = harness.main(["worker", "--job", "hostchaos", "--num-processes", "1", "--device", "cpu",
                   "--clients", "4", "--rounds", "2", "--block-size", "1",
                   "--fault-plan", str(tmp / "plan.json"), "--hb-dir", str(tmp / "hb"),
                   "--ckpt-dir", str(tmp / "ckpt"), "--out", str(tmp / "out.json")])
assert rc == 0 and json.loads((tmp / "out.json").read_text())["rounds"] == [0, 1]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
assert not bad, bad
print("ok")
"""


def test_faults_and_the_harness_worker_run_without_jax(tmp_path):
    """``nanofed_tpu_torch.faults`` and a hostchaos worker of
    ``scripts/multihost_harness_torch.py`` (plan, heartbeats, watchdog, generation
    commits) run with no JAX and nothing of the JAX package loaded."""
    proc = subprocess.run([sys.executable, "-c", _RUN_FAULTS_AND_HARNESS_WORKER,
                           str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr


_RUN_LOADGEN_AND_SERVICE = """
import logging, sys
logging.disable(logging.WARNING)
from nanofed_tpu_torch.loadgen import run_loadtest
from nanofed_tpu_torch.service import TenantSpec, run_tenant_service
rec = run_loadtest(mode="ingest", clients=16, async_buffer_k=8, ingest_capacity=16,
                   virtual_clock=True, device="cpu")
assert rec["failed_submits"] == 0 and rec["aggregations_completed"] == 2, rec
art = run_tenant_service([TenantSpec(name="a", model="linear", rounds=1, async_buffer_k=4)],
                         clients_per_tenant=8, submits_per_client=1, virtual_clock=True,
                         sequential_baseline=False, out_dir=None, device="cpu")
assert art["tenants"]["a"]["rounds_completed"] == 1, art
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
assert not bad, bad
print("ok")
"""


def test_loadgen_and_service_run_without_jax():
    """A swarm against the ingest path (``loadgen``) and a tenant behind the service's
    shared listener, scheduler and device gate (``service``) run with no JAX and
    nothing of the JAX package loaded."""
    proc = subprocess.run([sys.executable, "-c", _RUN_LOADGEN_AND_SERVICE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr


_RUN_FLEET = """
import asyncio, logging, sys
logging.disable(logging.WARNING)
from nanofed_tpu_torch import fleet
from nanofed_tpu_torch.fleet import evidence
from nanofed_tpu_torch.models import get_model
profile = fleet.reference_fleet()
base = get_model("mlp", in_features=16, hidden=8, num_classes=4).init(
    __import__("torch").Generator().manual_seed(0))
fleet.sweep_fleet_mix(profile, base, 24, device="cpu")
rec = evidence.run_fleet_convergence(profile, num_clients=4, num_rounds=1, local_steps=1,
                                     device="cpu")
assert rec["parity_max_abs_diff"] <= 1e-6, rec
digest = asyncio.run(evidence._swarm_leg(profile, num_clients=6, submits_per_client=1,
                                         device="cpu"))
assert digest["failed_total"] == 0 and digest["accepted_total"] > 0, digest
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
assert not bad, bad
print("ok")
"""


def test_the_fleet_runs_without_jax():
    """The fleet (``fleet``: the mix sweep, an in-process round through the gateway, the
    wire codecs and both aggregation routes, a live fleet server under a per-tier swarm)
    runs with no JAX and nothing of the JAX package loaded."""
    proc = subprocess.run([sys.executable, "-c", _RUN_FLEET], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr


_RUN_ANALYSIS = """
import logging, sys
logging.disable(logging.WARNING)
import torch
from nanofed_tpu_torch import analysis
from nanofed_tpu_torch.analysis import program_audit
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.parallel.mesh import Mesh
from nanofed_tpu_torch.trainer import TrainingConfig
assert analysis.lint_paths(["nanofed_tpu_torch"]) == []
assert all(r["ok"] for r in analysis.run_mutation_suite().values())
data = federate(synthetic_classification(64, 3, (8,), seed=0), 4, batch_size=16)
coord = Coordinator(get_model("mlp", in_features=8, hidden=8, num_classes=3), data,
                    CoordinatorConfig(num_rounds=2, rounds_per_block=2, save_metrics=False),
                    TrainingConfig(batch_size=16), device="cpu", strict=True,
                    mesh=Mesh.describe((2, 2, 1), 1))
assert all(r.ok for r in coord.audit_programs())
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
assert not bad, bad
print("ok")
"""


def test_the_analysis_runs_without_jax():
    """The analysis (``analysis``: fedlint over the package, the audit's mutation suite,
    a strict coordinator's contract checks and audit on a described mesh) runs with no
    JAX and nothing of the JAX package loaded."""
    proc = subprocess.run([sys.executable, "-c", _RUN_ANALYSIS], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr


def _harness_worker():
    spec = importlib.util.spec_from_file_location(
        "multihost_harness_torch", REPO / "scripts" / "multihost_harness_torch.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    return harness.main(["worker", "--num-processes", "1", "--clients", "2"])


def test_every_module_imports_in_process():
    for info in pkgutil.walk_packages(nanofed_tpu_torch.__path__, "nanofed_tpu_torch."):
        importlib.import_module(info.name)


def _entry_points():
    model = get_model("mnist_cnn")
    data = federate(synthetic_classification(32, 10, (28, 28, 1)), 2, batch_size=8)
    return {
        "resolve_device": lambda: resolve_device(),
        "run_experiment": lambda: run_experiment(num_clients=2, train_size=32),
        "Coordinator": lambda: Coordinator(model, data, CoordinatorConfig(save_metrics=False)),
        "from_numpy_params": lambda: from_numpy_params({"w": np.zeros(3)}),
        "NetworkCoordinator": lambda: NetworkCoordinator(
            HTTPServer(port=free_port()), {"w": torch.zeros(3)}, NetworkRoundConfig()),
        "mask_update_cuda_backend": lambda: secure_agg.mask_update(
            {"w": torch.zeros(3)}, 0, secure_agg.ClientKeyPair.generate(), [b"k"], 0,
            secure_agg.SecureAggregationConfig(min_clients=1), backend="cuda"),
        "expand_mask_cuda_backend": lambda: secure_agg.expand_mask(bytes(32), 4, "cuda"),
        "unmask_sum": lambda: secure_agg.unmask_sum(
            [np.zeros(3, np.uint32)], {"w": torch.zeros(3)},
            secure_agg.SecureAggregationConfig(min_clients=1)),
        "dequantize_sum": lambda: secure_agg.dequantize_sum(np.zeros(3, np.uint32), 16),
        "autotune": lambda: autotune(model, PopulationSpec(2, 16, (28, 28, 1))),
        "profile_aggregation_epilogues": lambda: profile_aggregation_epilogues(100),
        "Coordinator_scaffold": lambda: Coordinator(
            model, data, CoordinatorConfig(save_metrics=False), scaffold=True),
        "build_scaffold_round_step": lambda: build_scaffold_round_step(
            model, TrainingConfig(), 2),
        "Trainer": lambda: Trainer(model, TrainingConfig()),
        "DeviceIngestBuffer": lambda: DeviceIngestBuffer({"w": torch.zeros(3)}, 2),
        "IngestPipeline": lambda: IngestPipeline({"w": torch.zeros(3)}, IngestConfig()),
        "HTTPServer_ingest": lambda: HTTPServer(port=free_port(), ingest=IngestConfig()),
        "fedbuff_combine": lambda: fedbuff_combine({"w": torch.zeros(3)}, [], {}, 0),
        "build_round_block": lambda: build_round_block(model, TrainingConfig(), num_clients=2),
        "Coordinator_fused": lambda: Coordinator(
            model, data, CoordinatorConfig(save_metrics=False, rounds_per_block=2)),
        "run_benchmark": lambda: run_benchmark("cross_silo", train_size=64),
        "cli_bench": lambda: cli.main(["bench", "cross_silo", "--train-size", "64"]),
        "host_partial_row_empty": lambda: host_partial_row(None, 0.0, 3),
        "harness_worker": _harness_worker,
        "RoundScheduler": lambda: RoundScheduler(),
        "FederationService": lambda: FederationService(port=0),
        "run_loadtest": lambda: run_loadtest(clients=4),
        "run_tenant_service": lambda: run_tenant_service(out_dir=None),
        "cli_loadtest": lambda: cli.main(["loadtest", "--clients", "4", "--virtual-clock"]),
        "cli_tenants": lambda: cli.main(["tenants", "--clients", "4", "--virtual-clock"]),
        "reference_catalog": lambda: program_audit.reference_catalog(),
        "cli_audit": lambda: cli.main(["audit"]),
        "analysis_programs": lambda: analysis_main(["--programs", __file__]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "run_experiment", "Coordinator",
                                  "from_numpy_params", "NetworkCoordinator",
                                  "mask_update_cuda_backend", "expand_mask_cuda_backend",
                                  "unmask_sum", "dequantize_sum", "autotune",
                                  "profile_aggregation_epilogues", "Coordinator_scaffold",
                                  "build_scaffold_round_step", "Trainer",
                                  "DeviceIngestBuffer", "IngestPipeline", "HTTPServer_ingest",
                                  "fedbuff_combine", "build_round_block",
                                  "Coordinator_fused", "run_benchmark", "cli_bench",
                                  "host_partial_row_empty", "harness_worker",
                                  "RoundScheduler", "FederationService", "run_loadtest",
                                  "run_tenant_service", "cli_loadtest", "cli_tenants",
                                  "reference_catalog", "cli_audit", "analysis_programs"])
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("NANOFED_AUTOTUNE_HBM_BUDGET", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
    assert resolve_device("cpu").type == "cpu"
