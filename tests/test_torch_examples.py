"""The port's two examples on the CPU at a tiny size: ``examples/mnist/
run_experiment_torch.py`` (the reference example's three clients, on 600 synthetic
samples) and ``examples/secure_federation/run_secure_torch.py`` (3 digits clients over
localhost HTTP under secure aggregation, one round).  Each round must complete, and
the secure aggregate must equal the plain weighted FedAvg of what the clients masked
within 1e-4: each client's params are quantized at 2^-16 (an error of at most 2^-17),
and the sums run in float32 in another order.  Neither example imports JAX or
anything of ``nanofed_tpu``."""

import asyncio
import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import pytest

from nanofed_tpu_torch.communication.transport import free_port

REPO = Path(__file__).resolve().parents[1]
MNIST = REPO / "examples" / "mnist" / "run_experiment_torch.py"
SECURE = REPO / "examples" / "secure_federation" / "run_secure_torch.py"
SECURE_TOL = 1e-4


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_mnist_example_completes_its_rounds(tmp_path):
    history, final = _load(MNIST).run(rounds=1, epochs=1, synthetic_size=600,
                                      out_dir=str(tmp_path), device="cpu")
    assert [m.status.name for m in history] == ["COMPLETED"]
    assert history[0].num_clients == 3
    assert math.isfinite(history[0].agg_metrics["loss"])
    assert math.isfinite(final["loss"]) and 0.0 <= final["accuracy"] <= 1.0


def test_secure_example_aggregate_is_the_fedavg():
    pytest.importorskip("cryptography", reason="secure aggregation needs the crypto dependency")
    result = asyncio.run(_load(SECURE).main(free_port(), rounds=1, num_clients=3,
                                            device="cpu"))
    assert [h["status"] for h in result["history"]] == ["COMPLETED"]
    assert result["history"][0]["secure"] and result["history"][0]["num_clients"] == 3
    assert result["fedavg_gap"] <= SECURE_TOL
    assert 0.0 <= result["accuracy"] <= 1.0


_IMPORT_EXAMPLES = """
import importlib.util, sys
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "nanofed_tpu" or m.startswith("nanofed_tpu."))
assert "nanofed_tpu_torch" in sys.modules
assert not bad, bad
"""


def test_examples_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_EXAMPLES, str(MNIST), str(SECURE)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
