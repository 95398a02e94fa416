"""The port imports neither JAX nor anything of ``nanofed_tpu`` (every module of the
package, the network mode and secure aggregation included), and its entry points run
on the GPU unless the caller asks for the CPU."""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nanofed_tpu_torch
from nanofed_tpu_torch import run_experiment
from nanofed_tpu_torch.communication import HTTPServer, NetworkCoordinator, NetworkRoundConfig
from nanofed_tpu_torch.communication.transport import free_port
from nanofed_tpu_torch.core import resolve_device
from nanofed_tpu_torch.data import federate, synthetic_classification
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.security import secure_agg
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
    }


@pytest.mark.parametrize("name", ["resolve_device", "run_experiment", "Coordinator",
                                  "from_numpy_params", "NetworkCoordinator",
                                  "mask_update_cuda_backend", "expand_mask_cuda_backend",
                                  "unmask_sum", "dequantize_sum"])
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
    assert resolve_device("cpu").type == "cpu"
