#!/usr/bin/env python
"""Record the time-to-ready evidence of the PyTorch/CUDA port (counterpart of
``scripts/record_compile_evidence.py``).

The reference measures XLA's compile walltime of the transformer round program at
depths 2, 4 and 8, unrolled against ``scan_layers=True``, and claims that unrolled
compile time grows with depth while the scanned layout's stays near-constant.  The
port compiles no programs: its ``compile_seconds`` is a program's first call, its
time-to-ready (cuDNN's choice of algorithm, kernel loads, the kernels' first build;
``observability/profiling.py``).  This script measures that, on the reference's model
and sweep (vocab 64, seq 16, width 32, 4 heads; ``autotune`` with ``cache_dir=None``,
``out_dir=None`` and ``include_epilogues=False``), after one untimed warm call at
depth 1 (a depth outside the sweep) so that the first candidate does not carry the
process's CUDA start-up.  Each row also carries the candidate's steady call
(``measured_s_per_round``) and the first call's excess over it.

Beside it, ``cold_start`` splits a fresh process's start-up, each stage in fresh
subprocesses: the CUDA context (``torch.cuda.init()`` and a first tiny op,
synchronized); the kernel libraries (``ops._build.build()`` into a fresh temporary
directory, which runs ``nvcc``, against loading the libraries already built); and
the first round against the second of ``digits_mlp`` (the tutorial notebook's
federation), ``mnist_cnn`` at the tutorial round's shape (2 clients of 12,000 and
4,000 synthetic MNIST samples, 2 epochs, batch 64) and ``mnist_cnn`` on the digits at
28x28 (8 clients, ``record_accuracy_torch``'s run), each after its process's own
imports, context and libraries, which the stage also times.

The verdict fields say whether the reference's claim holds for the port:
``unrolled_grows`` (the depth-8 over depth-2 time-to-ready ratio above
``GROWTH_RATIO``) and ``scan_near_constant`` (that ratio at most ``GROWTH_RATIO``).

Usage (from the repo root; the card by default, ``--device cpu`` on request):
    python scripts/record_compile_evidence_torch.py [--device cpu] [--no-cold-start]

Writes ``runs/compile_torch.json``.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

DEPTHS = (2, 4, 8)
VOCAB, SEQ_LEN, WIDTH, HEADS = 64, 16, 32, 4
WARM_DEPTH = 1
# A depth-8 over depth-2 ratio above this "grows"; at or below it is "near-constant".
GROWTH_RATIO = 1.5
STAGE_TIMEOUT_S = 600.0

# Each stage is one fresh ``python -c`` process; it prints one JSON line of seconds.
_PRELUDE = """
import json, sys, time
t_start = time.perf_counter()
sys.path.insert(0, {repo!r})
import torch
t_torch = time.perf_counter()
out = {{"import_torch_s": t_torch - t_start}}
def sync():
    torch.cuda.synchronize()
"""

STAGES = {
    "cuda_context": """
t0 = time.perf_counter()
torch.cuda.init()
x = torch.ones(1, device="cuda") + 1
sync()
out["context_s"] = time.perf_counter() - t0
""",
    "kernel_build": """
import tempfile
from pathlib import Path
from nanofed_tpu_torch.ops import _build
with tempfile.TemporaryDirectory() as tmp:
    _build.BUILD_DIR = Path(tmp)
    t0 = time.perf_counter()
    _build.build()
    out["nvcc_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.load(name)
    out["load_built_s"] = time.perf_counter() - t0
""",
    "kernel_load": """
from nanofed_tpu_torch.ops import _build
_build.build()  # present from an earlier build: found by content hash
t0 = time.perf_counter()
_build.build()
for name in _build.SOURCES:
    _build.load(name)
out["load_built_s"] = time.perf_counter() - t0
""",
}

_FIRST_ROUND = """
t0 = time.perf_counter()
torch.cuda.init()
torch.ones(1, device="cuda").add_(1)
sync()
out["context_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
from nanofed_tpu_torch import ops
from nanofed_tpu_torch.ops import _build
from nanofed_tpu_torch.data import federate
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
from nanofed_tpu_torch.trainer import TrainingConfig
out["import_port_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
_build.build()
for name in _build.SOURCES:
    _build.load(name)
out["load_built_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
{data}
out["data_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
coord = Coordinator(model, data, CoordinatorConfig(num_rounds=2, seed=0,
                    base_dir={base!r}, save_metrics=False), training=training,
                    device="cuda")
sync()
out["construct_s"] = time.perf_counter() - t0
ops.reset_launch_counts()
rounds = [m.duration_s for m in coord.start_training()]
out["round0_s"], out["round1_s"] = rounds
out["first_round_excess_s"] = rounds[0] - rounds[1]
out["launches"] = ops.launch_counts()
"""

FIRST_ROUNDS = {
    "digits_mlp": """
from nanofed_tpu_torch.data import load_digits_dataset
model = get_model("digits_mlp", hidden=96)
data = federate(load_digits_dataset("train"), num_clients=8, scheme="iid", batch_size=16,
                seed=0)
training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.5)
""",
    "mnist_cnn_tutorial": """
from nanofed_tpu_torch.data import load_mnist
model = get_model("mnist_cnn")
data = federate(load_mnist("train", None, synthetic_size=16_000), num_clients=2,
                batch_size=64, seed=0, proportions=[0.75, 0.25])
training = TrainingConfig(batch_size=64, local_epochs=2, learning_rate=0.1)
""",
    "mnist_cnn_digits28": """
from nanofed_tpu_torch.data import load_digits_dataset, resize_images
model = get_model("mnist_cnn")
data = federate(resize_images(load_digits_dataset("train"), 28, 28), num_clients=8,
                scheme="iid", batch_size=16, seed=0)
training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.1)
""",
}


def run_stage(code: str) -> dict:
    """One fresh process running ``code`` after the prelude; its seconds, plus the
    process's whole wall time from its start as the parent saw it."""
    src = _PRELUDE.format(repo=str(REPO)) + code + "\nprint(json.dumps(out))\n"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                          timeout=STAGE_TIMEOUT_S, cwd=REPO, env=dict(os.environ))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"cold-start stage failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in row.items()} | {
        "process_wall_s": round(wall, 4)}


def cold_start() -> dict:
    """The fresh-process stages on the card (see the module note)."""
    out = {stage: run_stage(code) for stage, code in STAGES.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in FIRST_ROUNDS.items():
            out[f"first_round_{name}"] = run_stage(_FIRST_ROUND.format(data=data.strip(),
                                                                        base=tmp))
            print(f"cold start {name}: {json.dumps(out[f'first_round_{name}'])}",
                  file=sys.stderr, flush=True)
    return out


def record_compile(device: str | None = None, depths: tuple[int, ...] = DEPTHS,
                   with_cold_start: bool = True) -> dict:
    """Time-to-ready by depth and layout on ``device`` (and, on the card, the cold
    start); returns the artifact."""
    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.core.device import device_record, resolve_device
    from nanofed_tpu_torch.models.transformer import transformer_lm
    from nanofed_tpu_torch.trainer import TrainingConfig
    from nanofed_tpu_torch.tuning import PopulationSpec, TuningSpace
    from nanofed_tpu_torch.tuning.autotuner import autotune

    dev = resolve_device(device)
    ops.reset_launch_counts()
    space = TuningSpace(client_chunks=(None,), rounds_per_blocks=(1,), model_shards=(1,),
                        batch_sizes=(16,))
    pop = PopulationSpec(num_clients=8, capacity=32, sample_shape=(SEQ_LEN,),
                         x_dtype="int32")
    training = TrainingConfig(batch_size=16, local_epochs=1, learning_rate=0.1)

    def ready(depth: int, scan: bool) -> dict:
        model = transformer_lm(vocab=VOCAB, seq_len=SEQ_LEN, width=WIDTH, depth=depth,
                               heads=HEADS, scan_layers=scan)
        result = autotune(model, pop, training, num_rounds=4, space=space, cache_dir=None,
                          out_dir=None, include_epilogues=False, device=dev)
        outcome = result.outcomes[0]
        assert outcome.feasible, outcome.reject_reason
        return outcome.cost

    t0 = time.perf_counter()
    warm = ready(WARM_DEPTH, False)  # untimed: the process's CUDA start-up
    warm_wall = time.perf_counter() - t0
    rows = []
    for depth in depths:
        row = {"depth": depth}
        for scan in (False, True):
            cost = ready(depth, scan)
            key = "scan" if scan else "unrolled"
            row[f"{key}_compile_s"] = round(cost["compile_seconds"], 6)
            row[f"{key}_steady_s"] = round(cost["measured_s_per_round"], 6)
            row[f"{key}_ready_excess_s"] = round(
                cost["compile_seconds"] - cost["measured_s_per_round"], 6)
        row["scan_over_unrolled"] = round(row["scan_compile_s"] / row["unrolled_compile_s"], 4)
        rows.append(row)
        print(f"depth={depth}: unrolled={row['unrolled_compile_s']}s "
              f"scan={row['scan_compile_s']}s (steady {row['unrolled_steady_s']}s / "
              f"{row['scan_steady_s']}s)", file=sys.stderr, flush=True)

    first, last = rows[0], rows[-1]
    unrolled_ratio = round(last["unrolled_compile_s"] / first["unrolled_compile_s"], 4)
    scan_ratio = round(last["scan_compile_s"] / first["scan_compile_s"], 4)
    record = device_record(dev)
    cold = (cold_start() if with_cold_start and dev.type == "cuda" else
            {"not_measured": "the cold start is measured on the card only"
             if dev.type != "cuda" else "skipped (--no-cold-start)"})
    return {
        "what": (
            "time-to-ready (the first call's wall time, the port's compile_seconds) of the "
            "dispatched transformer ROUND PROGRAM (build_round_step profiled through the "
            "autotuner path) at increasing depth, unrolled blocks vs scan-over-layers; "
            "and a fresh process's cold start split by stage"
        ),
        "basis": (
            f"measured wall-clock on {record['name']} ({record['nvidia_smi']}; torch "
            f"{record['torch']}, CUDA {record['cuda']}); the port compiles no programs, so "
            "a candidate's compile_seconds is its first call, timed around a device "
            "synchronize after one untimed warm call at depth "
            f"{WARM_DEPTH} ({round(warm['compile_seconds'], 6)} s first call, "
            f"{round(warm_wall, 3)} s with its sweep); the autotune result cache was off"
        ),
        "model": {"vocab": VOCAB, "seq_len": SEQ_LEN, "width": WIDTH, "heads": HEADS,
                  "depths": list(depths)},
        "depths": rows,
        "growth": {
            "depth_ratio": last["depth"] / first["depth"],
            "unrolled_compile_ratio": unrolled_ratio,
            "scan_compile_ratio": scan_ratio,
            "claim": (
                "the JAX package's claim: unrolled compile grows with depth; scan compile "
                "is near-constant (ratio ~1) because XLA sees one block body"
            ),
            "threshold": GROWTH_RATIO,
        },
        "scan_near_constant": scan_ratio <= GROWTH_RATIO,
        "unrolled_grows": unrolled_ratio > GROWTH_RATIO,
        "parity": (
            "scan == unrolled layer math is pinned by tests/test_torch_transformer.py "
            "against the JAX package"
        ),
        "cold_start": cold,
        "device": record,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--no-cold-start", action="store_true",
                    help="skip the fresh-process stages")
    ap.add_argument("--out", default=None, help="artifact path (default runs/compile_torch.json)")
    args = ap.parse_args()
    artifact = record_compile(args.device, with_cold_start=not args.no_cold_start)
    out = Path(args.out) if args.out else REPO / "runs" / "compile_torch.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=2, sort_keys=True) + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
