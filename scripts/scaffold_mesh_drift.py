#!/usr/bin/env python3
"""How far a SCAFFOLD run on four ranks drifts from one rank, round by round.

``chip_smoke.py`` phase (x1)'s configuration (``mnist_cnn``, 1000 synthetic MNIST
clients, 10% cohorts in chunks of 25, 3 rounds) on four gloo ranks sharing ``cuda:0``
as a (2, 2, 1) mesh, once with bf16 fits and once in float32, each against one rank
given the mesh's cohorts in the mesh's slot order (so every client trains in a chunk
of the same clients on both sides), under cuDNN's deterministic algorithms.  After
each round prints the largest absolute gap of the params and of ``c_global``, their
largest magnitudes, and both losses.  The reduce across ranks sums in another order,
so the first round's gap is that order's; later rounds show what the fits do with it.

Run on a machine with a card, from the repository root:
``python3 scripts/scaffold_mesh_drift.py``.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DTYPES = ("bfloat16", "float32")


def coordinator(base_dir, dtype: str, **kw):
    import chip_smoke as cs
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu_torch.trainer import TrainingConfig

    f = cs.FLAGSHIP
    return Coordinator(
        get_model("mnist_cnn"), cs.flagship_data(),
        CoordinatorConfig(num_rounds=cs.SCAFFOLD_ROUNDS, participation_rate=0.1, seed=0,
                          base_dir=base_dir, save_metrics=False),
        TrainingConfig(batch_size=f["batch_size"], local_epochs=f["local_epochs"],
                       learning_rate=f["learning_rate"], compute_dtype=dtype),
        client_chunk=cs.SCAFFOLD_CHUNK, device="cuda", scaffold=True, **kw)


def record(coord, rows: list) -> None:
    """After each round: the full params, ``c_global`` and the loss (a collective on a
    mesh: every rank calls it)."""
    def after(metrics):
        rows.append({"params": {k: v.cpu().numpy() for k, v in coord.full_params().items()},
                     "c_global": coord.full_c_global().cpu().numpy(),
                     "loss": metrics.agg_metrics["loss"]})
    coord.on_round_end = after


def rank_fn(rank: int, world: int, base_dir: str) -> dict:
    import torch

    from nanofed_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.deterministic = True
    mesh = make_mesh((2, 2, 1), device="cuda")
    out = {}
    for dtype in DTYPES:
        coord = coordinator(f"{base_dir}/{dtype}", dtype, mesh=mesh)
        cohorts = [coord._sample_cohort(r) for r in range(coord.config.num_rounds)]
        rows: list = []
        record(coord, rows)
        coord.run()
        out[dtype] = {"rows": rows, "cohorts": cohorts,
                      "slots": [coord._place_cohort(c) for c in cohorts]}
    return out


def main() -> None:
    import numpy as np
    import torch

    from nanofed_tpu_torch.ops import _build
    from nanofed_tpu_torch.parallel.launch import spawn_world

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    _build.build()
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_world(rank_fn, 4, backend="gloo", device="cuda", timeout_s=400,
                            args=(tmp,))
        for dtype in DTYPES:
            mesh = ranks[0][dtype]
            one = coordinator(f"{tmp}/one_{dtype}", dtype)
            slots = {c.tobytes(): s for c, s in zip(mesh["cohorts"], mesh["slots"])}
            one._sample_cohort = lambda r, c=mesh["cohorts"]: c[r]
            one._place_cohort = lambda survived, s=slots: s[survived.tobytes()]
            rows: list = []
            record(one, rows)
            one.run()
            for r, (a, b) in enumerate(zip(mesh["rows"], rows)):
                params_gap = max(float(np.abs(a["params"][k] - b["params"][k]).max())
                                 for k in b["params"])
                print(f"{dtype} round {r}: params gap {params_gap:.3e} c_global gap "
                      f"{float(np.abs(a['c_global'] - b['c_global']).max()):.3e} "
                      f"max|c_global| {float(np.abs(b['c_global']).max()):.3e} max|params| "
                      f"{max(float(np.abs(v).max()) for v in b['params'].values()):.3e} "
                      f"loss (2, 2, 1) {a['loss']:.9f} one rank {b['loss']:.9f}")


if __name__ == "__main__":
    main()
