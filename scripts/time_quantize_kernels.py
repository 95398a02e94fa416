#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels B7 (``add_mask``) and B4
(``dequant_accumulate_flat``) of ``nanofed_tpu_torch/ops/quantize.py`` on one NVIDIA
GPU, exactly as ``chip_smoke.py``'s phase 2 does (its ``time_masks`` and
``time_dequant``), for the package of another checkout.

Run from the root of a checkout::

    python3 scripts/time_quantize_kernels.py [--root DIR]

``--root`` names the checkout whose ``nanofed_tpu_torch`` is timed (default: this
one), for instance an unpacked ``git archive`` of an earlier commit, so that two
versions of the kernels are timed by the same code in one call on one card: run it
for the old, the new, the new and the old tree in turn.

B7 is timed as a client's masking pass of k seeds at P = 1,199,882 for k = 1, 7, 8,
14 and 999 (one launch for all k seeds, or, with a package whose ``add_mask`` takes
one seed, k launches); B4 at C = 64 and 1000, with its launch plan and registers
where it has a plan.  Each is timed as the call (``ms``) and with the host's work
hidden behind a device sleep (``kernel_ms``: B7's pass, B4's launch alone where the
package has ``quantize.dequant_launch``).  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="checkout whose nanofed_tpu_torch is timed")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_quantize_kernels: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("chip_smoke_timing", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = smoke.nvidia_smi()
    package = Path(ops.__file__).resolve().parents[1]
    print(f"card: {card}; timing {package}")
    t0 = time.perf_counter()
    logs = _build.build(("quantize",))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in logs.get("quantize", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  quantize: {line.strip()}")
    masks = smoke.time_masks(torch, ops, card, np.random.default_rng(11))
    dequant = smoke.time_dequant(torch, ops, card, torch.Generator(device="cuda").manual_seed(4))
    print(json.dumps({"package": str(package),
                      "add_mask": {str(k): v for k, v in masks.items()},
                      "dequant_accumulate_flat": dequant}))


if __name__ == "__main__":
    main()
