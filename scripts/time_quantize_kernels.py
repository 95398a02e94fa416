#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels B5 (``quantize_u32``), B6 (``dequantize_u32``),
B7 (``add_mask``) and B4 (``dequant_accumulate_flat``) of
``nanofed_tpu_torch/ops/quantize.py`` on one NVIDIA GPU, exactly as ``chip_smoke.py``'s
phase 2 does (its ``time_floor``, ``time_fixed_point``, ``time_masks`` and
``time_dequant``), for the package of another checkout.

Run from the root of a checkout::

    python3 scripts/time_quantize_kernels.py [--root DIR] [--kernels b5b6,b7,b4]

``--root`` names the checkout whose ``nanofed_tpu_torch`` is timed (default: this
one), for instance an unpacked ``git archive`` of an earlier commit, so that two
versions of the kernels are timed by the same code in one call on one card: run it
for the old, the new, the new and the old tree in turn.

B5 and B6 are timed at P = 1,199,882 after the table's write flush, after a read flush
and warm, beside the floor of such a pass (an empty launch and a same-bytes copy; B1 at
C = 2 and 125 under each flush), with the wrapper's host time a call and, where the
package has a plan, the plan and the kernel's registers.  B7 is timed as a client's masking pass of k seeds at
P = 1,199,882 for k = 1, 7, 8, 14 and 999 (one launch for all k seeds, or, with a
package whose ``add_mask`` takes one seed, k launches), its plain version up to k = 8
or, with ``--b7-plain-all``, at every k (one run each above 8: about 72 ms a key); B4
at C = 64 and 1000, with its launch plan and registers where it has a plan.  Each is timed as the call
(``ms``) and with the host's work hidden behind a device sleep (``kernel_ms``: B5's
and B6's call, B7's pass, B4's launch alone where the
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


def time_plain_masks(torch, ops, smoke, card: str, rng, masks: dict) -> None:
    """B7's plain version, one run with no warm-up, at each k that ``time_masks`` left
    without a plain time; fills the record's ``plain_ms``."""
    import numpy as np

    from nanofed_tpu_torch.security.secure_agg import _fold_seed_words

    q = torch.randint(-(1 << 31), 1 << 31, (smoke.P_MNIST,), device="cuda",
                      dtype=torch.int32).view(torch.uint32)
    for k, record in masks.items():
        if record["plain_ms"] is not None:
            continue
        seeds = np.stack([_fold_seed_words(rng.bytes(32)) for _ in range(k)])
        signs = [int(v) for v in rng.choice([1, -1], k)]
        record["plain_ms"] = smoke.median_ms(
            lambda: smoke.mask_pass(ops, q, seeds, signs, plain=True), torch, reps=1,
            warmup=0)
        print(f"[{card}] add_mask k={k} P={smoke.P_MNIST}: plain_ms={record['plain_ms']:.6f} "
              "(one run)")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="checkout whose nanofed_tpu_torch is timed")
    parser.add_argument("--kernels", default="b5b6,b7,b4",
                        help="comma-separated kernels to time: b5b6, b7, b4")
    parser.add_argument("--b7-plain-all", action="store_true",
                        help="time B7's plain version at every k, not only up to k = 8")
    args = parser.parse_args()
    which = set(args.kernels.split(","))
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
    result = {"package": str(package)}
    if "b5b6" in which:
        result["floor"] = smoke.time_floor(torch, ops, card)
        result.update(smoke.time_fixed_point(torch, ops, card,
                                             torch.Generator(device="cuda").manual_seed(11)))
    if "b7" in which:
        rng = np.random.default_rng(11)
        masks = smoke.time_masks(torch, ops, card, rng)
        if args.b7_plain_all:
            time_plain_masks(torch, ops, smoke, card, rng, masks)
        result["add_mask"] = {str(k): v for k, v in masks.items()}
    if "b4" in which:
        result["dequant_accumulate_flat"] = smoke.time_dequant(
            torch, ops, card, torch.Generator(device="cuda").manual_seed(4))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
