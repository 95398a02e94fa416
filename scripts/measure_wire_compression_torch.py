#!/usr/bin/env python
"""Measure the q8-delta wire codec of the PyTorch/CUDA port on the flagship model
(counterpart of ``scripts/measure_wire_compression.py``): bytes on the wire and
reconstruction error, from a real trained round delta (deflate ratios lie on random
data).

Writes ``runs/wire_compression_<tag>.json`` with the reference artifact's keys plus
``device`` (the card's name and power limit, torch and CUDA versions, the run's kernel
launches):
  - payload bytes: the full params as npz (the baseline wire format) against the q8
    and topk8 deltas, and the reference's JSON-float-list encoding of the same params
    (``nanofed/communication/http/server.py:140-149``), computed locally;
  - the reconstruction error of the dequantized delta against the true delta;
  - a digits federation of 8 Dirichlet(0.2) clients run uncompressed, with every
    client delta through q8, and through topk8 with per-client error feedback.

Usage (from the repo root; the card by default, ``--device cpu`` on request):
    python scripts/measure_wire_compression_torch.py [--round-tag torch] [--device cpu]

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def measure_wire_compression(round_tag: str = "torch", rounds: int = 15,
                             device: str | None = None) -> dict:
    """The payload sizes and reconstruction error of the flagship's trained delta, and
    the compressed federation's accuracy after ``rounds`` rounds; returns the
    artifact."""
    import numpy as np
    import torch

    from nanofed_tpu_torch import ops
    from nanofed_tpu_torch.communication.codec import (
        decode_delta_q8,
        decode_delta_topk8,
        encode_delta_q8,
        encode_delta_topk8,
        encode_params,
    )
    from nanofed_tpu_torch.core.device import device_record, resolve_device
    from nanofed_tpu_torch.core.types import ClientData
    from nanofed_tpu_torch.data import federate, load_digits_dataset, pack_eval
    from nanofed_tpu_torch.models import get_model
    from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
    from nanofed_tpu_torch.trainer.local import make_evaluator, make_local_fit
    from nanofed_tpu_torch.utils.trees import to_numpy_params

    dev = resolve_device(device)
    ops.reset_launch_counts()
    t0 = time.time()

    def fit_clients(fit, training, params, data, seed: int):
        """Every client of ``data`` trained from ``params``: its own permutations and
        keys from ``seed``; returns each client's delta as host float32 arrays."""
        k, n = data.y.shape
        gen = torch.Generator(device=dev).manual_seed(seed)
        perms = draw_permutations(gen, k, training.local_epochs, n)
        trained = fit(params, data, perms, client_keys(seed, k, dev)).params
        return [{name: (trained[name][i] - params[name]).float().cpu().numpy()
                 for name in params} for i in range(k)], trained

    # --- Payload sizes on the flagship CNN with a real one-client trained delta ---
    model = get_model("mnist_cnn")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (1, 256, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (1, 256))
    data = ClientData(x=x, y=y, mask=np.ones((1, 256), np.float32)).to(dev)
    training = TrainingConfig(batch_size=64, local_epochs=2, learning_rate=0.1)
    (delta,), trained = fit_clients(make_local_fit(model, training), training, params,
                                    data, 1)
    result_params = {name: leaf[0] for name, leaf in trained.items()}
    delta_t = {name: torch.from_numpy(a) for name, a in delta.items()}

    npz_full = len(encode_params(result_params))
    q8 = encode_delta_q8(delta_t, seed=0)
    topk8_bytes = {f"fraction={f}": len(encode_delta_topk8(delta_t, fraction=f, seed=0))
                   for f in (0.05, 0.01)}
    # The reference's own wire format for the same params: JSON float lists.
    json_bytes = len(json.dumps(_tolist(to_numpy_params(result_params))).encode())
    dq = decode_delta_q8(q8, like=delta_t)
    flat_err = np.concatenate([np.abs(dq[name].numpy() - delta[name]).ravel()
                               for name in delta])
    flat_mag = np.concatenate([np.abs(a).ravel() for a in delta.values()])
    n_params = int(sum(a.size for a in delta.values()))

    # --- The simulated aggregate effect of compressing every client's delta in a
    # small federation (the wire path's own parity is held by the network tests) ---
    train = load_digits_dataset("train")
    test = load_digits_dataset("test")
    small = get_model("digits_mlp", hidden=64)
    cd = federate(train, num_clients=8, scheme="dirichlet", batch_size=16, seed=0,
                  alpha=0.2)
    counts = cd.mask.sum(axis=1)
    w = counts / counts.sum()
    cd = cd.to(dev)
    evaluator = make_evaluator(small, batch_size=128)
    eval_data = pack_eval(test, batch_size=128).to(dev)
    s_training = TrainingConfig(batch_size=16, local_epochs=4, learning_rate=0.2)
    sfit = make_local_fit(small, s_training)

    def run_rounds(mode: str) -> float:
        """mode: 'dense' | 'q8' | 'topk8' (top 5% with per-client error feedback)."""
        gp = small.init(torch.Generator(device=dev).manual_seed(0))
        residuals: list[dict | None] = [None] * 8
        for r in range(rounds):
            deltas, _ = fit_clients(sfit, s_training, gp, cd, 1000 + r)
            agg = None
            for i, d in enumerate(deltas):
                like = {name: torch.from_numpy(a) for name, a in d.items()}
                if mode == "q8":
                    sent = decode_delta_q8(encode_delta_q8(like, seed=r * 8 + i), like=like)
                    d = {name: sent[name].numpy() for name in d}
                elif mode == "topk8":
                    if residuals[i] is not None:
                        d = {name: d[name] + residuals[i][name] for name in d}
                    like = {name: torch.from_numpy(a) for name, a in d.items()}
                    sent = decode_delta_topk8(
                        encode_delta_topk8(like, fraction=0.05, seed=r * 8 + i), like=like)
                    residuals[i] = {name: d[name] - sent[name].numpy() for name in d}
                    d = {name: sent[name].numpy().astype(np.float32) for name in d}
                contrib = {name: w[i] * a for name, a in d.items()}
                agg = contrib if agg is None else {n: agg[n] + contrib[n] for n in agg}
            gp = {name: gp[name] + torch.from_numpy(agg[name].astype(np.float32)).to(dev)
                  for name in gp}
        return float(evaluator(gp, eval_data)["accuracy"])

    acc_plain = run_rounds("dense")
    acc_q8 = run_rounds("q8")
    acc_topk8 = run_rounds("topk8")
    q8_bytes = len(q8)
    return {
        "artifact": f"wire_compression_{round_tag}",
        "benchmark": "q8-delta update compression (stochastic int8, QSGD-style) on the "
                     "flagship CNN's real trained round delta",
        "model": "mnist_cnn", "num_params": n_params,
        "payload_bytes": {
            "reference_json_float_lists": json_bytes,
            "npz_full_params": npz_full,
            "q8_delta": q8_bytes,
            "topk8_delta": topk8_bytes,
        },
        "compression_vs_npz": round(npz_full / q8_bytes, 2),
        "compression_vs_reference_json": round(json_bytes / q8_bytes, 2),
        "topk8_compression_vs_npz": {k: round(npz_full / v, 1)
                                     for k, v in topk8_bytes.items()},
        "reconstruction": {
            "max_abs_error": float(flat_err.max()),
            "mean_abs_error": float(flat_err.mean()),
            "mean_abs_delta": float(flat_mag.mean()),
            "relative_mean_error": float(flat_err.mean() / max(flat_mag.mean(), 1e-12)),
        },
        "accuracy_parity_federation": {
            "config": f"digits_mlp(64), 8 clients Dirichlet(0.2), 4 local epochs, lr 0.2, "
                      f"{rounds} rounds, every client delta compressed each round "
                      "(topk8: fraction=0.05 with per-client error feedback)",
            "final_accuracy_uncompressed": round(acc_plain, 4),
            "final_accuracy_q8": round(acc_q8, 4),
            "final_accuracy_topk8_ef": round(acc_topk8, 4),
            "accuracy_delta_q8": round(acc_q8 - acc_plain, 4),
            "accuracy_delta_topk8": round(acc_topk8 - acc_plain, 4),
        },
        "platform": dev.type,
        "elapsed_s": round(time.time() - t0, 1),
        "device": device_record(dev),
    }


def _tolist(tree):
    """Nested params as JSON-ready nested lists."""
    if isinstance(tree, dict):
        return {k: _tolist(v) for k, v in tree.items()}
    return tree.tolist()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--round-tag", default="torch")
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    args = ap.parse_args()
    artifact = measure_wire_compression(args.round_tag, device=args.device)
    out = REPO / "runs" / f"{artifact['artifact']}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(artifact, indent=2))
    print(json.dumps(artifact, indent=2))
    print(f"\nartifact written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
