#!/usr/bin/env python
"""End-to-end SECURE federated learning over real HTTP on the PyTorch port.

The counterpart of ``run_secure.py`` beside it, on ``nanofed_tpu_torch``: the same
honest Bonawitz protocol over localhost aiohttp, the server seeing only uniformly
masked uint32 vectors and the cohort's weighted mean:

    1. every client enrolls its X25519 public key + sample count  (POST /secagg/register)
    2. clients fetch the roster: canonical order, all public keys,
       server-computed NORMALIZED FedAvg weights                  (GET /secagg/roster)
    3. each round: fetch global model -> local SGD -> pre-scale by
       weight -> quantize + pairwise-mask -> submit               (POST /update, masked)
    4. the coordinator modular-sums the cohort (masks cancel exactly in uint32),
       dequantizes, and that IS the new global model

On the card the clients train there and mask on the ``cuda`` backend (kernels B5 and
B7) and the server unmasks with B6; with ``--device cpu`` every party uses the
``host`` backend.  At the end the script prints how far the last round's secure
aggregate lies from the plain weighted FedAvg of what the clients submitted.

Run:  python examples/secure_federation/run_secure_torch.py [--port 18765] [--rounds 3]
      [--device cpu]

With ``--dropout-tolerant`` the double-masking variant (Bonawitz §4) runs instead;
pass ``--drop-client 2 --drop-round 1`` to watch client_2 vanish from round 1 on while
the rounds keep completing as the weighted FedAvg of the survivors.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

import torch

from nanofed_tpu_torch.communication import (
    HTTPClient,
    HTTPServer,
    NetworkCoordinator,
    NetworkRoundConfig,
)
from nanofed_tpu_torch.core import resolve_device
from nanofed_tpu_torch.core.exceptions import NanoFedError
from nanofed_tpu_torch.data import federate, load_digits_dataset
from nanofed_tpu_torch.models import get_model
from nanofed_tpu_torch.security.secure_agg import (
    ClientKeyPair,
    SecureAggregationConfig,
    build_unmask_reveals,
    make_dropout_shares,
    mask_update,
    open_share_inbox,
)
from nanofed_tpu_torch.trainer import TrainingConfig, client_keys, draw_permutations
from nanofed_tpu_torch.trainer.local import make_local_fit
from nanofed_tpu_torch.utils.trees import ravel


async def run_client(client_id: str, url: str, local_fit, data, cfg, template, device,
                     submitted: dict, drop_at_round: int | None = None):
    """One secure federated client: enroll once, then train, mask and submit every
    round.  ``submitted[round][client_id]`` records its FedAvg weight and the params
    it masked, for the FedAvg check at the end.

    In dropout-tolerant mode the client also deposits sealed Shamir shares at each
    round's start and answers the server's unmask requests as a survivor;
    ``drop_at_round`` simulates a crash: the client vanishes from that round on.
    """
    backend = "cuda" if device.type == "cuda" else "host"
    # Deterministic per-client seed (Python's str hash is salted per process).
    client_seed = int.from_bytes(hashlib.sha256(client_id.encode()).digest()[:4], "little")
    identity = ClientKeyPair.generate()
    num_samples = float(data.mask.sum())
    async with HTTPClient(url, client_id, timeout_s=60) as client:
        if not await client.register_secagg(identity.public_bytes(), num_samples,
                                            backend=backend):
            raise RuntimeError(f"{client_id}: enrollment refused")
        roster = await client.fetch_secagg_roster(timeout_s=60)
        print(f"  {client_id}: enrolled; weight={roster.weights[client_id]:.3f}")
        while True:
            try:
                params, rnd, active = await client.fetch_global_model(like=template)
            except NanoFedError:  # round 0 is published concurrently with start-up
                await asyncio.sleep(0.05)
                continue
            if not active:
                return
            mask_index, mask_keypair = roster.index_of(client_id), identity
            ordered_pks, self_seed, held = roster.ordered_keys(), None, None
            if cfg.dropout_tolerant:
                # Per-round secrets: a fresh ephemeral mask key and self seed,
                # Shamir-shared across this round's active cohort.
                participants, round_threshold = await client.fetch_secagg_round_info()
                if client_id not in participants:
                    print(f"  {client_id}: evicted from cohort; stopping")
                    return
                mask_keypair = ClientKeyPair.generate()
                context = f"{client.secagg_session}:{rnd}"
                self_seed, sealed = make_dropout_shares(
                    identity, mask_keypair, participants,
                    {c: roster.public_keys[c] for c in participants},
                    round_threshold or cfg.threshold, my_id=client_id, context=context,
                )
                if not await client.deposit_secagg_shares(
                        rnd, mask_keypair.public_bytes(), sealed,
                        self_seed_commitment=hashlib.sha256(self_seed).digest()):
                    raise RuntimeError(f"{client_id}: shares refused in round {rnd}")
                epks, inbox = await client.fetch_secagg_inbox(rnd, timeout_s=60)
                held = open_share_inbox(identity, client_id, roster.public_keys, inbox,
                                        epks, context)
                mask_index = participants.index(client_id)
                ordered_pks = [epks[c] for c in participants]
            if drop_at_round is not None and rnd >= drop_at_round:
                # After the share barrier: its pairwise masks are in survivors' vectors.
                print(f"  {client_id}: dropping out at round {rnd}")
                return
            local = local_fit({k: v.to(device) for k, v in params.items()}, data,
                              client_seed + rnd)
            submitted.setdefault(rnd, {})[client_id] = (roster.weights[client_id], local)
            masked = mask_update(local, mask_index, mask_keypair, ordered_pks, rnd, cfg,
                                 weight=roster.weights[client_id], backend=backend,
                                 self_seed=self_seed, device=device)
            if not await client.submit_masked_update(masked, {"num_samples": num_samples}):
                raise RuntimeError(f"{client_id}: update refused in round {rnd}")
            answered_unmask = False
            status = await client.check_server_status()
            while status["training_active"] and status["round"] == rnd:
                if cfg.dropout_tolerant and not answered_unmask:
                    request = await client.poll_unmask_request()
                    if (request is not None and request["round"] == rnd
                            and client_id in request["survivors"]):
                        reveals = build_unmask_reveals(request, client_id, held)
                        answered_unmask = await client.submit_unmask_reveals(rnd, reveals)
                await asyncio.sleep(0.05)
                status = await client.check_server_status()
            if not status["training_active"]:
                return


async def main(port: int, rounds: int, num_clients: int,
               dropout_tolerant: bool = False, drop_client: int | None = None,
               drop_round: int | None = None, round_timeout_s: float = 120.0,
               device: str | None = None) -> dict:
    """Run the federation; return its round history, the held-out accuracy and the
    last round's ``max|aggregate - FedAvg|``."""
    dev = resolve_device(device)
    model = get_model("digits_mlp", hidden=64)
    train = load_digits_dataset("train")
    client_data = federate(train, num_clients=num_clients, scheme="iid",
                           batch_size=16, seed=0)
    training = TrainingConfig(batch_size=16, local_epochs=2, learning_rate=0.5)
    fit = make_local_fit(model, training)

    def local_fit(params, data, seed: int):
        """One client's local SGD: its own permutations and dropout keys from ``seed``."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        perms = draw_permutations(gen, 1, training.local_epochs, data.y.shape[1])
        result = fit(params, data, perms, client_keys(seed, 1, dev))
        return {k: v[0] for k, v in result.params.items()}

    init = model.init(torch.Generator(device=dev).manual_seed(0))
    # min_clients is the PRIVACY FLOOR, the smallest cohort a client will mask into; in
    # tolerant mode the demo accepts one eviction's worth of shrinkage.  threshold
    # must exceed n/2 and still be reachable after one eviction.
    cfg = SecureAggregationConfig(
        min_clients=max(2, num_clients - 1) if dropout_tolerant else num_clients,
        dropout_tolerant=dropout_tolerant,
        threshold=num_clients // 2 + 1,
    )
    submitted: dict = {}
    server = HTTPServer(port=port)
    await server.start()
    try:
        coordinator = NetworkCoordinator(
            server, init,
            NetworkRoundConfig(num_rounds=rounds, min_clients=num_clients,
                               min_completion_rate=0.5 if dropout_tolerant else 1.0,
                               round_timeout_s=round_timeout_s),
            secure=cfg, device=dev,
        )
        clients = [
            run_client(f"client_{i}", f"http://127.0.0.1:{port}", local_fit,
                       client_data.select(slice(i, i + 1)).to(dev), cfg, init, dev,
                       submitted, drop_at_round=(drop_round if i == drop_client else None))
            for i in range(num_clients)
        ]
        await asyncio.gather(coordinator.run(), *clients)
        print("\nround history:")
        for h in coordinator.history:
            print(f"  {h}")
        # The last round's aggregate is the final model: against the plain weighted
        # FedAvg of the params its clients masked.
        entries = submitted[max(submitted)].values()
        mass = sum(w for w, _ in entries)
        fedavg = sum(w * ravel(p).double().cpu() for w, p in entries) / mass
        gap = float((ravel(coordinator.params).double().cpu() - fedavg).abs().max())
        print(f"\nlast round, {len(entries)} clients: max|aggregate - FedAvg| = {gap:.3e}")
        # Held-out sanity: the securely aggregated global model actually learned.
        test = load_digits_dataset("test")
        with torch.no_grad():
            logits = model.apply({k: v.to(dev) for k, v in coordinator.params.items()},
                                 torch.as_tensor(test.x, device=dev))
        acc = float((logits.argmax(-1).cpu() == torch.as_tensor(test.y)).float().mean())
        print(f"held-out accuracy of the securely-aggregated model: {acc:.4f}")
        return {"history": coordinator.history, "accuracy": acc, "fedavg_gap": gap}
    finally:
        await server.stop()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=18765)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--dropout-tolerant", action="store_true",
                    help="double-masking SecAgg: rounds survive client dropouts")
    ap.add_argument("--drop-client", type=int, default=None,
                    help="index of a client that crashes mid-run (needs "
                         "--dropout-tolerant to keep the rounds completing)")
    ap.add_argument("--drop-round", type=int, default=1,
                    help="round from which --drop-client vanishes")
    ap.add_argument("--round-timeout", type=float, default=120.0)
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    args = ap.parse_args()
    asyncio.run(main(args.port, args.rounds, args.clients,
                     dropout_tolerant=args.dropout_tolerant,
                     drop_client=args.drop_client, drop_round=args.drop_round,
                     round_timeout_s=args.round_timeout, device=args.device))
