"""The JAX package's half of ``scripts/fedprox_seed_spread.py``: the ``noniid_fedprox``
arms of ``scripts/record_evidence.py`` (its ``run_fedprox`` builds each run this way)
over seeds 0-9 on an 8-device virtual CPU mesh (the reference's ``--platform cpu``),
summarised as the port's script summarises its own.  Not a test module; run it from the
repo root:

    python tests/fedprox_seed_spread_jax.py [--seeds 0-9]

Writes ``runs/noniid_fedprox_seeds_jax_cpu.json``.
"""

import argparse
import importlib.util
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _spread_script():
    path = REPO / "scripts" / "fedprox_seed_spread.py"
    spec = importlib.util.spec_from_file_location("fedprox_seed_spread", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_run(regime: dict):
    """``run(mu, seed, base_dir)``: one run's per-round held-out accuracies on the JAX
    package."""
    from nanofed_tpu.utils.platform import force_cpu_mesh

    force_cpu_mesh(8)
    from nanofed_tpu.data import federate, load_digits_dataset, pack_eval
    from nanofed_tpu.models import get_model
    from nanofed_tpu.orchestration import Coordinator, CoordinatorConfig
    from nanofed_tpu.trainer import TrainingConfig

    train, test = load_digits_dataset("train"), load_digits_dataset("test")
    model = get_model("digits_mlp", hidden=96)

    def run(mu: float, seed: int, base_dir: Path) -> list[float]:
        cd = federate(train, num_clients=regime["clients"], scheme="dirichlet",
                      batch_size=regime["batch_size"], seed=seed, alpha=regime["alpha"])
        coord = Coordinator(
            model=model, train_data=cd,
            config=CoordinatorConfig(num_rounds=regime["rounds"], seed=seed,
                                     participation_rate=regime["participation"],
                                     base_dir=base_dir, eval_every=1, save_metrics=False),
            training=TrainingConfig(batch_size=regime["batch_size"],
                                    local_epochs=regime["local_epochs"],
                                    learning_rate=regime["learning_rate"], prox_mu=mu),
            eval_data=pack_eval(test, batch_size=128),
        )
        return [float(m.eval_metrics["accuracy"]) for m in coord.start_training()
                if m.eval_metrics.get("accuracy") is not None]

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", default="0-9")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spread = _spread_script()
    record = spread.summarise("jax", "cpu", spread.parse_seeds(args.seeds),
                              jax_run(spread.REGIME))
    spread.write(record, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
