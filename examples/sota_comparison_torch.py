"""FedLEO against the SOTA baselines (paper Table II) on one
constellation, on the PyTorch port.

The twin of ``examples/sota_comparison.py``, written against
``repro_torch`` alone.  It runs on the card unless ``--device`` names
another device.

  PYTHONPATH=src python examples/sota_comparison_torch.py [--fast] [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

from repro_torch.core import FedLEO, FederatedTask, SimConfig, TrainHyperparams
from repro_torch.core.baselines import ALL_BASELINES
from repro_torch.data import make_classification_dataset, partition_noniid_by_orbit
from repro_torch.models.cnn import apply_cnn, init_cnn
from repro_torch.optim import get_optimizer


def make_task(fast, device):
    train = make_classification_dataset("mnist-like",
                                        num_samples=800 if fast else 1600,
                                        seed=0)
    test = make_classification_dataset("mnist-like", num_samples=400,
                                       seed=99)
    clients = partition_noniid_by_orbit(train, 5, 8)
    hp = TrainHyperparams(local_epochs=100, learning_rate=0.05,
                          batch_size=16)
    return FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=(8, 16),
                                   hidden=32),
        apply_fn=apply_cnn, clients=clients, test_set=test,
        optimizer=get_optimizer("sgd", 0.05), hp=hp,
        sim_epochs=4 if fast else 8,
        payload_bits_override=int(4e6 * 32),
        device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which raises without a card)")
    args = ap.parse_args(argv)
    sim = SimConfig(horizon_hours=72.0)
    sync_rounds = 2 if args.fast else 4
    async_rounds = 10 if args.fast else 30

    results = {}
    print(f"{'method':16s} {'accuracy':>9s} {'sim hours':>10s} rounds")
    res = FedLEO(make_task(args.fast, args.device), sim).run(max_rounds=sync_rounds)
    results["FedLEO"] = res
    print(f"{'FedLEO':16s} {res.final_accuracy:9.4f} "
          f"{res.final_time_hours:10.2f} {len(res.history):6d}")

    for name in ("FedAvg", "FedISL-ideal", "FedHAP", "FedAsync",
                 "AsyncFLEO"):
        cls = ALL_BASELINES[name]
        n = async_rounds if name in ("FedAsync", "AsyncFLEO") else sync_rounds
        res = cls(make_task(args.fast, args.device), sim).run(max_rounds=n)
        results[name] = res
        print(f"{name:16s} {res.final_accuracy:9.4f} "
              f"{res.final_time_hours:10.2f} {len(res.history):6d}")
    return results


if __name__ == "__main__":
    main()
