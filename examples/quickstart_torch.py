"""Quickstart on the PyTorch port: FedLEO on a simulated 40-satellite
constellation.

The twin of ``examples/quickstart.py``, written against ``repro_torch``
alone: a Walker-delta constellation (5 orbits x 8 satellites, 1500 km,
80 deg), the Rolla MO ground station, non-IID MNIST-like data (2 orbits
hold 4 classes, 3 orbits the other 6), intra-plane model propagation and
sink-satellite scheduling; it prints the accuracy-vs-simulated-time trace
and each round's schedule decomposition.  It runs on the card unless
``--device`` names another device.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

from repro_torch.core import FedLEO, FederatedTask, SimConfig, TrainHyperparams
from repro_torch.data import make_classification_dataset, partition_noniid_by_orbit
from repro_torch.models.cnn import apply_cnn, init_cnn
from repro_torch.optim import get_optimizer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which raises without a card)")
    args = ap.parse_args(argv)

    # --- data: non-IID split across orbits (paper §V-A) ---------------------
    train = make_classification_dataset("mnist-like", num_samples=1600,
                                        seed=0)
    test = make_classification_dataset("mnist-like", num_samples=400,
                                       seed=99)
    clients = partition_noniid_by_orbit(train, num_planes=5,
                                        sats_per_plane=8)

    # --- the federated task (paper Table I hyperparameters) ------------------
    hp = TrainHyperparams(local_epochs=100, learning_rate=0.05,
                          batch_size=16)
    task = FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=(8, 16),
                                   hidden=32),
        apply_fn=apply_cnn,
        clients=clients,
        test_set=test,
        optimizer=get_optimizer("sgd", 0.05),
        hp=hp,
        sim_epochs=8,                      # executed epochs (clock uses 100)
        payload_bits_override=int(4e6 * 32),  # charge a 4M-param model
        device=args.device,
    )

    # --- run FedLEO ----------------------------------------------------------
    sim = SimConfig(horizon_hours=72.0)
    result = FedLEO(task, sim).run(max_rounds=4, verbose=True)

    print("\nschedule decomposition (round 1):")
    for p in result.history[0].events["planes"]:
        print(
            f"  plane {p['plane']}: source=slot{p['source_slot']} "
            f"sink=slot{p['sink_slot']} "
            f"models@sink={p['t_models_at_sink'] / 3600:.2f}h "
            f"wait={p['t_wait_sink'] / 3600:.2f}h "
            f"uploaded={p['t_upload_done'] / 3600:.2f}h"
        )
    print(f"\nfinal: accuracy={result.final_accuracy:.4f} "
          f"in {result.final_time_hours:.1f} simulated hours")
    return result


if __name__ == "__main__":
    main()
