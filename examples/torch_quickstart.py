"""Quickstart on the PyTorch/CUDA port: FeDLRT on the paper's homogeneous
least-squares test (§4.1).

The twin of ``examples/quickstart.py`` on :mod:`repro_torch`: a factorized
parameter, a loss, a FedConfig, and the round function, one layer below
the engine. FeDLRT identifies the planted rank (4) within a few
aggregation rounds, never underestimates it, and converges to the global
minimizer. It runs on the card unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

(For the engine-level drivers, with measured on-the-wire compression, see
``repro_torch.launch.train`` and ``examples/torch_federated_vision.py``.)
"""
import argparse

import torch

from repro_torch.api import resolve_device
from repro_torch.core import FedConfig, fedlrt_round, init_factor, materialize
from repro_torch.data import make_homogeneous_lsq


def loss_fn(f, batch):
    pred = torch.sum(((batch["px"] @ f.U) @ f.S) * (batch["py"] @ f.V), -1)
    return 0.5 * torch.mean((pred - batch["t"]) ** 2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    prob = make_homogeneous_lsq(n=20, rank=4, num_points=4000, num_clients=4)
    batches = {
        "px": torch.from_numpy(prob.px).to(dev),
        "py": torch.from_numpy(prob.py).to(dev),
        "t": torch.from_numpy(prob.target).to(dev),
    }
    W_star = torch.from_numpy(prob.W_star).to(dev)

    params = init_factor(
        torch.Generator(device=dev).manual_seed(0), 20, 20, r_max=10, init_rank=10,
        spectrum_scale=1.0,
    )
    # repro-lint: disable=RPL002 -- this example deliberately demos the
    # core API one layer below the engine (FedConfig + fedlrt_round);
    # the spec-API example is examples/torch_federated_vision.py
    cfg = FedConfig(
        num_clients=4, s_star=20, lr=0.1, correction="full", tau=0.1
    )

    print(f"target rank: {prob.rank_star}")
    for t in range(1, 101):
        params, metrics = fedlrt_round(loss_fn, params, batches, cfg)
        if t % 10 == 0 or t == 1:
            dist = float(torch.linalg.norm(materialize(params) - W_star))
            print(
                f"round {t:3d}  loss={float(metrics['loss_before']):.3e}  "
                f"rank={int(params.rank)}  ‖W−W*‖={dist:.3e}  "
                f"comm={float(metrics['comm_bytes_per_client'])/1e3:.1f} KB/client"
            )
    assert int(params.rank) == prob.rank_star
    return params


if __name__ == "__main__":
    main()
