"""CV proxy of the paper's Fig. 5 on the PyTorch/CUDA port: variance
correction vs client count.

The twin of ``examples/federated_vision.py``, with the same flags plus
``--device`` (the card unless given ``--device cpu``). Its factorized
hidden layer runs through ``lr_matmul``: with ``--kernels auto`` (the
default here) on the ``xus`` / ``avt`` / ``atb`` kernels on the card and
their plain versions on CPU tensors.

Trains a 2-layer MLP head (its hidden layer FeDLRT-factorized — the exact
setting of the paper's ResNet18/CIFAR10 experiment, which applies FeDLRT
to the fully connected head) on a synthetic classification task with a
planted low-rank decision map, split non-iid (Dirichlet α=0.3) across
clients.  Compares FeDLRT {none, simplified} against FedAvg/FedLin for
growing client counts with s* = 240/C local steps, like the paper.

The whole scenario is one declarative
:class:`repro_torch.api.ExperimentSpec`;
the method × client-count sweep is ``dataclasses.replace`` on a base
spec, and every engine is constructed through
:func:`repro_torch.api.build` —
so per-round participation, wire compression and the simulation engines
are each one spec field away:

Run:  PYTHONPATH=src python examples/torch_federated_vision.py [--clients 2 4 8]
      PYTHONPATH=src python examples/torch_federated_vision.py \
          --clients 8 --participation uniform:4
      PYTHONPATH=src python examples/torch_federated_vision.py \
          --clients 4 --wire-codec int8_affine
      PYTHONPATH=src python examples/torch_federated_vision.py \
          --clients 8 --engine async --sim-profile straggler:0.25,10
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.api import (
    DataSpec,
    EngineSpec,
    ExperimentSpec,
    FedSpec,
    ModelSpec,
    ParticipationSpec,
    SimSpec,
    WireSpec,
    build,
)

#: the four method columns of the fig-5 table → (round method, correction)
METHODS = {
    "fedavg": ("fedavg", "none"),
    "fedlin": ("fedlin", "none"),
    "fedlrt:none": ("fedlrt", "none"),
    "fedlrt:simplified": ("fedlrt", "simplified"),
}


def base_spec(args) -> ExperimentSpec:
    # the base spec carries the *largest* population of the sweep; run()
    # re-caps per C, so e.g. `--clients 2 4 8 --participation uniform:6`
    # validates here and caps to min(6, C) for the smaller columns
    C_max = max(args.clients)
    participation = ParticipationSpec.from_string(args.participation)
    if participation.cohort_size is not None:
        participation = dataclasses.replace(
            participation,
            cohort_size=min(participation.cohort_size, C_max),
        )
    return ExperimentSpec(
        name="federated-vision",
        rounds=args.rounds,
        log_every=0,
        model=ModelSpec(
            kind="mlp", dim=64, classes=10, hidden=256, r_max=24,
            kernels=args.kernels,
        ),
        data=DataSpec(
            kind="classification", batch=64, num_points=12_288, noise=0.3,
            planted_rank=6, partition="dirichlet:0.3", holdout=2048,
        ),
        fed=FedSpec(
            method="fedlrt", correction="simplified", clients=C_max,
            local_steps=0,  # 0 → the paper's s* = 240/C scaling
            lr=5e-2, tau=0.03, eval_after=False, weighted=args.weighted,
        ),
        participation=participation,
        engine=EngineSpec(kind=args.engine),
        wire=WireSpec(codec=args.wire_codec),
        sim=SimSpec(profile=args.sim_profile),
    )


def run(spec: ExperimentSpec, method: str, C: int, device: str = "cuda"):
    kind, correction = METHODS[method]
    part = spec.participation
    if part.cohort_size is not None and part.cohort_size > C:
        # sweeping C below the requested cohort: cap at the population (the
        # legacy min(k, C) behaviour; the spec itself rejects k > C)
        part = dataclasses.replace(part, cohort_size=C)
    spec = spec.replace(
        fed=dataclasses.replace(
            spec.fed, method=kind, correction=correction, clients=C
        ),
        participation=part,
    )
    exp = build(spec, device=device)
    hist = exp.run()
    acc = exp.evaluate()
    lowrank = kind.startswith("fedlrt")
    rank = int(exp.params["w1"].rank) if lowrank else "-"
    mean_cohort = float(np.mean([r.cohort_size for r in hist]))
    return acc, exp.comm_total_bytes(), rank, mean_cohort, hist[-1].t_virtual


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument(
        "--participation", type=str, default="full",
        help="full | uniform:K | round_robin:K | dropout:P",
    )
    ap.add_argument("--weighted", action="store_true",
                    help="client weights ∝ |X_c| in every aggregation")
    ap.add_argument("--kernels", default="auto",
                    choices=["auto", "off"],
                    help="low-rank kernel dispatch for the factorized layer "
                    "(auto = the Hopper kernels on the card, their plain "
                    "versions on the CPU; off = the plain chain)")
    ap.add_argument("--wire-codec", default="identity",
                    help="on-the-wire payload codec: identity | "
                    "downcast[:dtype] | int8_affine | topk_rank; the comm "
                    "column reports bytes *measured* through it")
    ap.add_argument("--engine", default="sync",
                    choices=["sync", "async", "hier"],
                    help="aggregation engine (repro.fed.sim): async = "
                    "FedBuff-style buffered, hier = two-tier edge→cloud")
    ap.add_argument("--sim-profile", type=str, default=None,
                    help="fleet spec for virtual-clock pricing: uniform | "
                    "straggler[:FRAC[,SLOWDOWN]] | lognormal[:SIGMA]")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    base = base_spec(args)
    print(
        f"participation={args.participation} wire_codec={args.wire_codec} "
        f"engine={args.engine}"
        + (f" sim_profile={args.sim_profile}" if args.sim_profile else "")
    )
    print(f"{'method':>18} | " + " | ".join(f"C={c}" for c in args.clients))
    table = {}
    for method in METHODS:
        cells = []
        for C in args.clients:
            acc, comm, rank, mean_cohort, t_virtual = run(base, method, C, args.device)
            cells.append(
                f"acc={acc:.3f} comm={comm/1e6:5.1f}MB "
                f"rank={rank} cohort={mean_cohort:.1f}"
                + (f" t={t_virtual:.1f}s" if t_virtual else "")
            )
        print(f"{method:>18} | " + " | ".join(cells))
        table[method] = cells
    return table


if __name__ == "__main__":
    main()
