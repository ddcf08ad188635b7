"""Federated training CLI of the port — a thin layer over
``repro_torch.api.build``, with the JAX package's flags plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --preset llm-100m --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.train --preset llm-tiny --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --config examples/configs/sync_baseline.toml --set wire.codec=int8_affine

Every invocation resolves an :class:`~repro_torch.api.spec.ExperimentSpec`
first (``--config`` file < flag aliases < ``--set``), so ``build(spec)``
stays the one engine construction site. It runs on ``cuda`` unless
``--device cpu`` is given. ``--engine async|hier`` and ``--sim-profile``
run the system simulator (:mod:`repro_torch.fed.sim`)::

    PYTHONPATH=src python -m repro_torch.launch.train --preset llm-tiny --smoke \
        --device cpu --engine async --sim-profile straggler:0.25,10 --async-buffer 2
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.api.tasks import PRESETS

#: flag → the dotted spec field it writes
FLAG_TO_FIELD = {
    "smoke": "model.smoke",
    "kernels": "model.kernels",
    "method": "fed.method",
    "correction": "fed.correction",
    "clients": "fed.clients",
    "local_steps": "fed.local_steps",
    "lr": "fed.lr",
    "tau": "fed.tau",
    "weighted": "fed.weighted",
    "wire_codec": "wire.codec",
    "edge_wire_codec": "wire.edge_codec",
    "engine": "engine.kind",
    "async_buffer": "engine.buffer_size",
    "staleness_power": "engine.staleness_power",
    "edges": "engine.edges",
    "edge_rounds": "engine.edge_rounds",
    "sim_profile": "sim.profile",
    "rounds": "rounds",
    "batch": "data.batch",
    "seq": "data.seq",
    "seed": "seed",
    "checkpoint_dir": "checkpoint.dir",
    "checkpoint_every": "checkpoint.every",
    "log_every": "log_every",
    "telemetry": "telemetry.enabled",
    "telemetry_dir": "telemetry.dir",
    "telemetry_sinks": "telemetry.sinks",
}

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        argument_default=argparse.SUPPRESS,  # only provided flags override
    )
    ap.add_argument("--config", type=str, default=None,
                    help="ExperimentSpec file (.toml or .json) to start from")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="SECTION.KEY=VALUE",
                    help="dotted spec override, e.g. --set wire.codec=int8_affine "
                    "(applied after the flags)")
    ap.add_argument("--arch", type=str,
                    help="architecture registry id (implies --preset none)")
    ap.add_argument("--preset", type=str, choices=sorted(PRESETS) + ["none"],
                    help="named LM preset (default llm-tiny)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--method", type=str,
                    choices=["fedlrt", "fedavg", "fedlin", "fedlrt_naive"])
    ap.add_argument("--correction", type=str, choices=["none", "simplified", "full"])
    ap.add_argument("--clients", type=int)
    ap.add_argument("--participation", type=str,
                    help="per-round cohort policy: full | uniform:K | round_robin:K | dropout:P")
    ap.add_argument("--weighted", action="store_true",
                    help="aggregate with client weights ∝ |X_c| (paper §2 extension)")
    ap.add_argument("--kernels", choices=["auto", "off"],
                    help="low-rank kernel dispatch: auto = the Hopper kernels on "
                    "CUDA tensors (their plain versions on CPU tensors), off = "
                    "the plain PyTorch chain")
    ap.add_argument("--wire-codec", type=str,
                    help="wire codec: identity | downcast[:dtype] | int8_affine | topk_rank")
    ap.add_argument("--engine", choices=["sync", "async", "hier"],
                    help="aggregation engine: sync (one barrier per round), async "
                    "(FedBuff-style buffered, --async-buffer arrivals per aggregate), hier "
                    "(two-tier edge→cloud; --edges/--edge-rounds)")
    ap.add_argument("--sim-profile", type=str,
                    help="client system-profile fleet for virtual-clock pricing: uniform | "
                    "straggler[:FRAC[,SLOWDOWN]] | lognormal[:SIGMA] (optionally prefixed "
                    "dropout:P,). Implied 'uniform' for the async/hier engines; omit "
                    "entirely for the plain sync engine")
    ap.add_argument("--async-buffer", type=int,
                    help="async engine: aggregate every K arrivals (default: #clients)")
    ap.add_argument("--staleness-power", type=float,
                    help="async engine: staleness discount (1+s)^-p on stale updates")
    ap.add_argument("--edges", type=int, help="hier engine: number of edge servers")
    ap.add_argument("--edge-rounds", type=int,
                    help="hier engine: local rounds per cloud round")
    ap.add_argument("--edge-wire-codec", type=str,
                    help="hier engine: codec for the edge→cloud hop (default: --wire-codec)")
    ap.add_argument("--rounds", type=int)
    ap.add_argument("--local-steps", type=int)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--lr", type=float)
    ap.add_argument("--tau", type=float)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--log-every", type=int)
    ap.add_argument("--checkpoint-dir", type=str,
                    help="write round_*.npz checkpoints here")
    ap.add_argument("--checkpoint-every", type=int,
                    help="checkpoint cadence in rounds (with --checkpoint-dir)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--telemetry", action="store_true",
                    help="structured telemetry: round spans, metric streams, JSONL "
                    "event log + Perfetto trace (repro_torch.telemetry; on ≡ off "
                    "bit for bit)")
    ap.add_argument("--telemetry-dir", type=str,
                    help="output directory of the jsonl / perfetto sinks "
                    "(events.jsonl, trace.json)")
    ap.add_argument("--telemetry-sinks", type=str,
                    help="comma list over console,memory,jsonl,perfetto (default console)")
    return ap


def spec_from_argv(argv=None):
    """Resolve CLI arguments into a validated ExperimentSpec.

    Precedence: ``--config`` file < flag aliases < ``--set``."""
    from repro_torch.api.serialization import parse_override, set_dotted
    from repro_torch.api.spec import ExperimentSpec, ParticipationSpec, load_spec

    ap = _parser()
    args = vars(ap.parse_args(argv))
    args.pop("device")
    sets = args.pop("sets")
    config = args.pop("config")
    spec = load_spec(config) if config else ExperimentSpec()

    preset, arch = args.pop("preset", None), args.pop("arch", None)
    if preset is not None and preset != "none" and arch is not None:
        ap.error("--preset and --arch are mutually exclusive (pass --preset none to use --arch)")
    assignments = {}
    if arch is not None:
        assignments.update({"model.preset": None, "model.arch": arch})
    elif preset == "none":
        assignments["model.preset"] = None
    elif preset is not None:
        assignments.update({"model.preset": preset, "model.arch": None})
    if "participation" in args:
        p = ParticipationSpec.from_string(args.pop("participation"))
        for f in dataclasses.fields(p):
            assignments[f"participation.{f.name}"] = getattr(p, f.name)
    method = args.get("method")
    if method is not None and not method.startswith("fedlrt"):
        args.setdefault("correction", "none")
    assignments.update({FLAG_TO_FIELD[k]: v for k, v in args.items()})

    # one pass over the plain dict, one validation at the end
    data = spec.to_dict()
    for path, value in assignments.items():
        set_dotted(ExperimentSpec, data, path, value, parse_str=False)
    for item in sets:
        path, raw = parse_override(item)
        set_dotted(ExperimentSpec, data, path, raw, parse_str=True)
    return ExperimentSpec.from_dict(data)


def main(argv=None):
    from repro_torch.api import build

    args = _parser().parse_args(argv)
    spec = spec_from_argv(argv)
    exp = build(spec, device=args.device)
    print(f"{exp.task.description} clients={spec.fed.clients} device={exp.engine.device} "
          f"[spec {spec.spec_hash()}]")
    hist = exp.run()
    mean_cohort = np.mean([r.cohort_size for r in hist]) if hist else 0.0
    if hist:
        eng = exp.engine
        # on the scenario, not on t_virtual's truthiness: a zero clock
        # reading still prints the engine's timing
        timing = (
            f"; virtual time {hist[-1].t_virtual:.1f}s [{spec.engine.kind}]"
            if exp.is_simulated else ""
        )
        analytic = (
            f" vs {eng.comm_total_bytes_analytic()/1e6:.1f} MB analytic"
            if hasattr(eng, "comm_total_bytes_analytic") else ""
        )
        print(
            f"done: loss {hist[0].loss_before:.4f} → {hist[-1].loss_before:.4f}; "
            f"total comm {eng.comm_total_bytes()/1e6:.1f} MB measured [{spec.wire.codec}]"
            f"{analytic} (mean cohort {mean_cohort:.1f}/{spec.fed.clients}){timing}"
        )
    return hist


if __name__ == "__main__":
    main()
