"""Federated training CLI of the port — a thin layer over
``repro_torch.api.build``, with the JAX package's flags plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --preset llm-100m --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.train --preset llm-tiny --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --config examples/configs/sync_baseline.toml --set wire.codec=int8_affine

Every invocation resolves an :class:`~repro_torch.api.spec.ExperimentSpec`
first (``--config`` file < flag aliases < ``--set``), so ``build(spec)``
stays the one engine construction site. It runs on ``cuda`` unless
``--device cpu`` is given. The flags of parts not ported yet (the async /
hier engines and the system simulator, the edge wire codec) are accepted by
the parser and raise, naming ROADMAP.md.
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

#: flags of the JAX package's CLI whose parts the port lacks
NOT_PORTED = {
    "edge_wire_codec": "the hier engine's edge wire (--edge-wire-codec)",
    "engine": "engines other than sync (--engine)",
    "sim_profile": "the system simulator (--sim-profile)",
    "async_buffer": "the async engine (--async-buffer)",
    "staleness_power": "the async engine (--staleness-power)",
    "edges": "the hier engine (--edges)",
    "edge_rounds": "the hier engine (--edge-rounds)",
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
    for flag in ("--edge-wire-codec", "--engine", "--sim-profile", "--async-buffer",
                 "--staleness-power", "--edges", "--edge-rounds"):
        ap.add_argument(flag, type=str, help="not ported yet (ROADMAP.md)")
    return ap


def spec_from_argv(argv=None):
    """Resolve CLI arguments into a validated ExperimentSpec.

    Precedence: ``--config`` file < flag aliases < ``--set``."""
    from repro_torch.api.serialization import parse_override, set_dotted
    from repro_torch.api.spec import ExperimentSpec, ParticipationSpec, load_spec

    ap = _parser()
    args = vars(ap.parse_args(argv))
    args.pop("device")
    for name in sorted(set(args) & set(NOT_PORTED)):
        raise NotImplementedError(
            f"{NOT_PORTED[name]} is not ported to PyTorch yet; see ROADMAP.md"
        )
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
        print(
            f"done: loss {hist[0].loss_before:.4f} → {hist[-1].loss_before:.4f}; "
            f"total comm {eng.comm_total_bytes()/1e6:.1f} MB measured [{spec.wire.codec}] "
            f"vs {eng.comm_total_bytes_analytic()/1e6:.1f} MB analytic "
            f"(mean cohort {mean_cohort:.1f}/{spec.fed.clients})"
        )
    return hist


if __name__ == "__main__":
    main()
