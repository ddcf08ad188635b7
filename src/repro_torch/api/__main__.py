"""CLI for spec files:  python -m repro_torch.api {validate,describe,run,serve} ...

The JAX package's ``python -m repro.api`` on the port, plus ``--device``
(``cuda`` by default, which raises without a card; ``cpu`` when asked).
``validate`` parses and validates spec files and prints their content
hashes (equal to the JAX package's); ``describe`` renders a built
experiment without running it; ``run`` builds and trains, with dotted
``--set section.key=value`` overrides; ``serve`` stands up the spec's
``[serve]`` section over seeded synthetic prompts and prints throughput and
latency.

    PYTHONPATH=src python -m repro_torch.api run examples/configs/sync_baseline.toml \\
        --set model.preset=llm-100m --set wire.codec=int8_affine --rounds 2
"""
import argparse
import sys

from repro_torch.api.spec import load_spec


def _load(path, overrides):
    spec = load_spec(path)
    if overrides:
        spec = spec.with_overrides(overrides)
    return spec


def _add_spec_args(p):
    p.add_argument("path")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="SECTION.KEY=VALUE")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_val = sub.add_parser("validate", help="parse + validate spec files")
    p_val.add_argument("paths", nargs="+")

    _add_spec_args(sub.add_parser("describe", help="build a spec and describe it"))

    p_run = sub.add_parser("run", help="build a spec and train it")
    _add_spec_args(p_run)
    p_run.add_argument("--rounds", type=int, default=None, help="override spec.rounds")
    p_run.add_argument("--log-every", type=int, default=None, help="override spec.log_every")

    p_srv = sub.add_parser("serve", help="build a spec's serving stack and drive "
                           "synthetic requests through it")
    _add_spec_args(p_srv)
    p_srv.add_argument("--requests", type=int, default=8, help="number of synthetic prompts")
    args = ap.parse_args(argv)

    if args.cmd == "validate":
        ok = True
        for path in args.paths:
            try:
                spec = load_spec(path)
            except (ValueError, OSError) as e:
                print(f"{path}: INVALID — {e}")
                ok = False
            else:
                print(f"{path}: ok [spec {spec.spec_hash()}]")
        return 0 if ok else 1

    spec = _load(args.path, args.sets)
    if args.cmd == "serve":
        from repro_torch.launch.serve import run_session

        return run_session(spec, num_requests=args.requests, device=args.device)

    from repro_torch.api.experiment import build

    exp = build(spec, device=args.device)
    print(exp.describe())
    if args.cmd == "describe":
        return 0
    hist = exp.run(rounds=args.rounds, log_every=args.log_every)
    if not hist:
        print("done: no rounds run")
        return 0
    timing = (
        f"; virtual time {hist[-1].t_virtual:.1f}s [{spec.engine.kind}]"
        if exp.is_simulated
        else ""
    )
    print(
        f"done: loss {hist[0].loss_before:.4f} → {hist[-1].loss_before:.4f}; "
        f"total comm {exp.comm_total_bytes()/1e6:.1f} MB measured [{spec.wire.codec}]"
        f"{timing}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
