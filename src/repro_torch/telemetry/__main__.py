"""Telemetry log tooling:  python -m repro_torch.telemetry {validate,export} ...

The JAX package's ``python -m repro.telemetry`` on the port's copies of the
schema and the exporter. ``validate`` checks JSONL event logs against the
schema (:mod:`repro_torch.telemetry.events`) and exits 1 if any is invalid;
``export`` renders a JSONL log as a Chrome/Perfetto ``trace_event`` JSON
file for https://ui.perfetto.dev.
"""
import argparse
import json
import sys

from repro_torch.telemetry.events import iter_jsonl, validate_jsonl
from repro_torch.telemetry.perfetto import events_to_trace


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_val = sub.add_parser("validate", help="schema-check JSONL event logs")
    p_val.add_argument("paths", nargs="+")

    p_exp = sub.add_parser("export", help="JSONL event log → Perfetto trace")
    p_exp.add_argument("events")
    p_exp.add_argument("trace")
    args = ap.parse_args(argv)

    if args.cmd == "validate":
        ok = True
        for path in args.paths:
            errs = validate_jsonl(path)
            if errs:
                ok = False
                print(f"{path}: INVALID")
                for e in errs[:20]:
                    print(f"  {e}")
                if len(errs) > 20:
                    print(f"  ... and {len(errs) - 20} more")
            else:
                n = sum(1 for _ in iter_jsonl(path))
                print(f"{path}: ok ({n} events)")
        return 0 if ok else 1

    events = [ev for _, ev in iter_jsonl(args.events)]
    with open(args.trace, "w") as fh:
        json.dump(events_to_trace(events), fh)
        fh.write("\n")
    print(f"wrote {args.trace} ({len(events)} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
