"""Serving CLI of the port — a thin layer over
``repro_torch.api.experiment.serve``, with the JAX package's flags plus
``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --preset llm-tiny --device cpu

Every invocation builds an :class:`~repro_torch.api.spec.ExperimentSpec`
first, so ``serve(spec)`` stays the one serving construction site. All
timing comes back from the scheduler's completions.
"""
from __future__ import annotations

import argparse

import numpy as np


def synthetic_requests(spec, num_requests: int, *, spread: bool = False):
    """Seeded synthetic prompt set for a spec: lengths in ``[4,
    max_prompt]``, ids in the model vocab. ``spread=True`` staggers
    arrivals (one request every other decode step) to exercise continuous
    admission; otherwise everything arrives at step 0."""
    from repro_torch.api.tasks import lm_model_config
    from repro_torch.serve import Request

    cfg = lm_model_config(spec.model)
    rng = np.random.default_rng(spec.seed)
    reqs = []
    for i in range(num_requests):
        length = int(rng.integers(4, spec.serve.max_prompt + 1))
        reqs.append(Request(
            rid=i,
            tokens=rng.integers(1, cfg.vocab_size, size=length).astype(np.int32),
            eos_id=spec.serve.eos_id,
            arrival_step=2 * i if spread else 0,
        ))
    return reqs


def summarize(completions) -> str:
    """One-line throughput/latency summary of a completion list."""
    toks = sum(len(c.tokens) for c in completions)
    span = sum(c.prefill_s + c.decode_s for c in completions)
    per_tok = np.concatenate([
        np.full(max(len(c.tokens), 1), c.decode_s / max(len(c.tokens), 1))
        for c in completions
    ])
    p50, p99 = np.percentile(per_tok, [50, 99])
    return (
        f"{len(completions)} requests, {toks} tokens; "
        f"{toks / max(span, 1e-9):.1f} tok/s aggregate; "
        f"per-token latency p50 {p50 * 1e3:.2f} ms / p99 {p99 * 1e3:.2f} ms"
    )


def run_session(spec, num_requests: int = 8, *, device="cuda") -> int:
    """Build the spec's serving stack, drive synthetic requests, print stats."""
    from repro_torch.api.experiment import serve

    session = serve(spec, device=device)
    print(session.describe())
    comps = session.run(
        synthetic_requests(spec, num_requests, spread=spec.serve.mode == "continuous")
    )
    print(summarize(comps))
    print(f"first sequence: {comps[0].tokens[:16].tolist()}")
    return 0


def main(argv=None):
    from repro_torch.api.spec import QUANT_MODES, ExperimentSpec, ModelSpec, ServeSpec

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--preset", type=str, default="llm-tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="round_*.npz file or checkpoint dir (latest wins)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quantize", choices=QUANT_MODES, default="none")
    ap.add_argument("--mode", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    bucket = max(8, args.prompt_len // 4)
    max_prompt = -(-args.prompt_len // bucket) * bucket
    spec = ExperimentSpec(
        name=f"serve-{args.arch or args.preset}",
        seed=args.seed,
        model=ModelSpec(
            kind="lm",
            preset=None if args.arch else args.preset,
            arch=args.arch,
            smoke=args.smoke,
        ),
        serve=ServeSpec(
            checkpoint=args.checkpoint,
            quantize=args.quantize,
            mode=args.mode,
            max_batch=args.batch,
            max_prompt=max_prompt,
            prompt_bucket=bucket,
            max_new_tokens=args.new_tokens,
            temperature=args.temperature,
        ),
    )
    return run_session(spec, num_requests=args.requests, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
