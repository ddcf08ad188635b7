"""Serving example on the PyTorch/CUDA port: train two FeDLRT rounds, then
serve the result.

The twin of ``examples/serve_llm.py``: the whole train→checkpoint→serve
loop is one declarative :class:`repro_torch.api.ExperimentSpec`;
``build(spec).run()`` trains and checkpoints, ``serve(spec)`` stands the
same spec up as a continuous-batching, factor-resident decode stack
(``U S Vᵀ`` is never materialized; on the card every factorized layer is
one ``xus`` and one ``avt`` launch; quantization / rank slicing are spec
knobs). It runs on the card unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_llm.py
      PYTHONPATH=src python examples/torch_serve_llm.py --quantize int8 --skip-train
      PYTHONPATH=src python -m repro_torch.api serve examples/configs/serve_lowrank.toml
"""
import argparse
import dataclasses
import tempfile

from repro_torch.api import (
    CheckpointSpec,
    DataSpec,
    ExperimentSpec,
    FedSpec,
    ModelSpec,
    ServeSpec,
    build,
    serve,
)
from repro_torch.launch.serve import summarize, synthetic_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantize", choices=("none", "int8", "bf16"),
                    default="none")
    ap.add_argument("--mode", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--skip-train", action="store_true",
                    help="serve fresh seed-initialized params")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    spec = ExperimentSpec(
        name="serve-llm-example",
        rounds=2,
        model=ModelSpec(kind="lm", preset="llm-tiny"),
        data=DataSpec(kind="token_stream", tokens_per_client=2048, batch=8),
        fed=FedSpec(method="fedlrt", clients=2, local_steps=2),
        serve=ServeSpec(
            quantize=args.quantize,
            rank_slice=args.quantize != "none",
            mode=args.mode,
            max_batch=3,
            max_prompt=32,
            prompt_bucket=8,
            max_new_tokens=16,
        ),
    )

    if args.skip_train:
        session = serve(spec, device=args.device)
    else:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            spec = dataclasses.replace(
                spec,
                checkpoint=CheckpointSpec(dir=ckpt_dir, every=1),
                serve=dataclasses.replace(spec.serve, checkpoint=ckpt_dir),
            )
            exp = build(spec, device=args.device)
            hist = exp.run()
            print(f"trained {len(hist)} rounds: "
                  f"loss {hist[0].loss_before:.4f} → {hist[-1].loss_before:.4f}")
            session = serve(spec, device=args.device)  # reloads the round_2 checkpoint

    print(session.describe())
    comps = session.run(synthetic_requests(
        spec, args.requests, spread=args.mode == "continuous",
    ))
    print(summarize(comps))
    print("first sequence:", comps[0].tokens[:16].tolist())
    return comps


if __name__ == "__main__":
    main()
