"""Multi-pod dry run: trace rank 0's program of every (architecture × input
shape) on the production meshes and write its roofline terms, the JAX
package's ``launch/dryrun.py`` on DTensor.

A ``fake`` process group of 256 ranks (a 16 × 16 ``("data", "model")``
mesh) or 512 (2 × 16 × 16 ``("pod", "data", "model")``) stands in for the
cluster: its collectives move nothing. The parameters are built on fake
tensors (no memory) on the card's device, laid out by their sanitized spec
tree, and rank 0's program runs on its local shards: a FeDLRT round
(``fedlrt_round`` with ``spec_tree`` and ``client_axes``, the model in
client mode) for ``train``, ``serve_prefill`` for ``prefill``,
``serve_step`` for ``decode``. :class:`repro_torch.launch.roofline.LocalCounter`
counts its FLOPs, bytes, collectives and memory on the way, and
``record_shapes`` the local shapes at which it calls ``xus`` / ``avt`` /
``atb`` (on fake tensors the kernels' custom ops run: a shape and a FLOP
count, no launch).

The JSON keeps the JAX package's keys where they mean the same thing:
``arch``, ``shape``, ``mesh``, ``devices``, ``lower_s`` (here the trace's
seconds), ``memory.{argument,output,temp}_bytes`` per device, ``roofline``,
``model_flops_total``, ``model_flops_per_device``, ``useful_flops_ratio``;
and adds ``kernel_shapes``. ``compile_s`` and ``code_bytes`` have no
counterpart: nothing is compiled.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod]   # a process per combo, one a core
  (--device cpu traces on fake CPU tensors, for a machine without a card)
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch")
#: seconds ``--all`` gives one combo (Jamba-1.5-Large's train_4k, the
#: longest, traces in ~270-450 s on one CPU core)
COMBO_TIMEOUT_S = 600
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "../.."))


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.tree import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if torch.is_tensor(t):
            total += t.numel() * t.element_size()
    return total


def _lay_out(structs, specs, mesh, device):
    """Fake zero tensors of the stand-ins' shapes, laid out by ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.utils import meshctx
    from repro_torch.utils.tree import tree_map

    return tree_map(
        lambda s, p: distribute_tensor(torch.zeros(s.shape, dtype=s.dtype, device=device), mesh,
                                       meshctx.placements(meshctx.fit(p, s.shape, mesh), mesh)),
        structs, specs,
    )


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool, s_star: int = 4,
                correction: str = "simplified", method: str = "fedlrt", device: str = "cuda"):
    from repro_torch.configs import get_config
    from repro_torch.core import FedConfig
    from repro_torch.core.factorization import training_dtypes
    from repro_torch.kernels.lowrank_matmul import record_shapes
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import data_axis_size, make_production_mesh
    from repro_torch.launch.specs import (
        SHAPES,
        _batch_axes,
        decode_specs,
        prefill_specs,
        sanitize_specs,
        shape_applies,
        train_specs,
    )
    from repro_torch.models import build_model, sharding
    from repro_torch.models.config import LowRankPolicy

    cfg = get_config(arch)
    if method in ("fedlin", "fedavg"):
        # the dense baseline: the same model with the factorization off
        cfg = dataclasses.replace(cfg, lowrank=LowRankPolicy(enable=False))
    shape = SHAPES[shape_name]
    ok, reason = shape_applies(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}

    _fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    sharding.enable(mesh)
    model = build_model(cfg)
    counter = rl.LocalCounter()
    with counter:
        gen = torch.Generator(device=device)
        params, specs = model.init(gen)
        if shape.kind == "train":  # the trainer's f32 bases beside a bf16 S
            params = training_dtypes(params)
        specs = sanitize_specs(mesh, params, specs)
        dparams = sharding.distribute(params, specs, mesh)
        del params
        if shape.kind == "train":
            C = data_axis_size(mesh)
            bstructs, bspecs = train_specs(cfg, shape, C, mesh)
            inputs = (_lay_out(bstructs, bspecs, mesh, device),)
            # repro-lint: disable=RPL002 -- offline tracing probe: a throwaway
            # FedConfig that traces one round's shapes on fake tensors, never
            # runs a scenario (no data, no engine, nothing to spec-hash)
            fc = FedConfig(num_clients=C, s_star=s_star, lr=1e-2, correction=correction,
                           tau=0.01, eval_after=False)
            sharding.set_client_mode(True)  # the client dim owns the data axes
            if method == "fedlrt":
                from repro_torch.core.fedlrt import fedlrt_round

                def step(p, batch):
                    return fedlrt_round(model.loss_fn, p, batch, fc, spec_tree=specs,
                                        client_axes=_batch_axes(mesh))
            else:
                from repro_torch.core.baselines import fedavg_round, fedlin_round

                base_fn = fedlin_round if method == "fedlin" else fedavg_round

                def step(p, batch):
                    return base_fn(model.loss_fn, p, batch, fc, spec_tree=specs,
                                   client_axes=_batch_axes(mesh))
        elif shape.kind == "prefill":
            bstructs, bspecs = prefill_specs(cfg, shape, mesh)
            inputs = (_lay_out(bstructs, bspecs, mesh, device),)

            def step(p, batch):
                return model.serve_prefill(p, batch, cache_len=shape.seq_len)
        else:  # decode
            (cstructs, tokens), (cspecs, tok_spec) = decode_specs(cfg, model, shape, mesh)
            inputs = (_lay_out(cstructs, cspecs, mesh, device),
                      _lay_out(tokens, tok_spec, mesh, device))

            def step(p, cache, tok):
                return model.serve_step(p, cache, tok)

        arg_bytes = _local_bytes((dparams, inputs))
        t0 = time.time()
        with counter.counting(), record_shapes() as calls, torch.no_grad() \
                if shape.kind != "train" else torch.enable_grad():
            out = step(dparams, *inputs)
        t_lower = time.time() - t0
        out_bytes = _local_bytes(out)
    sharding.set_client_mode(False)
    sharding.enable(None)

    roof = counter.roofline()
    tokens_total = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mflops = rl.model_flops(cfg, tokens_total, backward=(shape.kind == "train"))
    if shape.kind == "train":
        # the FeDLRT round does (1 basis-grad + s_star coeff) fwd+bwd passes
        mflops = mflops * (1 + s_star)
    n_dev = mesh.size()
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": int(n_dev),
        "lower_s": round(t_lower, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak,
        },
        "roofline": roof.to_dict(),
        "model_flops_total": mflops,
        "model_flops_per_device": mflops / n_dev,
        "useful_flops_ratio": (
            (mflops / n_dev) / roof.flops_per_device if roof.flops_per_device else None
        ),
        "kernel_shapes": [list(k) + [n] for k, n in
                          sorted(collections.Counter(calls).items(), key=str)],
    }


def run_one(args) -> int:
    try:
        res = lower_combo(args.arch, args.shape, multi_pod=args.multi_pod, s_star=args.s_star,
                          correction=args.correction, method=args.method, device=args.device)
    except Exception:
        traceback.print_exc()
        print(f"FAIL  {args.arch} × {args.shape} [{'2x16x16' if args.multi_pod else '16x16'}]")
        return 1
    res["method"] = args.method
    outdir = os.path.abspath(args.out or RESULTS_DIR)
    os.makedirs(outdir, exist_ok=True)
    suffix = "" if args.method == "fedlrt" else f"__{args.method}"
    tag = f"{res.get('mesh', 'skip')}__{args.arch}__{args.shape}{suffix}.json"
    with open(os.path.join(outdir, tag), "w") as f:
        json.dump(res, f, indent=2)
    if "skipped" in res:
        print(f"SKIP  {args.arch} × {args.shape}: {res['skipped']}")
        return 0
    r, m = res["roofline"], res["memory"]
    print(
        f"OK    {args.arch} × {args.shape} [{res['mesh']}] devices={res['devices']} "
        f"lower={res['lower_s']}s compute={r['compute_s'] * 1e3:.2f}ms "
        f"memory={r['memory_s'] * 1e3:.2f}ms collective={r['collective_s'] * 1e3:.2f}ms "
        f"dominant={r['dominant']} args={m['argument_bytes'] / 2**30:.2f}GiB/dev "
        f"temp={m['temp_bytes'] / 2**30:.2f}GiB/dev"
    )
    return 0


def run_all(args) -> int:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ALIASES
    from repro_torch.launch.specs import SHAPES

    combos = [(arch, shape) for arch in ALIASES for shape in SHAPES]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def one(combo):
        arch, shape = combo
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--device", args.device, "--method", args.method] + (
            ["--multi-pod"] if args.multi_pod else []) + (["--out", args.out] if args.out else [])
        t0 = time.time()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                               timeout=COMBO_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p = subprocess.CompletedProcess(
                cmd, -9, f"FAIL  {arch} × {shape}: timed out after {COMBO_TIMEOUT_S} s\n",
                "timed out")
        return p, time.time() - t0

    failures = []
    # a combo a core (each traces on one), printed in order
    with ThreadPoolExecutor(max_workers=max(1, (os.cpu_count() or 2) - 1)) as pool:
        for (arch, shape), (p, secs) in zip(combos, pool.map(one, combos)):
            sys.stdout.write(p.stdout)
            if p.returncode != 0:
                failures.append((arch, shape))
                print(f"      ({secs:.0f}s) {p.stderr.strip().splitlines()[-1:]}")
            sys.stdout.flush()
    print(f"\n{len(combos) - len(failures)}/{len(combos)} combos OK or SKIP")
    return 1 if failures else 0


def main():
    ap = argparse.ArgumentParser(description="FeDLRT multi-pod dry run (fake process group)")
    ap.add_argument("--arch", type=str, default="qwen2-7b")
    ap.add_argument("--shape", type=str, default="train_4k",
                    choices=["train_4k", "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--s-star", type=int, default=4)
    ap.add_argument("--correction", type=str, default="simplified")
    ap.add_argument("--method", type=str, default="fedlrt", choices=["fedlrt", "fedlin", "fedavg"],
                    help="fedlin/fedavg trace the dense full-rank baseline round")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="the device of the fake tensors (cuda: the card's)")
    args = ap.parse_args()
    if args.all:
        sys.exit(run_all(args))
    sys.exit(run_one(args))


if __name__ == "__main__":
    main()
