#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel to its plain PyTorch version at every shape the Qwen2-7B serving
path gives it, checks the kernel path's logits against the plain chain at
full width in f32, and then serves Qwen2-7B at full width and depth in
bf16 (fresh seeded weights) through ``repro_torch.api.serve``, counting
the kernel launches of that run. Every failure raises and exits non-zero.
The last two lines of standard output are one JSON object with each
kernel's numbers and one with the device.

Imports nothing of JAX. Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 outside them
REPLACES = {
    "xus": "src/repro/kernels/lowrank_matmul.py:58",
    "avt": "src/repro/kernels/lowrank_matmul.py:103",
}
SOURCE = "src/repro_torch/csrc/lowrank_matmul.cu"
#: tolerance of a kernel against its plain version, with the reason
TOL = {
    # both round once from f32 to bf16; f32 sums taken in different orders
    # can straddle a rounding boundary: up to ~2 bf16 ulps (2^-7 relative)
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    # f32 sums of up to 18944 terms in a different order
    "float32": dict(rtol=1e-4, atol=1e-4),
}
L2_DEFEAT_BYTES = 200 * 2**20  # weights cycled per timing: 4x the 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# the serving path's kernel calls
# ---------------------------------------------------------------------------


def decode_step_calls(cfg):
    """(kernel, dtype, K or N, R) → launches per decode step of ``cfg``.

    The embedding runs its chain in f32 (``apply_embedding(dtype=f32)``);
    every linear layer and the LM head in the compute dtype.
    """
    d, dff, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    kv = cfg.num_kv_heads * hd
    pol, L, dt = cfg.lowrank, cfg.num_layers, cfg.compute_dtype
    r = pol.r_max_for
    calls = {}

    def add(kernel, dtype, dim, rank, n):
        key = (kernel, dtype, dim, rank)
        calls[key] = calls.get(key, 0) + n

    for n_in, n_out, per_layer in (
        (d, cfg.num_heads * hd, 1), (d, kv, 2), (cfg.num_heads * hd, d, 1),
        (d, dff, 2), (dff, d, 1),
    ):
        add("xus", dt, n_in, r(n_in, n_out), per_layer * L)
        add("avt", dt, n_out, r(n_in, n_out), per_layer * L)
    re = r(V, d)
    add("xus", "float32", re, re, 1)  # embedding: (U[tok] S) I
    add("avt", "float32", d, re, 1)
    add("xus", dt, d, r(d, V), 1)  # LM head
    add("avt", dt, V, r(d, V), 1)
    return calls


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def graph_ms(torch, fn, n_inputs: int, reps: int) -> float:
    """Device time of ``fn(i)`` per call: ``reps`` calls cycling over
    ``n_inputs`` input sets, captured in one CUDA graph and replayed, so
    host overhead is out of the measurement and the weights come from
    device memory rather than from L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(n_inputs, 3)):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i % n_inputs)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, n: int = 200) -> float:
    """Host time per call of ``fn`` (launch overhead), in microseconds."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(0)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_environment(torch):
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load_library()
    log(f"[env] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_LOG['seconds']:.2f} s) -> {build.library_path().name}")
    for line in build.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[env] ptxas {line.strip()}")
    return smi


def _case_inputs(torch, kernel, dtype, M, dim, R, n_sets, gen):
    dev = "cuda"
    sets = []
    for _ in range(n_sets):
        if kernel == "xus":
            K = dim
            x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            U = (torch.randn(K, R, generator=gen, device=dev) / math.sqrt(K)).to(dtype)
            S = (torch.randn(R, R, generator=gen, device=dev) / math.sqrt(R)).to(dtype)
            sets.append((x, U, S))
        else:
            N = dim
            A = torch.randn(M, R, generator=gen, device=dev).to(dtype)
            V = (torch.randn(N, R, generator=gen, device=dev) / math.sqrt(R)).to(dtype)
            sets.append((A, V))
    return sets


def _bound_ms(kernel, dtype_name, M, dim, R):
    es = 2 if dtype_name == "bfloat16" else 4
    if kernel == "xus":
        K = dim
        nbytes = (M * K + K * R + R * R + M * R) * es
        flops = 2 * M * K * R + 2 * M * R * R
    else:
        N = dim
        nbytes = (M * R + N * R + M * N) * es
        flops = 2 * M * N * R
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, cfg):
    """Each kernel against its plain version at every path shape, M in
    {4, 16, 64}, bf16 and f32; returns per-case records."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_matmul import avt, xus

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = sorted({(k, dim, R) for (k, _dt, dim, R) in decode_step_calls(cfg)})
    fns = {
        "xus": (xus, ref.xus_ref, lambda x, U, S: torch.linalg.multi_dot([x, U, S])),
        "avt": (avt, ref.avt_ref, lambda A, V: torch.matmul(A, V.t())),
    }
    records = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for kernel, dim, R in shapes:
            kfn, pfn, lfn = fns[kernel]
            for M in (4, 16, 64):
                weight_bytes = dim * R * dtype.itemsize
                n_sets = max(2, min(512, math.ceil(L2_DEFEAT_BYTES / weight_bytes)))
                sets = _case_inputs(torch, kernel, dtype, M, dim, R, n_sets, gen)
                got, want = kfn(*sets[0]), pfn(*sets[0])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), **TOL[dtype_name])
                reps = max(n_sets, 20)
                rec = dict(
                    kernel=kernel, dtype=dtype_name, M=M, dim=dim, R=R, max_abs_err=err,
                    ok=ok,
                    ms=graph_ms(torch, lambda i: kfn(*sets[i]), n_sets, reps),
                    plain_ms=graph_ms(torch, lambda i: pfn(*sets[i]), n_sets, reps),
                    library_ms=graph_ms(torch, lambda i: lfn(*sets[i]), n_sets, reps),
                    host_us=host_us(torch, lambda i: kfn(*sets[i])),
                )
                rec["bound_ms"], rec["bound_by"] = _bound_ms(kernel, dtype_name, M, dim, R)
                records.append(rec)
                dimname = "K" if kernel == "xus" else "N"
                log(f"[kernels] {kernel} {dtype_name:8s} M={M:<3d} {dimname}={dim:<6d} R={R:<3d} "
                    f"max_abs_err={err:.3g} tol={TOL[dtype_name]} {'ok' if ok else 'MISMATCH'}  "
                    f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                    f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.6f} "
                    f"({rec['bound_by']}) host_us={rec['host_us']:.1f}")
                del sets
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the plain version: {bad}")
    return records


def phase_f32_check(torch):
    """Qwen2-7B at full width and 2 layers in f32: kernel-path prefill
    logits against the plain chain (kernels='off')."""
    import numpy as np

    from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec, serve
    from repro_torch.models import build_model

    spec = ExperimentSpec(
        name="chip-f32-check", seed=1,
        model=ModelSpec(arch="qwen2-7b", layers=2, dtype="float32"),
        serve=ServeSpec(max_batch=4, max_prompt=64, prompt_bucket=16, max_new_tokens=4),
    )
    session = serve(spec, device="cuda")
    eng = session.engine
    off = build_model(dataclasses.replace(eng.model.cfg, kernels="off"))
    rng = np.random.default_rng(1)
    worst = 0.0
    for length in (5, 16, 37):
        prompt = rng.integers(1, eng.model.cfg.vocab_size, size=length)
        logits, _ = eng.prefill(prompt)
        tokens = np.zeros((1, eng.bucket_len(length)), np.int64)
        tokens[0, :length] = prompt
        with torch.inference_mode():
            ref_logits, _ = off.serve_prefill(
                eng.params, {"tokens": torch.from_numpy(tokens).cuda()},
                cache_len=eng.cache_len, last_index=length - 1,
            )
        torch.cuda.synchronize()
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("f32 kernel-path logits are not finite")
        err = (logits - ref_logits).abs().max().item()
        worst = max(worst, err)
        log(f"[f32] prompt {length:2d}: max |logits(kernels) - logits(off)| = {err:.3g} "
            f"(|logits| max {ref_logits.abs().max().item():.3g})")
        if not torch.allclose(logits, ref_logits, rtol=0.0, atol=1e-3):
            raise AssertionError(f"f32 kernel-path logits differ from the plain chain by {err}")
    outs, _ = session.generate([rng.integers(1, 1000, size=9) for _ in range(3)])
    if not all(len(o) == 4 for o in outs):
        raise AssertionError("f32 session did not complete its requests")
    log(f"[f32] ok: worst prefill difference {worst:.3g} <= atol 1e-3 "
        f"(kernel and plain chain differ only in f32 summation order)")
    del session, eng
    torch.cuda.empty_cache()


def count_dispatches(torch, fn) -> int:
    """ATen operator calls (views included) that one call of ``fn`` makes:
    the host-side work an eager step pays for op by op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Counter.n += 1
            return func(*args, **(kwargs or {}))

    with Counter():
        fn()
    torch.cuda.synchronize()
    return Counter.n


def factor_bytes_per_step(params) -> int:
    """Bytes of factor weights one decode step reads: every factor's U, S
    and V, except the embedding's U, of which only the tokens' rows are
    gathered."""
    from repro_torch.core.factorization import is_factor

    total = 0

    def walk(tree, name=""):
        nonlocal total
        if is_factor(tree):
            for field in ("U", "S", "V"):
                if name == "embed" and field == "U":
                    continue
                t = getattr(tree, field)
                total += t.numel() * t.element_size()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k if not name else name)

    walk(params)
    return total


def phase_serve(torch, counters):
    """Qwen2-7B at full width and depth, bf16, continuous batching: the
    slice's main path, with the kernel launch counts of the run."""
    import numpy as np

    from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec, serve
    from repro_torch.kernels.lowrank_matmul import avt, xus
    from repro_torch.launch.serve import synthetic_requests

    spec = ExperimentSpec(
        name="chip-serve-qwen2-7b", seed=0,
        model=ModelSpec(arch="qwen2-7b"),
        serve=ServeSpec(max_batch=4, max_prompt=64, prompt_bucket=16,
                        max_new_tokens=16, mode="continuous"),
    )
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = serve(spec, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] built {spec.model.arch} ({session.engine.model.cfg.num_layers} layers, "
        f"{session.engine.model.cfg.compute_dtype}) in {time.perf_counter() - t0:.1f} s")
    log(session.describe())
    eng = session.engine

    # a short warm-up request (cuBLAS handles, allocator pools), not counted
    session.generate([np.arange(1, 9)], max_new_tokens=2)

    # every logits tensor the run produces is checked on the device
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step_fn, prefill_fn = eng.step, eng.prefill

    def checked_step(state, last):
        logits, state = step_fn(state, last)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, state

    def checked_prefill(prompt):
        logits, cache = prefill_fn(prompt)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    eng.step, eng.prefill = checked_step, checked_prefill
    reqs = synthetic_requests(spec, 8, spread=True)
    sched = session.scheduler
    steps0 = sched.decode_steps
    # the main path: counts at 0 just before, read just after
    xus.launches = avt.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = session.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters["xus"], counters["avt"] = xus.launches, avt.launches
    eng.step, eng.prefill = step_fn, prefill_fn

    steps = sched.decode_steps - steps0
    prefills = len(reqs)
    if len(comps) != len(reqs) or any(len(c.tokens) != 16 for c in comps):
        raise AssertionError(f"not every request completed 16 tokens: {[len(c.tokens) for c in comps]}")
    if not bool(finite):
        raise AssertionError("NaN/inf logits in the serve run")
    per_forward = 198  # 28 layers x 7 factorized linears + embedding + LM head
    for name in ("xus", "avt"):
        want = per_forward * (steps + prefills)
        if counters[name] != want:
            raise AssertionError(
                f"{name}: {counters[name]} launches, expected {per_forward} x "
                f"({steps} decode steps + {prefills} prefills) = {want}"
            )
    log(f"[serve] launches: xus {counters['xus']}, avt {counters['avt']} = "
        f"{per_forward} per forward x ({steps} decode steps + {prefills} prefills); "
        f"{per_forward} xus + {per_forward} avt per decode step")
    toks = sum(len(c.tokens) for c in comps)
    per_tok = np.concatenate([np.full(len(c.tokens), c.decode_s / len(c.tokens)) for c in comps])
    p50, p99 = np.percentile(per_tok, [50, 99])
    log(f"[serve] wall {wall:.3f} s for {toks} tokens = {toks / wall:.2f} tok/s; "
        f"per-token decode latency p50 {p50 * 1e3:.2f} ms, p99 {p99 * 1e3:.2f} ms")

    # one decode step: host clock (what the scheduler sees) and device time
    state = sched.state
    last = np.ones(eng.max_batch, np.int64)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(state, last)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    tokens = torch.ones((eng.max_batch, 1), dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        dev_ms = graph_ms(torch, lambda i: eng.model.serve_step(eng.params, state, tokens), 1, 5)
    dispatches = count_dispatches(torch, lambda: eng.step(state, last))
    nbytes = factor_bytes_per_step(eng.params)
    floor_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    host_ms = float(np.median(host) * 1e3)
    log(f"[serve] decode step: host {host_ms:.2f} ms (median of 10), device "
        f"{dev_ms:.3f} ms (CUDA graph replay); floor {floor_ms:.3f} ms = "
        f"{nbytes / 1e9:.3f} GB of factors / 3.35 TB/s; device idle "
        f"{100 * (1 - dev_ms / host_ms):.1f} % of the eager step")
    log(f"[serve] ATen dispatches in one decode step: {dispatches} "
        f"(plus {2 * per_forward} ctypes kernel calls)")
    log(f"[serve] torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    return dict(tok_s=toks / wall, p50_ms=p50 * 1e3, p99_ms=p99 * 1e3,
                step_host_ms=host_ms, step_device_ms=dev_ms,
                floor_ms=floor_ms, peak_gib=peak / 2**30, aten_dispatches=dispatches)


def kernel_summary(records, counters, cfg):
    """Per kernel: the sum over one decode step's launches (M = 4) of each
    measured number, and the worst error over every checked case."""
    calls = decode_step_calls(cfg)
    out = []
    for name in ("xus", "avt"):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        bound_by = set()
        for (kernel, dtype, dim, R), n in calls.items():
            if kernel != name:
                continue
            [rec] = [r for r in records if (r["kernel"], r["dtype"], r["dim"], r["R"], r["M"])
                     == (kernel, dtype, dim, R, 4)]
            for k in tot:
                tot[k] += n * rec[k]
            bound_by.add(rec["bound_by"])
        out.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": counters[name],
            "max_abs_err": max(r["max_abs_err"] for r in records if r["kernel"] == name),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
            "library_ms": tot["library_ms"],
        })
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-7b")
    t_start = time.perf_counter()
    smi = phase_environment(torch)
    records = phase_kernels(torch, cfg)
    log(f"[time] kernels phase done at {time.perf_counter() - t_start:.1f} s")
    phase_f32_check(torch)
    log(f"[time] f32 phase done at {time.perf_counter() - t_start:.1f} s")
    counters = {}
    serve_stats = phase_serve(torch, counters)
    log(f"[time] serve phase done at {time.perf_counter() - t_start:.1f} s")
    log("[summary] " + json.dumps({"card": smi, **serve_stats}))
    print(json.dumps({"kernels": kernel_summary(records, counters, cfg)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
