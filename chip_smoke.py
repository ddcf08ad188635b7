#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all started together) and drives each of the port's paths:

- kernels: holds each kernel to its plain PyTorch version at every shape
  its paths give it: ``xus``/``avt`` at the Qwen2-7B serving shapes (full
  width and rank-sliced to 128),
  ``atb`` at the llm-100m training shapes and at Qwen2-7B's, ``xus`` and
  ``avt`` at every shape of an llm-100m round (M = 512, f32); ``atb``'s,
  ``xus``'s and ``avt``'s times summed over one round; each ``xus``,
  ``avt`` and ``atb`` shape's device launches a call, counted in a CUDA
  graph captured around one call, are held to ``xus_plan``'s,
  ``avt_plan``'s and ``atb_plan``'s;
- backward: ``lowrank_apply``'s kernel-backed gradients against the plain
  chain's at one llm-100m layer's full width, in f32;
- f32 logits: the serving kernel path against the plain chain, Qwen2-7B at
  full width and 2 layers;
- serve: Qwen2-7B at full width and depth in bf16 (fresh seeded weights)
  through ``repro_torch.api.serve``, counting the kernel launches;
- serve-quant: the same model and requests through serving's at-rest
  transforms, one session at a time: int8 factors (dequantized on the
  device within ``quantization_error_bound``, resident bytes against
  bf16's, the dequantization's share of the decode step's device time,
  launches held to 198 ``xus`` + 198 ``avt`` a forward); every factor cut
  to rank 128 and served at r_max 256 and rank-sliced (prefill logits held
  within ``SLICE_LOGIT_RTOL``, factor bytes and device time of both decode
  steps); the materialized dense baseline (no ``xus`` / ``avt`` launch,
  peak memory, ``decode_matmul_flops`` both ways);
- models: the five architectures the MoE slice added (CodeQwen1.5-7B,
  Qwen1.5-32B, Qwen3-32B, OLMoE-1B-7B, DeepSeekMoE-16B) and the two the SSM
  slice added (RWKV6-7B; Jamba-1.5-Large, Mamba and attention with MoE) at
  full width and depth in bf16 through ``repro_torch.api.serve``: each
  model served, launches a forward held to ``decode_step_calls``, bytes
  against the plan, tok/s, p50/p99, decode step host and device ms, a
  repeated step and prefill bit-identical, the MoE capacity drops per
  step; then their new ``xus`` / ``avt`` shapes (the experts' G = 64 and
  G = 16 stacks included) against the plain versions; OLMoE-1B-7B in f32,
  kernel path against plain path: logits, and every layer's expert
  choices; RWKV6-7B in f32 the same: logits and greedy tokens; the
  recurrent models' 37-token prefill, host and device time; Jamba's
  chunked Mamba state scan against the token-by-token loop in bf16 at
  full width: one mixer over 1,100 tokens (output and state within
  ``MAMBA_BF16_RTOL``), and a reduced-depth model (one 8-layer superblock)
  prefilled over 37 and 1,100 tokens (bf16 logits within
  ``MAMBA_MODEL_RTOL``, with the prefill's host and device time both ways;
  f32 logits within ``MODEL_F32_RTOL`` and greedy tokens identical);
- train: three FeDLRT rounds of llm-100m at full width and depth in f32
  through ``repro_torch.api.build(spec).run()``, counting the launches
  against the counts the model's factors imply; one more round under
  ``torch.profiler`` (device busy share, kernels by device time); then
  one round from the same start with ``kernels="off"`` (held to the
  kernel run) and the kernel round again (held to be bit-identical), its
  truncations' coefficients held to an f64 SVD under both cuSOLVER
  drivers;
- flash: ``repro_torch.kernels.flash_attention`` at four attention shapes
  (Qwen2-7B prefill and decode against a cache, Mistral-7B's sliding
  window, an f32 case), each held to ``flash_attention_ref``, with its time
  (per call, and in a CUDA graph: device time) beside its bound, the plain
  version's and ``scaled_dot_product_attention``'s, and the route it took
  (bf16: the tensor-core kernel, with a split key range at decode; f32:
  the CUDA-core kernel);
- spec: llm-100m at full width and depth through ``python -m
  repro_torch.api run`` on a TOML written from
  ``examples/configs/sync_baseline.toml``: two rounds with int8 on the wire
  and a checkpoint per round; a fresh experiment resumed from the first
  checkpoint, held bit-identical to the uninterrupted run; one round with
  the identity codec held bit-identical to one with the wire off, its
  measured bytes held equal to ``cost_model.wire_round_bytes``; the two
  rounds again with the jsonl, perfetto and memory telemetry sinks, held
  bit-identical to telemetry off, the event log held to ``validate_jsonl``
  and the trace loaded; then 4 greedy requests served from the written
  checkpoint (the ``serve.tokens`` counter held to the tokens produced),
  and again rank-sliced and materialized, held token-identical (f32);
- sim: the system simulator (``repro_torch.fed.sim``) at llm-100m's full
  width and depth through ``build(spec).run()``: the sync engine priced
  under a 10x straggler fleet, held bit-identical to the plain engine, its
  virtual seconds recomputed as the straggler barrier; the async engine
  with a uniform fleet and buffer 4, held bit-identical to the plain
  rounds with their launches; ``examples/configs/async_straggler.toml``'s
  FedBuff flushes until the straggler lands, the zero inactive columns
  held exactly after each, and again with the jsonl, perfetto and memory
  sinks (the same timeline and bits, a valid log, a trace with both clocks
  and a track per client); ``examples/configs/hier_int8_wire.toml``'s
  cloud round (edge bytes against an identity edge wire's, the cloud
  aggregate's time, the invariant after it) and a 1-edge cloud aggregate
  held to keep every factor's ``U S Vᵀ``;
- mesh (after the models' phases): an NCCL group of one rank and a 1 x 1
  ``("data", "model")`` mesh; Qwen2-7B's bf16 prefill and 8 greedy steps
  and an llm-100m FeDLRT round (``spec_tree``, ``client_axes``) held
  bit-identical to the same calls without a mesh, with equal launches; the
  host ms of a step both ways; the custom-op route's host µs a call; the
  engine's decode step without a mesh held to its ATen operator count from
  before the mesh was ported;
- dryrun: ``python -m repro_torch.launch.dryrun`` on the host for Qwen2-7B
  (train_4k, prefill_32k, decode_32k; long_500k the documented skip),
  RWKV6-7B (long_500k) and OLMoE-1B-7B (train_4k) on a fake 256-rank
  16 x 16 mesh, then every local ``xus`` / ``avt`` / ``atb`` shape those
  traces record against its plain version on the card;
- examples (last): the example twins ``examples/torch_*.py`` through their
  ``main``: the quickstart (the planted rank 4 found), ``torch_train_llm.py
  --preset llm-100m --rounds 2`` (llm-100m at full width and depth on
  ``xus`` / ``avt`` / ``atb``), a dropout-participation run of it under
  ``repro_torch.analysis.trace_audit`` (one step signature per callsite),
  ``torch_serve_llm.py`` (trained, then continuous ≡ static), and
  ``torch_federated_vision.py --clients 4 --rounds 6`` (the ``mlp`` task's
  ``lr_matmul`` on the kernels).

Every failure raises and exits non-zero. The last two lines of standard
output are one JSON object with each kernel's numbers and one with the
device.

Imports nothing of JAX. Needs one CUDA card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 outside them
REPLACES = {
    "xus": "src/repro/kernels/lowrank_matmul.py:58",
    "avt": "src/repro/kernels/lowrank_matmul.py:103",
    "atb": "src/repro/kernels/coeff_grad.py:22",
    "flash_attention": "src/repro/kernels/flash_attention.py:34",
}
SOURCES = {
    "xus": "src/repro_torch/csrc/lowrank_matmul.cu",
    "avt": "src/repro_torch/csrc/lowrank_matmul.cu",
    "atb": "src/repro_torch/csrc/coeff_grad.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}
KERNELS = tuple(SOURCES)
PATHS = ("serve", "serve-quant", "models", "encdec", "vlm", "mesh", "train", "flash", "spec",
         "sim", "examples")
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


def decode_step_calls(cfg, encoder=False):
    """(kernel, dtype, K or N, R, G) → launches per decode step of ``cfg``
    (``encoder``: per prefill of an encoder-decoder model, which also runs
    the encoder).

    The embedding runs its chain in f32 (``apply_embedding(dtype=f32)``);
    every linear layer and the LM head in the compute dtype. Attention's q
    and o are ``d × H·hd`` (not square where ``H·hd ≠ d``, as in
    Qwen3-32B). A Mamba layer runs in_x, in_z, x_proj, dt_proj and out
    (``d → d_inner``, ``d_inner → dt_rank + 2N``, ``dt_rank → d_inner``,
    ``d_inner → d``); an RWKV layer r, k, v, g and out (``d → d``). A
    projection under the policy's ``min_dim`` is a dense ``torch.matmul``,
    not a kernel. A MoE layer runs each of its experts' up, gate and down
    projections as one call on the stack of G = E experts, and its shared
    experts' three as the MLP's; its router is a dense ``torch.matmul``,
    not a kernel. An encoder-decoder model's decoder layer adds its cross
    block's xq, xk, xv and xo (xk and xv over the encoder's states, at
    every step); its encoder layer runs q, k, v, o and the MLP.
    """
    d, dff, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    pol, dt = cfg.lowrank, cfg.compute_dtype
    r = pol.r_max_for
    NB, pattern = cfg.superblocks, cfg.block_pattern
    n_moe = NB * sum(cfg.moe_on_layer(i) for i in range(len(pattern)))
    n_mlp = cfg.num_layers - n_moe
    n_attn, n_mamba, n_rwkv = (NB * pattern.count(kind) for kind in ("attn", "mamba", "rwkv"))
    calls = {}

    def add(kernel, dtype, dim, rank, n, G=1):
        if n:
            key = (kernel, dtype, dim, rank, G)
            calls[key] = calls.get(key, 0) + n

    def linear(n_in, n_out, n, G=1):
        if pol.applies(n_in, n_out):
            add("xus", dt, n_in, r(n_in, n_out), n, G)
            add("avt", dt, n_out, r(n_in, n_out), n, G)

    n_enc = cfg.encoder.num_layers if encoder and cfg.is_encdec else 0
    n_cross = n_attn if cfg.is_encdec else 0
    linear(d, q, n_attn + n_cross + n_enc)
    linear(d, kv, 2 * (n_attn + n_cross + n_enc))
    linear(q, d, n_attn + n_cross + n_enc)
    if n_mamba:
        d_inner = cfg.mamba.expand * d
        dt_rank = cfg.mamba.dt_rank or -(-d // 16)
        linear(d, d_inner, 2 * n_mamba)
        linear(d_inner, dt_rank + 2 * cfg.mamba.d_state, n_mamba)
        linear(dt_rank, d_inner, n_mamba)
        linear(d_inner, d, n_mamba)
    linear(d, d, 5 * n_rwkv)
    linear(d, dff, (2 if cfg.gated_mlp else 1) * (n_mlp + n_enc))
    linear(dff, d, n_mlp + n_enc)
    if n_moe:
        m = cfg.moe
        linear(d, m.d_expert, 2 * n_moe, G=m.num_experts)
        linear(m.d_expert, d, n_moe, G=m.num_experts)
        if m.num_shared_experts:
            ds = m.d_shared or m.d_expert * m.num_shared_experts
            linear(d, ds, 2 * n_moe)
            linear(ds, d, n_moe)
    re = r(V, d)
    add("xus", "float32", re, re, 1)  # embedding: (U[tok] S) I
    add("avt", "float32", d, re, 1)
    add("xus", dt, d, r(d, V), 1)  # LM head
    add("avt", dt, V, r(d, V), 1)
    return calls


def per_forward(cfg) -> int:
    """``xus`` (and as many ``avt``) launches of one forward of ``cfg``."""
    return sum(n for (kernel, *_), n in decode_step_calls(cfg).items() if kernel == "xus")


#: the active rank the serve-quant phase gives every factor before slicing
SLICE_RANK = 128


def sliced_shapes(cfg, rank):
    """(kernel, K or N, R) of the decode step once every factor of ``cfg``
    is rank-sliced to ``min(rank, r_max)``: R shrinks, and so does the
    embedding's ``xus`` K, which is its rank (``(U[tok] S) I``)."""
    out = set()
    for kernel, _dt, dim, R, _G in decode_step_calls(cfg):
        r = min(rank, R)
        out.add((kernel, r if kernel == "xus" and dim == R else dim, r))
    return out


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


def device_launches(torch, fn) -> int:
    """Kernels that one call of ``fn()`` launches on the card: the kernel
    nodes of a CUDA graph captured around the call, counted through the
    driver API. A capture records every launch the call makes, so the
    count does not rest on a profiler's trace (``torch.profiler`` returned
    traces without the calls' kernels in two runs on an H100)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)

    def check(code):
        if code != 0:
            raise RuntimeError(f"CUDA driver call failed with CUresult {code}")

    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kinds.append(kind.value)
    del graph
    return sum(k == 0 for k in kinds)  # CU_GRAPH_NODE_TYPE_KERNEL


def _xus_route(x, U, S, got_launches):
    """The plan of an ``xus`` call (2-D, or stacked over G) and its device
    launches, held to each other: the run fails where the card ran another
    number of kernels."""
    from repro_torch.kernels.lowrank_matmul import xus_plan

    G = x.shape[0] if x.dim() == 3 else 1
    M, K = x.shape[-2:]
    R = U.shape[-1]
    plan = xus_plan(G, M, K, R, S is not None)
    if got_launches != plan.launches:
        raise AssertionError(f"xus G={G} M={M} K={K} R={R} S={S is not None}: "
                             f"{got_launches} device launches a call, plan says {plan.launches}")
    return plan


def _avt_route(A, V, got_launches):
    """The plan of an ``avt`` call (2-D, or stacked over G) and its device
    launches, held to each other, with the route's sizes as text."""
    from repro_torch.kernels.lowrank_matmul import avt_plan

    G = A.shape[0] if A.dim() == 3 else 1
    M, R = A.shape[-2:]
    N = V.shape[-2]
    plan = avt_plan(G, M, N, R)
    if got_launches != plan.launches:
        raise AssertionError(f"avt G={G} M={M} N={N} R={R}: {got_launches} device launches a "
                             f"call, plan says {plan.launches}")
    sizes = (f"rows={plan.rows} warps={plan.warps}" if plan.route == "stream"
             else f"tile={plan.tile[0]}x{plan.tile[1]}")
    return plan, f"route={plan.route} {sizes} launches={got_launches}"


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
    for kernel, line in _ptxas_by_kernel(build.BUILD_LOG["ptxas"]):
        log(f"[env] ptxas {kernel}: {line}")
    return smi


def _ptxas_by_kernel(ptxas: str):
    """(kernel, registers or spills line) pairs from ``nvcc -Xptxas -v``
    output; the kernels' names demangled by ``c++filt`` where the host has
    it, without namespace, return type and arguments."""
    pairs, name = [], "?"
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            pairs.append((name, line.split(":", 1)[-1].strip()))
    names = sorted({n for n, _ in pairs})
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        short = {n: d.replace("(anonymous namespace)::", "").removeprefix("void ")
                 .split("(", 1)[0] for n, d in zip(names, out)}
    except (OSError, subprocess.CalledProcessError):
        short = {n: n for n in names}
    return [(short.get(n, n), line) for n, line in pairs]


def _case_inputs(torch, kernel, dtype, M, dim, R, n_sets, gen, G=1):
    """``n_sets`` input sets of one call; a stack of ``G`` (G > 1) leads
    every operand with G."""
    dev = "cuda"
    lead = (G,) if G > 1 else ()
    sets = []
    for _ in range(n_sets):
        if kernel == "xus":
            K = dim
            x = torch.randn(lead + (M, K), generator=gen, device=dev).to(dtype)
            U = (torch.randn(lead + (K, R), generator=gen, device=dev) / math.sqrt(K)).to(dtype)
            S = (torch.randn(lead + (R, R), generator=gen, device=dev) / math.sqrt(R)).to(dtype)
            sets.append((x, U, S))
        else:
            N = dim
            A = torch.randn(lead + (M, R), generator=gen, device=dev).to(dtype)
            V = (torch.randn(lead + (N, R), generator=gen, device=dev) / math.sqrt(R)).to(dtype)
            sets.append((A, V))
    return sets


def _bound_ms(kernel, dtype_name, M, dim, R, has_s=True, G=1):
    es = 2 if dtype_name == "bfloat16" else 4
    if kernel == "xus":
        K = dim
        nbytes = G * (M * K + K * R + (R * R if has_s else 0) + M * R) * es
        flops = G * (2 * M * K * R + (2 * M * R * R if has_s else 0))
    else:
        N = dim
        nbytes = G * (M * R + N * R + M * N) * es
        flops = G * 2 * M * N * R
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_case(torch, kernel, dtype_name, M, dim, R, gen, G=1, tag="[kernels]"):
    """One ``xus`` / ``avt`` shape (stacked over G where G > 1) against its
    plain version, timed (kernel, plain, library) in a CUDA graph over
    enough input sets to defeat L2, with its bound, host µs a call and its
    device launches held to its plan; logs one ``tag`` line, returns the
    record."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_matmul import avt, xus

    dtype = getattr(torch, dtype_name)
    if G == 1:
        library = {"xus": lambda x, U, S: torch.linalg.multi_dot([x, U, S]),
                   "avt": lambda A, V: torch.matmul(A, V.t())}
    else:  # batched products over the stack
        library = {"xus": lambda x, U, S: torch.matmul(torch.matmul(x, U), S),
                   "avt": lambda A, V: torch.matmul(A, V.transpose(-1, -2))}
    kfn, pfn, lfn = {"xus": (xus, ref.xus_ref), "avt": (avt, ref.avt_ref)}[kernel] + (
        library[kernel],)
    # input sets cycled: the weights, or at a prefill's M the activations,
    # of all of them at least 4x the L2
    set_bytes = G * max(dim * R, M * (dim if kernel == "xus" else R)) * dtype.itemsize
    n_sets = max(2, min(512, math.ceil(L2_DEFEAT_BYTES / set_bytes)))
    sets = _case_inputs(torch, kernel, dtype, M, dim, R, n_sets, gen, G)
    got, want = kfn(*sets[0]), pfn(*sets[0])
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **TOL[dtype_name])
    reps = max(n_sets, 20)
    rec = dict(
        kernel=kernel, dtype=dtype_name, M=M, dim=dim, R=R, G=G, max_abs_err=err, ok=ok,
        ms=graph_ms(torch, lambda i: kfn(*sets[i]), n_sets, reps),
        plain_ms=graph_ms(torch, lambda i: pfn(*sets[i]), n_sets, reps),
        library_ms=graph_ms(torch, lambda i: lfn(*sets[i]), n_sets, reps),
        host_us=host_us(torch, lambda i: kfn(*sets[i])),
    )
    rec["bound_ms"], rec["bound_by"] = _bound_ms(kernel, dtype_name, M, dim, R, G=G)
    route = ""
    if kernel == "avt":
        n = device_launches(torch, lambda: avt(*sets[0]))
        plan, desc = _avt_route(*sets[0], n)
        rec.update(route=plan.route, launches=n)
        route = f" {desc}"
    if kernel == "xus":
        # device launches a call, with S (the serving path) and without
        for with_s in (True, False):
            s = sets[0][2] if with_s else None
            n = device_launches(torch, lambda: xus(sets[0][0], sets[0][1], s))
            plan = _xus_route(sets[0][0], sets[0][1], s, n)
            rec["launches_s" if with_s else "launches_no_s"] = n
            route += (f" [{'S' if with_s else 'no S'}: {plan.route} "
                      f"splits={plan.splits} launches={n}]")
    dimname = "K" if kernel == "xus" else "N"
    stack = f"G={G:<3d}" if G > 1 else ""
    log(f"{tag} {kernel} {dtype_name:8s} {stack}M={M:<3d} {dimname}={dim:<6d} R={R:<3d} "
        f"max_abs_err={err:.3g} tol={TOL[dtype_name]} {'ok' if ok else 'MISMATCH'}  "
        f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}) host_us={rec['host_us']:.1f}{route}")
    del sets
    return rec


def _check_records(records):
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the plain version: {bad}")


def phase_kernels(torch, cfg):
    """Each kernel against its plain version at every path shape, M in
    {4, 16, 64}, bf16 and f32; returns per-case records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = sorted({(k, dim, R) for (k, _dt, dim, R, _G) in decode_step_calls(cfg)}
                    | sliced_shapes(cfg, SLICE_RANK))
    records = [kernel_case(torch, kernel, dtype_name, M, dim, R, gen)
               for dtype_name in ("bfloat16", "float32") for kernel, dim, R in shapes
               for M in (4, 16, 64)]
    _check_records(records)
    return records


def phase_f32_check(torch):
    """Qwen2-7B at full width and 2 layers in f32: kernel-path prefill
    logits against the plain chain (kernels='off'). The depth and dtype are
    this check's own, so it builds the serving stack that ``serve()`` would
    from the replaced config."""
    import numpy as np

    from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec
    from repro_torch.api.experiment import ServeSession
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousScheduler, ServeEngine

    sv = ServeSpec(max_batch=4, max_prompt=64, prompt_bucket=16, max_new_tokens=4)
    spec = ExperimentSpec(name="chip-f32-check", seed=1, model=ModelSpec(arch="qwen2-7b"),
                          serve=sv)
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2,
                              compute_dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(spec.seed)
    with torch.inference_mode():
        params, _ = model.init(gen)
    eng = ServeEngine(model, params, max_batch=sv.max_batch, max_prompt=sv.max_prompt,
                      prompt_bucket=sv.prompt_bucket, max_new_tokens=sv.max_new_tokens,
                      seed=spec.seed)
    session = ServeSession(spec=spec, engine=eng, scheduler=ContinuousScheduler(eng))
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


def serve_spec(**serve_kw):
    """The Qwen2-7B serving spec of the serve phases: bf16, full width and
    depth, 4 slots, prompts up to 64, 16 new tokens, continuous batching."""
    from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec

    return ExperimentSpec(
        name="chip-serve-qwen2-7b", seed=0,
        model=ModelSpec(arch="qwen2-7b"),
        serve=ServeSpec(max_batch=4, max_prompt=64, prompt_bucket=16,
                        max_new_tokens=16, mode="continuous", **serve_kw),
    )


def drive_session(torch, session, spec, tag, launches=None, n_requests=8):
    """``n_requests`` seeded greedy requests of ``spec`` through ``session``
    (a short warm-up request first, not counted), every logits tensor
    checked finite on the device, the kernel launch counts set to 0 just
    before the run and read just after. Holds ``xus`` and ``avt`` to
    ``launches`` a forward, by default the model's :func:`per_forward`.
    Returns (completions, counts, stats)."""
    import numpy as np

    from repro_torch.launch.serve import synthetic_requests

    eng = session.engine
    forward = per_forward(eng.model.cfg) if launches is None else launches
    session.generate([np.arange(1, 9)], max_new_tokens=2)
    finite = torch.ones((), dtype=torch.bool, device=eng.device)
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
    reqs = synthetic_requests(spec, n_requests, spread=True)
    sched = session.scheduler
    steps0 = sched.decode_steps
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = session.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launch_counts()
    eng.step, eng.prefill = step_fn, prefill_fn

    steps = sched.decode_steps - steps0
    prefills = len(reqs)
    new = spec.serve.max_new_tokens
    if len(comps) != len(reqs) or any(len(c.tokens) != new for c in comps):
        raise AssertionError(f"{tag}: not every request completed {new} tokens: "
                             f"{[len(c.tokens) for c in comps]}")
    if not bool(finite):
        raise AssertionError(f"{tag}: NaN/inf logits in the serve run")
    for name in ("xus", "avt"):
        want = forward * (steps + prefills)
        if got[name] != want:
            raise AssertionError(
                f"{tag} {name}: {got[name]} launches, expected {forward} x "
                f"({steps} decode steps + {prefills} prefills) = {want}"
            )
    if got["atb"] or got["flash_attention"]:
        raise AssertionError(f"{tag}: serving (forward only) launched atb / flash_attention: {got}")
    log(f"{tag} launches: xus {got['xus']}, avt {got['avt']} = "
        f"{forward} per forward x ({steps} decode steps + {prefills} prefills); "
        f"{forward} xus + {forward} avt per decode step")
    toks = sum(len(c.tokens) for c in comps)
    per_tok = np.concatenate([np.full(len(c.tokens), c.decode_s / len(c.tokens)) for c in comps])
    p50, p99 = np.percentile(per_tok, [50, 99])
    log(f"{tag} wall {wall:.3f} s for {toks} tokens = {toks / wall:.2f} tok/s; "
        f"per-token decode latency p50 {p50 * 1e3:.2f} ms, p99 {p99 * 1e3:.2f} ms")
    return comps, got, dict(tok_s=toks / wall, p50_ms=p50 * 1e3, p99_ms=p99 * 1e3)


def decode_step_ms(torch, session):
    """One decode step over the session's slots, from the scheduler's state
    after its run: host ms (median of 10 ``step`` calls, each ending in a
    sync) and device ms (the step's forward, dequantization included,
    replayed as a CUDA graph)."""
    import numpy as np

    from repro_torch.serve import dequantize_params

    eng, state = session.engine, session.scheduler.state
    last = np.ones(eng.max_batch, np.int64)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(state, last)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    tokens = torch.ones((eng.max_batch, 1), dtype=torch.int64, device=eng.device)
    with torch.inference_mode():
        dev_ms = graph_ms(torch, lambda i: eng.model.serve_step(
            dequantize_params(eng.params), state, tokens), 1, 5)
    return float(np.median(host) * 1e3), dev_ms, state, last


def phase_serve(torch, counters):
    """Qwen2-7B at full width and depth, bf16, continuous batching: the
    slice's main path, with the kernel launch counts of the run."""
    from repro_torch.api import serve
    from repro_torch.serve import resident_bytes

    spec = serve_spec()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = serve(spec, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] built {spec.model.arch} ({session.engine.model.cfg.num_layers} layers, "
        f"{session.engine.model.cfg.compute_dtype}) in {time.perf_counter() - t0:.1f} s")
    log(session.describe())
    eng = session.engine
    # the main path: counts at 0 just before, read just after (drive_session)
    comps, counters["serve"], stats = drive_session(torch, session, spec, "[serve]")

    host_ms, dev_ms, state, last = decode_step_ms(torch, session)
    dispatches = count_dispatches(torch, lambda: eng.step(state, last))
    nbytes = factor_bytes_per_step(eng.params)
    floor_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] decode step: host {host_ms:.2f} ms (median of 10), device "
        f"{dev_ms:.3f} ms (CUDA graph replay); floor {floor_ms:.3f} ms = "
        f"{nbytes / 1e9:.3f} GB of factors / 3.35 TB/s; device idle "
        f"{100 * (1 - dev_ms / host_ms):.1f} % of the eager step")
    log(f"[serve] ATen dispatches in one decode step: {dispatches} "
        f"(plus {2 * per_forward(eng.model.cfg)} ctypes kernel calls)")
    # where one decode step's device time goes, kernel by kernel
    n, busy_s, _ = device_profile(torch, lambda: eng.step(state, last), "[serve] profile", 8)
    log(f"[serve] profile: one decode step, {n} kernels, device busy {busy_s * 1e3:.3f} ms")
    log(f"[serve] torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    stats.update(step_host_ms=host_ms, step_device_ms=dev_ms, floor_ms=floor_ms,
                 peak_gib=peak / 2**30, aten_dispatches=dispatches,
                 resident_bytes=resident_bytes(eng.params))
    tokens = [c.tokens.tolist() for c in comps]
    del session, eng, state
    return stats, tokens


#: prefill logits of the rank-sliced tree against the full-width one, both
#: bf16: the same products over fewer zero columns, but the kernels' plans
#: (and so their summation orders) follow R, and one bf16 rounding flip in
#: an early layer carries through 28 layers; relative to max |logit|
SLICE_LOGIT_RTOL = 5e-2
#: dequantized f32 factors against their bf16 source: the bound
#: (max scale / 2) plus the f32 rounding of the decode's two operations
DEQUANT_SLACK = 1e-6


def fresh_params(torch, spec):
    """The parameters ``serve(spec)`` initializes from ``spec.seed``."""
    from repro_torch.api.tasks import lm_model_config
    from repro_torch.models import build_model

    gen = torch.Generator(device="cuda")
    gen.manual_seed(spec.seed)
    with torch.inference_mode():
        return build_model(lm_model_config(spec.model)).init(gen)[0]


def with_active_rank(torch, params, r):
    """Every factor of ``params`` cut to active rank ``min(r, r_max)``: the
    columns of U and V past it and the rows and columns of S past it
    zeroed, so the zero-inactive-columns invariant holds."""
    from repro_torch.core.factorization import LowRankFactor, is_factor, mask_coeff, rank_mask
    from repro_torch.utils.tree import tree_map

    def one(f):
        if not is_factor(f):
            return f
        rank = torch.full_like(f.rank, float(min(r, f.r_max)))
        m = rank_mask(rank, f.r_max).to(f.U.dtype)
        return LowRankFactor(U=f.U * m[..., None, :], S=mask_coeff(f.S, m.to(f.S.dtype)),
                             V=f.V * m[..., None, :], rank=rank)

    with torch.inference_mode():
        return tree_map(one, params, is_leaf=is_factor)


def _add_counts(total, got):
    for name, n in got.items():
        total[name] = total.get(name, 0) + n


def _same_tokens(tokens, ref_tokens):
    """Share of generated tokens (a list per request) equal, position by
    position, to the reference run's."""
    same = sum(int(a == b) for t, r in zip(tokens, ref_tokens, strict=True)
               for a, b in zip(t, r, strict=True))
    return same / sum(len(r) for r in ref_tokens)


def phase_serve_quant(torch, counters, serve_stats, bf16_tokens):
    """Qwen2-7B at full width and depth through serving's at-rest
    transforms, one session at a time, each freed before the next: int8
    factors; a rank-128 model served at r_max 256 and rank-sliced; the
    materialized dense baseline."""
    from repro_torch.api import serve
    from repro_torch.core.factorization import is_factor
    from repro_torch.serve import (
        decode_matmul_flops,
        dequantize_params,
        quantization_error_bound,
        resident_bytes,
    )
    from repro_torch.serve.quantize import dequantize_factor, is_quantized
    from repro_torch.utils.tree import tree_leaves

    counters["serve-quant"] = total = {}
    out = {}
    source = fresh_params(torch, serve_spec())

    # 1. int8 at rest
    spec = serve_spec(quantize="int8")
    session = serve(spec, params=source, device="cuda")
    eng = session.engine
    log(session.describe())
    src = [f for f in tree_leaves(source, is_leaf=is_factor) if is_factor(f)]
    qfs = [q for q in tree_leaves(eng.params, is_leaf=is_quantized) if is_quantized(q)]
    worst = 0.0
    with torch.inference_mode():
        for f, q in zip(src, qfs, strict=True):
            back, bound = dequantize_factor(q), quantization_error_bound(q)
            for a, b in ((back.U, f.U), (back.V, f.V)):
                err = (a - b.float()).abs().max().item()
                limit = bound + DEQUANT_SLACK * b.float().abs().max().item()
                worst = max(worst, err / limit)
                if err > limit:
                    raise AssertionError(f"[int8] dequantized factor off by {err} > {limit}")
    q_bytes, b_bytes = resident_bytes(eng.params), serve_stats["resident_bytes"]
    log(f"[int8] {len(qfs)} factors dequantized on the device within quantization_error_bound "
        f"(worst err / (bound + {DEQUANT_SLACK} max|x|) = {worst:.3f}); resident bytes int8 "
        f"{q_bytes / 1e9:.3f} GB vs bf16 {b_bytes / 1e9:.3f} GB = {q_bytes / b_bytes:.3f}x")
    comps, got, stats = drive_session(torch, session, spec, "[int8]")
    _add_counts(total, got)
    host_ms, dev_ms, state, last = decode_step_ms(torch, session)
    with torch.inference_mode():
        deq_ms = graph_ms(torch, lambda i: dequantize_params(eng.params), 1, 5)
    device_profile(torch, lambda: eng.step(state, last), "[int8] profile", 5)
    same = _same_tokens([c.tokens.tolist() for c in comps], bf16_tokens)
    log(f"[int8] decode step: host {host_ms:.2f} ms (median of 10), device {dev_ms:.3f} ms "
        f"(CUDA graph replay), of which dequantization {deq_ms:.3f} ms = "
        f"{100 * deq_ms / dev_ms:.1f} %; bf16 step device {serve_stats['step_device_ms']:.3f} ms")
    log(f"[int8] greedy tokens identical to the bf16 run: {100 * same:.1f} % "
        f"(not gated: int8 changes the logits)")
    out["int8"] = dict(stats, step_host_ms=host_ms, step_device_ms=dev_ms, dequant_ms=deq_ms,
                       resident_bytes=q_bytes, bf16_resident_bytes=b_bytes,
                       same_tokens_as_bf16=same)
    del session, eng, state, qfs, src
    torch.cuda.empty_cache()

    # 2. rank 128 of r_max 256: served at full width, then rank-sliced
    params128 = with_active_rank(torch, source, 128)
    prompts = [list(range(1, 1 + n)) for n in (5, 23, 64)]
    logits, sliced = {}, {}
    for mode in ("full", "sliced"):
        spec = serve_spec(rank_slice=mode == "sliced")
        session = serve(spec, params=params128, device="cuda")
        eng = session.engine
        if mode == "sliced":
            log(session.describe())
        widths = sorted({f.r_max for f in tree_leaves(eng.params, is_leaf=is_factor)
                         if is_factor(f)})
        logits[mode] = [eng.prefill(p)[0].float() for p in prompts]
        comps, got, stats = drive_session(torch, session, spec, f"[rank-slice {mode}]")
        _add_counts(total, got)
        host_ms, dev_ms, state, last = decode_step_ms(torch, session)
        device_profile(torch, lambda: eng.step(state, last), f"[rank-slice {mode}] profile", 4)
        nbytes = factor_bytes_per_step(eng.params)
        log(f"[rank-slice {mode}] r_max {widths}; decode step factor bytes {nbytes / 1e9:.3f} GB; "
            f"host {host_ms:.2f} ms (median of 10), device {dev_ms:.3f} ms (CUDA graph replay)")
        sliced[mode] = dict(stats, r_max=widths, factor_bytes=nbytes, step_host_ms=host_ms,
                            step_device_ms=dev_ms, tokens=[c.tokens.tolist() for c in comps])
        del session, eng, state
        torch.cuda.empty_cache()
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(logits["sliced"], logits["full"]))
    same = _same_tokens(sliced["sliced"].pop("tokens"), sliced["full"].pop("tokens"))
    ratio = sliced["sliced"]["factor_bytes"] / sliced["full"]["factor_bytes"]
    log(f"[rank-slice] prefill logits sliced vs full width: max |diff| / max |logit| = "
        f"{worst:.3g} (tol {SLICE_LOGIT_RTOL}); greedy tokens identical {100 * same:.1f} %; "
        f"factor bytes {ratio:.3f}x of full width")
    if not worst <= SLICE_LOGIT_RTOL:
        raise AssertionError(f"rank-sliced prefill logits differ by {worst} of max |logit|")
    out["rank_slice"] = dict(sliced, logits_rel_diff=worst, same_tokens=same, bytes_ratio=ratio)
    del params128, logits
    torch.cuda.empty_cache()

    # 3. the materialized dense baseline
    spec = serve_spec(materialize=True)
    flops = {fr: decode_matmul_flops(source, factor_resident=fr) for fr in (True, False)}
    torch.cuda.reset_peak_memory_stats()
    session = serve(spec, params=source, device="cuda")
    eng = session.engine
    del source
    torch.cuda.empty_cache()
    log(session.describe())
    dense_bytes = resident_bytes(eng.params)
    comps, got, stats = drive_session(torch, session, spec, "[materialize]", launches=0)
    _add_counts(total, got)
    host_ms, dev_ms, state, last = decode_step_ms(torch, session)
    device_profile(torch, lambda: eng.step(state, last), "[materialize] profile", 4)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[materialize] resident {dense_bytes / 1e9:.3f} GB; peak "
        f"{peak:.2f} GiB; decode step host {host_ms:.2f} ms (median of 10), device "
        f"{dev_ms:.3f} ms (CUDA graph replay) vs factor-resident bf16 "
        f"{serve_stats['step_device_ms']:.3f} ms")
    log(f"[materialize] decode_matmul_flops per token: factor-resident {flops[True]:.4g}, "
        f"dense {flops[False]:.4g} ({flops[False] / flops[True]:.2f}x)")
    out["materialize"] = dict(stats, resident_bytes=dense_bytes, peak_gib=peak,
                              step_host_ms=host_ms, step_device_ms=dev_ms,
                              flops_factor_resident=flops[True], flops_dense=flops[False])
    del session, eng, state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the models phase: five more architectures at full width
# ---------------------------------------------------------------------------

#: (arch, requests, new tokens) the models phase serves at full width and
#: depth in bf16: OLMoE-1B-7B, the MoE block's path, with the serve phase's
#: 8 requests of 16 new tokens; the other four with 4 requests of 8
#: 8; then the SSM slice's RWKV6-7B and Jamba-1.5-Large (last: its 34 GB
#: of factors), 4 × 8 each
MODELS = (("olmoe-1b-7b", 8, 16), ("deepseek-moe-16b", 4, 8), ("codeqwen1.5-7b", 4, 8),
          ("qwen1.5-32b", 4, 8), ("qwen3-32b", 4, 8), ("rwkv6-7b", 4, 8),
          ("jamba-1.5-large-398b", 4, 8))
#: every factor's bf16 bytes, GB, as planned from ``LowRankPolicy.r_max_for``
#: and the published dimensions before the first run (PERF.md, §6)
PLANNED_FACTOR_GB = {"codeqwen1.5-7b": 1.53, "qwen1.5-32b": 4.76, "qwen3-32b": 4.30,
                     "olmoe-1b-7b": 2.72, "deepseek-moe-16b": 7.46, "rwkv6-7b": 1.38,
                     "jamba-1.5-large-398b": 34.01, "whisper-large-v3": 0.64,
                     "llava-next-mistral-7b": 1.32}
#: OLMoE-1B-7B and RWKV6-7B in f32, kernel path against plain path: logits
#: within this share of max |logit| (f32 sums in other orders through 16 or
#: 32 layers)
MODEL_F32_RTOL = 1e-4
#: an expert choice may differ between the two paths only where the router's
#: k-th and (k+1)-th probabilities are closer than this
FLIP_MARGIN = 1e-5


def model_serve_spec(arch, new_tokens):
    """The models phase's serving spec of ``arch``: bf16 at full width and
    depth, 4 slots, prompts up to 64, continuous batching."""
    from repro_torch.api import ExperimentSpec, ModelSpec, ServeSpec

    return ExperimentSpec(
        name=f"chip-serve-{arch}", seed=0, model=ModelSpec(arch=arch),
        serve=ServeSpec(max_batch=4, max_prompt=64, prompt_bucket=16,
                        max_new_tokens=new_tokens, mode="continuous"),
    )


def factor_bytes(params) -> int:
    """Bytes of every factor leaf's U, S and V."""
    from repro_torch.core.factorization import is_factor
    from repro_torch.utils.tree import tree_leaves

    return sum(t.numel() * t.element_size() for f in tree_leaves(params, is_leaf=is_factor)
               if is_factor(f) for t in (f.U, f.S, f.V))


def topk_margin(torch, probs, k):
    """Per token: its k-th router probability less its (k+1)-th."""
    ranked = torch.sort(probs, dim=-1, descending=True).values
    return ranked[:, k - 1] - ranked[:, k]


def capacity_drops(torch, decode, n_tokens, top_k, n_layers):
    """(token, expert) assignments the capacity dropped in each decode
    step, summed over its ``n_layers`` MoE calls: ``decode`` holds the
    routings of the decode steps' calls, in order, ``n_tokens`` each."""
    if not decode or len(decode) % n_layers or {r.probs.shape[0] for r in decode} != {n_tokens}:
        raise AssertionError(f"{len(decode)} decode-shaped MoE calls, not a multiple of "
                             f"{n_layers} layers")
    kept = torch.stack([(r.w_taken > 0).sum() for r in decode]).view(-1, n_layers)
    return (n_tokens * top_k - kept).sum(dim=1).tolist()


def routing_flips(torch, routed, ref_routed, top_k, n_layers):
    """The tokens whose chosen expert set differs between two runs' MoE
    calls (a prefill's ``n_layers`` calls, then a decode step's), as
    (prefill or decode, layer, token, the reference's top-k margin), and
    the smallest margin of the reference's calls."""
    smallest, flips = float("inf"), []
    for i, (r, ref) in enumerate(zip(routed, ref_routed, strict=True)):
        margin = topk_margin(torch, ref.probs, top_k)
        smallest = min(smallest, margin.min().item())
        differ = (torch.sort(r.topi, -1).values != torch.sort(ref.topi, -1).values).any(-1)
        for t in torch.nonzero(differ).flatten().tolist():
            flips.append(("prefill" if i < n_layers else "decode", i % n_layers, t,
                          margin[t].item()))
    return flips, smallest


@contextlib.contextmanager
def calls_of(module, name, record):
    """``module.name`` wrapped for the body of the ``with``:
    ``record(args, result)`` after each call (the call itself unchanged)."""
    fn = getattr(module, name)

    def wrapped(*args):
        out = fn(*args)
        record(args, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def path_shape(kernel, args):
    """(kernel, dtype, K or N, R, G, M) of one ``xus(x, U, S)`` or
    ``avt(A, V)`` call."""
    a, w = args[0], args[1]
    G = a.shape[0] if a.dim() == 3 else 1
    return (kernel, str(a.dtype).removeprefix("torch."), w.shape[-2], w.shape[-1], G,
            a.shape[-2])


@contextlib.contextmanager
def path_calls(routings, shapes):
    """For the body: every MoE block's :class:`Routing` appended to
    ``routings`` and the :func:`path_shape` of every ``xus`` / ``avt`` call
    of the kernel chain added to ``shapes``."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    with calls_of(moe, "route", lambda _, r: routings.append(r)), \
            calls_of(ops, "xus", lambda a, _: shapes.add(path_shape("xus", a))), \
            calls_of(ops, "avt", lambda a, _: shapes.add(path_shape("avt", a))):
        yield


def phase_models(torch, counters, records):
    """The architectures beyond Qwen2-7B (CodeQwen1.5-7B, Qwen1.5-32B,
    Qwen3-32B, OLMoE-1B-7B, DeepSeekMoE-16B; RWKV6-7B and
    Jamba-1.5-Large, whose recurrent blocks prefill each prompt at its true
    length), at full width and depth in bf16 (fresh seeded weights):

    - each model served through ``repro_torch.api.serve``, one session at a
      time: launches per forward held to :func:`decode_step_calls`, the
      shapes its ``xus`` / ``avt`` calls took recorded (decode at 4 rows, or
      cap = 1 row an expert of a G = E stack; prefill at one prompt's
      bucket of 16–64 rows, its experts at that bucket's capacity, the LM
      head at 1 row),
      resident and factor bytes against the plan, tok/s, p50/p99, the
      decode step's host and device ms, a repeated step and prefill held
      bit-identical, and for the MoE models the assignments the capacity
      dropped per decode step (a reading);
    - each recorded shape the kernels phase did not cover, against its
      plain version with its times and bound (K 4096 / 5120 / 8192, N
      13440 / 25600 / 27392 / 8192, the experts' G = 64 stacks at R 128
      and 176; Mamba's d_inner 16384 projections, its x_proj at R 72 and
      dt_proj at K 512, Jamba's G = 16 expert stacks);
    - OLMoE-1B-7B's and RWKV6-7B's f32 checks (:func:`olmoe_f32_check`,
      :func:`greedy_f32_check`).

    Returns (kernel records, stats)."""
    import numpy as np

    from repro_torch.api import serve
    from repro_torch.serve import resident_bytes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    have = {(r["kernel"], r["dtype"], r["dim"], r["R"], r["G"], r["M"]) for r in records}
    model_records = []
    counters["models"] = total = {}
    stats = {}
    for arch, n_requests, new in MODELS:
        spec = model_serve_spec(arch, new)
        tag = f"[models {arch}]"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        session = serve(spec, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        eng = session.engine
        cfg = eng.model.cfg
        mixers = "+".join(sorted(set(cfg.block_pattern)))
        log(f"{tag} built ({cfg.num_layers} layers, d {cfg.d_model}, {cfg.compute_dtype}, "
            f"{mixers}, {'MoE' if cfg.moe else 'dense'}, prefill at "
            f"{'the true length' if eng.exact_prefill else 'buckets'}) in {build_s:.1f} s")
        log(session.describe())
        pf = per_forward(cfg)
        # the path: counts at 0 just before, read just after (drive_session);
        # the MoE calls of the decode steps kept apart from the prefills'
        routings, shapes, decode_routings = [], set(), []
        step_fn = eng.step

        def marked_step(state, last, step_fn=step_fn, routings=routings,
                        decode_routings=decode_routings):
            n0 = len(routings)
            out = step_fn(state, last)
            decode_routings.extend(routings[n0:])
            return out

        eng.step = marked_step
        with path_calls(routings, shapes):
            _, got, st = drive_session(torch, session, spec, tag, n_requests=n_requests)
        eng.step = step_fn
        _add_counts(total, got)
        if {sh[:5] for sh in shapes} != set(decode_step_calls(cfg)):
            raise AssertionError(f"{tag}: the path's (kernel, dtype, K or N, R, G) differ from "
                                 f"decode_step_calls: {sorted(shapes)}")
        rows = {}
        for kernel, _dt, _dim, _R, G, M in shapes:
            rows.setdefault("experts" if G > 1 else "G=1", set()).add(M)
        log(f"{tag} the path's xus / avt shapes: {len(shapes)}; rows M "
            + "; ".join(f"{k} {sorted(v)}" for k, v in sorted(rows.items())))
        host_ms, dev_ms, state, last = decode_step_ms(torch, session)
        # the same step and the same prefill again: the same bits
        step_a, step_b = eng.step(state, last)[0], eng.step(state, last)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre_a = eng.prefill(np.arange(3, 40))[0]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pre_b = eng.prefill(np.arange(3, 40))[0]
        if not (torch.equal(step_a, step_b) and torch.equal(pre_a, pre_b)):
            raise AssertionError(f"{tag}: a repeated decode step or prefill changed the logits")
        dispatches = count_dispatches(torch, lambda: eng.step(state, last))
        log(f"{tag} ATen dispatches in one decode step: {dispatches} (plus {2 * pf} ctypes "
            f"kernel calls); a 37-token prefill: host {prefill_ms:.2f} ms (at "
            f"{eng.bucket_len(37)} tokens)")
        if cfg.moe is not None or eng.exact_prefill:  # where the decode step's device time goes
            n, busy_s, _ = device_profile(torch, lambda: eng.step(state, last),
                                          f"{tag} profile", 8)
            log(f"{tag} profile: one decode step, {n} kernels, device busy "
                f"{busy_s * 1e3:.3f} ms")
        prefill_dev_ms = None
        if eng.exact_prefill:  # the recurrent models: the prefill's device time too
            n, busy_s, _ = device_profile(torch, lambda: eng.prefill(np.arange(3, 40)),
                                          f"{tag} prefill profile", 5)
            prefill_dev_ms = busy_s * 1e3
            log(f"{tag} a 37-token prefill: host {prefill_ms:.2f} ms, {n} kernels, device busy "
                f"{prefill_dev_ms:.3f} ms")
        res, fb = resident_bytes(eng.params), factor_bytes(eng.params)
        step_bytes = factor_bytes_per_step(eng.params)
        floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        planned = PLANNED_FACTOR_GB[arch]
        log(f"{tag} resident {res / 1e9:.3f} GB, of it factors {fb / 1e9:.3f} GB against "
            f"{planned} GB planned ({fb / 1e9 / planned:.3f}x); peak {peak:.2f} GiB")
        log(f"{tag} decode step: host {host_ms:.2f} ms (median of 10), device {dev_ms:.3f} ms "
            f"(CUDA graph replay); floor {floor_ms:.3f} ms = {step_bytes / 1e9:.3f} GB of "
            f"factors / 3.35 TB/s; device idle {100 * (1 - dev_ms / host_ms):.1f} % of the "
            f"eager step; {pf} xus + {pf} avt launches a forward; a repeated step and prefill "
            f"bit-identical")
        rec = dict(st, layers=cfg.num_layers, build_s=build_s, resident_bytes=res,
                   factor_bytes=fb, planned_factor_gb=planned, step_factor_bytes=step_bytes,
                   floor_ms=floor_ms, step_host_ms=host_ms, step_device_ms=dev_ms,
                   peak_gib=peak, per_forward=pf, aten_dispatches=dispatches, launches=got,
                   prefill37_host_ms=prefill_ms, prefill37_device_ms=prefill_dev_ms)
        if cfg.moe is not None:
            m = cfg.moe
            n_moe = cfg.superblocks * sum(map(cfg.moe_on_layer, range(len(cfg.block_pattern))))
            drops = capacity_drops(torch, decode_routings, eng.max_batch, m.top_k, n_moe)
            n = eng.max_batch * m.top_k * n_moe
            log(f"{tag} capacity factor {m.capacity_factor} (cap 1 a decode step): "
                f"(token, expert) assignments dropped per decode step, of {n}: mean "
                f"{np.mean(drops):.2f}, min {min(drops)}, max {max(drops)} over {len(drops)} "
                f"steps (a reading, not a gate)")
            rec["capacity_drops"] = dict(assignments=n, mean=float(np.mean(drops)),
                                         min=min(drops), max=max(drops), steps=len(drops))
        stats[arch] = rec
        del session, eng, state, routings, decode_routings, step_a, step_b, pre_a, pre_b
        torch.cuda.empty_cache()
        # each shape the path gave the kernels, against its plain version
        for kernel, dtype, dim, R, G, M in sorted(shapes - have):
            model_records.append(kernel_case(torch, kernel, dtype, M, dim, R, gen, G=G))
        have |= shapes
        _check_records(model_records)
        torch.cuda.empty_cache()
    stats["olmoe-1b-7b f32"] = olmoe_f32_check(torch)
    stats["rwkv6-7b f32"] = greedy_f32_check(torch, "rwkv6-7b", 3)
    stats["jamba mamba scan"] = mamba_scan_check(torch)
    return model_records, stats


#: the Mamba state-scan check: Jamba-1.5-Large at full width cut to one
#: 8-layer superblock (7 Mamba layers, one attention layer, MoE on every
#: other layer), fresh weights; prompts of 37 tokens (one chunk of the scan)
#: and 1,100 (two whole 512-step chunks and a ragged one of 76), 2 rows
#: each, then 8 greedy decode steps
MAMBA_CHECK_LAYERS = 8
MAMBA_CHECK_T = (37, 1100)
MAMBA_CHECK_STEPS = 8
#: one full-width Mamba mixer in bf16, the chunked doubling scan against the
#: token-by-token loop: output and new state within this share of their
#: largest entry (both round every step's state to bf16, in other orders)
MAMBA_BF16_RTOL = 5e-2
#: the 8-layer model's bf16 prefill logits, scan against loop, within this
#: share of max |logit|: a bf16 difference in a Mamba layer's output moves
#: the MoE routers whose top-2 margin is under it, and a token whose expert
#: choice flips gets another expert's output (on an H100 the 8-layer model
#: read 0.021-0.091 over 37-1,100 tokens, with 3-5 % of its expert choices
#: flipped). Its greedy tokens follow those flips, so they are held
#: identical in f32 (within ``MODEL_F32_RTOL``), where no router flips.
MAMBA_MODEL_RTOL = 0.15


def _mamba_prefill(torch, model, params, tokens, order):
    """A prefill of ``tokens`` and 8 greedy decode steps under ``order``
    (the scan, or the loop patched in): the prefill's logits, the greedy
    tokens and the MoE routings of the prefill."""
    routed = []
    with torch.inference_mode(), order:
        with path_calls(routed, set()):
            pre, cache = model.serve_prefill(params, {"tokens": tokens},
                                             cache_len=tokens.shape[1] + MAMBA_CHECK_STEPS)
        greedy = [pre.argmax(-1)]
        for _ in range(MAMBA_CHECK_STEPS):
            logits, cache = model.serve_step(params, cache, greedy[-1][:, None])
            greedy.append(logits.argmax(-1))
    if not bool(torch.isfinite(pre).all()):
        raise AssertionError("[models jamba mamba scan] prefill logits are not finite")
    return dict(logits=pre.float(), tokens=torch.stack(greedy, 1), routed=routed)


def mamba_scan_check(torch):
    """The serving prefill's Mamba state branch (the chunked doubling scan
    from the given state) against the token-by-token loop it replaced
    (``ssm._stepped_recurrence`` in ``linear_recurrence``'s place), on the
    same weights and inputs, at full width:

    - layer 0's Mamba mixer in bf16 from a random state over 2 x 1,100
      tokens: output and new ``h`` within ``MAMBA_BF16_RTOL`` of their
      largest entry; the host ms of each (second calls);
    - the 8-layer model's prefill at each of ``MAMBA_CHECK_T``, in bf16:
      logits within ``MAMBA_MODEL_RTOL`` of max |logit|, with the expert
      choices that flipped, the greedy tokens that agree (readings), and
      the prefill's host and device ms both ways; in f32 (the same weights):
      logits within ``MODEL_F32_RTOL``, the prefill's and 8 decode steps'
      greedy tokens identical."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, ssm
    from repro_torch.models.transformer import _layer
    from repro_torch.utils.tree import tree_map

    tag = "[models jamba mamba scan]"
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), num_layers=MAMBA_CHECK_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    with torch.inference_mode():
        params, _ = model.init(gen)
    stepped = lambda: unittest.mock.patch.object(  # noqa: E731
        ssm, "linear_recurrence", ssm._stepped_recurrence)
    orders = (("scan", contextlib.nullcontext), ("steps", stepped))
    out = {}

    # one mixer: no router downstream, the scan's own bf16 difference
    p = _layer(params["blocks"]["pos0"]["mamba"], 0)
    T = MAMBA_CHECK_T[-1]
    with torch.inference_mode():
        x = torch.randn((2, T, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        state = {k: 0.3 * torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype)
                 for k, v in ssm.mamba_init_state(cfg, 2, torch.bfloat16, "cuda").items()}
        mix = {}
        for name, order in orders:
            with order():
                for _ in range(2):  # the second call timed
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y, new = ssm.mamba_mix(p, x, cfg, state=state)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
            mix[name] = (y.float(), new["h"], ms)
    rel = [((mix["scan"][i] - mix["steps"][i]).abs().max() / mix["steps"][i].abs().max()).item()
           for i in (0, 1)]
    log(f"{tag} one Mamba mixer (d_inner {2 * cfg.d_model}), 2 x {T} tokens from a random "
        f"state, bf16: max |scan - steps| / max of the output {rel[0]:.3g}, of the new h "
        f"{rel[1]:.3g} (tol {MAMBA_BF16_RTOL}); host {mix['scan'][2]:.1f} ms (scan) vs "
        f"{mix['steps'][2]:.1f} ms (token by token)")
    if not max(rel) <= MAMBA_BF16_RTOL:
        raise AssertionError(f"{tag}: the mixer's scan differs from the loop by {rel} "
                             f"(> {MAMBA_BF16_RTOL})")
    out["mixer"] = dict(tokens=T, out_rel_err=rel[0], h_rel_err=rel[1], scan_ms=mix["scan"][2],
                        steps_ms=mix["steps"][2])
    del x, state, mix, y, new

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")
    with torch.inference_mode():
        params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    models = (("bfloat16", model, params, MAMBA_MODEL_RTOL),
              ("float32", build_model(cfg32), params32, MODEL_F32_RTOL))
    k, n_moe = cfg.moe.top_k, sum(map(cfg.moe_on_layer, range(len(cfg.block_pattern))))
    for T in MAMBA_CHECK_T:
        tokens = torch.randint(1, cfg.vocab_size, (2, T), generator=gen, device="cuda")
        for dtype, m, prm, rtol in models:
            a, b = (_mamba_prefill(torch, m, prm, tokens, order()) for _, order in orders)
            err = ((a["logits"] - b["logits"]).abs().max() / b["logits"].abs().max()).item()
            same = (a["tokens"] == b["tokens"]).all(0)
            decode_same = int(same[1:].cumprod(0).sum())
            flips, _ = routing_flips(torch, a["routed"], b["routed"], k, n_moe)
            log(f"{tag} {MAMBA_CHECK_LAYERS} layers, {dtype}, 2 x {T} tokens: max |logits(scan) "
                f"- logits(steps)| / max |logit| = {err:.3g} (tol {rtol}); expert choices "
                f"flipped in the prefill: {len(flips)} of {2 * T * n_moe} (token, layer); the "
                f"prefill's greedy tokens {'the same' if bool(same[0]) else 'differ'}, decode "
                f"steps the same before the first difference: {decode_same} of "
                f"{MAMBA_CHECK_STEPS}")
            if not err <= rtol:
                raise AssertionError(f"{tag} {dtype} T {T}: prefill logits differ by {err} of "
                                     f"max |logit| (> {rtol})")
            if dtype == "float32" and not bool(same.all()):
                raise AssertionError(f"{tag} f32 T {T}: greedy tokens differ: "
                                     f"{a['tokens'].tolist()} vs {b['tokens'].tolist()}")
            rec = dict(rel_err=err, flips=len(flips), prefill_token_same=bool(same[0]),
                       decode_same=decode_same)
            if dtype == "bfloat16":  # the prefill's cost both ways
                for name, order in orders:
                    with torch.inference_mode(), order():
                        n, busy_s, wall = device_profile(
                            torch, lambda: m.serve_prefill(prm, {"tokens": tokens},
                                                           cache_len=T + MAMBA_CHECK_STEPS),
                            f"{tag} {name}", 0)
                    rec[f"{name}_host_ms"], rec[f"{name}_device_ms"] = wall * 1e3, busy_s * 1e3
                log(f"{tag} {dtype} 2 x {T}-token prefill: host {rec['scan_host_ms']:.1f} ms, "
                    f"device busy {rec['scan_device_ms']:.1f} ms (scan); host "
                    f"{rec['steps_host_ms']:.1f} ms, device busy {rec['steps_device_ms']:.1f} ms "
                    f"(token by token), under the profiler")
            out[f"{dtype}_T{T}"] = rec
            del a, b
    del params, params32, models
    torch.cuda.empty_cache()
    return out


def f32_runs(torch, arch, seed):
    """``arch`` at full width and depth in f32, fresh weights from ``seed``:
    one 37-token prefill and one decode step (the prefill's greedy token)
    on the kernel path and on the plain path (``kernels="off"``), on the
    same weights and tokens (an encoder-decoder model's prefill over
    seeded stub frames). Returns (config, {"kernels" | "plain": {"logits":
    (prefill, decode), "routed": the MoE calls' routings}})."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32", param_dtype="float32")
    models = {"kernels": build_model(cfg),
              "plain": build_model(dataclasses.replace(cfg, kernels="off"))}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with torch.inference_mode():
        params, _ = models["kernels"].init(gen)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, 37), generator=gen, device="cuda")}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((1, cfg.encoder.num_frames, cfg.d_model), generator=gen,
                                      device="cuda")
    runs, tok = {}, None
    for name, model in models.items():
        routed = []
        with torch.inference_mode(), path_calls(routed, set()):
            pre, cache = model.serve_prefill(params, batch, cache_len=48)
            if tok is None:
                tok = pre.argmax(-1)[:, None]
            step, _ = model.serve_step(params, cache, tok)
        runs[name] = dict(logits=(pre, step), routed=routed)
        del cache
    del params
    torch.cuda.synchronize()
    return cfg, runs


def olmoe_f32_check(torch):
    """OLMoE-1B-7B at full width and depth in f32, :func:`f32_runs`. Logits
    within ``MODEL_F32_RTOL`` of max |logit|; every layer's expert choices
    the same, except where the plain path's top-k margin is under
    ``FLIP_MARGIN`` (each such flip printed); the smallest margin printed.
    """
    cfg, runs = f32_runs(torch, "olmoe-1b-7b", 2)
    k = cfg.moe.top_k
    errs = []
    pairs = zip(("prefill", "decode"), runs["kernels"]["logits"], runs["plain"]["logits"])
    for what, a, b in pairs:
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[models f32] {what} logits are not finite")
        errs.append(((a - b).abs().max() / b.abs().max()).item())
        log(f"[models f32] olmoe-1b-7b {what}: max |logits(kernels) - logits(off)| / "
            f"max |logit| = {errs[-1]:.3g} (tol {MODEL_F32_RTOL})")
    if len(runs["kernels"]["routed"]) != 2 * cfg.num_layers:
        raise AssertionError(f"[models f32] {len(runs['kernels']['routed'])} MoE calls, "
                             f"expected {2 * cfg.num_layers}")
    flips, smallest = routing_flips(torch, runs["kernels"]["routed"], runs["plain"]["routed"],
                                    k, cfg.num_layers)
    for what, layer, t, margin in flips:
        log(f"[models f32] expert choice flipped: {what} layer {layer} token {t}, top-k "
            f"margin {margin:.3g}")
    log(f"[models f32] expert choices: {len(flips)} flip(s) over {2 * cfg.num_layers} MoE "
        f"calls; smallest top-k margin {smallest:.3g} (a flip is allowed under {FLIP_MARGIN})")
    if any(m >= FLIP_MARGIN for *_, m in flips):
        raise AssertionError(f"[models f32] expert choices differ at a margin >= {FLIP_MARGIN}: "
                             f"{flips}")
    if not max(errs) <= MODEL_F32_RTOL:
        raise AssertionError(f"[models f32] kernel-path logits differ from the plain path's by "
                             f"{max(errs)} of max |logit| (> {MODEL_F32_RTOL})")
    del runs
    torch.cuda.empty_cache()
    return dict(prefill_rel_err=errs[0], decode_rel_err=errs[1], flips=len(flips),
                smallest_margin=smallest)


def greedy_f32_check(torch, arch, seed, tag="[models f32]"):
    """``arch`` at full width and depth in f32 (RWKV6-7B ~2.8 GB),
    :func:`f32_runs`: logits within ``MODEL_F32_RTOL`` of max |logit|, and
    the greedy token of each the same."""
    _, runs = f32_runs(torch, arch, seed)
    errs = []
    for what, a, b in zip(("prefill", "decode"), runs["kernels"]["logits"],
                          runs["plain"]["logits"]):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} {arch} {what} logits are not finite")
        errs.append(((a - b).abs().max() / b.abs().max()).item())
        same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
        log(f"{tag} {arch} {what}: max |logits(kernels) - logits(off)| / max |logit| "
            f"= {errs[-1]:.3g} (tol {MODEL_F32_RTOL}); greedy token "
            f"{'the same' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"{tag} {arch} {what}: the greedy token differs")
    if not max(errs) <= MODEL_F32_RTOL:
        raise AssertionError(f"{tag} {arch} kernel-path logits differ from the plain "
                             f"path's by {max(errs)} of max |logit| (> {MODEL_F32_RTOL})")
    del runs
    torch.cuda.empty_cache()
    return dict(prefill_rel_err=errs[0], decode_rel_err=errs[1])


# ---------------------------------------------------------------------------
# the encoder-decoder and VLM phase: Whisper-large-v3, LLaVA-NeXT-Mistral-7B
# ---------------------------------------------------------------------------

#: (path, arch, rows, prompt tokens, cache slots or 0 for prompt + steps):
#: Whisper-large-v3 over 4 rows of 1500 stub frames; LLaVA-NeXT-Mistral-7B
#: over 2 rows of 2880 stub vision tokens, its cache at the 4096-slot window
#: (the attention layer refuses a smaller one)
ENCDEC_VLM = (("encdec", "whisper-large-v3", 4, 16, 0),
              ("vlm", "llava-next-mistral-7b", 2, 32, 4096))
#: greedy decode steps after each prefill
ENCDEC_VLM_STEPS = 8


def stub_batch(torch, cfg, rows, prompt, gen):
    """A prompt of ``prompt`` seeded tokens a row and the stub frontend's
    output, made on the device from ``gen``: Whisper's frame embeddings or
    LLaVA's vision embeddings, f32 as the JAX package's input specs give
    them."""
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (rows, prompt), generator=gen,
                                     device="cuda")}
    name, n = (("frames", cfg.encoder.num_frames) if cfg.is_encdec
               else ("vision_embeds", cfg.vision_tokens))
    batch[name] = torch.randn((rows, n, cfg.d_model), generator=gen, device="cuda")
    return batch


def shape_sums(name, counts, records):
    """``name``'s measured numbers summed over ``counts`` ((kernel, dtype, K
    or N, R, G, M) → calls), each call at its shape's record, with what
    bounds them."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for key, n in counts.items():
        if key[0] != name:
            continue
        [rec] = [r for r in records
                 if (r["kernel"], r["dtype"], r["dim"], r["R"], r["G"], r["M"]) == key]
        for k in tot:
            tot[k] += n * rec[k]
        bound_by.add(rec["bound_by"])
    return dict(tot, calls=sum(n for key, n in counts.items() if key[0] == name),
                bound_by="bytes" if bound_by == {"bytes"} else "operations")


def _refusal(what, fn, match):
    """``fn()`` must raise the ValueError the JAX package raises there."""
    try:
        fn()
    except ValueError as e:
        if match not in str(e):
            raise
        log(f"{what}: refused, as in the JAX package: {e}")
        return
    raise AssertionError(f"{what}: not refused")


def phase_encdec_vlm(torch, counters, records):
    """The encoder-decoder and VLM families at full width and depth in bf16
    (fresh seeded weights; stub frontends, as in the JAX package), one path
    each, through the model's own entry points (the serving engine refuses
    an enc-dec model, and serves a VLM text-only):

    - Whisper-large-v3 (path ``encdec``): 4 rows of 1500 frames, a 16-token
      prompt, ``serve_prefill`` (the 32-layer encoder, then the decoder),
      8 greedy ``serve_step``s on the shared-position cache, each
      re-projecting the encoder's states through every layer's ``xk`` /
      ``xv`` (M = 6000);
    - LLaVA-NeXT-Mistral-7B (path ``vlm``): 2 rows of 2880 vision tokens and
      a 32-token prompt, prefilled (M = 5824) into a 4096-slot cache, then
      8 greedy steps.

    Each: counts at 0 just before the path and read just after, ``xus`` and
    ``avt`` held to :func:`decode_step_calls` (the prefill with the
    encoder's projections) and the shapes they took recorded; build s,
    factor GB against the plan, the prefill's host ms (Whisper's with its
    encoder), the decode step's host and device ms (CUDA graph replay) and
    idle share, tok/s, peak memory and the factor-byte floor; a repeated
    step and prefill bit-identical; the engine's refusals (Whisper: enc-dec;
    LLaVA at the engine's default 96-slot cache: smaller than the window).
    Then each new path shape against its plain version, and Whisper in f32,
    kernel path against plain. Returns (kernel records, stats, per-model
    ``xus`` / ``avt`` sums over a decode step and a prefill)."""
    import collections

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    have = {(r["kernel"], r["dtype"], r["dim"], r["R"], r["G"], r["M"]) for r in records}
    new_records, stats, shapes_of = [], {}, {}
    steps = ENCDEC_VLM_STEPS
    for path, arch, rows, prompt, cache_len in ENCDEC_VLM:
        tag = f"[{path} {arch}]"
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg)
        wgen = torch.Generator(device="cuda")
        wgen.manual_seed(0)
        with torch.inference_mode():
            params, _ = model.init(wgen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        stub = "frames" if cfg.is_encdec else "vision tokens"
        n_stub = cfg.encoder.num_frames if cfg.is_encdec else cfg.vision_tokens
        log(f"{tag} built ({cfg.num_layers} decoder layers"
            + (f" + {cfg.encoder.num_layers} encoder layers" if cfg.is_encdec else "")
            + f", d {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv, "
            f"{cfg.compute_dtype}) in {build_s:.1f} s; {rows} rows x ({n_stub} {stub} + "
            f"{prompt} tokens), then {steps} greedy steps")
        if cfg.is_encdec:
            _refusal(f"{tag} ServeEngine", lambda: ServeEngine(model, params), "enc-dec")
        else:
            eng = ServeEngine(model, params)
            _refusal(f"{tag} ServeEngine at its defaults ({eng.cache_len} cache slots), "
                     f"prefill", lambda: eng.prefill(np.arange(1, 9)), "attention window")
            del eng
        batch = stub_batch(torch, cfg, rows, prompt, gen)
        cache_len = cache_len or prompt + steps
        pre_calls, step_want = decode_step_calls(cfg, encoder=True), decode_step_calls(cfg)
        per_prefill, per_step = (sum(n for (k, *_), n in c.items() if k == "xus")
                                 for c in (pre_calls, step_want))

        # the path: counts at 0 just before, read just after
        calls = []
        with torch.inference_mode(), \
                calls_of(ops, "xus", lambda a, _: calls.append(path_shape("xus", a))), \
                calls_of(ops, "avt", lambda a, _: calls.append(path_shape("avt", a))):
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.serve_prefill(params, batch, cache_len=cache_len)
            n_pre = len(calls)
            outs = [logits]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(steps):
                logits, cache = model.serve_step(params, cache, logits.argmax(-1)[:, None])
                outs.append(logits)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            got = _launch_counts()
        counters[path] = got
        tokens = torch.stack([o.argmax(-1) for o in outs], dim=1)
        if not bool(torch.stack([torch.isfinite(o).all() for o in outs]).all()):
            raise AssertionError(f"{tag}: NaN/inf logits on the path")
        if tuple(tokens.shape) != (rows, steps + 1):
            raise AssertionError(f"{tag}: tokens {tuple(tokens.shape)}")
        want = per_prefill + steps * per_step
        for name in ("xus", "avt"):
            if got[name] != want:
                raise AssertionError(f"{tag} {name}: {got[name]} launches, expected "
                                     f"{per_prefill} (prefill) + {steps} x {per_step} = {want}")
        if got["atb"] or got["flash_attention"]:
            raise AssertionError(f"{tag}: the forward launched atb / flash_attention: {got}")
        pre_counts = collections.Counter(calls[:n_pre])
        step_counts = collections.Counter(calls[n_pre:])
        for what, counts, expect, n in (("prefill", pre_counts, pre_calls, 1),
                                        ("decode step", step_counts, step_want, steps)):
            by_key = collections.Counter()
            for key, c in counts.items():
                by_key[key[:5]] += c
            if dict(by_key) != {k: n * v for k, v in expect.items()}:
                raise AssertionError(f"{tag}: the {what}'s (kernel, dtype, K or N, R, G) calls "
                                     f"differ from decode_step_calls: {sorted(by_key.items())}")
        step_counts = collections.Counter({k: c / steps for k, c in step_counts.items()})
        shapes = set(calls)
        log(f"{tag} launches: xus {got['xus']}, avt {got['avt']} = {per_prefill} per prefill + "
            f"{steps} x {per_step} per decode step; the path's xus / avt shapes: {len(shapes)}, "
            f"rows M {sorted({sh[5] for sh in shapes})}; greedy tokens of row 0: "
            f"{tokens[0].tolist()}")
        prefill_path_ms, step_path_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3 / steps

        # the prefill and a step again: host ms, the same bits
        with torch.inference_mode():
            pre, host = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pre.append(model.serve_prefill(params, batch, cache_len=cache_len)[0])
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t0)
            prefill_ms = min(host) * 1e3
            tok = tokens[:, -1:].contiguous()
            step_a = model.serve_step(params, cache, tok)[0]
            step_b = model.serve_step(params, cache, tok)[0]
            if not (torch.equal(pre[0], pre[1]) and torch.equal(pre[0], outs[0])
                    and torch.equal(step_a, step_b)):
                raise AssertionError(f"{tag}: a repeated decode step or prefill changed the "
                                     f"logits")
            host = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.serve_step(params, cache, tok)
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t0)
            step_host_ms = float(np.median(host) * 1e3)
            step_dev_ms = graph_ms(torch, lambda i: model.serve_step(params, cache, tok), 1, 5)
            dispatches = count_dispatches(torch, lambda: model.serve_step(params, cache, tok))
            n_k, busy_s, _ = device_profile(torch, lambda: model.serve_step(params, cache, tok),
                                            f"{tag} profile", 8)
        fb, step_bytes = factor_bytes(params), factor_bytes_per_step(params)
        floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        planned = PLANNED_FACTOR_GB[arch]
        tok_s = rows * steps / (t2 - t1)
        log(f"{tag} factors {fb / 1e9:.3f} GB against {planned} GB planned "
            f"({fb / 1e9 / planned:.3f}x); peak {peak:.2f} GiB")
        log(f"{tag} prefill: host {prefill_ms:.2f} ms (best of 2; {prefill_path_ms:.2f} ms on "
            f"the path{', the encoder included' if cfg.is_encdec else ''}); decode: "
            f"{tok_s:.2f} tok/s over the path's {steps} steps ({step_path_ms:.2f} ms a step)")
        extra = ""
        if cfg.is_encdec:  # the step re-projects the encoder's states through xk / xv
            M = rows * cfg.encoder.num_frames
            d, kv = cfg.d_model, cfg.num_kv_heads * cfg.hd
            r = cfg.lowrank.r_max_for(d, kv)
            flops = 2 * cfg.num_layers * (2 * M * d * r + 2 * M * r * r + 2 * M * kv * r)
            extra = (f"; the cross K/V re-projection {flops / 1e9:.1f} GFLOP a step, "
                     f"{flops / PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms at the bf16 peak")
        log(f"{tag} decode step: host {step_host_ms:.2f} ms (median of 10), device "
            f"{step_dev_ms:.3f} ms (CUDA graph replay); floor {floor_ms:.3f} ms = "
            f"{step_bytes / 1e9:.3f} GB of factors / 3.35 TB/s{extra}; device idle "
            f"{100 * (1 - step_dev_ms / step_host_ms):.1f} % of the eager step; profile "
            f"{n_k} kernels, busy {busy_s * 1e3:.3f} ms; {dispatches} ATen dispatches; a "
            f"repeated step and prefill bit-identical")
        stats[arch] = dict(rows=rows, prompt=prompt, cache_len=cache_len, build_s=build_s,
                           factor_bytes=fb, planned_factor_gb=planned, peak_gib=peak,
                           prefill_host_ms=prefill_ms, prefill_path_ms=prefill_path_ms,
                           step_host_ms=step_host_ms, step_device_ms=step_dev_ms,
                           step_path_ms=step_path_ms, tok_s=tok_s, floor_ms=floor_ms,
                           step_factor_bytes=step_bytes, aten_dispatches=dispatches,
                           busy_ms=busy_s * 1e3, per_prefill=per_prefill, per_step=per_step,
                           launches=got)
        shapes_of[arch] = (pre_counts, step_counts)
        del model, params, cache, batch, outs, pre, step_a, step_b, logits
        torch.cuda.empty_cache()
        # each shape the path gave the kernels, against its plain version
        for kernel, dtype, dim, R, G, M in sorted(shapes - have):
            new_records.append(kernel_case(torch, kernel, dtype, M, dim, R, gen, G=G))
        have |= shapes
        _check_records(new_records)
        torch.cuda.empty_cache()
    stats["whisper-large-v3 f32"] = greedy_f32_check(torch, "whisper-large-v3", 5,
                                                     tag="[encdec f32]")
    every = records + new_records
    sums = {arch: {name: dict(shape_sums(name, step_counts, every),
                              prefill=shape_sums(name, pre_counts, every))
                   for name in ("xus", "avt")}
            for arch, (pre_counts, step_counts) in shapes_of.items()}
    return new_records, stats, sums


# ---------------------------------------------------------------------------
# the training path: atb, the backward, FeDLRT rounds
# ---------------------------------------------------------------------------

#: atb tolerance in f32, relative to the largest |C|: the sums of up to 8192
#: products are taken in another order than the plain version's, so the
#: error scales with the sum's magnitude, not with each entry's
ATB_F32_RTOL = 1e-4


def atb_shapes():
    """(model, M values, Ka, Kb) of every ``atb`` call of the training path.

    llm-100m (d = 640, d_ff = 2560, vocab 8192, r = 160, augmented 320):
    dS 160² in the basis-gradient pass (and the embedding's coefficient
    slot), dS 320² in the client loop, dU / dV with Ka = n_in / n_out. Also
    Qwen2-7B's (d = 3584, d_ff = 18944, vocab 152064, r = 256, k/v 64), for
    the slice that trains it: basis pass Kb in {256, 64}, client loop 512 /
    128, Ka up to the vocab.
    """
    llm = [(160, 160), (320, 320), (640, 160), (2560, 160), (8192, 160)]
    qwen = [(256, 256), (64, 64), (512, 512), (128, 128), (3584, 256), (3584, 64),
            (18944, 256), (512, 64), (152064, 256)]
    return ([("llm-100m", (512, 8192), ka, kb) for ka, kb in llm]
            + [("qwen2-7b", (512,), ka, kb) for ka, kb in qwen])


def _atb_bound_ms(dtype_name, M, Ka, Kb):
    es = 2 if dtype_name == "bfloat16" else 4
    nbytes = (M * Ka + M * Kb + Ka * Kb) * es
    flops = 2 * M * Ka * Kb
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def llm100m_round_calls(torch):
    """The ``xus``, ``avt`` and ``atb`` calls of one llm-100m FeDLRT round
    with the spec defaults (:func:`train_xus_calls`, :func:`train_avt_calls`,
    :func:`train_atb_calls`), held to :func:`expected_launches`, and their M
    (batch × seq)."""
    from repro_torch.api import ExperimentSpec, ModelSpec, build

    spec = ExperimentSpec(name="chip-calls-llm-100m", seed=0, model=ModelSpec(preset="llm-100m"))
    exp = build(spec, device="cuda")
    cfg = exp.engine.cfg
    calls = dict(xus=train_xus_calls(exp.params, cfg), avt=train_avt_calls(exp.params, cfg),
                 atb=train_atb_calls(exp.params, cfg))
    want, _ = expected_launches(exp.params, cfg)
    del exp
    torch.cuda.empty_cache()
    for name, c in calls.items():
        if sum(c.values()) != want[name]:
            raise AssertionError(f"train_{name}_calls counts {sum(c.values())} {name} calls a "
                                 f"round, expected_launches {want[name]}")
    return dict(calls, M=spec.data.batch * spec.data.seq)


def phase_atb(torch, round_calls):
    """``atb`` against its plain version at every training-path shape, f32
    and bf16, with its device launches a call (held to ``atb_plan``), its
    time, bound, plain time and ``torch.matmul(A.T, B)``'s; then the sums
    over one llm-100m round's calls (``round_calls["atb"]``, f32)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coeff_grad import atb, atb_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    records = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for model, Ms, Ka, Kb in atb_shapes():
            for M in Ms:
                set_bytes = M * (Ka + Kb) * dtype.itemsize
                n_sets = max(2, min(64, math.ceil(L2_DEFEAT_BYTES / set_bytes)))
                sets = [
                    (torch.randn(M, Ka, generator=gen, device="cuda").to(dtype),
                     torch.randn(M, Kb, generator=gen, device="cuda").to(dtype))
                    for _ in range(n_sets)
                ]
                got, want = atb(*sets[0]), ref.atb_ref(*sets[0])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                plan = atb_plan(1, M, Ka, Kb)
                dev = device_launches(torch, lambda: atb(*sets[0]))
                if dev != plan.launches:
                    raise AssertionError(f"atb M={M} Ka={Ka} Kb={Kb} {dtype_name}: {dev} device "
                                         f"launches a call, plan says {plan.launches}")
                if dtype_name == "float32":
                    ok = err <= ATB_F32_RTOL * want.abs().max().item()
                    tol = f"{ATB_F32_RTOL:g} x max|C|"
                else:
                    ok = torch.allclose(got.float(), want.float(), **TOL[dtype_name])
                    tol = str(TOL[dtype_name])
                reps = max(n_sets, 8)
                rec = dict(
                    kernel="atb", model=model, dtype=dtype_name, M=M, Ka=Ka, Kb=Kb,
                    max_abs_err=err, ok=ok, splits=plan.splits, launches=dev,
                    ms=graph_ms(torch, lambda i: atb(*sets[i]), n_sets, reps),
                    plain_ms=graph_ms(torch, lambda i: ref.atb_ref(*sets[i]), n_sets, reps),
                    library_ms=graph_ms(
                        torch, lambda i: torch.matmul(sets[i][0].t(), sets[i][1]), n_sets, reps
                    ),
                )
                rec["bound_ms"], rec["bound_by"] = _atb_bound_ms(dtype_name, M, Ka, Kb)
                rec["tflops"] = 2 * M * Ka * Kb / rec["ms"] / 1e9
                records.append(rec)
                log(f"[atb] {model:8s} {dtype_name:8s} M={M:<5d} Ka={Ka:<6d} Kb={Kb:<3d} "
                    f"max_abs_err={err:.3g} (max|C| {want.float().abs().max().item():.3g}) "
                    f"tol={tol} {'ok' if ok else 'MISMATCH'}  kernel_ms={rec['ms']:.4f} "
                    f"({rec['tflops']:.1f} TF/s) plain_ms={rec['plain_ms']:.4f} "
                    f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.6f} "
                    f"({rec['bound_by']}) splits={plan.splits} launches={dev}")
                del sets, got, want
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} atb case(s) disagree with the plain version: {bad}")
    M = round_calls["M"]
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, calls=0, device_launches=0.0)
    for (Ka, Kb), n in sorted(round_calls["atb"].items()):
        [rec] = [r for r in records if (r["model"], r["dtype"], r["M"], r["Ka"], r["Kb"])
                 == ("llm-100m", "float32", M, Ka, Kb)]
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[k] += n * rec[k]
        total["calls"] += n
        total["device_launches"] += n * rec["launches"]
    log(f"[atb] round: per llm-100m round (f32, M={M}): {total['calls']} calls, "
        f"{total['device_launches']:g} device launches; kernel {total['ms']:.3f} ms, plain "
        f"{total['plain_ms']:.3f} ms, library {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms; by (Ka, Kb): "
        + ", ".join(f"{ka}x{kb} x{n}" for (ka, kb), n in sorted(round_calls["atb"].items())))
    return records, total


def phase_xus_train(torch, round_calls):
    """``xus`` at every shape of one llm-100m FeDLRT round (M = batch × seq
    = 512, f32, with and without S), each held to its plain version, with
    its device launches a call against the plan, its time, the plain
    version's, the library call's (``torch.linalg.multi_dot``, or
    ``torch.matmul`` without S) and the bound; then the sums over one
    round's calls (``round_calls["xus"]``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_matmul import xus

    torch.backends.cuda.matmul.allow_tf32 = False
    calls, M = round_calls["xus"], round_calls["M"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    records = []
    for (K, R, has_s), n in sorted(calls.items()):
        set_bytes = (M * K + K * R + R * R) * 4
        n_sets = max(2, min(64, math.ceil(L2_DEFEAT_BYTES / set_bytes)))
        sets = [(torch.randn(M, K, generator=gen, device="cuda"),
                 torch.randn(K, R, generator=gen, device="cuda") / math.sqrt(K),
                 torch.randn(R, R, generator=gen, device="cuda") / math.sqrt(R) if has_s else None)
                for _ in range(n_sets)]
        got, plain = xus(*sets[0]), ref.xus_ref(*sets[0])
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        ok = torch.allclose(got, plain, **TOL["float32"])
        dev = device_launches(torch, lambda: xus(*sets[0]))
        plan = _xus_route(sets[0][0], sets[0][1], sets[0][2], dev)
        if has_s:
            lib = lambda i: torch.linalg.multi_dot(list(sets[i]))  # noqa: E731
        else:
            lib = lambda i: torch.matmul(sets[i][0], sets[i][1])  # noqa: E731
        reps = max(n_sets, 20)
        rec = dict(K=K, R=R, S=has_s, calls=n, max_abs_err=err, ok=ok, route=plan.route,
                   splits=plan.splits, launches=dev,
                   ms=graph_ms(torch, lambda i: xus(*sets[i]), n_sets, reps),
                   plain_ms=graph_ms(torch, lambda i: ref.xus_ref(*sets[i]), n_sets, reps),
                   library_ms=graph_ms(torch, lib, n_sets, reps))
        rec["bound_ms"], rec["bound_by"] = _bound_ms("xus", "float32", M, K, R, has_s)
        flops = 2 * M * K * R + (2 * M * R * R if has_s else 0)
        rec["tflops"] = flops / rec["ms"] / 1e9
        records.append(rec)
        log(f"[xus-train] M={M} K={K:<5d} R={R:<3d} S={'yes' if has_s else 'no ':3s} x{n:<5d} "
            f"max_abs_err={err:.3g} tol={TOL['float32']} {'ok' if ok else 'MISMATCH'}  "
            f"kernel_ms={rec['ms']:.4f} ({rec['tflops']:.1f} TF/s) plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}) route={plan.route} splits={plan.splits} launches={dev}")
        del sets, got, plain
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(
            f"{len(bad)} xus training case(s) disagree with the plain version: {bad}")
    total = {k: sum(r["calls"] * r[k] for r in records)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["calls"] = sum(r["calls"] for r in records)
    total["device_launches"] = sum(r["calls"] * r["launches"] for r in records)
    log(f"[xus-train] per llm-100m round: {total['calls']} calls, {total['device_launches']:g} "
        f"device launches; kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"library {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    return records, total


def phase_avt_train(torch, round_calls):
    """``avt`` at every shape of one llm-100m FeDLRT round (M = batch × seq
    = 512, f32), each held to its plain version, with its device launches a
    call against the plan, its time, the plain version's, the library
    call's (``torch.matmul(A, V.t())``, TF32 off) and the bound; then the
    sums over one round's calls (``round_calls["avt"]``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_matmul import avt

    torch.backends.cuda.matmul.allow_tf32 = False
    calls, M = round_calls["avt"], round_calls["M"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    records = []
    for (N, R), n in sorted(calls.items()):
        set_bytes = (M * R + N * R) * 4
        n_sets = max(2, min(64, math.ceil(L2_DEFEAT_BYTES / set_bytes)))
        sets = [(torch.randn(M, R, generator=gen, device="cuda"),
                 torch.randn(N, R, generator=gen, device="cuda") / math.sqrt(R))
                for _ in range(n_sets)]
        got, plain = avt(*sets[0]), ref.avt_ref(*sets[0])
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        ok = torch.allclose(got, plain, **TOL["float32"])
        dev = device_launches(torch, lambda: avt(*sets[0]))
        plan, desc = _avt_route(*sets[0], dev)
        reps = max(n_sets, 20)
        rec = dict(N=N, R=R, calls=n, max_abs_err=err, ok=ok, route=plan.route, launches=dev,
                   ms=graph_ms(torch, lambda i: avt(*sets[i]), n_sets, reps),
                   plain_ms=graph_ms(torch, lambda i: ref.avt_ref(*sets[i]), n_sets, reps),
                   library_ms=graph_ms(torch, lambda i: torch.matmul(sets[i][0], sets[i][1].t()),
                                       n_sets, reps))
        rec["bound_ms"], rec["bound_by"] = _bound_ms("avt", "float32", M, N, R)
        rec["tflops"] = 2 * M * N * R / rec["ms"] / 1e9
        records.append(rec)
        log(f"[avt-train] M={M} N={N:<5d} R={R:<3d} x{n:<5d} max_abs_err={err:.3g} "
            f"tol={TOL['float32']} {'ok' if ok else 'MISMATCH'}  kernel_ms={rec['ms']:.4f} "
            f"({rec['tflops']:.1f} TF/s) plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}) {desc}")
        del sets, got, plain
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(
            f"{len(bad)} avt training case(s) disagree with the plain version: {bad}")
    total = {k: sum(r["calls"] * r[k] for r in records)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["calls"] = sum(r["calls"] for r in records)
    total["device_launches"] = sum(r["calls"] * r["launches"] for r in records)
    log(f"[avt-train] per llm-100m round: {total['calls']} calls, {total['device_launches']:g} "
        f"device launches; kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"library {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    return records, total


def phase_backward(torch):
    """``lowrank_apply``'s kernel-backed gradients against the plain
    chain's (autograd of ``((x U) S) Vᵀ``), f32, at one llm-100m layer's
    shapes (M = 512 = batch 4 x seq 128), for every ``needs_input_grad``
    combination the training path uses."""
    from repro_torch.kernels.ops import lowrank_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    M, d, dff = 512, 640, 2560
    cases = [
        # (what, K, N, R, which of x, U, S, V need a gradient)
        ("basis pass, up 640->2560", d, dff, 160, (1, 1, 1, 1)),
        ("basis pass, down 2560->640", dff, d, 160, (1, 1, 1, 1)),
        ("client loop, up (augmented)", d, dff, 320, (1, 0, 1, 0)),
        ("client loop, down (augmented)", dff, d, 320, (1, 0, 1, 0)),
        ("basis pass, embedding (U[tok] S) I V^T", 160, d, 160, (1, 1, 0, 1)),
        ("client loop, embedding (augmented)", 320, d, 320, (0, 1, 0, 0)),
    ]
    worst = 0.0
    for what, K, N, R, need in cases:
        x = torch.randn(M, K, generator=gen, device="cuda")
        U = torch.linalg.qr(torch.randn(K, R, generator=gen, device="cuda"))[0]
        S = torch.randn(R, R, generator=gen, device="cuda") / math.sqrt(R)
        V = torch.linalg.qr(torch.randn(N, R, generator=gen, device="cuda"))[0]
        dy = torch.randn(M, N, generator=gen, device="cuda")
        grads = []
        for use_kernels in (True, False):
            ins = [t.clone().requires_grad_(bool(n)) for t, n in zip((x, U, S, V), need)]
            y = lowrank_apply(*ins, use_kernels)
            grads.append(torch.autograd.grad(y, [t for t in ins if t.requires_grad], dy))
        torch.cuda.synchronize()
        names = [n for n, k in zip(("dx", "dU", "dS", "dV"), need) if k]
        for name, g, w in zip(names, *grads):
            rel = ((g - w).abs().max() / w.abs().max()).item()
            worst = max(worst, rel)
            log(f"[backward] {what:40s} {name}: max|kernel - plain| / max|plain| = {rel:.3g}")
            if not rel <= 1e-4:
                raise AssertionError(f"backward {what} {name} differs by {rel} (> 1e-4 relative)")
    log(f"[backward] ok: worst relative difference {worst:.3g} <= 1e-4 (f32 sums in "
        f"another order)")


def _clone(tree):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def _factors(params):
    """(path, factor) of every factor leaf, the path as the round's rank keys."""
    from repro_torch.core.factorization import is_factor
    from repro_torch.utils.tree import tree_map_with_path

    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)) if is_factor(x) else None,
                       params, is_leaf=is_factor)
    return out


def expected_launches(params, cfg):
    """Kernel launches one FeDLRT round makes, from the model's factors.

    Per factor slice, a forward is 1 ``xus`` + 1 ``avt``. The backward of a
    linear layer in the basis-gradient pass (x, U, S, V all differentiated)
    is 4 ``xus``, 1 ``avt``, 3 ``atb``; in the client loop (x and S̃) 3
    ``xus``, 1 ``avt``, 1 ``atb``. The embedding runs the chain on
    ``U[tok]`` with its S in the U slot: 2 ``xus``, 1 ``avt``, 2 ``atb`` in
    the basis pass, plus 1 ``atb`` for the gather's backward into U
    (``onehotᵀ · g``); 1 ``xus`` + 1 ``atb`` in the client loop. Each client
    runs the basis pass once, s* client steps (one more with the full
    correction) and, with ``eval_after``, one forward.
    """
    import math

    n_emb = sum(math.prod(f.U.shape[:-2]) for p, f in _factors(params) if p == "['embed']")
    n_lin = sum(math.prod(f.U.shape[:-2]) for p, f in _factors(params)) - n_emb
    fwd = n_lin + n_emb
    basis = dict(xus=fwd + 4 * n_lin + 2 * n_emb, avt=fwd + n_lin + n_emb,
                 atb=3 * n_lin + 3 * n_emb)
    step = dict(xus=fwd + 3 * n_lin + n_emb, avt=fwd + n_lin, atb=n_lin + n_emb)
    steps = cfg.s_star + (1 if cfg.correction == "full" else 0)
    C = cfg.num_clients
    return {k: C * (basis[k] + steps * step[k] + (fwd if cfg.eval_after and k != "atb" else 0))
            for k in basis}, (n_lin, n_emb)


def train_atb_calls(params, cfg):
    """(Ka, Kb) → ``atb`` launches of one FeDLRT round (as counted in
    :func:`expected_launches`)."""
    import math

    calls = {}

    def add(key, n):
        calls[key] = calls.get(key, 0) + n

    C, steps = cfg.num_clients, cfg.s_star + (1 if cfg.correction == "full" else 0)
    for path, f in _factors(params):
        n, r = math.prod(f.U.shape[:-2]), f.r_max
        if path == "['embed']":
            add((r, r), C * n)  # dU slot (the coefficient)
            add((f.n_out, r), C * n)  # dV
            add((f.n_in, r), C * n)  # the gather's backward into U: onehotᵀ g
        else:
            add((r, r), C * n)  # dS
            add((f.n_in, r), C * n)  # dU
            add((f.n_out, r), C * n)  # dV
        add((2 * r, 2 * r), C * steps * n)  # dS̃ (embedding: its dU slot)
    return calls


def train_avt_calls(params, cfg):
    """(N, R) → ``avt`` launches of one FeDLRT round (as counted in
    :func:`expected_launches`), all at M = batch × seq.

    A linear slice (n_in → n_out, rank r): the basis pass runs the forward
    (N = n_out) and the backward's ``dx`` (N = n_in); a client step the same
    at the augmented rank 2r; the evaluation one forward at r. The
    embedding runs the chain on ``U[tok]`` with its S in the U slot: the
    basis pass forward (N = d) and ``dx`` into ``U[tok]`` (N = r); a client
    step the forward at 2r.
    """
    import math

    calls = {}

    def add(key, n):
        calls[key] = calls.get(key, 0) + n

    C, steps = cfg.num_clients, cfg.s_star + (1 if cfg.correction == "full" else 0)
    evals = 1 if cfg.eval_after else 0
    for path, f in _factors(params):
        n, r = math.prod(f.U.shape[:-2]), f.r_max
        add((f.n_out, r), C * n * (1 + evals))  # forward (and the evaluation)
        add((f.n_out, 2 * r), C * steps * n)
        if path == "['embed']":
            add((r, r), C * n)  # dx into U[tok]: N is the U slot's rows, S's r
        else:
            add((f.n_in, r), C * n)  # dx
            add((f.n_in, 2 * r), C * steps * n)
    return calls


def train_xus_calls(params, cfg):
    """(K, R, with S) → ``xus`` launches of one FeDLRT round (as counted in
    :func:`expected_launches`), all at M = batch × seq.

    A linear slice (n_in → n_out, rank r): the basis pass runs the forward
    ``x U S``, the backward ``dy V Sᵀ``, ``x U``, ``dy V`` and ``x U S``; a
    client step the same at the augmented rank 2r without the last one; the
    evaluation one forward at r. The embedding runs the chain on ``U[tok]``
    (K = r) with its S in the U slot and an identity in the S slot: the
    basis pass forward, ``dy V Iᵀ`` (K = d) and ``u S I``; a client step the
    forward and ``dy V Iᵀ`` at 2r.
    """
    import math

    calls = {}

    def add(key, n):
        calls[key] = calls.get(key, 0) + n

    C, steps = cfg.num_clients, cfg.s_star + (1 if cfg.correction == "full" else 0)
    evals = 1 if cfg.eval_after else 0
    for path, f in _factors(params):
        n, r = math.prod(f.U.shape[:-2]), f.r_max
        if path == "['embed']":
            add((r, r, True), C * n * (2 + evals))  # forward, u S I (and the evaluation)
            add((f.n_out, r, True), C * n)  # dy V Iᵀ
            add((2 * r, 2 * r, True), C * steps * n)
            add((f.n_out, 2 * r, True), C * steps * n)
        else:
            add((f.n_in, r, True), C * n * (2 + evals))  # forward, x U S (and the evaluation)
            add((f.n_out, r, True), C * n)  # dy V Sᵀ
            add((f.n_in, r, False), C * n)  # x U
            add((f.n_out, r, False), C * n)  # dy V
            add((f.n_in, 2 * r, True), C * steps * n)
            add((f.n_out, 2 * r, True), C * steps * n)
            add((f.n_in, 2 * r, False), C * steps * n)
            add((f.n_out, 2 * r, False), C * steps * n)
    return calls


def _wrappers():
    from repro_torch.kernels.coeff_grad import atb
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_matmul import avt, xus

    return {"xus": xus, "avt": avt, "atb": atb, "flash_attention": flash_attention}


def _launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def device_profile(torch, fn, tag: str, top: int):
    """One call of ``fn`` under ``torch.profiler``: its kernels, the union
    of their intervals on the card (device busy seconds) and the host
    seconds of the call; logs the ``top`` kernel names by device time,
    each with its share, as ``tag`` lines."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    busy, reach = 0.0, float("-inf")  # length of the union of the intervals (µs)
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    total = sum(by_name.values()) or 1.0
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"{tag} {us / 1e3:9.3f} ms  {100 * us / total:5.1f} %  {name[:110]}")
    return len(spans), busy / 1e6, wall


def profile_round(torch, exp, wall: float):
    """Where one more FeDLRT round of ``exp`` spends the card's time, under
    ``torch.profiler``. Device busy time is the union of the kernels'
    intervals, read against ``wall``, an unprofiled round's host time; the
    breakdown sums each kernel name's device time."""
    n, busy_s, wall_prof = device_profile(
        torch, lambda: exp.run(rounds=1, log_every=0), "[profile]", 15)
    log(f"[profile] one round: host wall {wall:.3f} s unprofiled ({wall_prof:.3f} s under the "
        f"profiler); {n} kernels, device busy {busy_s:.3f} s = "
        f"{100 * busy_s / wall:.1f} % of the unprofiled round (idle {100 * (1 - busy_s / wall):.1f} %)")
    return dict(wall_s=wall, device_busy_s=busy_s, kernels=n)


def phase_train(torch, counters):
    """llm-100m at full width and depth, f32: three FeDLRT rounds through
    ``build(spec).run()`` with the spec defaults (fedlrt, simplified
    correction, 4 clients, s* = 4, batch 4, seq 128, kernels auto), one
    more under ``torch.profiler`` (where the round's device time goes);
    then one round from the same start with kernels off, and the first
    round again."""
    import numpy as np

    from repro_torch.api import ExperimentSpec, ModelSpec, build
    from repro_torch.core.factorization import materialize
    from repro_torch.utils.tree import tree_leaves

    spec = ExperimentSpec(name="chip-train-llm-100m", seed=0, rounds=3, log_every=1,
                          model=ModelSpec(preset="llm-100m"))
    t0 = time.perf_counter()
    exp = build(spec, device="cuda")
    torch.cuda.synchronize()
    log(f"[train] built in {time.perf_counter() - t0:.1f} s")
    log(exp.describe())
    cfg = exp.engine.cfg
    params0 = _clone(exp.params)
    want, (n_lin, n_emb) = expected_launches(params0, cfg)
    dense_elems = sum(
        f.n_in * f.n_out * math.prod(f.U.shape[:-2]) for _, f in _factors(params0)
    ) + sum(
        t.numel() for t in tree_leaves(params0)
    ) - sum(sum(t.numel() for t in (f.U, f.S, f.V, f.rank)) for _, f in _factors(params0))
    fedavg_bytes = 2 * dense_elems * 4  # cost_model.dense_round_comm_bytes of the dense model
    log(f"[train] {n_lin} linear factor slices + {n_emb} embedding; expected launches per "
        f"round: {want} (C={cfg.num_clients}, s*={cfg.s_star}, correction={cfg.correction}, "
        f"eval_after={cfg.eval_after})")

    rounds, params_r1 = [], None
    # the main path: counts at 0 just before, read just after
    _zero_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    for r in range(spec.rounds):
        before = _launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = exp.run(rounds=1)[-1]
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _launch_counts().items() if k in want}
        ranks = np.concatenate([np.ravel(v) for v in res.ranks.values()])
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not (math.isfinite(res.loss_before) and math.isfinite(res.loss_after)):
            raise AssertionError(f"round {r}: non-finite loss {res.loss_before} / {res.loss_after}")
        if got != want:
            raise AssertionError(f"round {r}: launches {got}, expected {want}")
        log(f"[train] round {r}: loss_before {res.loss_before:.6f} loss_after "
            f"{res.loss_after:.6f}; rank min/mean/max {ranks.min():.0f}/{ranks.mean():.2f}/"
            f"{ranks.max():.0f} over {ranks.size} factor slices; host {res.seconds:.3f} s; "
            f"comm per client static {res.comm_bytes_per_client / 1e6:.3f} MB, effective "
            f"{res.comm_bytes_per_client_effective / 1e6:.3f} MB, FedAvg dense "
            f"{fedavg_bytes / 1e6:.3f} MB; peak {peak:.2f} GiB; launches {got} = expected")
        rounds.append(dict(loss_before=res.loss_before, loss_after=res.loss_after,
                           rank_min=float(ranks.min()), rank_mean=float(ranks.mean()),
                           rank_max=float(ranks.max()), host_s=res.seconds,
                           comm_static_bytes=res.comm_bytes_per_client,
                           comm_effective_bytes=res.comm_bytes_per_client_effective,
                           fedavg_dense_bytes=fedavg_bytes, peak_gib=peak, launches=got))
        if r == 0:
            params_r1 = _clone(exp.params)
            ranks_r1 = {k: np.asarray(v) for k, v in res.ranks.items()}
    path_s = time.perf_counter() - t_path
    counters["train"] = _launch_counts()
    log(f"[train] {spec.rounds} rounds in {path_s:.1f} s; launches {counters['train']}")
    profile = profile_round(torch, exp, rounds[-1]["host_s"])
    del exp
    torch.cuda.empty_cache()

    # one round from the same start on the plain chain (kernels off)
    off_spec = dataclasses.replace(spec, name="chip-train-off",
                                   model=ModelSpec(preset="llm-100m", kernels="off"))
    exp_off = build(off_spec, params=_clone(params0), device="cuda")
    _zero_counts()
    res_off = exp_off.run(rounds=1, log_every=0)[-1]
    torch.cuda.synchronize()
    if any(_launch_counts().values()):
        raise AssertionError(f"kernels='off' launched kernels: {_launch_counts()}")
    r0 = rounds[0]
    for name in ("loss_before", "loss_after"):
        a, b = r0[name], getattr(res_off, name)
        rel = abs(a - b) / abs(b)
        log(f"[train] kernels vs off, round 0 {name}: {a:.7f} vs {b:.7f} (rel {rel:.3g})")
        if not rel <= 1e-4:
            raise AssertionError(f"{name} differs between kernels and off by {rel} (> 1e-4)")
    for k, v in res_off.ranks.items():
        if not np.array_equal(np.asarray(v), ranks_r1[k]):
            raise AssertionError(f"rank of {k} differs: kernels {ranks_r1[k]} vs off {v}")
    worst = 0.0
    for (path, f), (_, g) in zip(_factors(params_r1), _factors(exp_off.params)):
        W, W_off = materialize(f), materialize(g)
        rel = ((W - W_off).abs().max() / W_off.abs().max()).item()
        worst = max(worst, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"{path}: U S V^T differs between kernels and off by {rel}")
    log(f"[train] kernels vs off: ranks identical; worst factor max|W - W_off| / max|W_off| "
        f"= {worst:.3g} <= 1e-3")
    del exp_off
    torch.cuda.empty_cache()

    # the first round again, kernels on: the same bits; the coefficients its
    # truncations receive are kept for the SVD drivers' reading
    import repro_torch.core.fedlrt as fedlrt_module

    exp_rep = build(spec, params=_clone(params0), device="cuda")
    truncate, coeffs = fedlrt_module.truncate, []

    def keep_coeff(f, **kw):
        coeffs.append(f.S.detach().float().clone())
        return truncate(f, **kw)

    fedlrt_module.truncate = keep_coeff
    try:
        exp_rep.run(rounds=1, log_every=0)
    finally:
        fedlrt_module.truncate = truncate
    torch.cuda.synchronize()
    a_leaves, b_leaves = tree_leaves(params_r1), tree_leaves(exp_rep.params)
    same = len(a_leaves) == len(b_leaves) and all(
        torch.equal(a, b) for a, b in zip(a_leaves, b_leaves)
    )
    if not same:
        n_diff = sum(not torch.equal(a, b) for a, b in zip(a_leaves, b_leaves))
        raise AssertionError(f"repeat of round 0 is not bit-identical ({n_diff} tensors differ)")
    log(f"[train] repeat of round 0: all {len(a_leaves)} tensors bit-identical (torch.equal)")
    drivers = truncation_svd_drivers(torch, coeffs, exp_rep.engine.cfg.tau)
    del exp_rep, coeffs
    torch.cuda.empty_cache()
    return dict(rounds=rounds, path_s=path_s, profile=profile, svd_drivers=drivers)


def truncation_svd_drivers(torch, coeffs, tau):
    """The round's truncation SVD under cuSOLVER's Jacobi ``gesvdj`` and
    its QR-based ``gesvd``, on the aggregated 2r × 2r coefficients S̃ that
    one llm-100m round's truncations received (one stack per factor leaf,
    one call per stack, as ``truncate`` makes them): each driver's worst σ
    error relative to the matrix's largest σ against an f64 SVD (LAPACK,
    on the host), whether ``pick_rank`` chooses the f64 σ's ranks, the
    worst ``max|U S Vᵀ − S̃| / max|S̃|``, and the time over the whole set.
    Fails if ``gesvdj``, torch's default on CUDA, which ``truncate`` calls,
    misses 1e-4 or changes a rank."""
    from repro_torch.core.dlrt import pick_rank

    ref = []
    for S in coeffs:
        S64 = S.double().cpu()
        s64 = torch.linalg.svdvals(S64)
        theta = tau * torch.linalg.norm(S64, dim=(-2, -1))
        ref.append((s64, pick_rank(s64, theta, S.shape[-1] // 2)))
    out = {}
    for driver in ("gesvdj", "gesvd"):
        torch.linalg.svd(coeffs[0], full_matrices=False, driver=driver)  # warm-up, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svds = [torch.linalg.svd(S, full_matrices=False, driver=driver) for S in coeffs]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        sigma_err = rebuild = 0.0
        ranks_same = True
        for S, (P, s, Qt), (s64, r64) in zip(coeffs, svds, ref):
            s_cpu = s.double().cpu()
            sigma_err = max(sigma_err, ((s_cpu - s64).abs().amax(-1) / s64[..., 0]).max().item())
            theta = tau * torch.linalg.norm(S, dim=(-2, -1))
            ranks_same &= torch.equal(pick_rank(s, theta, S.shape[-1] // 2).cpu(), r64.float())
            W = (P * s[..., None, :]) @ Qt
            rebuild = max(rebuild, ((W - S).abs().max() / S.abs().max()).item())
        out[driver] = dict(ms=ms, sigma_rel_err=sigma_err, ranks_same=bool(ranks_same),
                           worst_rebuild=rebuild)
        log(f"[train] truncation SVD driver {driver}: {len(coeffs)} stacks "
            f"({sum(math.prod(S.shape[:-2]) for S in coeffs)} matrices of "
            f"{coeffs[0].shape[-1]} x {coeffs[0].shape[-1]}) in {ms:.1f} ms; worst sigma error "
            f"{sigma_err:.3g} of the largest (f64 reference); ranks "
            f"{'the same as' if ranks_same else 'DIFFERENT from'} the f64 sigma's; worst "
            f"max|U S V^T - S~| / max|S~| = {rebuild:.3g}")
    if not (out["gesvdj"]["ranks_same"] and out["gesvdj"]["worst_rebuild"] <= 1e-4):
        raise AssertionError(f"the truncation's SVD driver gesvdj misses 1e-4 or changes a "
                             f"rank: {out['gesvdj']}")
    return out


# ---------------------------------------------------------------------------
# flash attention on its own entry point
# ---------------------------------------------------------------------------

#: (name, B, Tq, Tk, H, Hkv, d, dtype, window, invalid tail slots, head groups
#: for the plain version); positions: queries at the end of the keys
FLASH_CASES = [
    ("qwen2-7b prefill", 1, 4096, 4096, 28, 4, 128, "bfloat16", 0, 0, 1),
    ("qwen2-7b decode vs cache", 4, 1, 4096, 28, 4, 128, "bfloat16", 0, 512, 1),
    ("mistral-7b window 4096", 1, 8192, 8192, 32, 8, 128, "bfloat16", 4096, 0, 4),
    ("f32 check", 1, 1024, 1024, 28, 4, 128, "float32", 0, 0, 1),
]


def _flash_inputs(torch, case, gen):
    _, B, Tq, Tk, H, Hkv, d, dtype_name, window, tail, _ = case
    dtype = getattr(torch, dtype_name)
    q = torch.randn(B, Tq, H, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Tk, Hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Tk, Hkv, d, generator=gen, device="cuda").to(dtype)
    kpos = torch.arange(Tk, device="cuda", dtype=torch.int32)
    if tail:  # a cache whose last slots are not written yet
        kpos[Tk - tail:] = -1
    qpos = torch.arange(Tq, device="cuda", dtype=torch.int32) + (Tk - tail - Tq)
    return q, k, v, dict(q_positions=qpos, kv_positions=kpos, causal=True,
                         sliding_window=window)


def _flash_plain_err(torch, case, q, k, v, kw, out):
    """(max |kernel − plain|, worst |kernel − plain| / tolerance) over the
    heads (``flash_mismatch``: 1e-4 in f32, element-wise and scaled to the
    row in bf16), the plain version run by KV-head groups (its scores are
    materialized: 8.6 GB at the Mistral case)."""
    from repro_torch.kernels.ref import flash_attention_ref, flash_mismatch

    groups, H, Hkv = case[-1], q.shape[2], k.shape[2]
    hk, g = Hkv // groups, H // Hkv
    err = ratio = 0.0
    for i in range(groups):
        hq = slice(i * hk * g, (i + 1) * hk * g)
        hkv = slice(i * hk, (i + 1) * hk)
        want = flash_attention_ref(q[:, :, hq].contiguous(), k[:, :, hkv].contiguous(),
                                   v[:, :, hkv].contiguous(), **kw)
        e, r = flash_mismatch(out[:, :, hq], want)
        err, ratio = max(err, e), max(ratio, r)
        del want
    return err, ratio


def _flash_bound_ms(torch, case, q, kw):
    """max(bytes / 3.35 TB/s, FLOPs / peak): Q and the positions read once,
    K and V read once over the slots some query sees (an invalid slot is
    never loaded), the output written once; FLOPs = 4 B H d × the visible
    query-key pairs of these positions."""
    _, B, Tq, Tk, H, Hkv, d, dtype_name, window, _, _ = case
    qp = kw["q_positions"].long()[:, None]
    kp = kw["kv_positions"].long()[None, :]
    vis = (kp >= 0) & (qp >= 0) & (kp <= qp)
    if window:
        vis &= kp > qp - window
    pairs = int(vis.sum().item())
    slots = int(vis.any(0).sum().item())
    es = q.element_size()
    nbytes = (2 * B * Tq * H * d + 2 * B * slots * Hkv * d) * es + 4 * (Tq + Tk)
    flops = 4 * B * H * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops


def _event_ms(torch, fn, n_inputs: int, reps: int) -> float:
    """Device time per call of ``fn(i)`` over ``reps`` calls cycling through
    ``n_inputs`` input sets, by CUDA events after a warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_flash(torch, counters):
    """``flash_attention`` on its own entry point at the four cases of
    :data:`FLASH_CASES`: the path (one call per case, counted), then each
    output against the plain version, then times: kernel (per call by CUDA
    events, and without the host's share as a CUDA graph's replay),
    plain version, ``scaled_dot_product_attention`` (the yardstick; the port
    never calls it) and the bound."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_splits
    from repro_torch.kernels.ref import flash_attention_ref

    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    inputs = [_flash_inputs(torch, case, gen) for case in FLASH_CASES]
    # the main path: counts at 0 just before, read just after
    _zero_counts()
    torch.cuda.synchronize()
    outs = [flash_attention(q, k, v, **kw) for q, k, v, kw in inputs]
    torch.cuda.synchronize()
    counters["flash"] = _launch_counts()
    if counters["flash"]["flash_attention"] != len(FLASH_CASES):
        raise AssertionError(f"flash path launches {counters['flash']}")
    records = []
    for case, (q, k, v, kw), out in zip(FLASH_CASES, inputs, outs):
        name, B, Tq, Tk, H, Hkv, d, dtype_name, window, tail, _ = case
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash {name}: non-finite output")
        err, ratio = _flash_plain_err(torch, case, q, k, v, kw, out)
        ok = ratio <= 1.0
        bound, bound_by, flops = _flash_bound_ms(torch, case, q, kw)
        # the kernel the wrapper takes: bf16 on tensor cores, with a split
        # key range (and a second launch that merges it) where the grid is small
        bf16 = q.dtype == torch.bfloat16
        splits = flash_splits(B, Tq, Tk, H, Hkv) if bf16 else 1
        # K/V sets cycled through more than the 50 MB L2 where they would fit
        kv_bytes = 2 * k.numel() * k.element_size()
        n_sets = max(1, min(8, math.ceil(L2_DEFEAT_BYTES / kv_bytes)))
        sets = [(q, k, v)] + [(q, k.clone(), v.clone()) for _ in range(n_sets - 1)]
        reps = max(n_sets, 4)
        rec = dict(kernel="flash_attention", case=name, dtype=dtype_name, B=B, Tq=Tq, Tk=Tk,
                   H=H, Hkv=Hkv, d=d, window=window, invalid_slots=tail, max_abs_err=err,
                   err_over_tol=ratio, ok=ok, flops=flops, bound_ms=bound, bound_by=bound_by,
                   route="tensor-core bf16" if bf16 else "cuda-core f32",
                   splits=splits, device_launches=2 if splits > 1 else 1)
        rec["ms"] = _event_ms(torch, lambda i: flash_attention(*sets[i], **kw), n_sets, reps)
        rec["device_ms"] = graph_ms(torch, lambda i: flash_attention(*sets[i], **kw), n_sets,
                                    reps)
        if case[-1] == 1:  # the plain version in one call fits the card
            rec["plain_ms"] = _event_ms(
                torch, lambda i: flash_attention_ref(*sets[i], **kw), n_sets, reps)
        else:  # by head groups, summed
            groups, hk = case[-1], Hkv // case[-1]
            rec["plain_ms"] = sum(
                _event_ms(torch, lambda i, j=j: flash_attention_ref(
                    q[:, :, j * hk * (H // Hkv):(j + 1) * hk * (H // Hkv)].contiguous(),
                    k[:, :, j * hk:(j + 1) * hk].contiguous(),
                    v[:, :, j * hk:(j + 1) * hk].contiguous(), **kw), 1, 1)
                for j in range(groups))
        # the library call on (B, H, T, d) views made beforehand
        qpos, kpos = kw["q_positions"].long(), kw["kv_positions"].long()
        mask = None
        if window or tail:
            m = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
            if window:
                m &= kpos[None, :] > qpos[:, None] - window
            mask = m[None, None]
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in qkv) for qkv in sets]
        rec["library_ms"] = _event_ms(torch, lambda i: F.scaled_dot_product_attention(
            *lib_sets[i], attn_mask=mask, is_causal=mask is None, enable_gqa=True), n_sets, reps)
        records.append(rec)
        log(f"[flash] {name:26s} {dtype_name:8s} B={B} Tq={Tq} Tk={Tk} H={H}/{Hkv} d={d} "
            f"window={window} invalid={tail}: max_abs_err={err:.3g} "
            f"worst err/tol={ratio:.3g} {'ok' if ok else 'MISMATCH'}  "
            f"kernel_ms={rec['ms']:.4f} (device {rec['device_ms']:.4f}) "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} bound_ms={bound:.6f} ({bound_by}; "
            f"{flops:.3e} FLOPs) route={rec['route']} splits={rec['splits']} "
            f"launches={rec['device_launches']}")
        del sets, lib_sets, mask
        torch.cuda.empty_cache()
    del inputs, outs
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} flash case(s) disagree with the plain version: {bad}")
    return records


# ---------------------------------------------------------------------------
# the spec-file path: python -m repro_torch.api run, wire, checkpoint, resume
# ---------------------------------------------------------------------------

#: --set overrides that turn examples/configs/sync_baseline.toml into the
#: llm-100m run of the spec phase (spec defaults otherwise: fedlrt,
#: simplified correction, 4 clients, s* = 4, batch 4, seq 128, f32)
SPEC_SETS = ["name=chip-spec-llm-100m", "model.preset=llm-100m", "rounds=2", "log_every=1",
             "wire.codec=int8_affine", "checkpoint.every=1"]


def _tensor_bits_equal(torch, a, b) -> bool:
    from repro_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _history_rows(history):
    """A round history (RoundResults, or the sidecar's dicts) as JSON-safe
    dicts without the host clock."""
    from repro_torch.fed.engine import history_to_state

    rows = history if history and isinstance(history[0], dict) else history_to_state(history)
    return [{k: v for k, v in r.items() if k != "seconds"} for r in rows]


def phase_spec(torch, counters, workdir):
    """llm-100m through the spec-file path, with the wire and checkpoints."""
    import numpy as np

    from repro_torch.api import build, load_spec, serve
    from repro_torch.api.__main__ import main as api_main
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core import cost_model
    from repro_torch.core.factorization import is_factor
    from repro_torch.telemetry import NULL_HUB, set_hub, validate_jsonl
    from repro_torch.utils.tree import tree_leaves

    base = os.path.join(ROOT, "examples", "configs", "sync_baseline.toml")
    ckdir = os.path.join(workdir, "ckpt")
    sets = SPEC_SETS + [f"checkpoint.dir={ckdir}"]
    spec = load_spec(base).with_overrides(sets)
    toml = os.path.join(workdir, "llm100m_spec.toml")
    spec.save(toml)
    log(f"[spec] {toml} written from examples/configs/sync_baseline.toml with "
        f"{' '.join('--set ' + x for x in sets)}; spec {spec.spec_hash()}")

    # 1. the main path: python -m repro_torch.api run <toml> (its main(),
    #    in this process, so the launch counts can be read)
    argv = ["run", toml, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if api_main(argv) != 0:
        raise AssertionError(f"python -m repro_torch.api {' '.join(argv)} failed")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counters["spec"] = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in ("xus", "avt", "atb"):
        if not counters["spec"][name]:
            raise AssertionError(f"spec path launched no {name}: {counters['spec']}")
    ck1, ck2 = (os.path.join(ckdir, f"round_{i:06d}.npz") for i in (1, 2))
    params_full, meta2 = load_checkpoint(ck2, device="cuda")
    state2 = np.load(ck2 + ".state.npy", allow_pickle=True).item()
    hist_full = state2["history"]
    log(f"[spec] python -m repro_torch.api {' '.join(argv)}: {run_s:.1f} s with the build; "
        f"launches {counters['spec']}; peak {peak:.2f} GiB; checkpoints {sorted(os.listdir(ckdir))}")
    if meta2.get("spec_hash") != spec.spec_hash() or meta2.get("round") != 2:
        raise AssertionError(f"checkpoint meta {meta2}")

    # 1b. the same rounds with every telemetry sink on: the same bits, a
    #     valid event log, a loadable trace
    teldir = os.path.join(workdir, "telemetry")
    tel_spec = spec.with_overrides(["telemetry.enabled=true",
                                    "telemetry.sinks=jsonl,perfetto,memory",
                                    f"telemetry.dir={teldir}", "checkpoint.dir=none"])
    exp = build(tel_spec, device="cuda")
    t0 = time.perf_counter()
    exp.run(log_every=0)
    torch.cuda.synchronize()
    tel_s = time.perf_counter() - t0
    exp.hub.close()
    set_hub(NULL_HUB)
    if not _tensor_bits_equal(torch, exp.params, params_full):
        raise AssertionError("telemetry-on params differ from the telemetry-off run's")
    if _history_rows(exp.history) != _history_rows(hist_full):
        raise AssertionError("telemetry-on history differs from the telemetry-off run's")
    events = os.path.join(teldir, "events.jsonl")
    errs = validate_jsonl(events)
    if errs:
        raise AssertionError(f"{events}: {errs[:5]}")
    [mem] = [x for x in exp.hub.sinks if x.name == "memory"]
    with open(os.path.join(teldir, "trace.json")) as fh:
        trace = json.load(fh)
    names = sorted({f"{e['kind']}:{e['name']}" for e in mem.events})
    log(f"[spec] telemetry on (jsonl, perfetto, memory), {len(exp.history)} rounds: params "
        f"and history bit-identical to telemetry off; {len(mem.events)} events, "
        f"validate_jsonl ok ({os.path.getsize(events) / 1e6:.3f} MB), trace.json loads "
        f"({len(trace['traceEvents'])} trace events); rounds {tel_s:.3f} s host vs "
        f"{sum(r['seconds'] for r in hist_full):.3f} s off; events {names}")
    del exp, mem
    torch.cuda.empty_cache()

    # 2. a fresh experiment from the same TOML, resumed from round 1
    exp = build(load_spec(toml), device="cuda")
    exp.resume(ck1)
    exp.run(rounds=1, log_every=0)
    torch.cuda.synchronize()
    if not _tensor_bits_equal(torch, exp.params, params_full):
        raise AssertionError("resumed run's params differ from the uninterrupted run's")
    got_rows = _history_rows(exp.history)
    want_rows = _history_rows(hist_full)
    if got_rows != want_rows:
        raise AssertionError(f"resumed history differs:\n{got_rows}\n{want_rows}")
    log(f"[spec] resume from {os.path.basename(ck1)} + 1 round: params bit-identical to the "
        f"uninterrupted run ({len(tree_leaves(exp.params))} tensors), history equal")
    resumed_hist = exp.history
    del exp
    torch.cuda.empty_cache()

    # 3. one round from the round-1 params with the identity codec, and one
    #    with the wire off: the same bits
    params1, _ = load_checkpoint(ck1, device="cuda")
    id_spec = spec.with_overrides(["wire.codec=identity", "checkpoint.dir=none"])
    exp_id = build(id_spec, params=params1, device="cuda")
    exp_off = build(id_spec, params=params1, device="cuda")
    exp_off.engine.wire = None  # wire_codec=None: payloads as they are, no meter
    res_id = exp_id.run(rounds=1, log_every=0)[-1]
    res_off = exp_off.run(rounds=1, log_every=0)[-1]
    torch.cuda.synchronize()
    if not _tensor_bits_equal(torch, exp_id.params, exp_off.params):
        raise AssertionError("identity codec and wire off disagree")
    if (res_id.loss_before, res_id.loss_after) != (res_off.loss_before, res_off.loss_after):
        raise AssertionError("identity codec and wire off losses differ")
    analytic = cost_model.wire_round_bytes(params1, "fedlrt",
                                           correction=spec.fed.correction_effective)
    if (res_id.wire_bytes_down_per_client, res_id.wire_bytes_up_per_client) != (
            analytic["down"], analytic["up"]):
        raise AssertionError(f"measured identity bytes {res_id.wire_bytes_down_per_client} / "
                             f"{res_id.wire_bytes_up_per_client} != wire_round_bytes {analytic}")
    if res_off.wire_codec or res_off.wire_bytes_up_per_client:
        raise AssertionError("the wire-off round measured bytes")
    log(f"[spec] identity codec vs wire off, one round from round-1 params: all "
        f"{len(tree_leaves(exp_id.params))} tensors bit-identical; measured identity "
        f"down {res_id.wire_bytes_down_per_client / 1e6:.6f} MB / up "
        f"{res_id.wire_bytes_up_per_client / 1e6:.6f} MB per client = wire_round_bytes "
        f"{analytic['down'] / 1e6:.6f} / {analytic['up'] / 1e6:.6f} MB (exact)")
    del exp_id, exp_off
    torch.cuda.empty_cache()

    rounds = []
    for r in hist_full:
        ranks = np.concatenate([np.ravel(v) for v in r["ranks"].values()])
        row = dict(round=r["round_idx"], host_s=r["seconds"],
                   loss_before=r["loss_before"], loss_after=r["loss_after"],
                   int8_down_mb=r["wire_bytes_down_per_client"] / 1e6,
                   int8_up_mb=r["wire_bytes_up_per_client"] / 1e6,
                   identity_down_mb=res_id.wire_bytes_down_per_client / 1e6,
                   identity_up_mb=res_id.wire_bytes_up_per_client / 1e6,
                   wire_round_bytes_down_mb=analytic["down"] / 1e6,
                   wire_round_bytes_up_mb=analytic["up"] / 1e6,
                   static_mb=r["comm_bytes_per_client"] / 1e6,
                   effective_mb=r["comm_bytes_per_client_effective"] / 1e6,
                   rank_min=float(ranks.min()), rank_mean=float(ranks.mean()),
                   rank_max=float(ranks.max()), peak_gib=peak)
        rounds.append(row)
        log(f"[spec] round {row['round']}: host {row['host_s']:.3f} s; loss "
            f"{row['loss_before']:.6f} -> {row['loss_after']:.6f}; MB per client down/up: int8 "
            f"{row['int8_down_mb']:.6f} / {row['int8_up_mb']:.6f}, identity "
            f"{row['identity_down_mb']:.6f} / {row['identity_up_mb']:.6f} (wire_round_bytes "
            f"{row['wire_round_bytes_down_mb']:.6f} / {row['wire_round_bytes_up_mb']:.6f}); "
            f"FeDLRT protocol static {row['static_mb']:.3f} MB, effective "
            f"{row['effective_mb']:.3f} MB; rank min/mean/max {row['rank_min']:.0f}/"
            f"{row['rank_mean']:.2f}/{row['rank_max']:.0f}; run peak {peak:.2f} GiB")
        if not (math.isfinite(row["loss_before"]) and math.isfinite(row["loss_after"])):
            raise AssertionError(f"spec round {row['round']}: non-finite loss")
    ratio = res_id.wire_bytes_up_per_client / hist_full[0]["wire_bytes_up_per_client"]
    log(f"[spec] int8 uplink is {ratio:.3f}x below identity's (>= 3 required)")
    if not ratio >= 3.0:
        raise AssertionError(f"int8 uplink only {ratio:.3f}x below identity")

    # 4. serve 4 short greedy requests from the written checkpoint, with a
    #    memory sink counting the tokens; then rank-sliced and materialized,
    #    both held token-identical to it (f32)
    srv_spec = spec.with_overrides([f"serve.checkpoint={ckdir}", "serve.max_batch=4",
                                    "serve.max_prompt=16", "serve.prompt_bucket=8",
                                    "serve.max_new_tokens=8", "serve.temperature=0.0",
                                    "telemetry.enabled=true", "telemetry.sinks=memory"])
    session = serve(srv_spec, device="cuda")
    log(session.describe())
    if not _tensor_bits_equal(torch, session.engine.params, params_full):
        raise AssertionError("served params differ from the latest checkpoint's")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, session.engine.model.cfg.vocab_size, size=n) for n in (5, 9, 13, 16)]
    t0 = time.perf_counter()
    outs, comps = session.generate(prompts)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    vocab = session.engine.model.cfg.vocab_size
    if [len(o) for o in outs] != [8] * 4 or not all(
            0 <= int(t) < vocab for o in outs for t in o):
        raise AssertionError(f"served outputs {outs}")
    [mem] = session.hub.sinks
    counted = sum(e["value"] for e in mem.events if e["name"] == "serve.tokens")
    if counted != sum(len(o) for o in outs):
        raise AssertionError(f"serve.tokens counted {counted}, produced {sum(map(len, outs))}")
    log(f"[spec] served 4 greedy requests x 8 tokens from {os.path.basename(ck2)} in "
        f"{serve_s:.3f} s; first tokens {[list(map(int, o[:4])) for o in outs]}; "
        f"serve.tokens counter {counted:g} = tokens produced")
    del session
    set_hub(NULL_HUB)
    for sets in (["serve.rank_slice=true"], ["serve.materialize=true"]):
        other = serve(srv_spec.with_overrides(["telemetry.enabled=false", *sets]), device="cuda")
        got, _ = other.generate(prompts)
        if [o.tolist() for o in got] != [o.tolist() for o in outs]:
            raise AssertionError(f"{sets[0]}: greedy tokens differ from factor-resident: "
                                 f"{got} vs {outs}")
        widths = sorted({f.r_max for f in tree_leaves(other.engine.params, is_leaf=is_factor)
                         if is_factor(f)})
        log(f"[spec] {sets[0]} (r_max {widths or 'dense'}): greedy tokens identical to "
            f"factor-resident (f32)")
        del other
    torch.cuda.empty_cache()
    return dict(rounds=rounds, run_s=run_s, resumed_rounds=len(resumed_hist),
                int8_uplink_ratio=ratio, serve_s=serve_s, spec_hash=spec.spec_hash(),
                telemetry_rounds_s=tel_s, telemetry_events=len(trace["traceEvents"]))


# ---------------------------------------------------------------------------
# the system simulator at llm-100m
# ---------------------------------------------------------------------------

#: the fleet of examples/configs/async_straggler.toml: the last quarter of
#: the clients 10x slower
SIM_PROFILE = "straggler:0.25,10"
#: FedBuff flushes of the async runs: with buffer 2 the three fast clients
#: flush ~1.5 times a round trip, so the straggler's first round (priced
#: 10x a fast one) lands after about 26 flushes, and its track with it
SIM_FLUSHES = 30


def _inactive_nonzeros(torch, params) -> int:
    """Entries that break the zero-inactive-columns invariant in every
    factor (stacked slices each at their own rank): U / V columns past the
    rank, S outside its active block. Raises on a rank above r_max."""
    from repro_torch.core.factorization import rank_mask

    bad = 0
    for path, f in _factors(params):
        if bool((f.rank > f.r_max).any()):
            raise AssertionError(f"{path}: rank {f.rank.max().item()} > r_max {f.r_max}")
        off = ~rank_mask(f.rank, f.r_max).bool()
        bad += int(((f.U != 0) & off[..., None, :]).sum())
        bad += int(((f.V != 0) & off[..., None, :]).sum())
        bad += int(((f.S != 0) & (off[..., :, None] | off[..., None, :])).sum())
    return bad


def _launch_delta(before):
    return {k: v - before[k] for k, v in _launch_counts().items() if k != "flash_attention"}


def _record_flushes(torch, eng, rows, *, check: bool):
    """Time every flush of an async engine, count its launches and, with
    ``check``, hold the zero-inactive-columns invariant after it."""
    flush = eng._flush

    def recorded():
        before = _launch_counts()
        t0 = time.perf_counter()
        res = flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = dict(flush=res.round_idx, host_s=res.seconds, wall_s=wall,
                   virtual_s=res.virtual_seconds, t_virtual=res.t_virtual,
                   staleness=res.staleness_mean, cohort=[int(c) for c in res.cohort],
                   loss_before=res.loss_before, launches=_launch_delta(before))
        if check:
            row["inactive_nonzeros"] = _inactive_nonzeros(torch, eng.params)
            if row["inactive_nonzeros"]:
                raise AssertionError(f"flush {res.round_idx}: {row['inactive_nonzeros']} "
                                     f"nonzero entries past the ranks")
        if not math.isfinite(res.loss_before):
            raise AssertionError(f"flush {res.round_idx}: loss {res.loss_before}")
        rows.append(row)
        return res

    eng._flush = recorded


def _svd_drivers(torch, params):
    """The cloud aggregate's SVD under cuSOLVER's default Jacobi driver
    (``gesvdj``) and under the QR-based ``gesvd`` the hier engine asks for
    on CUDA: each factor's ``W`` rebuilt at its rank, the worst
    ``max|W' - W| / max|W|`` and the SVDs' time over all factors."""
    from repro_torch.core.factorization import materialize, rank_mask

    Ws = [(f, materialize(f)) for _, f in _factors(params)]
    out = {}
    for driver in ("gesvdj", "gesvd"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svds = [torch.linalg.svd(W, full_matrices=False, driver=driver) for _, W in Ws]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        worst = 0.0
        for (f, W), (P, s, Qt) in zip(Ws, svds):
            keep = rank_mask(f.rank, f.r_max, dtype=s.dtype)
            r = f.r_max
            W2 = (P[..., :, :r] * (s[..., :r] * keep)[..., None, :]) @ Qt[..., :r, :]
            worst = max(worst, ((W2 - W).abs().max() / W.abs().max()).item())
        out[driver] = dict(ms=ms, worst_rel=worst)
        log(f"[sim hier] cloud SVD driver {driver}: {len(Ws)} factor leaves "
            f"({sum(math.prod(W.shape[:-2]) for _, W in Ws)} matrices) in {ms:.1f} ms; worst "
            f"rebuild max|W' - W| / max|W| = {worst:.3g}")
    return out


def phase_sim(torch, counters, workdir):
    """The system simulator (``repro_torch.fed.sim``) through ``build(spec)``,
    at llm-100m's full width and depth:

    1. ``[sim sync]``: the sync engine priced under ``SIM_PROFILE``, two
       rounds, bit-identical to the plain engine's two rounds from the same
       params and batches; each round's virtual seconds recomputed as the
       straggler barrier;
    2. ``[sim async-uniform]``: a uniform fleet with buffer 4, two flushes,
       bit-identical to the plain rounds, with their launches;
    3. ``[sim async]``: ``examples/configs/async_straggler.toml`` (buffer 2,
       staleness power 0.5, downcast wire), ``SIM_FLUSHES`` flushes with the
       invariant held exactly after each; again with the jsonl, perfetto
       and memory sinks: the same timeline and bits, a valid event log, a
       trace with both clocks and a track per client;
    4. ``[sim hier]``: ``examples/configs/hier_int8_wire.toml`` (2 edges ×
       2 edge rounds, int8 edge wire), one cloud round: edge bytes against
       an identity edge wire's, the invariant after the cloud aggregate,
       the cloud SVD's time; then a 1-edge cloud aggregate of the result
       held to keep every factor's U S Vᵀ.
    """
    import numpy as np

    from repro_torch.api import ExperimentSpec, build, load_spec
    from repro_torch.core import cost_model
    from repro_torch.core.factorization import materialize
    from repro_torch.fed.sim import Fleet, make_sim_engine
    from repro_torch.fed.wire import Wire
    from repro_torch.telemetry import NULL_HUB, set_hub, validate_jsonl

    sets = ["model.preset=llm-100m"]
    configs = os.path.join(ROOT, "examples", "configs")
    base = ExperimentSpec(name="chip-sim", seed=0, rounds=2, log_every=0).with_overrides(sets)

    # the plain engine's two rounds: what steps 1 and 2 are held to (their
    # launches are the comparison's, outside the path's count)
    plain = build(base, device="cuda")
    params0 = _clone(plain.params)
    cfg = plain.engine.cfg
    before = _launch_counts()
    plain.run(rounds=2)
    torch.cuda.synchronize()
    plain_launches = _launch_delta(before)
    params_plain, plain_hist = plain.params, plain.history
    log(f"[sim] plain sync engine, 2 rounds: host {[round(r.seconds, 3) for r in plain_hist]} "
        f"s; launches {plain_launches}")
    del plain

    # the main path: counts at 0 just before, read after the hier round
    _zero_counts()
    t_path = time.perf_counter()

    # 1. sync engine on the virtual clock
    s_spec = base.with_overrides([f"sim.profile={SIM_PROFILE}"])
    exp = build(s_spec, params=_clone(params0), device="cuda")
    fleet = Fleet.from_spec(SIM_PROFILE, cfg.num_clients, seed=s_spec.seed)
    tokens = s_spec.data.batch * (s_spec.data.seq + 1)  # a window is seq + 1 tokens
    sync_rows = []
    for r in range(2):
        before = _launch_counts()
        res = exp.run(rounds=1)[-1]
        torch.cuda.synchronize()
        got = _launch_delta(before)
        flops = float(cfg.s_star) * cost_model.client_step_flops(exp.params, tokens)
        want = max(fleet[int(c)].round_seconds(flops, res.wire_bytes_down_per_client,
                                               res.wire_bytes_up_per_client)
                   for c in res.cohort)
        if res.virtual_seconds != want:
            raise AssertionError(f"sim sync round {r}: virtual {res.virtual_seconds!r} != "
                                 f"straggler barrier {want!r}")
        sync_rows.append(dict(round=r, host_s=res.seconds, virtual_s=res.virtual_seconds,
                              t_virtual=res.t_virtual, staleness=res.staleness_mean,
                              launches=got))
        log(f"[sim sync] round {r}: host {res.seconds:.3f} s; virtual {res.virtual_seconds:.3f} s "
            f"(= max over the cohort of round_seconds({flops:.4g} flops, "
            f"{res.wire_bytes_down_per_client / 1e6:.3f} MB down, "
            f"{res.wire_bytes_up_per_client / 1e6:.3f} MB up)), t {res.t_virtual:.3f} s; "
            f"staleness {res.staleness_mean:g}; launches {got}")
    if not _tensor_bits_equal(torch, exp.params, params_plain):
        raise AssertionError("sim sync params differ from the plain engine's")
    if [r.loss_before for r in exp.history] != [r.loss_before for r in plain_hist]:
        raise AssertionError("sim sync losses differ from the plain engine's")
    log(f"[sim sync] 2 rounds under {SIM_PROFILE}: params bit-identical to the plain engine's")
    del exp

    # 2. async, uniform fleet, buffer = C: the sync rounds
    u_spec = base.with_overrides(["engine.kind=async", f"engine.buffer_size={cfg.num_clients}"])
    exp = build(u_spec, params=_clone(params0), device="cuda")
    uniform_rows = []
    _record_flushes(torch, exp.engine, uniform_rows, check=False)
    before = _launch_counts()
    exp.run(rounds=2)
    torch.cuda.synchronize()
    got = _launch_delta(before)
    for row in uniform_rows:
        log(f"[sim async-uniform] flush {row['flush']}: host {row['host_s']:.3f} s; virtual "
            f"{row['virtual_s']:.3f} s; staleness {row['staleness']:g}; launches "
            f"{row['launches']}")
    if not _tensor_bits_equal(torch, exp.params, params_plain):
        raise AssertionError("async (uniform, buffer C) params differ from the sync engine's")
    if got != plain_launches:
        raise AssertionError(f"async (uniform, buffer C) launches {got} != sync {plain_launches}")
    log(f"[sim async-uniform] 2 flushes of {cfg.num_clients}: params bit-identical to the sync "
        f"engine's 2 rounds, launches {got} equal")
    del exp

    # 3. FedBuff under the straggler fleet, twice: telemetry off, then on
    a_sets = sets + ["name=chip-sim-async", f"rounds={SIM_FLUSHES}", "log_every=0"]
    a_spec = load_spec(os.path.join(configs, "async_straggler.toml")).with_overrides(a_sets)
    runs = []
    for tel in (False, True):
        spec = a_spec
        if tel:
            teldir = os.path.join(workdir, "sim_telemetry")
            spec = a_spec.with_overrides(["telemetry.enabled=true",
                                          "telemetry.sinks=jsonl,perfetto,memory",
                                          f"telemetry.dir={teldir}"])
        exp = build(spec, params=_clone(params0), device="cuda")
        rows = []
        _record_flushes(torch, exp.engine, rows, check=not tel)
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        runs.append(dict(exp=exp, rows=rows, wall_s=time.perf_counter() - t0))
        if tel:
            exp.hub.close()
            set_hub(NULL_HUB)
    off, on = runs
    for row in off["rows"]:
        log(f"[sim async] flush {row['flush']}: host {row['host_s']:.3f} s; virtual "
            f"{row['virtual_s']:.3f} s, t {row['t_virtual']:.3f} s; staleness "
            f"{row['staleness']:g} (cohort {row['cohort']}); loss {row['loss_before']:.6f}; "
            f"launches {row['launches']}; nonzeros past the ranks {row['inactive_nonzeros']}")
    eng = off["exp"].engine
    if not any(r.staleness_mean > 0 for r in eng.history):
        raise AssertionError("no stale flush in the async run")
    first, n_agg = {}, 0  # client → flushes done before its first arrival
    for e in eng.timeline:
        n_agg += e.kind == "aggregate"
        if e.kind == "arrive":
            first.setdefault(e.client, n_agg)
    keys_on, keys_off = on["exp"].engine.timeline.keys(), eng.timeline.keys()
    if keys_on != keys_off:
        raise AssertionError("same seed, telemetry on: the timeline differs")
    if not _tensor_bits_equal(torch, on["exp"].params, off["exp"].params):
        raise AssertionError("same seed, telemetry on: the params differ")
    if _history_rows(on["exp"].history) != _history_rows(eng.history):
        raise AssertionError("same seed, telemetry on: the history differs")
    events = os.path.join(teldir, "events.jsonl")
    errs = validate_jsonl(events)
    if errs:
        raise AssertionError(f"{events}: {errs[:5]}")
    with open(os.path.join(teldir, "trace.json")) as fh:
        trace = json.load(fh)["traceEvents"]
    clocks = {e["args"]["name"] for e in trace if e["ph"] == "M" and e["name"] == "process_name"}
    tracks = sorted({e["tid"] for e in trace if e["ph"] == "X" and e["pid"] == 2
                     and e["tid"] != 0})
    [mem] = [x for x in on["exp"].hub.sinks if x.name == "memory"]
    names = sorted({f"{e['kind']}:{e['name']}" for e in mem.events})
    if clocks != {"wall clock", "virtual clock"}:
        raise AssertionError(f"trace processes {clocks}")
    if tracks != [c + 1 for c in range(cfg.num_clients)]:
        raise AssertionError(f"virtual client tracks {tracks}: a client never arrived within "
                             f"{SIM_FLUSHES} flushes (first arrivals at flush {first})")
    stale = [r["staleness"] for r in off["rows"]]
    log(f"[sim async] {SIM_FLUSHES} flushes under {SIM_PROFILE}, buffer 2, downcast wire: "
        f"staleness mean {np.mean(stale):.3f} (max {max(stale):g}, "
        f"{sum(s > 0 for s in stale)} stale flushes); every client arrived, first at flushes "
        f"{first}; the invariant exact after every flush; host {off['wall_s']:.3f} s off vs "
        f"{on['wall_s']:.3f} s with telemetry; virtual {eng.clock.now:.3f} s")
    log(f"[sim async] same seed with the jsonl, perfetto and memory sinks: {len(keys_on)} "
        f"timeline entries identical, params and history bit-identical; validate_jsonl ok "
        f"({os.path.getsize(events) / 1e6:.3f} MB); trace: {sorted(clocks)}, virtual client "
        f"tracks {tracks}; events {names}")
    async_stats = dict(flushes=off["rows"], wall_s=off["wall_s"], telemetry_wall_s=on["wall_s"],
                       virtual_s=eng.clock.now, first_arrival_flush=first,
                       timeline_entries=len(keys_on), trace_events=len(trace),
                       events=len(mem.events))
    del runs, off, on, eng, mem

    # 4. hier: 2 edges × 2 edge rounds, int8 edge wire, one cloud round
    h_sets = sets + ["name=chip-sim-hier", "rounds=1", "log_every=0"]
    h_spec = load_spec(os.path.join(configs, "hier_int8_wire.toml")).with_overrides(h_sets)
    exp = build(h_spec, params=_clone(params0), device="cuda")
    heng = exp.engine
    svd_ms = []
    aggregate = heng._cloud_aggregate

    def timed(edge_params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = aggregate(edge_params)
        torch.cuda.synchronize()
        svd_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    heng._cloud_aggregate = timed
    before = _launch_counts()
    t0 = time.perf_counter()
    [res] = exp.run()
    torch.cuda.synchronize()
    hier_wall = time.perf_counter() - t0
    got = _launch_delta(before)
    counters["sim"] = _launch_counts()
    path_s = time.perf_counter() - t_path
    bad = _inactive_nonzeros(torch, exp.params)
    if bad:
        raise AssertionError(f"hier: {bad} nonzero entries past the ranks after the cloud "
                             f"aggregate")
    _, id_down = Wire("identity").roundtrip(params0, name="edge_down")
    _, id_up = Wire("identity").roundtrip(exp.params, name="edge_up")
    down, up = res.wire_bytes_down_per_client, res.wire_bytes_up_per_client
    ratio = (id_down + id_up) / (down + up)
    ranks = np.concatenate([np.ravel(v) for v in res.ranks.values()])
    log(f"[sim hier] cloud round 0 (2 edges x 2 edge rounds of 2 clients): host "
        f"{hier_wall:.3f} s; virtual {res.virtual_seconds:.3f} s; edge wire "
        f"[{res.wire_codec}] {down / 1e6:.6f} MB down, {up / 1e6:.6f} MB up per edge vs "
        f"identity {id_down / 1e6:.6f} / {id_up / 1e6:.6f} MB = {ratio:.3f}x fewer bytes; cloud "
        f"aggregate (materialize + SVD + re-factor) {svd_ms[0]:.1f} ms; rank min/mean/max "
        f"{ranks.min():.0f}/{ranks.mean():.2f}/{ranks.max():.0f}; invariant exact; loss "
        f"{res.loss_before:.6f}; launches {got}")
    if not math.isfinite(res.loss_before):
        raise AssertionError(f"hier loss {res.loss_before}")

    # a 1-edge cloud aggregate keeps every factor's U S Vᵀ (tests/test_sim.py's
    # single-edge refactorization pin, here on the card)
    one = make_sim_engine("hier", exp.task.loss_fn, exp.params, cfg, num_edges=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = one._cloud_aggregate([exp.params])
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0)
    worst = 0.0
    for (path, f), (_, g) in zip(_factors(exp.params), _factors(again)):
        W, W2 = materialize(f), materialize(g)
        rel = ((W2 - W).abs().max() / W.abs().max()).item()
        worst = max(worst, rel)
        if not rel <= 1e-4:
            raise AssertionError(f"1-edge cloud aggregate: {path} U S V^T moved by {rel}")
        if not torch.equal(f.rank, g.rank):
            raise AssertionError(f"1-edge cloud aggregate: {path} rank changed")
    if _inactive_nonzeros(torch, again):
        raise AssertionError("1-edge cloud aggregate broke the invariant")
    log(f"[sim hier] 1-edge cloud aggregate of the round's params: worst factor max|W' - W| / "
        f"max|W| = {worst:.3g} <= 1e-4, ranks kept; {one_ms:.1f} ms")
    drivers = _svd_drivers(torch, exp.params)
    for name in ("xus", "avt", "atb"):
        if not counters["sim"][name]:
            raise AssertionError(f"sim path launched no {name}: {counters['sim']}")
    log(f"[sim] path (sync, async-uniform, 2 x async, hier) in {path_s:.1f} s; launches "
        f"{counters['sim']}")
    hier_stats = dict(host_s=hier_wall, virtual_s=res.virtual_seconds, down_bytes=down,
                      up_bytes=up, identity_down_bytes=id_down, identity_up_bytes=id_up,
                      byte_ratio=ratio, cloud_aggregate_ms=svd_ms[0], one_edge_ms=one_ms,
                      one_edge_worst_rel=worst, svd_drivers=drivers, launches=got)
    del exp, heng, one, again
    return dict(sync=sync_rows, uniform=uniform_rows, plain_launches=plain_launches,
                async_=async_stats, hier=hier_stats, path_s=path_s)


#: ATen operators one Qwen2-7B bf16 engine decode step dispatched before the
#: mesh was ported (``[serve]``, Run 21.4, H100 80GB HBM3, 700.00 W): the
#: path without a mesh must not have grown
SERVE_STEP_DISPATCHES = 7980
#: the dry runs of the card machine's host: (arch, shape), and whether a
#: documented skip is expected
DRYRUNS = (("qwen2-7b", "train_4k", False), ("qwen2-7b", "prefill_32k", False),
           ("qwen2-7b", "decode_32k", False), ("rwkv6-7b", "long_500k", False),
           ("olmoe-1b-7b", "train_4k", False), ("qwen2-7b", "long_500k", True))


def _bits_equal(torch, a, b) -> bool:
    """Every leaf of ``b`` (DTensors read as their local shard, whole on a
    1 x 1 mesh) equal to ``a``'s, bit for bit."""
    from repro_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    lb = [t.to_local() if hasattr(t, "to_local") else t for t in lb]
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(la, lb))


def phase_mesh(torch, counters, serve_stats):
    """The sharded path on the card: an NCCL group of one rank (a
    ``FileStore`` in a temp dir) and a (1, 1) ``("data", "model")`` mesh,
    ``sharding.enable(mesh)``. On a 1 x 1 mesh every shard is whole, so the
    sharded path must give the bits of the path without a mesh, with the
    same kernel launches; any difference is a plumbing fault.

    - Qwen2-7B, bf16, full width and depth: a prefill of 4 rows (32
      tokens) and 8 greedy ``serve_step``s, without a mesh and then with
      the parameters laid out by ``sharding.distribute``: logits of every
      call bit-identical, ``xus`` / ``avt`` launches equal; the host ms of a
      step both ways (DTensor's dispatch on a host-bound step).
    - llm-100m, f32: one FeDLRT round (spec defaults: 4 clients, s* 4,
      simplified correction) without a mesh, then with ``spec_tree`` and
      ``client_axes=("data",)`` under client mode: the new parameters and
      the losses bit-identical, ``xus`` / ``avt`` / ``atb`` launches equal.
    - the custom-op route the dry run traces through: host µs a call of
      ``torch.ops.repro_torch.xus`` / ``avt`` / ``atb`` on card tensors
      against the wrappers' direct calls.
    - ``sharding.enable(None)``: the engine's decode step dispatches
      :data:`SERVE_STEP_DISPATCHES` ATen operators, as before the port of
      the mesh (read in the serve phase), and a model step without a mesh
      launches ``decode_step_calls``'s ``xus`` / ``avt``.

    The counts for path ``mesh`` are those of the sharded runs (prefill,
    steps and round), zeroed just before and read just after each."""
    import numpy as np
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.api import ExperimentSpec
    from repro_torch.api.tasks import PRESETS
    from repro_torch.configs import get_config
    from repro_torch.core.fedlrt import fedlrt_round
    from repro_torch.kernels.coeff_grad import atb
    from repro_torch.kernels.lowrank_matmul import avt, xus
    from repro_torch.models import build_model, sharding
    from repro_torch.utils.tree import tree_map

    tag = "[mesh]"
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                            rank=0, world_size=1)
    mesh_counts = {k: 0 for k in KERNELS}

    def add(got):
        for k in KERNELS:
            mesh_counts[k] += got[k]

    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        log(f"{tag} NCCL group of 1 rank, mesh {mesh}")

        def layout(model, params):
            sharding.enable(mesh)
            with FakeTensorMode():  # the spec tree, without a second copy of the weights
                _, specs = model.init(torch.Generator(device="cuda"))
            specs = sharding.sanitize(mesh, params, specs)
            return sharding.distribute(params, specs, mesh), specs

        # -- Qwen2-7B serving --------------------------------------------------
        cfg = get_config("qwen2-7b")
        model = build_model(cfg)
        wgen = torch.Generator(device="cuda")
        wgen.manual_seed(0)
        with torch.no_grad():  # DTensor views of inference tensors are refused
            params, _ = model.init(wgen)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        prompt = torch.randint(1, cfg.vocab_size, (4, 32), generator=gen, device="cuda")
        steps = 8

        def serve_run(p):
            with torch.no_grad():
                _zero_counts()
                torch.cuda.synchronize()
                logits, cache = model.serve_prefill(p, {"tokens": prompt}, cache_len=32 + steps)
                outs = [logits]
                for _ in range(steps):
                    logits, cache = model.serve_step(p, cache, outs[-1].argmax(-1)[:, None])
                    outs.append(logits)
                torch.cuda.synchronize()
                got = _launch_counts()
                _zero_counts()  # one more step alone
                model.serve_step(p, cache, outs[-1].argmax(-1)[:, None])
                torch.cuda.synchronize()
                one = _launch_counts()
                host = []
                for _ in range(5):  # host ms of one more step, median of 5
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.serve_step(p, cache, outs[-1].argmax(-1)[:, None])
                    torch.cuda.synchronize()
                    host.append(time.perf_counter() - t0)
            outs = [o.to_local() if hasattr(o, "to_local") else o for o in outs]
            return outs, got, one, float(np.median(host) * 1e3)

        ref, ref_got, ref_one, ref_ms = serve_run(params)
        dp, _ = layout(model, params)
        outs, got, one, mesh_ms = serve_run(dp)
        add(got)
        same = all(torch.equal(a, b) for a, b in zip(ref, outs))
        launches_equal = all(ref_got[k] == got[k] and ref_one[k] == one[k]
                             for k in ("xus", "avt", "atb"))
        tokens = torch.stack([o.argmax(-1) for o in outs], dim=1)
        log(f"{tag} qwen2-7b bf16, 4 rows x 32 tokens + {steps} greedy steps on the 1x1 mesh: "
            f"logits bit-identical to no mesh: {same}; launches xus/avt/atb "
            f"{got['xus']}/{got['avt']}/{got['atb']} (no mesh {ref_got['xus']}/{ref_got['avt']}/"
            f"{ref_got['atb']}); step host {mesh_ms:.2f} ms with the mesh, {ref_ms:.2f} ms "
            f"without (median of 5); tokens row 0 {tokens[0].tolist()}")
        if not same or not launches_equal:
            raise AssertionError(f"{tag} qwen2-7b on a 1x1 mesh differs from no mesh: bits "
                                 f"{same}, launches {got} vs {ref_got}")
        if not bool(torch.isfinite(torch.stack(outs)).all()):
            raise AssertionError(f"{tag} NaN/inf logits")
        serve = dict(step_host_ms_mesh=mesh_ms, step_host_ms=ref_ms, launches=got)
        sharding.enable(None)
        del dp, params, model, ref, outs
        torch.cuda.empty_cache()

        # -- llm-100m FeDLRT round ---------------------------------------------
        spec = ExperimentSpec(name="chip-mesh-llm-100m", seed=0)
        fc = spec.fed.to_fed_config()
        lcfg = PRESETS["llm-100m"]
        lmodel = build_model(lcfg)
        wgen.manual_seed(1)
        with torch.no_grad():
            lparams, _ = lmodel.init(wgen)
            # row-major, as the mesh's shards are (QR's bases are column-major,
            # and cuBLAS rounds a product of the two layouts differently)
            lparams = tree_map(lambda t: t.contiguous(), lparams)
        batches = {"tokens": torch.randint(
            1, lcfg.vocab_size, (fc.num_clients, spec.data.batch, spec.data.seq + 1),
            generator=gen, device="cuda")}

        def round_run(p, **mesh_kw):
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = fedlrt_round(lmodel.loss_fn, p, batches, fc, **mesh_kw)
            torch.cuda.synchronize()
            return new, m, _launch_counts(), time.perf_counter() - t0

        new0, m0, got0, s0 = round_run(lparams)
        dp, specs = layout(lmodel, lparams)
        sharding.set_client_mode(True)
        try:
            new1, m1, got1, s1 = round_run(dp, spec_tree=specs, client_axes=("data",))
        finally:
            sharding.set_client_mode(False)
        add(got1)
        same = _bits_equal(torch, new0, new1) and all(
            torch.equal(m0[k], m1[k].to_local()) for k in ("loss_before", "loss_after"))
        launches_equal = all(got0[k] == got1[k] for k in ("xus", "avt", "atb"))
        log(f"{tag} llm-100m FeDLRT round (C={fc.num_clients}, s*={fc.s_star}) with spec_tree / "
            f"client_axes on the 1x1 mesh: bit-identical to no mesh: {same}; launches "
            f"xus/avt/atb {got1['xus']}/{got1['avt']}/{got1['atb']} (no mesh {got0['xus']}/"
            f"{got0['avt']}/{got0['atb']}); host {s1:.2f} s with the mesh, {s0:.2f} s without; "
            f"loss {float(m0['loss_before']):.4f} -> {float(m0['loss_after']):.4f}")
        if not same or not launches_equal:
            raise AssertionError(f"{tag} the llm-100m round on a 1x1 mesh differs from no mesh: "
                                 f"bits {same}, launches {got1} vs {got0}")
        train = dict(round_s_mesh=s1, round_s=s0, launches=got1)
        sharding.enable(None)
        del dp, lparams, new0, new1, lmodel
        torch.cuda.empty_cache()

        # -- the custom-op route's host cost -----------------------------------
        x = torch.randn(4, 3584, device="cuda", dtype=torch.bfloat16)
        U = torch.randn(3584, 256, device="cuda", dtype=torch.bfloat16)
        S = torch.randn(256, 256, device="cuda", dtype=torch.bfloat16)
        V = torch.randn(3584, 256, device="cuda", dtype=torch.bfloat16)
        A = torch.randn(512, 3584, device="cuda")
        B = torch.randn(512, 256, device="cuda")
        ops = torch.ops.repro_torch
        host = {
            "xus": (host_us(torch, lambda i: xus(x, U, S)),
                    host_us(torch, lambda i: ops.xus(x, U, S))),
            "avt": (host_us(torch, lambda i: avt(x[:, :256].contiguous(), V)),
                    host_us(torch, lambda i: ops.avt(x[:, :256].contiguous(), V))),
            "atb": (host_us(torch, lambda i: atb(A, B)), host_us(torch, lambda i: ops.atb(A, B))),
        }
        torch.cuda.synchronize()
        for k, (direct, op) in host.items():
            log(f"{tag} host us a call, {k}: wrapper {direct:.1f}, custom op {op:.1f} "
                f"(+{op - direct:.1f})")
        if not torch.equal(xus(x, U, S), ops.xus(x, U, S)):
            raise AssertionError(f"{tag} the custom op xus differs from the wrapper")
    finally:
        sharding.enable(None)
        dist.destroy_process_group()
    counters["mesh"] = mesh_counts

    # -- without a mesh: the serve phase's engine step, and a model step -----
    if serve_stats["aten_dispatches"] != SERVE_STEP_DISPATCHES:
        raise AssertionError(f"{tag} the engine's decode step dispatched "
                             f"{serve_stats['aten_dispatches']} ATen operators without a mesh, "
                             f"{SERVE_STEP_DISPATCHES} before the mesh was ported")
    want = decode_step_calls(cfg)
    per = {k: sum(n for (kk, *_), n in want.items() if kk == k) for k in ("xus", "avt")}
    if any(ref_one[k] != per[k] for k in per):
        raise AssertionError(f"{tag} a decode step without a mesh launched {ref_one}, "
                             f"decode_step_calls says {per}")
    log(f"{tag} without a mesh: the engine's decode step dispatched "
        f"{serve_stats['aten_dispatches']} ATen operators (serve phase; {SERVE_STEP_DISPATCHES} "
        f"before the mesh was ported); a model step launched {ref_one['xus']} xus + "
        f"{ref_one['avt']} avt (decode_step_calls: {per['xus']} + {per['avt']}), the same on "
        f"the 1x1 mesh")
    return dict(serve=serve, train=train,
                custom_op_host_us={k: dict(wrapper=v[0], custom_op=v[1]) for k, v in host.items()},
                decode_xus_avt_per_forward=per)


def phase_dryrun(torch, records):
    """``python -m repro_torch.launch.dryrun`` on the card machine's host
    (fake tensors on the card's device; nothing runs on it): the combos of
    :data:`DRYRUNS` at once, one process each, each writing its JSON under
    ``results/dryrun_torch``; their ``OK`` lines (mesh, devices,
    per-device argument / temp bytes, compute / memory / collective ms,
    dominant term) and the documented ``SKIP``. Then every local shape at
    which those traces call ``xus`` / ``avt`` / ``atb`` that the kernels
    phases lack, against its plain version on the card. Returns the new
    kernel records and the dry runs' results."""
    out = os.path.join(ROOT, "results", "dryrun_torch")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    t0 = time.perf_counter()
    for arch, shape, _ in DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", out]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=ROOT))
    results = {}
    for (arch, shape, skip), p in zip(DRYRUNS, procs):
        stdout, stderr = p.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith(("OK", "SKIP", "FAIL"))]
        log(f"[dryrun] {lines[-1] if lines else '(no result line)'}")
        want = "SKIP" if skip else "OK"
        if p.returncode != 0 or not lines or not lines[-1].startswith(want):
            raise AssertionError(f"[dryrun] {arch} x {shape}: expected {want}, rc "
                                 f"{p.returncode}: {stderr[-2000:]}")
        name = f"{'skip' if skip else '16x16'}__{arch}__{shape}.json"
        with open(os.path.join(out, name)) as f:
            results[(arch, shape)] = json.load(f)
    log(f"[dryrun] {len(DRYRUNS)} combos in {time.perf_counter() - t0:.1f} s (in parallel)")

    have = {(r["kernel"], r["dtype"], r.get("dim"), r.get("R"), r.get("G", 1), r["M"])
            for r in records if r["kernel"] in ("xus", "avt")}
    have |= {("atb", r["dtype"], r["Ka"], r["Kb"], 1, r["M"]) for r in records
             if r["kernel"] == "atb"}
    shapes = set()
    for res in results.values():
        for kernel, dtype, M, dim, R, G, _ in res.get("kernel_shapes", []):
            shapes.add((kernel, dtype, dim, R, G, M))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    new = []
    for kernel, dtype, dim, R, G, M in sorted(shapes - have):
        if kernel == "atb":
            new.append(atb_case(torch, dtype, M, dim, R, gen, G=G, tag="[kernels dryrun]"))
        else:
            new.append(kernel_case(torch, kernel, dtype, M, dim, R, gen, G=G,
                                   tag="[kernels dryrun]"))
        torch.cuda.empty_cache()
    _check_records(new)
    log(f"[dryrun] {len(shapes)} local kernel shapes recorded, {len(new)} new ones held to "
        f"their plain versions")
    summary = {f"{a} x {s}": ({"skipped": r["skipped"]} if "skipped" in r else {
        "mesh": r["mesh"], "devices": r["devices"], "lower_s": r["lower_s"],
        "memory": r["memory"], "roofline": {k: v for k, v in r["roofline"].items()
                                            if k != "collectives"}})
        for (a, s), r in results.items()}
    return new, summary


def atb_case(torch, dtype_name, M, Ka, Kb, gen, G=1, tag="[kernels]"):
    """One ``atb`` shape (stacked over G where G > 1) against its plain
    version, timed (kernel, plain, ``matmul(A.T, B)``) in a CUDA graph, with
    its bound and device launches held to ``atb_plan``; logs one line."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coeff_grad import atb, atb_plan

    dtype = getattr(torch, dtype_name)
    lead = (G,) if G > 1 else ()
    set_bytes = G * M * (Ka + Kb) * dtype.itemsize
    n_sets = max(2, min(64, math.ceil(L2_DEFEAT_BYTES / set_bytes)))
    sets = [(torch.randn(lead + (M, Ka), generator=gen, device="cuda").to(dtype),
             torch.randn(lead + (M, Kb), generator=gen, device="cuda").to(dtype))
            for _ in range(n_sets)]
    got, want = atb(*sets[0]), ref.atb_ref(*sets[0])
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if dtype_name == "float32":
        ok = err <= ATB_F32_RTOL * want.abs().max().item()
    else:
        ok = torch.allclose(got.float(), want.float(), **TOL[dtype_name])
    plan = atb_plan(G, M, Ka, Kb)
    dev = device_launches(torch, lambda: atb(*sets[0]))
    if dev != plan.launches:
        raise AssertionError(f"atb G={G} M={M} Ka={Ka} Kb={Kb}: {dev} device launches, plan "
                             f"{plan.launches}")
    reps = max(n_sets, 8)
    rec = dict(kernel="atb", model="dryrun", dtype=dtype_name, M=M, Ka=Ka, Kb=Kb, G=G,
               max_abs_err=err, ok=ok, splits=plan.splits, launches=dev,
               ms=graph_ms(torch, lambda i: atb(*sets[i]), n_sets, reps),
               plain_ms=graph_ms(torch, lambda i: ref.atb_ref(*sets[i]), n_sets, reps),
               library_ms=graph_ms(torch, lambda i: torch.matmul(
                   sets[i][0].transpose(-1, -2), sets[i][1]), n_sets, reps))
    b_ms, rec["bound_by"] = _atb_bound_ms(dtype_name, M, Ka, Kb)
    rec["bound_ms"] = G * b_ms
    log(f"{tag} atb {dtype_name:8s} {f'G={G:<3d}' if G > 1 else ''}M={M:<5d} Ka={Ka:<6d} "
        f"Kb={Kb:<4d} max_abs_err={err:.3g} {'ok' if ok else 'MISMATCH'}  "
        f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}) splits={plan.splits} launches={dev}")
    del sets
    return rec



# ---------------------------------------------------------------------------
# the example twins: examples/torch_*.py through their main()
# ---------------------------------------------------------------------------


def _twin(stem: str):
    """``examples/<stem>.py`` loaded as a module (``examples/`` is not a
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"twin_{stem}",
                                                  os.path.join(ROOT, "examples", f"{stem}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _twin_launches(torch, before, tag):
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _launch_counts().items()}
    log(f"{tag} launches: xus {got['xus']}, avt {got['avt']}, atb {got['atb']}")
    return got


def phase_examples(torch, counters):
    """The four example twins on the card, each through its ``main(argv)``
    with the flags a user would give, the counts at 0 just before the path
    and read just after:

    - ``torch_quickstart.py``: 100 FeDLRT rounds of the §4.1 least-squares
      problem (plain tensors: its loss contracts the factors itself); the
      planted rank 4 found;
    - ``torch_train_llm.py --preset llm-100m --rounds 2``: llm-100m at full
      width and depth, every factorized layer on ``xus`` / ``avt`` /
      ``atb``; then ``--rounds 3 --participation dropout:0.5`` under
      ``repro_torch.analysis.trace_audit``: cohorts of several sizes, one
      step signature at the engine's one round callsite;
    - ``torch_serve_llm.py``: two llm-tiny rounds, then 6 requests served
      from the checkpoint; fresh weights served continuous and static,
      token-identical;
    - ``torch_federated_vision.py --clients 4 --rounds 6``: the Fig. 5 table,
      the ``mlp`` task's factorized layer through ``lr_matmul`` on the
      kernels.

    Fails unless ``xus``, ``avt`` and ``atb`` each launched in the path."""
    from repro_torch.analysis import trace_audit

    stats = {}
    _zero_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()

    tag, t0, before = "[examples quickstart]", time.perf_counter(), _launch_counts()
    params = _twin("torch_quickstart").main([])
    if int(params.rank) != 4 or params.U.device.type != "cuda":
        raise AssertionError(f"{tag}: rank {int(params.rank)} on {params.U.device}, expected 4 "
                             f"on the card")
    stats["quickstart"] = dict(rank=int(params.rank), s=time.perf_counter() - t0,
                               launches=_twin_launches(torch, before, tag))
    log(f"{tag} the planted rank 4 found; {stats['quickstart']['s']:.1f} s")

    tag, t0, before = "[examples train]", time.perf_counter(), _launch_counts()
    train = _twin("torch_train_llm")
    hist = train.main(["--preset", "llm-100m", "--rounds", "2"])
    got = _twin_launches(torch, before, tag)
    if len(hist) != 2 or not all(math.isfinite(r.loss_before) and math.isfinite(r.loss_after)
                                 for r in hist):
        raise AssertionError(f"{tag}: {len(hist)} rounds, losses "
                             f"{[(r.loss_before, r.loss_after) for r in hist]}")
    if not all(got[k] for k in ("xus", "avt", "atb")):
        raise AssertionError(f"{tag}: llm-100m did not run on every kernel: {got}")
    stats["train"] = dict(s=time.perf_counter() - t0, host_s=[r.seconds for r in hist],
                          loss=[(r.loss_before, r.loss_after) for r in hist], launches=got)
    log(f"{tag} llm-100m, 2 rounds: host {', '.join(f'{r.seconds:.3f}' for r in hist)} s; "
        f"{stats['train']['s']:.1f} s with the build")

    tag, before = "[examples train dropout]", _launch_counts()
    with trace_audit() as audit:
        hist = train.main(["--preset", "llm-100m", "--rounds", "3", "--participation",
                           "dropout:0.5", "--log-every", "0"])
    got = _twin_launches(torch, before, tag)
    sizes = [r.cohort_size for r in hist]
    if len(set(sizes)) < 2:
        raise AssertionError(f"{tag}: the dropout draw gave one cohort size {sizes}")
    audit.assert_within_limit()
    if len(audit.counts) != 1:
        raise AssertionError(f"{tag}: {len(audit.counts)} round callsites, expected the "
                             f"engine's one: {audit.counts}")
    [((site_file, site_line, fn), n)] = audit.counts.items()
    log(f"{tag} cohorts {sizes} padded to 4: {n} step signature at "
        f"{os.path.relpath(site_file, ROOT)}:{site_line} ({fn}) over {len(hist)} rounds")
    stats["train_dropout"] = dict(cohorts=sizes, signatures=n, launches=got,
                                  host_s=[r.seconds for r in hist])

    tag, t0, before = "[examples serve]", time.perf_counter(), _launch_counts()
    serve_twin = _twin("torch_serve_llm")
    comps = serve_twin.main([])
    if len(comps) != 6 or any(len(c.tokens) != 16 for c in comps):
        raise AssertionError(f"{tag}: {[len(c.tokens) for c in comps]} tokens, expected 6 x 16")
    modes = {m: {c.rid: c.tokens.tolist() for c in serve_twin.main(["--skip-train", "--mode", m])}
             for m in ("continuous", "static")}
    if modes["continuous"] != modes["static"]:
        raise AssertionError(f"{tag}: continuous and static batching served different tokens")
    got = _twin_launches(torch, before, tag)
    if not (got["xus"] and got["avt"]):
        raise AssertionError(f"{tag}: serving did not run on xus / avt: {got}")
    stats["serve"] = dict(s=time.perf_counter() - t0, launches=got)
    log(f"{tag} trained and served 6 x 16 tokens; continuous ≡ static token for token; "
        f"{stats['serve']['s']:.1f} s")

    tag, t0, before = "[examples vision]", time.perf_counter(), _launch_counts()
    table = _twin("torch_federated_vision").main(["--clients", "4", "--rounds", "6"])
    got = _twin_launches(torch, before, tag)
    if list(table) != ["fedavg", "fedlin", "fedlrt:none", "fedlrt:simplified"] or not all(
            c.startswith("acc=") for cells in table.values() for c in cells):
        raise AssertionError(f"{tag}: unexpected table {table}")
    if not all(got[k] for k in ("xus", "avt", "atb")):
        raise AssertionError(f"{tag}: lr_matmul did not run on every kernel: {got}")
    stats["vision"] = dict(s=time.perf_counter() - t0, table=table, launches=got)
    log(f"{tag} the Fig. 5 table at C = 4, 6 rounds; {stats['vision']['s']:.1f} s")

    torch.cuda.synchronize()
    counters["examples"] = _launch_counts()
    missing = [k for k in ("xus", "avt", "atb") if not counters["examples"][k]]
    if missing:
        raise AssertionError(f"[examples] the path launched no {missing}")
    stats["path_s"] = time.perf_counter() - t_path
    log(f"[examples] the path in {stats['path_s']:.1f} s; launches {counters['examples']}")
    return stats


def decode_step_sums(name, cfg, records):
    """``name``'s measured numbers summed over one decode step of ``cfg``
    (each shape's record at its decode M: 4 rows, or 1 row an expert of a
    G = E stack) with the step's launches of it; and what bounds them."""
    counts = {(kernel, dtype, dim, R, G, 1 if G > 1 else 4): n
              for (kernel, dtype, dim, R, G), n in decode_step_calls(cfg).items()}
    return shape_sums(name, counts, records)


def kernel_summary(records, model_records, atb_records, flash_records, counters, cfg, atb_round,
                   xus_round, avt_round, encdec_sums):
    """Per kernel: ``xus``/``avt`` as the sum over one Qwen2-7B decode
    step's launches (M = 4) of each measured number, with the sum over one
    decode step of each of the models phase's architectures under
    ``by_model`` (Whisper-large-v3 and LLaVA-NeXT-Mistral-7B: their paths'
    recorded calls, a decode step's with a prefill's under ``prefill``)
    and over one llm-100m round's calls under ``round``;
    ``atb`` as the sum over
    one llm-100m FeDLRT round's calls (M = 512, f32: ``phase_atb``'s
    ``[atb] round``); ``flash_attention``
    as one Qwen2-7B 4096-token causal prefill (bf16). ``launches`` is the
    count over the paths' runs; the worst error is over every checked case."""

    def launches(name):
        return {"launches": sum(counters[p][name] for p in PATHS),
                "launches_by_path": {p: counters[p][name] for p in PATHS}}

    from repro_torch.api.tasks import lm_model_config

    all_records = records + model_records
    out = []
    for name in ("xus", "avt"):
        step = decode_step_sums(name, cfg, records)
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            **launches(name),
            "max_abs_err": max(r["max_abs_err"] for r in all_records if r["kernel"] == name),
            **step, "unit": "one Qwen2-7B decode step (bf16, M=4)",
        })
        out[-1]["by_model"] = {
            arch: dict(decode_step_sums(
                name, lm_model_config(model_serve_spec(arch, new).model), all_records),
                unit="one decode step (bf16, 4 slots)")
            for arch, _, new in MODELS
        }
        for path, arch, rows, prompt, _ in ENCDEC_VLM:
            out[-1]["by_model"][arch] = dict(
                encdec_sums[arch][name],
                unit=f"one decode step (bf16, {rows} rows; prefill: {prompt} tokens a row and "
                     f"the stub frontend's)")
        # the training path's calls, summed over one round
        out[-1]["round"] = {**(xus_round if name == "xus" else avt_round),
                            "bound_by": "operations",
                            "unit": "one llm-100m FeDLRT round (f32, M=512)"}
    bound_by = {r["bound_by"] for r in atb_records
                if r["model"] == "llm-100m" and r["dtype"] == "float32" and r["M"] == 512}
    out.append({
        "name": "atb", "route": "cuda", "source": SOURCES["atb"], "replaces": REPLACES["atb"],
        **launches("atb"),
        "max_abs_err": max(r["max_abs_err"] for r in atb_records),
        "ms": atb_round["ms"], "plain_ms": atb_round["plain_ms"],
        "bound_ms": atb_round["bound_ms"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": atb_round["library_ms"], "calls": atb_round["calls"],
        "device_launches": atb_round["device_launches"],
        "unit": "one llm-100m FeDLRT round (f32, M=512)",
    })
    [pre] = [r for r in flash_records if r["case"] == "qwen2-7b prefill"]
    out.append({
        "name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], **launches("flash_attention"),
        "max_abs_err": max(r["max_abs_err"] for r in flash_records),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
        "unit": "one Qwen2-7B 4096-token causal prefill (bf16)",
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

    def done(phase):
        torch.cuda.empty_cache()
        log(f"[time] {phase} phase done at {time.perf_counter() - t_start:.1f} s")

    smi = phase_environment(torch)
    done("build")
    records = phase_kernels(torch, cfg)
    done("kernels")
    round_calls = llm100m_round_calls(torch)
    atb_records, atb_round = phase_atb(torch, round_calls)
    done("atb")
    xus_train, xus_round = phase_xus_train(torch, round_calls)
    done("xus-train")
    avt_train, avt_round = phase_avt_train(torch, round_calls)
    done("avt-train")
    phase_backward(torch)
    done("backward")
    phase_f32_check(torch)
    done("f32")
    counters = {}
    serve_stats, bf16_tokens = phase_serve(torch, counters)
    done("serve")
    quant_stats = phase_serve_quant(torch, counters, serve_stats, bf16_tokens)
    done("serve-quant")
    model_records, model_stats = phase_models(torch, counters, records)
    done("models")
    ev_records, ev_stats, ev_sums = phase_encdec_vlm(torch, counters, records + model_records)
    model_records += ev_records
    done("encdec-vlm")
    mesh_stats = phase_mesh(torch, counters, serve_stats)
    done("mesh")
    dry_records, dry_stats = phase_dryrun(torch, records + model_records + atb_records)
    model_records += [r for r in dry_records if r["kernel"] != "atb"]
    atb_records += [r for r in dry_records if r["kernel"] == "atb"]
    done("dryrun")
    train = phase_train(torch, counters)
    done("train")
    flash_records = phase_flash(torch, counters)
    done("flash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spec_") as workdir:
        spec_stats = phase_spec(torch, counters, workdir)
    done("spec")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sim_") as workdir:
        sim_stats = phase_sim(torch, counters, workdir)
    done("sim")
    examples_stats = phase_examples(torch, counters)
    done("examples")
    log("[summary] " + json.dumps({"card": smi, "serve": serve_stats,
                                   "serve_quant": quant_stats, "models": model_stats,
                                   "encdec_vlm": ev_stats, "mesh": mesh_stats,
                                   "dryrun": dry_stats,
                                   "train": train,
                                   "flash": flash_records, "spec": spec_stats,
                                   "sim": sim_stats, "examples": examples_stats,
                                   "xus_train": xus_train,
                                   "avt_train": avt_train}))
    print(json.dumps({"kernels": kernel_summary(
        records, model_records, atb_records, flash_records, counters, cfg, atb_round, xus_round,
        avt_round, ev_sums)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
