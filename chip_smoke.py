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
  full width and depth in bf16 (the two 32B models at 16 of their 64
  layers, Jamba at 16 of its 72) through ``repro_torch.api.serve``: each
  model served, launches a forward held to ``decode_step_calls``, bytes
  against the plan, tok/s, p50/p99, decode step host and device ms, a
  repeated step and prefill bit-identical, the MoE capacity drops per
  step; then their new ``xus`` / ``avt`` shapes (the experts' G = 64 and
  G = 16 stacks included) against the plain versions, timed at a decode
  step's rows, untimed at the others; OLMoE-1B-7B in f32,
  kernel path against plain path: logits, and every layer's expert
  choices; RWKV6-7B in f32 the same: logits and greedy tokens; the
  recurrent models' 37-token prefill, host and device time; Jamba's
  Mamba state branch (the ``selective_scan`` kernel, one launch a Mamba
  layer a prefill or decode step, held to the layers) against the
  kernel's plain version at full width: one mixer over 2 x 1,100 tokens in
  bf16 and f32 (output and state within ``MAMBA_BF16_RTOL`` /
  ``MAMBA_F32_RTOL``, the state's differing bits held at none), the kernel's
  device time against its plain version's and its bound, and a
  reduced-depth model (one 8-layer superblock) prefilled over 37 and 1,100
  tokens (bf16 logits within ``MAMBA_MODEL_RTOL``, with the prefill's host
  and device time both ways; f32 logits within ``MODEL_F32_RTOL`` and
  greedy tokens identical);
- train: three FeDLRT rounds of llm-100m at full width and depth in f32
  through ``repro_torch.api.build(spec).run()``, counting the launches
  against the counts the model's factors imply; one more round under
  ``torch.profiler`` (device busy share, kernels by device time); then
  one round from the same start with ``kernels="off"`` (held to the
  kernel run) and the kernel round again (held to be bit-identical), its
  truncations' coefficients held to an f64 SVD under both cuSOLVER
  drivers;
- train-qwen2: the token stream's rows route held token-equal to the dense
  route at vocabulary 8192 on this host's numpy; one FeDLRT round of
  Qwen2-7B at full width and 14 of its 28 layers in bf16 (f32 bases,
  vocabulary 152,064, r_max 256) through ``build(spec).run()`` on 4 x
  4,096 tokens, with the launches, the losses, the inactive columns, the
  ranks and the measured wire bytes held (``cost_model.wire_round_bytes``),
  peak memory and host s a round; at full width and 2 layers one round with
  kernels on, its every call held to ``round_calls`` (one per launch, by
  kernel, dtypes, K or N, R, the stack G and the rows M), against one
  with kernels off (each factor's ``U S Vᵀ`` within 2⁻⁷ of its largest
  entry and 1/8 of the round's own change of it); every bf16 ``xus`` (S
  in bf16, or in f32 as the backward gives it) / ``avt`` / ``atb`` shape
  of the round against its plain version, timed, and the sums over the
  round that ran;
- train-olmoe: the same for OLMoE-1B-7B (16 layers, d 2048, 64 experts
  top-8 of hidden 1024, vocabulary 50,304): one round at 8 of the 16
  layers, each
  MoE projection one launch a layer with its 64 experts on
  the kernels' grid axis at the capacity's 80 rows; the 2-layer pair with
  the tokens whose expert choices differ counted, held only where none
  does, else again in f32, where a choice of the basis pass may differ
  only at a near-tie and a later one only within twice its call's
  largest router probability gap (an expert stack within 1/4 of its own
  change); the
  truncation SVD drivers on 8 expert members;
- train-rwkv: the same for RWKV6-7B (32 layers, d 4096, 64 heads of 64,
  d_ff 14,336 non-gated, vocabulary 65,536, the wkv in chunks of 64): one
  round at 16 of the 32 layers, with the kernels-off pair at 2 layers; after
  the main path, layer 0's time mix of the trained model at B 4, T 128 in
  f32 held to the same mix with its wkv run token by token in f64: the
  output and the gradients with respect to x, ``w0``, ``u`` and the decay
  LoRA within ``WKV_RTOL`` of each tensor's largest entry; the wkv's
  calls a round, their estimated device busy seconds and their share of
  the round's host time;
- train-jamba: the same for Jamba-1.5-Large at one 8-layer period, its
  round's memory reckoned first, the Mamba scan's kernels held to one
  ``selective_scan`` a mixer call and one ``selective_scan_bwd`` a call
  that takes a gradient; layer 0's Mamba mixer of the trained model, its
  scan kernels forward and backward, held to its recurrence run token by
  token in f64, and the two kernels to their plain versions at the
  round's shape;
- train-deepseek: the same for DeepSeekMoE-16B (28 layers, d 2048, 64
  routed experts top-6 of hidden 1408 and 2 shared ones of 2816 in all,
  vocabulary 102,400) at 4 of its 28 layers, its round's memory reckoned
  first; the routed experts' G = 64 stacks at the capacity's 60 rows, the
  shared experts dense factors at the batch's 512; after the main path,
  layer 0's shared experts of the trained model in f32, kernels against
  the plain chain: the output and the gradients of x and of each factor's
  U, S and V within ``SHARED_RTOL`` of each tensor's largest entry; the
  2-layer pair as OLMoE's; the truncation SVD drivers on 8 of the
  experts' 352 x 352 S̃;
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
  width, cut to 4 of its 12 layers, through ``build(spec).run()``: the
  sync engine priced under a 10x straggler fleet, held bit-identical to
  the plain engine, its
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
  and an llm-100m FeDLRT round (``spec_tree``, ``client_axes``), and the
  round again with ``int8_affine`` on the wire, held bit-identical to the
  same calls without a mesh, with equal launches and measured bytes; the
  host ms of a step both ways; the custom-op route's host µs a call; the
  engine's decode step without a mesh held to its ATen operator count from
  before the mesh was ported;
- dryrun: ``python -m repro_torch.launch.dryrun`` on the host for Qwen2-7B
  (train_4k, prefill_32k, decode_32k; long_500k the documented skip),
  RWKV6-7B (long_500k) and OLMoE-1B-7B (train_4k) on a fake 256-rank
  16 x 16 mesh, started after the build and tracing beside the phases
  before it, then every local ``xus`` / ``avt`` / ``atb`` shape those
  traces record (``xus`` by S's dtype too) against its plain version on
  the card (untimed);
- examples (last): the example twins ``examples/torch_*.py`` through their
  ``main``: the quickstart (the planted rank 4 found), ``torch_train_llm.py
  --preset llm-100m --rounds 2`` (llm-100m at full width and depth on
  ``xus`` / ``avt`` / ``atb``), a dropout-participation run of it at
  llm-tiny under ``repro_torch.analysis.trace_audit`` (one step signature
  per callsite),
  ``torch_serve_llm.py`` (trained, then continuous ≡ static), and
  ``torch_federated_vision.py --clients 4 --rounds 6`` (the ``mlp`` task's
  ``lr_matmul`` on the kernels).

Every failure raises and exits non-zero. The last two lines of standard
output are one JSON object with each kernel's numbers and one with the
device.

``python3 chip_smoke.py --round ARCH [--limit-gib G]``
runs no phase: one FeDLRT round of ARCH at full width and
depth through ``build(spec, device="cuda").run(1)`` on 4,096 tokens a
client at the largest cohort of 4, 2 and 1 clients
whose reckoned memory, with the layers' activations measured at full width,
fits G GiB (the card's memory by default), held to the training phases'
gates (:func:`recorded_round`).

Imports nothing of JAX. Needs one CUDA card.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
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
    # the port's own kernels: the reference computes this recurrence in XLA
    # (mamba_mix's sequential lax.scan, and in training associative_scan with
    # the custom VJP _linrec_bwd), no Pallas kernel does
    "selective_scan": "src/repro/models/ssm.py:185",
    "selective_scan_bwd": "src/repro/models/ssm.py:63",
}
SOURCES = {
    "xus": "src/repro_torch/csrc/lowrank_matmul.cu",
    "avt": "src/repro_torch/csrc/lowrank_matmul.cu",
    "atb": "src/repro_torch/csrc/coeff_grad.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
    "selective_scan_bwd": "src/repro_torch/csrc/selective_scan.cu",
}
KERNELS = tuple(SOURCES)
PATHS = ("serve", "serve-quant", "models", "encdec", "vlm", "mesh", "train", "train-qwen2",
         "train-olmoe", "train-rwkv", "train-jamba", "train-deepseek", "flash", "spec", "sim",
         "examples")
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


def mamba_layers(cfg) -> int:
    """Mamba layers of ``cfg``: one ``selective_scan`` launch each, a
    prefill or a decode step."""
    return cfg.superblocks * list(cfg.block_pattern).count("mamba")


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


def _case_inputs(torch, kernel, dtype, M, dim, R, n_sets, gen, G=1, s_dtype=None):
    """``n_sets`` input sets of one call; a stack of ``G`` (G > 1) leads
    every operand with G; ``xus``'s S in ``s_dtype`` (default ``dtype``)."""
    dev = "cuda"
    lead = (G,) if G > 1 else ()
    sets = []
    for _ in range(n_sets):
        if kernel == "xus":
            K = dim
            x = torch.randn(lead + (M, K), generator=gen, device=dev).to(dtype)
            U = (torch.randn(lead + (K, R), generator=gen, device=dev) / math.sqrt(K)).to(dtype)
            S = (torch.randn(lead + (R, R), generator=gen, device=dev) / math.sqrt(R)).to(
                s_dtype or dtype)
            sets.append((x, U, S))
        else:
            N = dim
            A = torch.randn(lead + (M, R), generator=gen, device=dev).to(dtype)
            V = (torch.randn(lead + (N, R), generator=gen, device=dev) / math.sqrt(R)).to(dtype)
            sets.append((A, V))
    return sets


def _bound_ms(kernel, dtype_name, M, dim, R, has_s=True, G=1, s_dtype=None):
    """``xus`` / ``avt``'s bound; ``xus``'s S in ``s_dtype`` (default the
    activations' dtype), its ``(x U) S`` product at S's dtype's peak (the
    kernel's second pass takes x U in f32 where S is f32)."""
    es = 2 if dtype_name == "bfloat16" else 4
    s_dtype = s_dtype or dtype_name
    if kernel == "xus":
        K = dim
        es_s = 2 if s_dtype == "bfloat16" else 4
        nbytes = G * ((M * K + K * R + M * R) * es + (R * R * es_s if has_s else 0))
        t_ops = G * (2 * M * K * R / PEAK_FLOPS[dtype_name]
                     + (2 * M * R * R / PEAK_FLOPS[s_dtype] if has_s else 0)) * 1e3
    else:
        N = dim
        nbytes = G * (M * R + N * R + M * N) * es
        t_ops = G * 2 * M * N * R / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_case(torch, kernel, dtype_name, M, dim, R, gen, G=1, tag="[kernels]", timed=True,
                s_dtype=None):
    """One ``xus`` / ``avt`` shape (stacked over G where G > 1) against its
    plain version, timed (kernel, plain, library) in a CUDA graph over
    enough input sets to defeat L2, with its bound, host µs a call and its
    device launches held to its plan; logs one ``tag`` line, returns the
    record. ``timed=False`` holds the shape to its plain version and its
    plan without timing it (its times None); ``xus`` is held with S and
    without. ``s_dtype``: ``xus``'s S in another dtype than x's, untimed
    only (no one library call takes mixed operands)."""
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
    sets = _case_inputs(torch, kernel, dtype, M, dim, R, n_sets if timed else 1, gen, G,
                        getattr(torch, s_dtype) if s_dtype else None)
    pairs = [(kfn(*sets[0]), pfn(*sets[0]))]
    if kernel == "xus":  # and without S
        pairs.append((xus(*sets[0][:2]), ref.xus_ref(*sets[0][:2])))
    torch.cuda.synchronize()
    err = max((got.float() - want.float()).abs().max().item() for got, want in pairs)
    ok = all(torch.allclose(got.float(), want.float(), **TOL[dtype_name]) for got, want in pairs)
    del pairs
    reps = max(n_sets, 20)
    rec = dict(kernel=kernel, dtype=dtype_name, M=M, dim=dim, R=R, G=G, max_abs_err=err, ok=ok,
               ms=None, plain_ms=None, library_ms=None, host_us=None,
               S=(s_dtype or dtype_name) if kernel == "xus" else None)
    if timed:
        rec.update(
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
    times = (f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
             f"library_ms={rec['library_ms']:.4f} " if timed else "untimed ")
    host = f" host_us={rec['host_us']:.1f}" if timed else ""
    s_txt = f"S={s_dtype} " if s_dtype else ""
    log(f"{tag} {kernel} {dtype_name:8s} {stack}M={M:<3d} {dimname}={dim:<6d} R={R:<3d} {s_txt}"
        f"max_abs_err={err:.3g} tol={TOL[dtype_name]} {'ok' if ok else 'MISMATCH'}  {times}"
        f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}){host}{route}")
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
    mamba = mamba_layers(eng.model.cfg)
    if got["selective_scan"] != mamba * (steps + prefills):
        raise AssertionError(f"{tag} selective_scan: {got['selective_scan']} launches, expected "
                             f"{mamba} Mamba layers x ({steps} decode steps + {prefills} "
                             f"prefills)")
    log(f"{tag} launches: xus {got['xus']}, avt {got['avt']} = "
        f"{forward} per forward x ({steps} decode steps + {prefills} prefills); "
        f"{forward} xus + {forward} avt per decode step"
        + (f"; selective_scan {got['selective_scan']} = {mamba} a forward" if mamba else ""))
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
#: of factors at full depth, 7.6 GB at the depth served), 4 × 8 each
MODELS = (("olmoe-1b-7b", 8, 16), ("deepseek-moe-16b", 4, 8), ("codeqwen1.5-7b", 4, 8),
          ("qwen1.5-32b", 4, 8), ("qwen3-32b", 4, 8), ("rwkv6-7b", 4, 8),
          ("jamba-1.5-large-398b", 4, 8))
#: the models served at full width and part depth (layers): the two 32B
#: models, whose every layer gives the kernels the same shapes, at 16 of
#: their 64, and Jamba-1.5-Large, whose every 8-layer period does, at two
#: periods of its nine; the part drives every shape and the launches a
#: forward of that depth; a decode step's sums (``by_model``) stay reckoned
#: over every layer from the shapes' records
MODEL_LAYERS = {"qwen1.5-32b": 16, "qwen3-32b": 16, "jamba-1.5-large-398b": 16}
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


def routing_flips(torch, routed, ref_routed, top_k, n_layers, forwards=False):
    """The tokens whose chosen expert set differs between two runs' MoE
    calls (a prefill's ``n_layers`` calls, then a decode step's), as
    (prefill or decode, layer, token, the reference's top-k margin), and
    the smallest margin of the reference's calls. ``forwards``: the calls
    are forwards of ``n_layers`` calls each, named by their index."""
    smallest, flips = float("inf"), []
    for i, (r, ref) in enumerate(zip(routed, ref_routed, strict=True)):
        margin = topk_margin(torch, ref.probs, top_k)
        smallest = min(smallest, margin.min().item())
        differ = (torch.sort(r.topi, -1).values != torch.sort(ref.topi, -1).values).any(-1)
        for t in torch.nonzero(differ).flatten().tolist():
            what = i // n_layers if forwards else "prefill" if i < n_layers else "decode"
            flips.append((what, i % n_layers, t, margin[t].item()))
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
      time (Qwen1.5-32B and Qwen3-32B at ``MODEL_LAYERS`` of their 64
      layers): launches per forward held to :func:`decode_step_calls`, the
      shapes its ``xus`` / ``avt`` calls took recorded (decode at 4 rows, or
      cap = 1 row an expert of a G = E stack; prefill at one prompt's
      bucket of 16–64 rows, its experts at that bucket's capacity, the LM
      head at 1 row),
      resident and factor bytes against the plan, tok/s, p50/p99, the
      decode step's host and device ms, a repeated step and prefill held
      bit-identical, and for the MoE models the assignments the capacity
      dropped per decode step (a reading);
    - each recorded shape the kernels phase did not cover, against its
      plain version (K 4096 / 5120 / 8192, N 13440 / 25600 / 27392 / 8192,
      the experts' G = 64 stacks at R 128 and 176; Mamba's d_inner 16384
      projections, its x_proj at R 72 and dt_proj at K 512, Jamba's G = 16
      expert stacks), with its times and bound at a decode step's rows
      (what ``by_model`` sums), untimed at the prefills' and the experts'
      other rows;
    - OLMoE-1B-7B's and RWKV6-7B's f32 checks (:func:`olmoe_f32_check`,
      :func:`greedy_f32_check`).

    Returns (kernel records, stats)."""
    import numpy as np

    from repro_torch.api import experiment, serve
    from repro_torch.serve import resident_bytes

    resolve = experiment.lm_model_config
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
        depth = MODEL_LAYERS.get(arch)
        t0 = t_arch = time.perf_counter()
        cut = (unittest.mock.patch.object(
            experiment, "lm_model_config",
            lambda m, depth=depth: dataclasses.replace(resolve(m), num_layers=depth))
            if depth else contextlib.nullcontext())
        with cut:
            session = serve(spec, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        eng = session.engine
        cfg = eng.model.cfg
        mixers = "+".join(sorted(set(cfg.block_pattern)))
        of = f" of {resolve(spec.model).num_layers}" if depth else ""
        log(f"{tag} built ({cfg.num_layers}{of} layers, d {cfg.d_model}, {cfg.compute_dtype}, "
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
        planned = None if depth else PLANNED_FACTOR_GB[arch]
        log(f"{tag} resident {res / 1e9:.3f} GB, of it factors {fb / 1e9:.3f} GB "
            + (f"at {depth} layers (the plan, {PLANNED_FACTOR_GB[arch]} GB, is for all of them)"
               if depth else f"against {planned} GB planned ({fb / 1e9 / planned:.3f}x)")
            + f"; peak {peak:.2f} GiB")
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
        # each shape the path gave the kernels, against its plain version;
        # timed at a decode step's rows
        decode = {(kernel, dtype, dim, R, G, 1 if G > 1 else 4)
                  for kernel, dtype, dim, R, G in decode_step_calls(cfg)}
        for key in sorted(shapes - have):
            kernel, dtype, dim, R, G, M = key
            model_records.append(kernel_case(torch, kernel, dtype, M, dim, R, gen, G=G,
                                             timed=key in decode))
        have |= shapes
        _check_records(model_records)
        torch.cuda.empty_cache()
        log(f"{tag} {time.perf_counter() - t_arch:.1f} s with its kernel shapes")
    t0 = time.perf_counter()
    stats["olmoe-1b-7b f32"] = olmoe_f32_check(torch)
    stats["rwkv6-7b f32"] = greedy_f32_check(torch, "rwkv6-7b", 3)
    log(f"[models f32] both checks took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stats["jamba mamba scan"] = mamba_scan_check(torch)
    log(f"[models jamba mamba scan] the check took {time.perf_counter() - t0:.1f} s")
    return model_records, stats


#: the Mamba check: Jamba-1.5-Large at full width cut to one 8-layer
#: superblock (7 Mamba layers, one attention layer, MoE on every other
#: layer), fresh weights; prompts of 37 tokens and 1,100, 2 rows each, then
#: 8 greedy decode steps
MAMBA_CHECK_LAYERS = 8
MAMBA_CHECK_T = (37, 1100)
MAMBA_CHECK_STEPS = 8
#: one full-width Mamba mixer, the selective-scan kernel against its plain
#: version on the same weights and inputs: output and new state within this
#: share of their largest entry. In bf16 both round every step's state at
#: the same points (the new state's bits are the same where the two agree
#: on every step); the output's sum over the 16 states runs in another
#: order, and the mixer's bf16 output and its projection round that
MAMBA_BF16_RTOL = 1e-2
#: the same in f32: sums in another order
MAMBA_F32_RTOL = 1e-5
#: the 8-layer model's bf16 prefill logits, kernel against plain, within
#: this share of max |logit|: a bf16 difference in a Mamba layer's output
#: can move an MoE router whose top-2 margin is under it, and a token whose
#: expert choice flips gets another expert's output (the flips are
#: logged). The greedy tokens are held identical in f32, within
#: ``MODEL_F32_RTOL``, where no router flips
MAMBA_MODEL_RTOL = 5e-2


def _mamba_prefill(torch, model, params, tokens, order):
    """A prefill of ``tokens`` and 8 greedy decode steps under ``order``
    (the kernel, or its plain version patched in): the prefill's logits,
    the greedy tokens and the MoE routings of the prefill."""
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


def scan_bound_ms(B, T, D, N, checkpoints=False):
    """The least time of one ``selective_scan`` call of this shape: each
    input read once (delta, x, Bp, Cp, A, h0, f32) and each output written
    once (y, h_T, and the checkpoints when asked for, f32), or its
    ``SCAN_OPS`` operations a (b, t, channel, state) at the f32 rate; the
    larger, which, and the bytes."""
    from repro_torch.kernels.selective_scan import SCAN_K, SCAN_OPS

    ck = B * -(-T // SCAN_K) * D * N if checkpoints else 0
    nbytes = 4 * (3 * B * T * D + 2 * B * T * N + D * N + 2 * B * D * N + ck)
    return _larger(nbytes, SCAN_OPS * B * T * D * N)


def scan_bwd_bound_ms(B, T, D, N):
    """The same for one ``selective_scan_bwd`` call: delta, x, dy, Bp, Cp,
    A, the checkpoints and dh_T read once, dδ, dx, dB, dC, dA and dh0
    written once (h0 is not read: the first checkpoint holds it), or its
    ``SCAN_BWD_OPS`` operations a (b, t, channel, state)."""
    from repro_torch.kernels.selective_scan import SCAN_BWD_OPS, SCAN_K

    ck = B * -(-T // SCAN_K) * D * N
    nbytes = 4 * (5 * B * T * D + 4 * B * T * N + 2 * D * N + 2 * B * D * N + ck)
    return _larger(nbytes, SCAN_BWD_OPS * B * T * D * N)


def _larger(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _mixer_pair(torch, cfg, p, x, state, orders):
    """Layer 0's mixer over ``x`` from ``state`` under each order: output,
    new ``h``, host ms (the second of two calls), and the arguments its
    ``selective_scan`` call took (kernel order)."""
    from repro_torch.models import ssm

    out, args = {}, []
    real = ssm.selective_scan
    for name, order in orders:
        def record(*a, real=real):
            args[:] = a
            return real(*a)

        with torch.inference_mode(), order(), (
                unittest.mock.patch.object(ssm, "selective_scan", record)
                if name == "kernel" else contextlib.nullcontext()):
            for _ in range(2):  # the second call timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y, new = ssm.mamba_mix(p, x, cfg, state=state)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        out[name] = (y.float(), new["h"], ms)
    rel = [((out["kernel"][i] - out["plain"][i]).abs().max()
            / out["plain"][i].abs().max()).item() for i in (0, 1)]
    h_bits = int((out["kernel"][1] != out["plain"][1]).sum().item())
    return rel, h_bits, out, args


def mamba_scan_check(torch):
    """The serving path's Mamba state branch, one ``selective_scan`` launch a
    mixer call, against the kernel's plain version
    (``ref.selective_scan_ref``, token by token, patched in for
    ``ssm.selective_scan``) on the same weights and inputs, at full width:

    - layer 0's Mamba mixer from a random state over 2 x 1,100 tokens, in
      bf16 and in f32: output and new ``h`` within ``MAMBA_BF16_RTOL`` /
      ``MAMBA_F32_RTOL`` of their largest entry, the entries of the new
      ``h`` whose bits differ (held at none: both round every step's state at
      the same points), the host ms of
      each; then the kernel alone on the bf16 mixer's arguments: device ms
      by CUDA events, the plain version's, the bound (the kernels JSON
      line's ``selective_scan`` entry);
    - the 8-layer model's prefill at each of ``MAMBA_CHECK_T``, in bf16:
      logits within ``MAMBA_MODEL_RTOL`` of max |logit|, with the expert
      choices that flipped, the greedy tokens that agree (readings), and
      the prefill's host and device ms both ways; in f32 (the same weights):
      logits within ``MODEL_F32_RTOL``, the prefill's and 8 decode steps'
      greedy tokens identical."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan
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
    plain = lambda: unittest.mock.patch.object(  # noqa: E731
        ssm, "selective_scan", ref.selective_scan_ref)
    orders = (("kernel", contextlib.nullcontext), ("plain", plain))
    out = {}

    # one mixer: no router downstream, the kernel's own difference
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")
    T = MAMBA_CHECK_T[-1]
    with torch.inference_mode():
        params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
        x = torch.randn((2, T, cfg.d_model), generator=gen, device="cuda")
        state = {k: 0.3 * torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype)
                 for k, v in ssm.mamba_init_state(cfg, 2, torch.float32, "cuda").items()}
    for dtype, c, prm, rtol in (("bfloat16", cfg, params, MAMBA_BF16_RTOL),
                                ("float32", cfg32, params32, MAMBA_F32_RTOL)):
        dt = getattr(torch, dtype)
        p = _layer(prm["blocks"]["pos0"]["mamba"], 0)
        st = {"h": state["h"], "conv": state["conv"].to(dt)}
        rel, h_bits, mix, args = _mixer_pair(torch, c, p, x.to(dt), st, orders)
        n_h = mix["plain"][1].numel()
        log(f"{tag} one Mamba mixer (d_inner {2 * cfg.d_model}, N {cfg.mamba.d_state}), 2 x {T} "
            f"tokens from a random state, {dtype}: max |kernel - plain| / max of the output "
            f"{rel[0]:.3g}, of the new h {rel[1]:.3g} (tol {rtol}); entries of the new h whose "
            f"bits differ: {h_bits} of {n_h}; host {mix['kernel'][2]:.1f} ms (kernel) vs "
            f"{mix['plain'][2]:.1f} ms (plain, token by token)")
        if not max(rel) <= rtol or h_bits:
            raise AssertionError(f"{tag} {dtype}: the mixer's kernel differs from its plain "
                                 f"version by {rel} (> {rtol}) or in {h_bits} bits of the state")
        out[f"mixer_{dtype}"] = dict(tokens=T, out_rel_err=rel[0], h_rel_err=rel[1],
                                     h_bits_differ=h_bits, h_entries=n_h,
                                     kernel_host_ms=mix["kernel"][2],
                                     plain_host_ms=mix["plain"][2])
        if dtype == "bfloat16":  # the kernel alone at the serving prefill's shapes
            n0 = selective_scan.launches
            ms = _event_ms(torch, lambda i: selective_scan(*args), 1, 20)
            plain_ms = _event_ms(torch, lambda i: ref.selective_scan_ref(*args), 1, 3)
            selective_scan.launches = n0  # timing launches are not the path's
            B_, T_, D_ = args[0].shape
            N_ = args[2].shape[-1]
            bound, bound_by, nbytes = scan_bound_ms(B_, T_, D_, N_)
            err = max((a - b).abs().max().item() for a, b in
                      zip(selective_scan(*args), ref.selective_scan_ref(*args)))
            selective_scan.launches = n0
            out["kernel"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                                 library_ms=None, max_abs_err=err, bytes=nbytes,
                                 shape=[B_, T_, D_, N_], scan_dt=dtype)
            log(f"[kernels] selective_scan B {B_} T {T_} D {D_} N {N_} "
                f"(state {dtype}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound:.3f} ms ({bound_by}: {nbytes / 1e6:.1f} MB), "
                f"{100 * bound / ms:.1f} % of the bound; max |kernel - plain| {err:.3g}")
        del mix, args, p, st
    del x, state

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
            log(f"{tag} {MAMBA_CHECK_LAYERS} layers, {dtype}, 2 x {T} tokens: max "
                f"|logits(kernel) - logits(plain)| / max |logit| = {err:.3g} (tol {rtol}); "
                f"expert choices flipped in the prefill: {len(flips)} of {2 * T * n_moe} "
                f"(token, layer); the prefill's greedy tokens "
                f"{'the same' if bool(same[0]) else 'differ'}, decode steps the same before "
                f"the first difference: {decode_same} of {MAMBA_CHECK_STEPS}")
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
                            f"{tag} {name}", 4 if T == MAMBA_CHECK_T[-1] else 0,
                            cpu=name == "kernel")
                    rec[f"{name}_host_ms"], rec[f"{name}_device_ms"] = wall * 1e3, busy_s * 1e3
                log(f"{tag} {dtype} 2 x {T}-token prefill: host {rec['kernel_host_ms']:.1f} ms, "
                    f"device busy {rec['kernel_device_ms']:.1f} ms (kernel, under the profiler "
                    f"of host and card); host {rec['plain_host_ms']:.1f} ms, device busy "
                    f"{rec['plain_device_ms']:.1f} ms (plain, token by token, under the card's "
                    f"profiler alone)")
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
    or N, R, G, M) → calls), each call at its shape's timed record, with
    what bounds them."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for key, n in counts.items():
        if key[0] != name:
            continue
        [rec] = [r for r in records if r["ms"] is not None
                 and (r["kernel"], r["dtype"], r["dim"], r["R"], r["G"], r["M"]) == key]
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
    # the shapes this phase sums over need their times: an untimed one is
    # taken again
    have = {(r["kernel"], r["dtype"], r["dim"], r["R"], r["G"], r["M"]) for r in records
            if r["ms"] is not None}
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


def llm100m_round_calls():
    """The ``xus``, ``avt`` and ``atb`` calls of one llm-100m FeDLRT round
    with the spec defaults, f32 (:func:`round_calls`), from the model's
    factors (built on the host: no data, no engine)."""
    import torch

    from repro_torch.api import ExperimentSpec
    from repro_torch.api.tasks import PRESETS
    from repro_torch.core.factorization import training_dtypes
    from repro_torch.models.model import build_params

    spec = ExperimentSpec(name="chip-calls-llm-100m", seed=0)
    with torch.no_grad():
        params, _ = build_params(PRESETS["llm-100m"], torch.Generator().manual_seed(0))
    return round_calls(training_dtypes(params), spec.fed.to_fed_config(),
                       spec.data.batch * spec.data.seq)


def phase_atb(torch, calls):
    """``atb`` against its plain version at every training-path shape, f32
    and bf16, with its device launches a call (held to ``atb_plan``), its
    time, bound, plain time and ``torch.matmul(A.T, B)``'s; then the sums
    over one llm-100m round's calls (``calls``, :func:`round_calls`, f32)."""
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
                    kernel="atb", model=model, dtype=dtype_name, M=M, Ka=Ka, Kb=Kb, G=1,
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
    return records, atb_round_total(torch, records, calls, "llm-100m")


def dominant_bound(parts) -> str:
    """"bytes" or "operations": the larger share of a sum of bounds, from
    its (bound ms, what bounds it) parts."""
    by = {"bytes": 0.0, "operations": 0.0}
    for ms, what in parts:
        by[what] += ms
    return max(by, key=by.get)


def atb_round_total(torch, records, calls, model, tag="[atb]"):
    """``atb``'s measured numbers summed over one ``model`` round's calls
    (``calls``, :func:`round_calls`), each call at its shape's record in
    ``records``; a shape none has is held to its plain version and timed
    (:func:`atb_case`) first, its record added to ``records``."""
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, calls=0, device_launches=0.0)
    parts = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for (_, dt, Ka, Kb, _, G, M), n in of_kernel(calls, "atb").items():
        found = [r for r in records if r["ms"] is not None and (
            r["dtype"], r["Ka"], r["Kb"], r["G"], r["M"]) == (dt, Ka, Kb, G, M)]
        if not found:
            found = [atb_case(torch, dt, M, Ka, Kb, gen, G=G, tag=tag, model=model)]
            _check_records(found)
            records += found
        rec = found[0]
        parts.append((n * rec["bound_ms"], rec["bound_by"]))
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[k] += n * rec[k]
        total["calls"] += n
        total["device_launches"] += n * rec["launches"]
    log(f"{tag} round: per {model} round: {total['calls']} calls, "
        f"{total['device_launches']:g} device launches; kernel {total['ms']:.3f} ms, plain "
        f"{total['plain_ms']:.3f} ms, library {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms; by (dtype, Ka, Kb, G, M): "
        + ", ".join(f"{dt} {Ka}x{Kb} G{G} M{M} x{n}"
                    for (_, dt, Ka, Kb, _, G, M), n in of_kernel(calls, "atb").items()))
    total["bound_by"] = dominant_bound(parts)
    return total


def _round_total(records, tag, model):
    """A round's sums over its shapes' ``records`` (each weighed by its
    ``calls``): kernel, plain, bound and, where every shape has one, library
    ms (``library_ms_where_one`` over the shapes that have one); logged."""
    total = {k: sum(r["calls"] * r[k] for r in records) for k in ("ms", "plain_ms", "bound_ms")}
    with_lib = [r for r in records if r["library_ms"] is not None]
    total["library_ms_where_one"] = sum(r["calls"] * r["library_ms"] for r in with_lib)
    total["library_calls"] = sum(r["calls"] for r in with_lib)
    total["library_ms"] = total["library_ms_where_one"] if len(with_lib) == len(records) else None
    total["calls"] = sum(r["calls"] for r in records)
    total["device_launches"] = sum(r["calls"] * r["launches"] for r in records)
    total["bound_by"] = dominant_bound((r["calls"] * r["bound_ms"], r["bound_by"]) for r in records)
    log(f"{tag} per {model} round: {total['calls']} calls, {total['device_launches']:g} "
        f"device launches; kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"library {total['library_ms_where_one']:.3f} ms over the {total['library_calls']} "
        f"calls that have one, bound {total['bound_ms']:.3f} ms")
    return total


def _n_sets(set_bytes):
    """Input sets cycled in a timing: all of them at least 4x the L2."""
    return max(2, min(64, math.ceil(L2_DEFEAT_BYTES / set_bytes)))


def phase_xus_train(torch, calls, tag="[xus-train]", model="llm-100m"):
    """``xus`` at every shape of one ``model`` FeDLRT round (``calls``,
    :func:`round_calls`: x's dtype, K, R, S's dtype or no S, the stack G and
    the rows M of each key), each held to its plain version, with its
    device launches a call against the plan, its time, the plain version's,
    the library call's (``torch.linalg.multi_dot``, or ``torch.matmul``
    without S or over a stack; none where S's dtype differs: no one call
    takes mixed operands) and the bound; then the sums over one round's
    calls (``library_ms`` None if a shape has no library call,
    ``library_ms_where_one`` over the shapes that have one)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_matmul import xus

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    records = []
    for (_, dt, K, R, s_name, G, M), n in of_kernel(calls, "xus").items():
        dtype, has_s = getattr(torch, dt), s_name is not None
        s_type = getattr(torch, s_name or dt)
        lead = (G,) if G > 1 else ()
        n_sets = _n_sets(G * ((M * K + K * R) * dtype.itemsize + R * R * s_type.itemsize))
        def draw(*shape, scale=1.0, dtype=dtype):
            return (torch.randn(lead + shape, generator=gen, device="cuda") * scale).to(dtype)

        sets = [(draw(M, K), draw(K, R, scale=K**-0.5),
                 draw(R, R, scale=R**-0.5, dtype=s_type) if has_s else None)
                for _ in range(n_sets)]
        got, plain = xus(*sets[0]), ref.xus_ref(*sets[0])
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        ok = torch.allclose(got.float(), plain.float(), **TOL[dt])
        dev = device_launches(torch, lambda: xus(*sets[0]))
        plan = _xus_route(sets[0][0], sets[0][1], sets[0][2], dev)
        if not has_s:
            lib = lambda i: torch.matmul(sets[i][0], sets[i][1])  # noqa: E731
        elif s_name != dt:
            lib = None
        elif G > 1:
            lib = lambda i: sets[i][0] @ sets[i][1] @ sets[i][2]  # noqa: E731
        else:
            lib = lambda i: torch.linalg.multi_dot(list(sets[i]))  # noqa: E731
        reps = max(n_sets, 20)
        rec = dict(dtype=dt, K=K, R=R, S=s_name, G=G, M=M, calls=n, max_abs_err=err, ok=ok,
                   route=plan.route, splits=plan.splits, launches=dev,
                   ms=graph_ms(torch, lambda i: xus(*sets[i]), n_sets, reps),
                   plain_ms=graph_ms(torch, lambda i: ref.xus_ref(*sets[i]), n_sets, reps),
                   library_ms=graph_ms(torch, lib, n_sets, reps) if lib else None)
        rec["bound_ms"], rec["bound_by"] = _bound_ms("xus", dt, M, K, R, has_s, G=G,
                                                     s_dtype=s_name)
        flops = G * (2 * M * K * R + (2 * M * R * R if has_s else 0))
        rec["tflops"] = flops / rec["ms"] / 1e9
        records.append(rec)
        lib_txt = "none" if lib is None else f"{rec['library_ms']:.4f}"
        log(f"{tag} {dt} {f'G={G} ' if G > 1 else ''}M={M} K={K:<5d} R={R:<3d} "
            f"S={s_name or 'no':8s} x{n:<5d} max_abs_err={err:.3g} tol={TOL[dt]} "
            f"{'ok' if ok else 'MISMATCH'}  kernel_ms={rec['ms']:.4f} ({rec['tflops']:.1f} TF/s) "
            f"plain_ms={rec['plain_ms']:.4f} library_ms={lib_txt} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}) route={plan.route} splits={plan.splits} launches={dev}")
        del sets, got, plain
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(
            f"{len(bad)} xus training case(s) disagree with the plain version: {bad}")
    return records, _round_total(records, tag, model)


def phase_avt_train(torch, calls, tag="[avt-train]", model="llm-100m"):
    """``avt`` at every shape of one ``model`` FeDLRT round (``calls``,
    :func:`round_calls`: dtype, N, R, the stack G and the rows M of each
    key), each held to its plain version, with its device launches a call
    against the plan, its time, the plain version's, the library call's
    (``torch.matmul(A, Vᵀ)``, TF32 off) and the bound; then the sums over
    one round's calls."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_matmul import avt

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    records = []
    for (_, dt, N, R, _, G, M), n in of_kernel(calls, "avt").items():
        dtype = getattr(torch, dt)
        lead = (G,) if G > 1 else ()
        n_sets = _n_sets(G * (M * R + N * R) * dtype.itemsize)
        sets = [(torch.randn(lead + (M, R), generator=gen, device="cuda").to(dtype),
                 (torch.randn(lead + (N, R), generator=gen, device="cuda") * R**-0.5).to(dtype))
                for _ in range(n_sets)]
        got, plain = avt(*sets[0]), ref.avt_ref(*sets[0])
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        ok = torch.allclose(got.float(), plain.float(), **TOL[dt])
        dev = device_launches(torch, lambda: avt(*sets[0]))
        plan, desc = _avt_route(*sets[0], dev)
        reps = max(n_sets, 20)
        rec = dict(dtype=dt, N=N, R=R, G=G, M=M, calls=n, max_abs_err=err, ok=ok,
                   route=plan.route, launches=dev,
                   ms=graph_ms(torch, lambda i: avt(*sets[i]), n_sets, reps),
                   plain_ms=graph_ms(torch, lambda i: ref.avt_ref(*sets[i]), n_sets, reps),
                   library_ms=graph_ms(torch, lambda i: torch.matmul(
                       sets[i][0], sets[i][1].transpose(-1, -2)), n_sets, reps))
        rec["bound_ms"], rec["bound_by"] = _bound_ms("avt", dt, M, N, R, G=G)
        rec["tflops"] = G * 2 * M * N * R / rec["ms"] / 1e9
        records.append(rec)
        log(f"{tag} {dt} {f'G={G} ' if G > 1 else ''}M={M} N={N:<5d} R={R:<3d} x{n:<5d} "
            f"max_abs_err={err:.3g} tol={TOL[dt]} {'ok' if ok else 'MISMATCH'}  "
            f"kernel_ms={rec['ms']:.4f} ({rec['tflops']:.1f} TF/s) plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}) {desc}")
        del sets, got, plain
    torch.cuda.empty_cache()
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(
            f"{len(bad)} avt training case(s) disagree with the plain version: {bad}")
    return records, _round_total(records, tag, model)


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


def fake_params(torch, cfg):
    """The training parameters of a model of ``cfg`` (f32 bases beside the
    model's S) as fake tensors: their shapes and dtypes, nothing
    allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.factorization import training_dtypes
    from repro_torch.models import build_model

    with FakeTensorMode():
        return training_dtypes(build_model(cfg).init(torch.Generator())[0])


def expert_rows(moe, M) -> int:
    """Rows each expert of a MoE block takes from ``M`` tokens: its capacity
    ``cap = min(max(int(cf·k·M/E), 1), M)`` (``models/moe.py`` ``route``)."""
    return min(max(int(moe.capacity_factor * moe.top_k * M / moe.num_experts), 1), M)


def round_calls(params, cfg, M, dtype="float32", moe=None):
    """The kernel calls of one FeDLRT round, one per launch: (kernel, the
    first operand's dtype, K or N or Ka, R or Kb, S's dtype or None, G, M)
    → calls, the keys :func:`kernel_calls` records.

    A factor leaf launches once a layer of its stack: G is the product of
    its further stack dims (a MoE block's E experts, the kernels' grid
    axis), M the rows of each member: batch × seq (``M``), or for the
    experts their capacity (:func:`expert_rows` of ``moe``). ``dtype`` is
    the activations' dtype; the backward's products with S (``dy V Sᵀ``,
    ``x U S``, ``u S I``) take S in f32, and the embedding gather's
    backward into U runs ``atb`` at U's dtype.

    Per launch, a forward is 1 ``xus`` (``x U S``) + 1 ``avt``. The
    backward of a linear layer in the basis-gradient pass (x, U, S, V all
    differentiated) is 4 ``xus`` (``dy V Sᵀ``, ``x U``, ``dy V``, ``x U
    S``), 1 ``avt`` (dx), 3 ``atb`` (dU, dS, dV); in the client loop (x and
    S̃, at the augmented rank 2r) 3 ``xus``, 1 ``avt``, 1 ``atb``. The
    embedding runs the chain on ``U[tok]`` (K = r) with its S in the U
    slot and an identity in the S slot: the basis pass's forward, ``dy V
    Iᵀ`` (K = d) and ``u S I`` on ``xus``, dx into ``U[tok]`` (N = r) on
    ``avt``, its coefficient and dV on ``atb``, plus 1 ``atb`` for the
    gather's backward into U (``onehotᵀ · g``); a client step the forward
    and ``dy V Iᵀ`` at 2r, and dS̃. Each client runs the basis pass once,
    s* client steps (one more with the full correction) and, with
    ``eval_after``, one forward.
    """
    calls = {}
    C, steps = cfg.num_clients, cfg.s_star + (1 if cfg.correction == "full" else 0)
    runs = 1 + (1 if cfg.eval_after else 0)  # the forward, and the evaluation's
    wide = "float32"
    for path, f in _factors(params):
        stack = tuple(f.U.shape[:-2])
        n, G = math.prod(stack[:1]), math.prod(stack[1:])
        rows = M if G == 1 else expert_rows(moe, M)
        r, r2 = f.r_max, 2 * f.r_max

        def add(kernel, a, b, times, s=None, dt=dtype):
            key = (kernel, dt, a, b, s, G, rows)
            calls[key] = calls.get(key, 0) + C * n * times

        if path == "['embed']":
            add("xus", r, r, runs, dtype)
            add("xus", r, r, 1, wide)  # u S I
            add("xus", f.n_out, r, 1, wide)  # dy V Iᵀ
            add("xus", r2, r2, steps, dtype)
            add("xus", f.n_out, r2, steps, wide)
            add("avt", f.n_out, r, runs)
            add("avt", r, r, 1)  # dx into U[tok]: N is the U slot's rows, S's r
            add("avt", f.n_out, r2, steps)
            add("atb", r, r, 1)  # the U slot (the coefficient)
            add("atb", f.n_out, r, 1)  # dV
            add("atb", f.n_in, r, 1, dt=str(f.U.dtype).removeprefix("torch."))  # onehotᵀ g
            add("atb", r2, r2, steps)  # dS̃ (its U slot)
            continue
        add("xus", f.n_in, r, runs, dtype)  # x U S
        add("xus", f.n_in, r, 1, wide)  # x U S, for dV
        add("xus", f.n_out, r, 1, wide)  # dy V Sᵀ
        add("xus", f.n_in, r, 1)  # x U
        add("xus", f.n_out, r, 1)  # dy V
        add("xus", f.n_in, r2, steps, dtype)
        add("xus", f.n_out, r2, steps, wide)
        add("xus", f.n_in, r2, steps)
        add("xus", f.n_out, r2, steps)
        add("avt", f.n_out, r, runs)
        add("avt", f.n_in, r, 1)  # dx
        add("avt", f.n_out, r2, steps)
        add("avt", f.n_in, r2, steps)
        add("atb", r, r, 1)  # dS
        add("atb", f.n_in, r, 1)  # dU
        add("atb", f.n_out, r, 1)  # dV
        add("atb", r2, r2, steps)  # dS̃
    return calls


def scan_launches(cfg, model_cfg) -> dict:
    """The Mamba scan kernels' launches of one FeDLRT round of a model of
    ``model_cfg`` under round config ``cfg``, reckoned as
    :func:`round_calls` reckons the projections': a Mamba mixer call is one
    ``selective_scan`` launch, and one ``selective_scan_bwd`` where it takes
    a gradient; each client calls every Mamba layer with a gradient in the
    basis pass and in each of its s* client steps (one more with the full
    correction), and without one in the evaluation (``eval_after``). Empty
    for a model without Mamba layers."""
    pattern = model_cfg.block_pattern
    n = sum(pattern[i % len(pattern)] == "mamba" for i in range(model_cfg.num_layers))
    if not n:
        return {}
    grad = cfg.num_clients * n * (1 + cfg.s_star + (1 if cfg.correction == "full" else 0))
    return {"selective_scan": grad + cfg.num_clients * n * (1 if cfg.eval_after else 0),
            "selective_scan_bwd": grad}


def launches_of(calls) -> dict:
    """``xus`` / ``avt`` / ``atb`` launches of :func:`round_calls`' calls."""
    out = {"xus": 0, "avt": 0, "atb": 0}
    for key, n in calls.items():
        out[key[0]] += n
    return out


def of_kernel(calls, kernel) -> dict:
    """The calls of ``kernel`` among :func:`round_calls`' (a sorted dict)."""
    return {k: n for k, n in sorted(calls.items(), key=str) if k[0] == kernel}


def _wrappers():
    from repro_torch.kernels.coeff_grad import atb
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_matmul import avt, xus
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_bwd

    return {"xus": xus, "avt": avt, "atb": atb, "flash_attention": flash_attention,
            "selective_scan": selective_scan, "selective_scan_bwd": selective_scan_bwd}


def _launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def device_profile(torch, fn, tag: str, top: int, cpu: bool = True, by_name=None, hold=None):
    """One call of ``fn`` under ``torch.profiler``: its kernels, the union
    of their intervals on the card (device busy seconds) and the host
    seconds of the call; logs the ``top`` kernel names by device time,
    each with its share, as ``tag`` lines. ``cpu=False`` traces the card
    alone: for a call of ~10^5 small operators, whose host events take the
    profiler tens of seconds to collect (the host seconds then lack the
    profiler's per-operator cost; a trace without device events is taken
    again with both). The trace's raw events are read, not the profiler's
    parsed ``events()``, whose Python objects cost minutes for a round of
    10^6 kernels. ``by_name``, a dict, receives each kernel
    name's device µs; ``hold``, a dict, the profiler while ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        if hold is not None:
            hold["prof"] = prof
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = []
    by_name = {} if by_name is None else by_name
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start, end, name = e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()
            spans.append((start, end))
            by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy, reach = 0.0, float("-inf")  # length of the union of the intervals (µs)
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    if not spans and not cpu:
        return device_profile(torch, fn, tag, top, by_name=by_name, hold=hold)
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
    want = launches_of(round_calls(params0, cfg, spec.data.batch * spec.data.seq))
    dense_elems = sum(
        f.n_in * f.n_out * math.prod(f.U.shape[:-2]) for _, f in _factors(params0)
    ) + sum(
        t.numel() for t in tree_leaves(params0)
    ) - sum(sum(t.numel() for t in (f.U, f.S, f.V, f.rank)) for _, f in _factors(params0))
    fedavg_bytes = 2 * dense_elems * 4  # cost_model.dense_round_comm_bytes of the dense model
    log(f"[train] {len(_factors(params0))} factor leaves; expected launches per "
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


def truncation_svd_drivers(torch, coeffs, tau, tag="[train]"):
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
        log(f"{tag} truncation SVD driver {driver}: {len(coeffs)} stacks "
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
# Qwen2-7B and OLMoE-1B-7B trained at full width and depth, bf16
# ---------------------------------------------------------------------------

#: one round, as OLMoE's and RWKV's (a second round reads only its host
#: time again)
QWEN2_ROUNDS = 1
#: the main path's depth, half of the model's 28 layers for the script's
#: time (the launch and wire gates hold at any depth); the timed shapes are
#: summed over this round's calls
QWEN2_LAYERS = 14
QWEN2_ROUND_UNIT = ("one Qwen2-7B FeDLRT round (bf16 activations, M=512; atb's embedding "
                    "gather in f32)")
QWEN2_TOKENS_PER_CLIENT = 4096
#: depth of the kernels-off comparison round (full width)
QWEN2_OFF_LAYERS = 2
QWEN2_OFF_TOKENS_PER_CLIENT = 512
#: the bf16 kernel round against the plain chain's (kernels="off"), from the
#: same parameters: two bf16 roundings (2⁻⁷) relative, for the loss (every
#: activation rounds to bf16 after f32 sums taken in another order; the
#: mean over 2,048 tokens a client) and for each factor's U S Vᵀ against its
#: largest entry (the bases are f32; S̃ takes each client's bf16 updates)
QWEN2_LOSS_RTOL = 2.0**-7
QWEN2_USVT_RTOL = 2.0**-7
#: and for each factor within this share of the round's own change of its
#: U S Vᵀ (kernels off against the start): Qwen2's k and v projections
#: (r_max 64) move by only ~1e-3 of their largest entry, their bf16 S below
#: its rounding, so 2⁻⁷ alone would pass a kernel round that left them
#: unchanged (a share of 1) or moved them wrongly; the kernel round's
#: bf16 activations shift the change by ~2 % of it
QWEN2_USVT_OF_MOVE = 1 / 8
#: the same share for an expert stack (a MoE block's E members in one
#: leaf): each member moves by ~1e-3 of the stack's largest entry in a
#: round, and one bf16 rounding apart reads 0.14-0.16 of that change on the
#: CPU (tests/test_torch_train_arch.py); a no-op round reads 1
EXPERT_USVT_OF_MOVE = 1 / 4
#: the least limit of a factor's kernels-against-off gap, of its largest
#: entry: 2⁻²⁰, 8 f32 ulps of it. A factor that one round barely trains
#: (Jamba's dt_proj and x_proj, reached only through Δ ~ 0.01 and the
#: scan's B and C) moves by a few ulps to ~1e-5 of its largest entry, so
#: 1/8 of that change would sit under the two rounds' f32 rounding; such a
#: factor is held to this instead (its f32 pair at full width reads up to
#: 2.95e-7, dt_proj's change 1.8e-7 to 6.5e-7, x_proj's 2.2e-6 up)
USVT_FLOOR = 2.0**-20
#: OLMoE-1B-7B (16 layers, d 2048, 64 experts top-8 of hidden 1024,
#: vocabulary 50,304): one round on 4 x 4,096 tokens (the rows route)
OLMOE_ROUNDS = 1
#: the main path's depth, half of the model's 16 layers, as Qwen2's
OLMOE_LAYERS = 8
OLMOE_ROUND_UNIT = ("one OLMoE-1B-7B FeDLRT round at 8 of its 16 layers (bf16 activations; "
                    "M=512, the experts' G=64 stacks at M=80; atb's embedding gather in f32)")
OLMOE_TOKENS_PER_CLIENT = 4096
OLMOE_OFF_LAYERS = 2
OLMOE_OFF_TOKENS_PER_CLIENT = 512
#: expert members whose truncation SVD both cuSOLVER drivers take (f64
#: reference on the host)
OLMOE_SVD_MEMBERS = 8
#: the reckoned peak of a cut training phase's round at the spec's four
#: clients (:func:`train_peak_reckoning`) is held at or under this, ~10 GiB
#: under the card's 79.18 for what a reckoning may miss
PEAK_LIMIT_GIB = 70.0
#: tokens of the rows-against-dense check of the token stream at vocab 8192
STREAM_CHECK_TOKENS = 8192


def token_stream_check():
    """The token stream's rows route (the one Qwen2's vocabulary takes)
    against the dense route, the JAX package's code, at vocabulary 8192 on
    this host's numpy and BLAS: token for token."""
    import numpy as np

    from repro_torch.data import synthetic

    kw = dict(vocab_size=8192, num_tokens=STREAM_CHECK_TOKENS, rank=16, temperature=1.0, seed=0)
    t0 = time.perf_counter()
    dense = synthetic._token_stream_dense(**kw)
    t1 = time.perf_counter()
    rows = synthetic._token_stream_rows(**kw)
    t2 = time.perf_counter()
    same = int(np.sum(rows == dense))
    log(f"[train-qwen2] token stream at vocab 8192 (numpy {np.__version__}): rows route "
        f"{same} of {len(dense)} tokens equal to the dense route's; dense {t1 - t0:.2f} s, "
        f"rows {t2 - t1:.2f} s ({1e3 * (t2 - t1) / len(dense):.3f} ms a token)")
    if same != len(dense):
        raise AssertionError(f"token stream: rows route differs from the dense route in "
                             f"{len(dense) - same} of {len(dense)} tokens")
    return dict(dense_s=t1 - t0, rows_s=t2 - t1, tokens=len(dense))


@contextlib.contextmanager
def kernel_calls(counts):
    """For the body: every ``xus`` / ``avt`` / ``atb`` call of the model's
    kernel path counted in ``counts`` by (kernel, the first operand's dtype,
    K or N or Ka, R or Kb, S's dtype or None, G, M): :func:`round_calls`'
    keys (G 1 for 2-D operands; ``atb``'s M is the rows it sums over)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    def name(t):
        return None if t is None else str(t.dtype).removeprefix("torch.")

    def key(kernel, a):
        G = a[0].shape[0] if a[0].dim() == 3 else 1
        if kernel == "xus":
            return ("xus", name(a[0]), a[1].shape[-2], a[1].shape[-1],
                    name(a[2]) if len(a) > 2 else None, G, a[0].shape[-2])
        return (kernel, name(a[0]), a[1].shape[-2] if kernel == "avt" else a[0].shape[-1],
                a[1].shape[-1], None, G, a[0].shape[-2])

    def add(kernel):
        return lambda a, _: counts.__setitem__(key(kernel, a), counts.get(key(kernel, a), 0) + 1)

    with calls_of(ops, "xus", add("xus")), calls_of(ops, "avt", add("avt")), \
            calls_of(ops, "atb", add("atb")), calls_of(layers, "atb", add("atb")):
        yield


def profile_train_round(torch, exp, tag, wall):
    """One more FeDLRT round of ``exp`` under ``torch.profiler`` (the card's
    trace alone): kernels by device time, the device busy share of an
    unprofiled round's host ``wall`` and the truncation SVD's share of the
    busy time. The truncations of expert stacks (leaves of G > 1 members,
    each member's ``gesvdj`` ~800 kernels: 2.4 M a round at OLMoE's 3,072,
    a trace the profiler takes minutes to read) run with the trace's card
    collection off, after a sync, timed by CUDA events: their time counts
    as busy and as SVD, an upper bound (it holds their few other kernels
    and the gaps between their launches)."""
    import repro_torch.core.fedlrt as fedlrt_module
    from torch.profiler import ProfilerActivity

    truncate, hold, apart, names = fedlrt_module.truncate, {}, [], {}

    def untraced(f, **kw):
        if f.S.dim() <= 3:
            return truncate(f, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        hold["prof"].toggle_collection_dynamic(False, [ProfilerActivity.CUDA])
        start.record()
        out = truncate(f, **kw)
        end.record()
        torch.cuda.synchronize()
        hold["prof"].toggle_collection_dynamic(True, [ProfilerActivity.CUDA])
        apart.append(start.elapsed_time(end) / 1e3)
        return out

    t0 = time.perf_counter()
    with unittest.mock.patch.object(fedlrt_module, "truncate", untraced):
        n, traced_s, wall_prof = device_profile(
            torch, lambda: exp.run(rounds=1, log_every=0), f"{tag[:-1]} profile]", 15,
            cpu=False, by_name=names, hold=hold)
    read_s = time.perf_counter() - t0 - wall_prof
    busy_s = traced_s + sum(apart)
    svd_s = sum(us for name, us in names.items() if "svd" in name.lower()) / 1e6 + sum(apart)
    log(f"{tag[:-1]} profile] one round: {n} kernels traced, device busy {busy_s:.3f} s = "
        f"{100 * busy_s / wall:.1f} % of an unprofiled round's {wall:.3f} s host (idle "
        f"{100 * (1 - busy_s / wall):.1f} %); {wall_prof:.3f} s under the profiler, "
        f"{read_s:.1f} s to read the trace; the truncation's SVDs {svd_s:.3f} s = "
        f"{100 * svd_s / busy_s:.1f} % of the busy time"
        + (f" (of it the {len(apart)} expert stacks' truncations untraced, by CUDA events: "
           f"{sum(apart):.3f} s)" if apart else ""))
    return dict(kernels_traced=n, device_busy_s=busy_s, traced_busy_s=traced_s,
                untraced_truncation_s=sum(apart), svd_s=svd_s, wall_s=wall,
                profiled_wall_s=wall_prof, read_s=read_s)


def _cut_round(torch, spec, arch, layers, tokens, dtype, calls=None, clients=None):
    """One FeDLRT round of ``arch`` at full width and ``layers`` layers in
    ``dtype`` (parameters and compute; f32 bases as every training caller)
    with kernels, and one with kernels off from the same parameters, with
    ``clients`` clients (the spec's when None); every kernel call of the
    first counted in ``calls``, every MoE block's routing of both recorded.
    The kernel run's start and end parameters go to host memory before the
    plain run starts, so one model's round lives on the card at a time.
    Returns (the start, (the kernel run's parameters, round result and
    routings), the plain run's, the round's ``FedConfig``): the start and
    the kernel run's parameters on the host."""
    from repro_torch.api import DataSpec, ModelSpec, build
    from repro_torch.api import tasks
    from repro_torch.models import moe
    from repro_torch.utils.tree import tree_map

    resolve = tasks.lm_model_config

    def cut(m):
        return dataclasses.replace(resolve(m), num_layers=layers, param_dtype=dtype,
                                   compute_dtype=dtype)

    fed = spec.fed if clients is None else dataclasses.replace(spec.fed, clients=clients)
    small = dataclasses.replace(spec, name=f"{spec.name}-cut", rounds=1, log_every=0,
                                data=DataSpec(tokens_per_client=tokens), fed=fed)
    runs = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    with unittest.mock.patch.object(tasks, "lm_model_config", cut):
        for kernels in ("auto", "off"):
            routed = []
            p = None if kernels == "auto" else tree_map(lambda t: t.cuda(), start)
            exp = build(dataclasses.replace(small, model=ModelSpec(arch=arch, kernels=kernels)),
                        params=p, device="cuda")
            if kernels == "auto":
                start = tree_map(lambda t: t.detach().cpu(), exp.params)
            count = kernel_calls(calls) if calls is not None and kernels == "auto" else (
                contextlib.nullcontext())
            with count, calls_of(moe, "route", lambda _, r: routed.append(r)):
                res = exp.run(rounds=1)[-1]
            params = exp.params
            if kernels == "auto":
                params = tree_map(lambda t: t.detach().cpu(), params)
            runs[kernels] = (params, res, routed)
            fed_cfg = exp.engine.cfg
            del exp, p
            gc.collect()
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return start, runs["auto"], runs["off"], fed_cfg


def moe_layers(params) -> int:
    """MoE blocks in a model's ``params``: the layers of every routed
    ``up`` expert stack, the MoE calls of one forward."""
    return sum(f.U.shape[0] for path, f in _factors(params) if path.endswith("['moe']['up']"))


def _usvt_gaps(torch, f, g, f0):
    """max|W_f − W_g|, max|W_g| and max|W_g − W_f0| of three factors of one
    leaf (``W = U S Vᵀ``), each member of a stack (its leading dims) on the
    card at a time, wherever its tensors lie: a MoE leaf of Jamba's 16
    experts of 8192 x 24,576 holds 12.9 GB of f32 entries whole."""
    from repro_torch.core.factorization import LowRankFactor, materialize

    def members(x):
        lead = x.U.shape[:-2]
        flat = [t.reshape((-1,) + t.shape[len(lead):]) for t in (x.U, x.S, x.V)]
        return [LowRankFactor(U=u.cuda(), S=s.cuda(), V=v.cuda(), rank=x.rank)
                for u, s, v in zip(*flat)]

    gap = scale = move = 0.0
    for a, b, c in zip(members(f), members(g), members(f0)):
        W, W_off, W0 = materialize(a), materialize(b), materialize(c)
        gap = max(gap, (W - W_off).abs().max().item())
        scale = max(scale, W_off.abs().max().item())
        move = max(move, (W_off - W0).abs().max().item())
        del W, W_off, W0
    return gap, scale, move


def _kernels_against_off(torch, tag, p0, on, off, moe_cfg, near_ties=False, same_start=0):
    """The kernel round ``on`` against the plain chain's ``off`` from ``p0``:
    the losses, the ranks, each factor's ``U S Vᵀ`` against its largest
    entry and against the round's own change of it (an expert stack within
    ``EXPERT_USVT_OF_MOVE``, the others ``QWEN2_USVT_OF_MOVE``; no limit
    under ``USVT_FLOOR`` of its largest entry), and with
    MoE blocks the tokens whose expert choices differ. Held to the limits
    unless an expert choice differs. With ``near_ties``, in the first
    ``same_start`` MoE calls (every client's basis pass, where both runs
    start from the same parameters and differ only by this forward's
    rounding) a choice may differ only at a near-tie (the plain round's
    top-k margin under ``FLIP_MARGIN``); later calls follow client steps,
    which amplify the two runs' f32 roundings step by step (each call's
    largest router probability gap logged), so there a choice may differ
    only where its margin is at most twice its own call's largest
    probability gap (a set of top-k choices changes only where two
    probabilities cross, and each moved by at most that gap: a flip past it
    is a fault of the choice, not of the rounding); and the limits are held
    all the same. Returns the readings."""
    import numpy as np

    (params_k, res_k, routed_k), (params_off, res_off, routed_off) = on, off
    out = dict(loss_before=(res_k.loss_before, res_off.loss_before),
               loss_after=(res_k.loss_after, res_off.loss_after))
    failed, gate = [], True
    if moe_cfg is not None:
        flips, smallest = routing_flips(torch, routed_k, routed_off, moe_cfg.top_k, 1,
                                        forwards=True)
        tokens = sum(r.probs.shape[0] for r in routed_off)
        out.update(flips=len(flips), smallest_margin=smallest, moe_calls=len(routed_off))
        log(f"{tag} kernels vs off: expert choices differ for {len(flips)} of {tokens} "
            f"(token, MoE call) over {len(routed_off)} MoE calls; smallest top-k margin "
            f"{smallest:.3g}" + "".join(f"; call {i} token {t} margin {m:.3g}"
                                        for i, _, t, m in flips[:5]))
        if near_ties:
            if same_start < 1:
                raise ValueError("near_ties needs the basis pass's MoE calls (same_start)")
            drift = [(a.probs - b.probs).abs().max().item()
                     for a, b in zip(routed_k, routed_off, strict=True)]
            start = max(drift[:same_start], default=0.0)
            early = [f for f in flips if f[0] < same_start]
            far = [f for f in early if f[-1] >= FLIP_MARGIN]
            out.update(start_drift=start, drift=drift)
            log(f"{tag} kernels vs off: the {same_start} MoE calls of the clients' basis pass "
                f"(one start): router probabilities within {start:.3g}, "
                f"{len(early)} differing choice(s) there, margins "
                f"{', '.join(f'{f[-1]:.3g}' for f in early[:8]) or '-'} (each under "
                f"{FLIP_MARGIN} held); the largest probability gap by call after it: "
                + ", ".join(f"{i} {d:.3g}" for i, d in enumerate(drift) if i >= same_start))
            if flips:
                first = [f for f in flips if f[0] == flips[0][0]]
                log(f"{tag} kernels vs off: the first MoE call with a differing choice, call "
                    f"{first[0][0]} (its largest probability gap {drift[first[0][0]]:.3g}): "
                    f"{len(first)} token(s), top-k margins "
                    f"{', '.join(f'{f[-1]:.3g}' for f in first[:8])}; "
                    f"{len(flips) - len(first)} more after it")
            unexplained = [f for f in flips if f[-1] > 2 * drift[f[0]]]
            out.update(worst_margin_of_drift=max((f[-1] / (2 * drift[f[0]]) for f in flips
                                                  if drift[f[0]] > 0), default=0.0))
            log(f"{tag} kernels vs off: every differing choice's margin against twice its "
                f"call's largest probability gap: at most {out['worst_margin_of_drift']:.3g} of "
                f"it (limit 1), {len(unexplained)} past it")
            if far:
                raise AssertionError(f"{tag} in the clients' basis pass an expert choice "
                                     f"differs at a margin >= {FLIP_MARGIN}: {far[:10]}")
            if unexplained:
                raise AssertionError(f"{tag} an expert choice differs at a margin over twice "
                                     f"its call's largest probability gap: "
                                     f"{[(f, drift[f[0]]) for f in unexplained[:10]]}")
        else:
            gate = not flips
    for name in ("loss_before", "loss_after"):
        a, b = getattr(res_k, name), getattr(res_off, name)
        rel = abs(a - b) / abs(b)
        log(f"{tag} kernels vs off, {name}: {a:.7f} vs {b:.7f} (rel {rel:.3g}, tol "
            f"{QWEN2_LOSS_RTOL:.3g})")
        if not rel <= QWEN2_LOSS_RTOL:
            failed.append(f"{name} differs between kernels and off by {rel}")
    ranks_same = all(np.array_equal(np.asarray(v), np.asarray(res_k.ranks[k]))
                     for k, v in res_off.ranks.items())
    if not ranks_same:
        failed.append(f"ranks differ: kernels {res_k.ranks} vs off {res_off.ranks}")
    worst, moves, of_move, floored, shared = 0.0, [], 0.0, [], []
    for (path, f), (_, g), (_, f0) in zip(_factors(params_k), _factors(params_off),
                                          _factors(p0)):
        # an expert stack has (layers, experts) in front; DeepSeekMoE's
        # shared experts, under the same block, are (layers,) stacks of
        # dense factors and held as such
        limit = EXPERT_USVT_OF_MOVE if f.U.dim() > 3 else QWEN2_USVT_OF_MOVE
        gap, scale, move = _usvt_gaps(torch, f, g, f0)
        rel, move = gap / scale, move / scale
        moves.append(move)
        if "['shared_" in path:
            shared.append((path, rel, move, limit))
        floor = limit * move < USVT_FLOOR
        worst = max(worst, rel)
        if floor:
            floored.append((path, rel, move))
        else:
            of_move = max(of_move, rel / move)
        log(f"{tag} kernels vs off, {path}: max|W - W_off| / max|W_off| = {rel:.3g}; "
            f"the round's own change max|W_off - W_0| / max|W_off| = {move:.3g} "
            + (f"(limit {USVT_FLOOR:.3g} of max: {limit:g} of the change is under it)" if floor
               else f"({rel / move:.3g} of it, limit {limit:g})"))
        if not (rel <= QWEN2_USVT_RTOL and rel <= max(limit * move, USVT_FLOOR)):
            failed.append(f"{path}: U S V^T differs between kernels and off by {rel} of its "
                          f"largest entry, {rel / move if move else math.inf} of the round's "
                          f"change")
    small = [(path, m) for (path, _), m in zip(_factors(params_off), moves)
             if m < 8 * QWEN2_USVT_RTOL]
    if small:
        log(f"{tag} kernels vs off: {len(small)} of {len(moves)} factor leaves move by less "
            f"than 8x the {QWEN2_USVT_RTOL:.3g} limit in the round, so that limit alone could "
            f"not tell a wrong round; each is held by its share of its own change, or "
            f"where that is under {USVT_FLOOR:.3g} by that bound: "
            + ", ".join(f"{path} {m:.3g}" for path, m in small))
    if shared:
        log(f"{tag} kernels vs off, the shared experts (dense factors beside the routed "
            f"experts, each held to {QWEN2_USVT_OF_MOVE:g} of its change as a dense factor): "
            + "; ".join(f"{p} gap {r:.3g} of max, change {m:.3g}, {r / m:.3g} of it (limit {lim:g})"
                        for p, r, m, lim in shared))
    if floored:
        log(f"{tag} kernels vs off: {len(floored)} factor leaves held to {USVT_FLOOR:.3g} of max, "
            f"worst gap {max(r for _, r, _ in floored):.3g}; of them a round that left the "
            f"factor as it was (a gap equal to its change) would pass for "
            + (", ".join(p for p, _, m in floored if m <= USVT_FLOOR) or "none"))
    log(f"{tag} kernels vs off: ranks {'identical' if ranks_same else 'DIFFER'}; worst factor "
        f"max|W - W_off| / max|W_off| = {worst:.3g} (tol {QWEN2_USVT_RTOL:.3g}), at most "
        f"{of_move:.3g} of the factor's own change in the round ({min(moves):.3g} to "
        f"{max(moves):.3g} over {len(moves)} factor leaves)"
        + ("" if gate else "; not held: expert choices differ"))
    if gate and failed:
        raise AssertionError(f"{tag} kernels vs off: " + "; ".join(failed))
    out.update(worst_usvt=worst, round_move=(min(moves), max(moves)), worst_of_move=of_move,
               ranks_same=ranks_same, held=gate, small_moves=small,
               floored=[dict(path=p, gap=r, move=m) for p, r, m in floored],
               shared=[dict(path=p, gap=r, move=m) for p, r, m, _ in shared])
    return out


@contextlib.contextmanager
def moment_peaks(torch, peaks):
    """For the body: the card's peak memory (GiB) in the moments of a
    FeDLRT round that :func:`train_peak_reckoning` reckons, and in the
    truncation, each the largest over its calls: ``basis pass backward`` (each client's
    ``value_and_grad``), ``augmentation`` (each leaf's ``augment_basis``),
    ``coefficient step`` (each client's ``client_step``) and
    ``truncation`` (each leaf's ``truncate``); each call starts the peak
    counter anew, and ``peaks["round"]`` keeps the peak over the whole
    body, the windows between the calls included."""
    import repro_torch.core.fedlrt as fl

    def fold():
        torch.cuda.synchronize()
        peaks["round"] = max(peaks.get("round", 0.0), torch.cuda.max_memory_allocated() / 2**30)

    def wrap(fn, name):
        def measured(*a, **kw):
            fold()
            torch.cuda.reset_peak_memory_stats()
            try:
                return fn(*a, **kw)
            finally:
                fold()
                peaks[name] = max(peaks.get(name, 0.0),
                                  torch.cuda.max_memory_allocated() / 2**30)
        return measured

    torch.cuda.reset_peak_memory_stats()
    with unittest.mock.patch.object(fl, "value_and_grad",
                                    wrap(fl.value_and_grad, "basis pass backward")), \
            unittest.mock.patch.object(fl, "augment_basis",
                                       wrap(fl.augment_basis, "augmentation")), \
            unittest.mock.patch.object(fl.FedLRTProgram, "client_step",
                                       wrap(fl.FedLRTProgram.client_step, "coefficient step")), \
            unittest.mock.patch.object(fl, "truncate", wrap(fl.truncate, "truncation")):
        yield
    fold()


def gated_round(torch, exp, tag, r, want, wire, r_max, watch=contextlib.nullcontext,
                by_moment=False):
    """One FeDLRT round of ``exp`` (``exp.run(rounds=1)``, inside
    ``watch()``) held to the training gates: finite losses, the launches
    ``want`` (:func:`launches_of` of :func:`round_calls`), no nonzeros past
    the ranks, every rank in [1, ``r_max`` of its leaf] and the measured
    wire bytes equal to ``wire`` (``cost_model.wire_round_bytes``); logged
    as ``tag`` round ``r``, with the round's peak card memory and, with
    ``by_moment``, each moment's (:func:`moment_peaks`, whose syncs around
    every call it wraps lengthen the round's host time: the recorded rounds
    only). Returns the readings."""
    import numpy as np

    before = _launch_counts()
    peaks = {}
    torch.cuda.reset_peak_memory_stats()
    with watch(), moment_peaks(torch, peaks) if by_moment else contextlib.nullcontext():
        res = exp.run(rounds=1)[-1]
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _launch_counts().items() if k in want}
    peak = peaks.pop("round", torch.cuda.max_memory_allocated() / 2**30)
    ranks = {k: np.ravel(v) for k, v in res.ranks.items()}
    flat = np.concatenate(list(ranks.values()))
    inactive = _inactive_nonzeros(torch, exp.params)
    if not (math.isfinite(res.loss_before) and math.isfinite(res.loss_after)):
        raise AssertionError(f"round {r}: non-finite loss {res.loss_before} / {res.loss_after}")
    if got != want:
        raise AssertionError(f"round {r}: launches {got}, expected {want}")
    if inactive:
        raise AssertionError(f"round {r}: {inactive} nonzeros past the ranks")
    bad = {k: v for k, v in ranks.items() if v.min() < 1 or v.max() > r_max[k]}
    if bad:
        raise AssertionError(f"round {r}: ranks outside [1, r_max]: {bad}")
    measured = (res.wire_bytes_down_per_client, res.wire_bytes_up_per_client)
    if measured != (wire["down"], wire["up"]):
        raise AssertionError(f"round {r}: measured wire bytes {measured}, cost model "
                             f"{(wire['down'], wire['up'])}")
    below = {k: int((v < r_max[k]).sum()) for k, v in ranks.items() if (v < r_max[k]).any()}
    by_r_max = {}
    for k, v in ranks.items():
        by_r_max.setdefault(r_max[k], []).append(v)
    by_r_max = {m: np.concatenate(v) for m, v in sorted(by_r_max.items())}
    log(f"{tag} round {r}: loss_before {res.loss_before:.6f} loss_after "
        f"{res.loss_after:.6f}; rank min/mean/max {flat.min():.0f}/{flat.mean():.2f}/"
        f"{flat.max():.0f} over {flat.size} factor members, {sum(below.values())} below "
        f"r_max (" + ", ".join(f"r_max {m}: {v.min():.0f}/{v.mean():.2f}/{v.max():.0f} over "
                               f"{v.size}" for m, v in by_r_max.items())
        + f"); host {res.seconds:.3f} s; wire a client {measured[0] / 1e6:.6f} MB down, "
        f"{measured[1] / 1e6:.6f} MB up (= cost model); paper protocol "
        f"{res.comm_bytes_per_client / 1e6:.3f} MB static, "
        f"{res.comm_bytes_per_client_effective / 1e6:.3f} MB effective; peak {peak:.2f} GiB"
        + (" (by moment " + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + ")"
           if peaks else "")
        + f"; nonzeros past the ranks 0; launches {got} = expected")
    return dict(loss_before=res.loss_before, loss_after=res.loss_after,
                rank_min=float(flat.min()), rank_mean=float(flat.mean()),
                rank_max=float(flat.max()), below_r_max=sum(below.values()),
                ranks_by_r_max={str(m): [float(v.min()), float(v.mean()), float(v.max())]
                                for m, v in by_r_max.items()},
                host_s=res.seconds, peak_gib=peak, peak_gib_by_moment=peaks,
                wire_down_bytes=measured[0], wire_up_bytes=measured[1], launches=got)


def build_round(torch, spec, tag, layers=None, stream_note="built here"):
    """``build(spec, device="cuda")`` of an ``lm`` spec, timed, with
    ``layers`` cutting the depth (``num_layers`` through a patched
    ``tasks.lm_model_config``: the spec, its hash and the CLI stay the
    reference's), described, and its round's reckoning: the factor leaves,
    members and entries, the bytes by dtype, :func:`round_calls` at bf16
    activations and their launches, the wire bytes of
    ``cost_model.wire_round_bytes`` and each leaf's r_max; all logged as
    ``tag``. Returns (the experiment, the reckoning)."""
    import repro_torch.data
    from repro_torch.api import build, tasks
    from repro_torch.core import cost_model
    from repro_torch.utils.tree import tree_leaves

    resolve = tasks.lm_model_config

    def depth(m):
        cfg = resolve(m)
        return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
    make_stream, data_s = repro_torch.data.make_token_stream, []

    def timed_stream(**kw):
        t0 = time.perf_counter()
        out = make_stream(**kw)
        data_s.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    with unittest.mock.patch.object(repro_torch.data, "make_token_stream", timed_stream), \
            unittest.mock.patch.object(tasks, "lm_model_config", depth):
        exp = build(spec, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(exp.describe())
    cfg, model_cfg = exp.engine.cfg, depth(spec.model)
    M = spec.data.batch * spec.data.seq
    factors = _factors(exp.params)
    entries = sum(f.U.numel() + f.S.numel() + f.V.numel() for _, f in factors)
    by_dtype = {}
    for t in tree_leaves(exp.params):
        name = str(t.dtype).removeprefix("torch.")
        by_dtype[name] = by_dtype.get(name, 0) + t.numel() * t.element_size()
    calls_round = round_calls(exp.params, cfg, M, "bfloat16", model_cfg.moe)
    want = {**launches_of(calls_round), **scan_launches(cfg, model_cfg)}
    wire = cost_model.wire_round_bytes(exp.params, correction=cfg.correction)
    r_max = {p: f.r_max for p, f in factors}
    members = sum(math.prod(f.U.shape[:-2]) for _, f in factors)
    log(f"{tag} {model_cfg.num_layers} layers, {cfg.num_clients} clients: built in "
        f"{build_s:.1f} s, of it {data_s[0]:.1f} s to fetch the token stream "
        f"({cfg.num_clients} x {spec.data.tokens_per_client} tokens, {stream_note}); "
        f"{len(factors)} factor leaves ({members} members), {entries / 1e6:.1f} M factor "
        f"entries; bytes by dtype { {k: f'{v / 1e9:.3f} GB' for k, v in by_dtype.items()} }; "
        f"r_max {sorted(set(r_max.values()))}; expected launches a round {want}; wire a client "
        f"{wire['down'] / 1e6:.6f} MB down, {wire['up'] / 1e6:.6f} MB up")
    return exp, dict(layers=model_cfg.num_layers, build_s=build_s, stream_fetch_s=data_s[0],
                     factor_entries=entries, members=members, bytes_by_dtype=by_dtype,
                     round_calls=calls_round, want=want, wire=wire, r_max=r_max)


def phase_train_arch(torch, counters, path, arch, rounds, tokens, off_layers, off_tokens,
                     watch=contextlib.nullcontext, check=None, layers=None, off_clients=None,
                     profile=True):
    """``arch`` at full width and depth in bf16 (f32 bases): ``rounds``
    FeDLRT rounds through ``build(spec).run()`` with the spec defaults
    (fedlrt, simplified correction, 4 clients, s* = 4, batch 4, seq 128,
    kernels auto) on ``tokens`` tokens a client, counted as the ``path``
    path, with the launches held to :func:`round_calls`' per-launch count,
    the losses finite, the inactive columns zero, the ranks in [1, r_max]
    and the measured wire bytes equal to ``cost_model.wire_round_bytes``;
    one more round under ``torch.profiler`` (the card's trace alone: busy
    share, kernels by device time, the truncation SVD's share); then at
    full width and ``off_layers`` layers one bf16 round with kernels on,
    its every kernel call held to :func:`round_calls`, against one with
    kernels off from the same parameters (:func:`_kernels_against_off`;
    with MoE blocks held only if no expert choice differs, else the pair
    again in f32, where the 3xTF32 route must keep the basis pass's
    choices but for near-ties under ``FLIP_MARGIN`` and every later
    differing choice's margin within twice its call's probability gap,
    held); and every shape of the round's
    ``xus`` / ``avt`` / ``atb`` against its plain version, timed, summed
    over the main path's round (the calls its launches were held to). ``watch()``, a context manager, is entered
    around each round of the main path (a pass-through wrapper that counts
    what it sees); ``check(exp, params0)`` runs after the main path's
    rounds, on the trained model, and its result is returned under
    ``check``. ``layers`` cuts the main path's depth (``num_layers``
    through a patched ``tasks.lm_model_config``, the spec as the
    reference's) and ``off_clients`` sets the pair's cohort (the spec's
    when None); ``profile=False`` leaves out the profiled round."""
    import repro_torch.core.fedlrt as fedlrt_module
    from repro_torch.api import DataSpec, ExperimentSpec, FedSpec, ModelSpec
    from repro_torch.api import tasks

    tag = f"[{path}]"
    spec = ExperimentSpec(name=f"chip-{path}", seed=0, rounds=rounds, log_every=1,
                          model=ModelSpec(arch=arch), data=DataSpec(tokens_per_client=tokens),
                          fed=FedSpec())
    moe_cfg = tasks.lm_model_config(spec.model).moe
    exp, built = build_round(torch, spec, tag, layers,
                             "built in a process of its own: its build's host time is on its "
                             "[streams] line")
    M = spec.data.batch * spec.data.seq
    cfg, params0 = exp.engine.cfg, exp.params
    calls_round, want, wire, r_max = (built[k] for k in ("round_calls", "want", "wire", "r_max"))

    history = []
    # the main path: counts at 0 just before, read just after
    _zero_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    for r in range(rounds):
        history.append(gated_round(torch, exp, tag, r, want, wire, r_max, watch))
    path_s = time.perf_counter() - t_path
    counters[path] = _launch_counts()
    log(f"{tag} {rounds} round(s) in {path_s:.1f} s; launches {counters[path]}")
    checked = check(exp, params0) if check is not None else None
    del params0
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_train_round(torch, exp, tag, history[-1]["host_s"]) if profile else None
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    # full width, off_layers layers: the kernel round, every call counted,
    # against the plain chain's from the same parameters
    calls, coeffs = {}, []
    truncate = fedlrt_module.truncate

    def keep_coeff(f, **kw):
        if f.S.dim() > 3 and len(coeffs) < 1:  # an expert stack: its first layer's members
            coeffs.append(f.S[0, :OLMOE_SVD_MEMBERS].detach().float().clone())
        return truncate(f, **kw)

    t0 = time.perf_counter()
    with unittest.mock.patch.object(fedlrt_module, "truncate", keep_coeff):
        p0, on, off, off_cfg = _cut_round(torch, spec, arch, off_layers, off_tokens, "bfloat16",
                                          calls, off_clients)
    log(f"{tag} {off_layers} layers: the pair of rounds in {time.perf_counter() - t0:.1f} s")
    want_calls = round_calls(p0, off_cfg, M, "bfloat16", moe_cfg)
    if calls != want_calls:
        raise AssertionError(f"the {off_layers}-layer round's kernel calls {calls} differ from "
                             f"round_calls' {want_calls}")
    log(f"{tag} {off_layers} layers: the kernel round's calls by (kernel, dtype, K or N, R, "
        f"S's dtype, G, M) equal round_calls' ("
        + ", ".join(f"{k} {v}" for k, v in launches_of(calls).items())
        + f"; xus with S in f32 {sum(n for k, n in calls.items() if k[4] == 'float32')}, "
          f"on G > 1 stacks {sum(n for k, n in calls.items() if k[5] > 1)})")
    off_stats = _kernels_against_off(torch, tag, p0, on, off, moe_cfg)
    del on, off, p0
    gc.collect()
    torch.cuda.empty_cache()
    off_f32 = None
    if not off_stats["held"]:
        log(f"{tag} expert choices differ in bf16: the pair again in f32")
        t0 = time.perf_counter()
        p0, on, off, f32_cfg = _cut_round(torch, spec, arch, off_layers, off_tokens, "float32",
                                          clients=off_clients)
        log(f"{tag} {off_layers} layers, f32: the pair of rounds in "
            f"{time.perf_counter() - t0:.1f} s")
        off_f32 = _kernels_against_off(torch, f"{tag[:-1]} f32]", p0, on, off, moe_cfg,
                                       near_ties=True,
                                       same_start=f32_cfg.num_clients * moe_layers(p0))
        del on, off, p0
        gc.collect()
        torch.cuda.empty_cache()
    drivers = truncation_svd_drivers(torch, coeffs, cfg.tau, tag) if coeffs else None
    t0 = time.perf_counter()

    # every xus / avt shape of the bf16 round against its plain version,
    # timed; the sums over the main path's round (atb's: main, from the atb
    # phase's records)
    _, xus_round = phase_xus_train(torch, calls_round, f"{tag[:-1]} xus]", arch)
    _, avt_round = phase_avt_train(torch, calls_round, f"{tag[:-1]} avt]", arch)
    log(f"{tag} the round's xus / avt shapes timed in {time.perf_counter() - t0:.1f} s; summed "
        f"over the main path's round at {built['layers']} layers ("
        + ", ".join(f"{k} {v}" for k, v in launches_of(calls_round).items()) + " launches)")
    return dict(stream_fetch_s=built["stream_fetch_s"], build_s=built["build_s"],
                factor_entries=built["factor_entries"], members=built["members"],
                bytes_by_dtype=built["bytes_by_dtype"], wire=wire, rounds=history, path_s=path_s,
                profile=prof, check=checked,
                off=off_stats, off_f32=off_f32, svd_drivers=drivers,
                round_calls=calls_round, xus_round=xus_round, avt_round=avt_round)


def phase_train_qwen2(torch, counters):
    """The token stream's rows route held to the dense route
    (:func:`token_stream_check`), then Qwen2-7B (28 layers, d 3584, d_ff
    18944, vocabulary 152,064, r_max 256) through :func:`phase_train_arch`:
    ``QWEN2_ROUNDS`` rounds at ``QWEN2_LAYERS`` layers on
    ``QWEN2_TOKENS_PER_CLIENT`` tokens a client, no profiled round (the
    script's time), the kernels-off comparison at ``QWEN2_OFF_LAYERS``
    layers."""
    stream = token_stream_check()
    out = phase_train_arch(torch, counters, "train-qwen2", "qwen2-7b", QWEN2_ROUNDS,
                           QWEN2_TOKENS_PER_CLIENT, QWEN2_OFF_LAYERS,
                           QWEN2_OFF_TOKENS_PER_CLIENT, layers=QWEN2_LAYERS, profile=False)
    return dict(out, stream=stream)


def phase_train_olmoe(torch, counters):
    """OLMoE-1B-7B (16 layers, d 2048, 16 heads x 128 with qk-norm, 64
    experts top-8 of hidden 1024, vocabulary 50,304; r_max 256, the
    experts' 128) through :func:`phase_train_arch`: ``OLMOE_ROUNDS``
    round(s) at ``OLMOE_LAYERS`` layers on ``OLMOE_TOKENS_PER_CLIENT``
    tokens a client, each MoE
    projection one launch a layer with its 64 experts on the kernels' grid
    axis at the capacity's 80 rows, the kernels-off comparison at
    ``OLMOE_OFF_LAYERS`` layers with the expert choices counted, and the
    truncation SVD drivers on ``OLMOE_SVD_MEMBERS`` expert members. No
    profiled round (the script's time)."""
    return phase_train_arch(torch, counters, "train-olmoe", "olmoe-1b-7b", OLMOE_ROUNDS,
                            OLMOE_TOKENS_PER_CLIENT, OLMOE_OFF_LAYERS,
                            OLMOE_OFF_TOKENS_PER_CLIENT, layers=OLMOE_LAYERS, profile=False)


#: RWKV6-7B (32 layers, d 4096, 64 heads of 64, d_ff 14,336 non-gated,
#: vocabulary 65,536, wkv chunks of 64): one round on 4 x 4,096 tokens (the
#: rows route), as OLMoE's
RWKV_ROUNDS = 1
#: the main path's depth, half of the model's 32 layers, as Qwen2's
RWKV_LAYERS = 16
RWKV_ROUND_UNIT = ("one RWKV6-7B FeDLRT round (bf16 activations, M=512; atb's embedding "
                   "gather in f32)")
RWKV_TOKENS_PER_CLIENT = 4096
RWKV_OFF_LAYERS = 2
RWKV_OFF_TOKENS_PER_CLIENT = 512
#: [train-rwkv wkv]: layer 0's time mix of the trained model over B x T
#: tokens in f32, its wkv chunked against token by token in f64
WKV_CHECK_B, WKV_CHECK_T = 4, 128
#: the chunked wkv in f32 against the recurrence in f64, as a share of each
#: tensor's largest entry (the output and five gradients): the f32 prefix
#: sums of the log-decays reach ~23.5 in a 64-token chunk at w0 = -1, an
#: absolute rounding of ~2e-6 an add, which the rescaled keys k / W_{<=i}
#: (up to e^23.5) and r ⊙ W_{<i} turn into a relative error of the same
#: order in each product; 1e-5 is the worst reckoned, 1e-4 the limit
WKV_RTOL = 1e-4


def wkv_against_recurrence(torch, cfg, p, B, T, seed, device="cuda", tag="[train-rwkv wkv]"):
    """One RWKV6 time mix (``ssm.rwkv_mix``, layer parameters ``p`` of
    ``cfg`` cast to f32, on the kernels ``cfg`` names) over a seeded x of
    (B, T, d) in f32, against the same mix with its wkv run token by token
    in f64 (``ssm._rwkv_stepped``): the output, and the gradients of
    ``<out, P>`` (P a seeded projection) with respect to x, ``w0``, ``u``,
    ``w_lora_a`` and ``w_lora_b``, each as max|chunked - stepped| /
    max|stepped|, held within ``WKV_RTOL``.

    A chunk whose log-decay passes -``ssm.CLAMP`` (the clamps bind: its
    keys' rescaling is cut at e^30, so its own outputs are not the
    recurrence's) is left out of the output and of ``<out, P>``, and said;
    the state it hands on is the recurrence's up to e^-30 of it (its
    ``k_i ⊙ W_{i+1..L}`` is never clamped), so the later chunks are held.
    Returns the readings."""
    from repro_torch.models import ssm
    from repro_torch.utils.tree import tree_map

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    p = tree_map(lambda t: t.detach().float() if t.is_floating_point() else t, p)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device=device)
    proj = torch.randn((B, T, cfg.d_model), generator=gen, device=device)
    chunked, seen = ssm._rwkv_chunked, []

    def record(*a):
        seen.append(a)
        return chunked(*a)

    with torch.no_grad(), unittest.mock.patch.object(ssm, "_rwkv_chunked", record):
        ssm.rwkv_mix(p, x, cfg32)
    logw, L = seen[0][3], min(seen[0][6], T)
    n = -(-T // L)
    lw = torch.cat([logw, logw.new_zeros((B, n * L - T) + logw.shape[2:])], dim=1)
    deepest = torch.cumsum(lw.reshape((B, n, L) + logw.shape[2:]), dim=2).amin(dim=(0, 2, 3, 4))
    binds = (deepest < -ssm.CLAMP).tolist()
    if all(binds):
        raise AssertionError(f"{tag} a clamp binds in every chunk: nothing to hold")
    held = torch.tensor([not b for b in binds], device=device).repeat_interleave(L)[:T, None]

    def stepped(r, k, v, logw, u, S0, chunk):
        o, S = ssm._rwkv_stepped(*(a.double() for a in (r, k, v, logw, u, S0)))
        return o.float(), S.float()

    names = ("x", "w0", "u", "w_lora_a", "w_lora_b")

    def run(wkv):
        leaves = {k: p[k].clone().requires_grad_(True) for k in names[1:]}
        xg = x.clone().requires_grad_(True)
        t0 = time.perf_counter()
        with unittest.mock.patch.object(ssm, "_rwkv_chunked", wkv):
            out, _ = ssm.rwkv_mix(dict(p, **leaves), xg, cfg32)
            grads = torch.autograd.grad((out * proj * held).sum(), [xg, *leaves.values()])
        if device != "cpu":
            torch.cuda.synchronize()
        return [out.detach() * held, *grads], time.perf_counter() - t0

    got, chunked_s = run(chunked)
    want, stepped_s = run(stepped)
    errs = {name: ((a - b).abs().max() / b.abs().max()).item()
            for name, a, b in zip(("out",) + tuple(f"grad {k}" for k in names), got, want)}
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    log(f"{tag} one time mix at B {B}, T {T}, d {cfg.d_model} ({cfg.d_model // cfg.rwkv.head_dim} "
        f"heads of {cfg.rwkv.head_dim}), f32, chunks of {L}: the deepest log-decay a chunk "
        f"reaches {deepest.min().item():.2f} (the rescaled keys up to "
        f"e^{min(-deepest.min().item(), ssm.CLAMP):.1f}; the clamps at -{ssm.CLAMP:g}); a "
        f"clamp binds in "
        f"{sum(binds)} of {n} chunks" + (", left out" if any(binds) else "")
        + f"; chunked {1e3 * chunked_s:.1f} ms, token by token in f64 {1e3 * stepped_s:.1f} "
          f"ms (forward and backward)")
    log(f"{tag} chunked in f32 against token by token in f64, max|a - b| / max|b| (limit "
        f"{WKV_RTOL:g}): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    if not finite or not max(errs.values()) <= WKV_RTOL:
        raise AssertionError(f"{tag} the chunked wkv misses the token-by-token recurrence: "
                             f"{errs} (limit {WKV_RTOL}), finite {finite}")
    return dict(errs=errs, deepest_log_decay=deepest.min().item(), chunks=n,
                clamped_chunks=sum(binds), chunked_s=chunked_s, stepped_s=stepped_s)


def wkv_call_cost(torch, cfg, B, T, reps=5):
    """One chunked wkv's forward, and its forward and backward, at the
    round's shape (B rows of T tokens, f32 as ``rwkv_mix`` runs it), timed
    by :func:`call_cost`."""
    from repro_torch.models import ssm

    H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    gen = torch.Generator(device="cuda").manual_seed(5)
    r, k, v = (torch.randn((B, T, H, hd), generator=gen, device="cuda") for _ in range(3))
    logw = -torch.exp(-1.0 + 0.1 * torch.randn((B, T, H, hd), generator=gen, device="cuda"))
    u = torch.full((H, hd), 0.5, device="cuda")
    S0 = torch.zeros((B, H, hd, hd), device="cuda")
    ins = [t.requires_grad_(True) for t in (r, k, v, logw, u)]

    def fwd():
        with torch.no_grad():
            ssm._rwkv_chunked(*ins, S0, cfg.rwkv.chunk_len)

    def fwd_bwd():
        o, S = ssm._rwkv_chunked(*ins, S0, cfg.rwkv.chunk_len)
        torch.autograd.grad(o.sum() + S.sum(), ins)

    return call_cost(torch, fwd, fwd_bwd, f"[train-rwkv wkv] %s at B {B}, T {T}:", reps)


def call_cost(torch, fwd, fwd_bwd, tag, reps):
    """``fwd()`` and ``fwd_bwd()``, each ``reps`` times after a warm-up:
    the card's busy ms a call (the union of its kernels' intervals under
    ``torch.profiler``) and the host's ms a call (the same calls
    unprofiled, ending in a sync), with the kernels a call (0 where the
    trace saw none: a lone ctypes launch, timed by CUDA events instead);
    ``tag`` takes the call's name at its ``%s``."""
    out = {}
    for name, fn in (("forward", fwd), ("forward_backward", fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        n, busy_s, _ = device_profile(torch, lambda fn=fn: [fn() for _ in range(reps)],
                                      tag % name.replace("_", " and "), 3, cpu=False)
        if not n:  # a lone ctypes launch the trace missed: time the call by CUDA events
            busy_s = _event_ms(torch, lambda i, fn=fn: fn(), 1, reps) * reps / 1e3
        out[name] = dict(device_ms=busy_s / reps * 1e3, host_ms=host_ms, kernels=n // reps)
    return out


def phase_train_rwkv(torch, counters):
    """RWKV6-7B (32 layers, d 4096, 64 heads of 64, d_ff 14,336 non-gated,
    vocabulary 65,536, the wkv in chunks of 64; r_max 256 everywhere)
    through :func:`phase_train_arch`: ``RWKV_ROUNDS`` round(s) at
    ``RWKV_LAYERS`` layers on ``RWKV_TOKENS_PER_CLIENT`` tokens a client
    (no profiled round: the script's time), each of the five d x d
    projections, the MLP's two factors, the embedding and the head one
    launch a layer on the chain; the wkv's calls in the round counted.
    After the main path, on the trained model: :func:`wkv_against_recurrence`
    on layer 0 (``[train-rwkv wkv]``), the decay LoRA's move in the round,
    and one wkv's device busy and host ms at the round's shape
    (:func:`wkv_call_cost`), which times its calls a round give its device
    busy seconds a round and its share of the round's host time (an
    estimate: the wkv's einsums carry no name of their own in the trace).
    Then the kernels-off pair at ``RWKV_OFF_LAYERS`` layers."""
    from repro_torch.api import ModelSpec, tasks
    from repro_torch.models import ssm
    from repro_torch.models.transformer import _layer

    cfg = tasks.lm_model_config(ModelSpec(arch="rwkv6-7b"))
    calls = {}  # (forward or forward_backward, B, T) -> calls in the main path

    @contextlib.contextmanager
    def watch():
        chunked = ssm._rwkv_chunked

        def counted(r, *a):
            kind = "forward_backward" if torch.is_grad_enabled() and r.requires_grad else "forward"
            key = (kind,) + tuple(r.shape[:2])
            calls[key] = calls.get(key, 0) + 1
            return chunked(r, *a)

        with unittest.mock.patch.object(ssm, "_rwkv_chunked", counted):
            yield

    def check(exp, params0):
        tag = "[train-rwkv wkv]"
        mix, mix0 = (_layer(p["blocks"]["pos0"]["rwkv"], 0) for p in (exp.params, params0))
        moved = {k: ((mix[k].float() - mix0[k].float()).abs().max()
                     / mix0[k].float().abs().max()).item()
                 for k in ("w0", "u", "w_lora_a", "w_lora_b")}
        log(f"{tag} layer 0's dense leaves moved in the round, max|after - before| / "
            f"max|before|: " + ", ".join(f"{k} {v:.3g}" for k, v in moved.items()))
        torch.backends.cuda.matmul.allow_tf32 = False
        out = wkv_against_recurrence(torch, cfg, mix, WKV_CHECK_B, WKV_CHECK_T, 7, tag=tag)
        cost = {(B, T): wkv_call_cost(torch, cfg, B, T) for B, T in {k[1:] for k in calls}}
        per_round = {what: sum(n * cost[key[1:]][key[0]][f"{what}_ms"]
                               for key, n in calls.items()) / RWKV_ROUNDS / 1e3
                     for what in ("device", "host")}
        log(f"{tag} the round's wkv calls, each's device busy / host ms: "
            + "; ".join(f"{n // RWKV_ROUNDS} x {kind.replace('_', ' and ')} at B {B}, T {T} "
                        f"{cost[(B, T)][kind]['device_ms']:.3f} / "
                        f"{cost[(B, T)][kind]['host_ms']:.3f} ms "
                        f"({cost[(B, T)][kind]['kernels']} kernels)"
                        for (kind, B, T), n in sorted(calls.items()))
            + f"; a round {per_round['device']:.3f} s device busy, {per_round['host']:.3f} s "
              f"host")
        return dict(out, dense_moved=moved,
                    wkv_cost={f"{B}x{T}": v for (B, T), v in cost.items()},
                    wkv_calls={f"{k} {B}x{T}": n for (k, B, T), n in calls.items()},
                    wkv_round_device_s=per_round["device"], wkv_round_host_s=per_round["host"])

    out = phase_train_arch(torch, counters, "train-rwkv", "rwkv6-7b", RWKV_ROUNDS,
                           RWKV_TOKENS_PER_CLIENT, RWKV_OFF_LAYERS, RWKV_OFF_TOKENS_PER_CLIENT,
                           watch=watch, check=check, layers=RWKV_LAYERS, profile=False)
    host = out["rounds"][-1]["host_s"]
    share = out["check"]["wkv_round_host_s"] / host
    log(f"[train-rwkv wkv] the wkv in the round: {out['check']['wkv_round_device_s']:.3f} s "
        f"device busy; {100 * share:.1f} % of the round's host time {host:.3f} s (estimated: its "
        f"calls in the round times one call's device busy and host ms)")
    out["check"]["wkv_host_share"] = share
    return out


#: Jamba-1.5-Large (arXiv:2403.19887) at full width, one period of its 72
#: layers (``superblocks`` takes whole periods of 8): positions 0-3 and 5-7
#: Mamba (d_inner 16,384, N 16), 4 attention (64 heads, 8 KV heads of 128),
#: the odd layers MoE (16 experts top-2 of hidden 24,576), d 8192,
#: vocabulary 65,536; one round and the profiled one on 4,096 tokens a
#: client (the rows route)
JAMBA_LAYERS = 8
JAMBA_ROUNDS = 1
JAMBA_ROUND_UNIT = ("one Jamba-1.5-Large FeDLRT round at 8 of its 72 layers (bf16 activations; "
                    "M=512, the experts' G=16 stacks at M=80; atb's embedding gather in f32)")
JAMBA_TOKENS_PER_CLIENT = 4096
#: the kernels-against-off pair: the model's fewest layers, one client
JAMBA_OFF_CLIENTS = 1
JAMBA_OFF_TOKENS_PER_CLIENT = 512
#: [train-jamba scan]: layer 0's Mamba mixer of the trained model over B x T
#: tokens in f32: the round's shape, and a long sequence (69 of the
#: backward's 16-step segments, the last one ragged)
SCAN_CHECK_CASES = ((4, 128), (1, 1100))
#: the scan kernels in f32 (the forward and its backward) against the
#: recurrence token by token in f64, as a share of each tensor's largest
#: entry (the output and nine gradients): each step rounds once in f32, ~6e-8
#: relative, carried by decays under 1 over ~100 tokens, and dB, dC and dA
#: sum 16,384 channels or 512 steps in another order; 1e-5 is the worst
#: reckoned, 1e-4 the limit
SCAN_RTOL = 1e-4
#: the scan kernels against their plain versions on the same inputs at the
#: round's shape, in f32 and bf16 states: y within this share of its largest
#: entry (the sum over the states in another order); each of the backward's
#: six outputs within SCAN_BWD_RTOL of its largest entry (the kernel's λ
#: takes one fma where the plain version rounds a product and a sum, and
#: dB, dC and dA sum their channels, steps and rows in another order; the
#: states, and so a_t, are the same bits in both). The states and the
#: checkpoints are held to the same bits
SCAN_Y_RTOL = 1e-5
SCAN_BWD_RTOL = 1e-4


def train_peak_reckoning(params, cfg, clients, B, T):
    """The card memory of one FeDLRT round of ``params`` (a model of
    ``cfg``, the round's shapes: ``clients`` clients, B x T tokens a
    batch), reckoned from the leaves' shapes and dtypes at the round's
    three fullest moments (``core/fedlrt.py``):

    - the basis augmentation (the end of ``broadcast``): the parameters,
      every client's gradient (each leaf at its dtype, the bases f32), their
      aggregate, and the augmented bases ``[U | Ū]``, ``[V | V̄]`` in f32
      with the 2r x 2r S̃; and the workspace of the leaf being augmented
      (``core/dlrt.py`` ``augment_basis``), beyond its own augmented bases:
      on the U side the gradient blocks and CholeskyQR2's pass (its input,
      ``U Uᵀ Q`` and ``Q`` itself) hold 4|U| + |V| before ``[U | Ū]``
      exists, on the V side ``[U | Ū]`` and 4|V|: the largest leaf's
      max(2|U| - |V|, 2|V|) (|U|, |V| its f32 bases' bytes);
    - the last client's backward in the basis pass: the parameters, the
      clients' gradients (its own forming), the forward's saved tensors:
      each Mamba mixer's scan keeps its f32 inputs (Δ and x, B·T·d_inner
      each; B and C; h0) and its state every ``SCAN_K`` steps
      (B·⌈T/K⌉·d_inner·N f32), no (B, T, d_inner, N) tensor, and the head's
      M x vocab logits (the compute dtype, their f32 copy and the one-hot
      mask);
    - a client's coefficient step: the parameters, the augmented factors,
      each client's correction (its S̃ block and dense leaves), the step's
      own S̃ and its gradient, and the forward's saved tensors again (the
      server keeps only the aggregate gradient's norm past the
      augmentation).

    The dense activations (B·T·d a tensor) are left out: ~0.1 GB a layer
    at Jamba's width. Returns bytes by term and by moment."""
    from repro_torch.kernels.selective_scan import SCAN_K
    from repro_torch.models.ssm import mamba_dims
    from repro_torch.utils.tree import tree_leaves

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    factors = [f for _, f in _factors(params)]
    params_b = nbytes(tree_leaves(params))
    bases_b = nbytes([t for f in factors for t in (f.U, f.V)])
    aug_b = 2 * bases_b + 4 * nbytes([f.S for f in factors])
    work_b = max(max(2 * u - v, 2 * v) for u, v in
                 ((f.U.numel() * 4, f.V.numel() * 4) for f in factors))
    # S̃ at S's dtype, with the dense leaves: what a client trains
    coeff_b = 4 * nbytes([f.S for f in factors]) + params_b - nbytes(
        [t for f in factors for t in (f.U, f.S, f.V, f.rank)])
    M = B * T
    n_mamba = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "mamba"
                  for i in range(cfg.num_layers))
    act = {"bfloat16": 2, "float16": 2, "float32": 4}[cfg.compute_dtype]
    scan_b = 0
    if n_mamba:
        d_inner, _, d_state, _ = mamba_dims(cfg)
        scan_b = n_mamba * 4 * (2 * B * T * d_inner + 2 * B * T * d_state
                                 + B * d_inner * d_state * (1 + -(-T // SCAN_K)))
    logits_b = M * cfg.vocab_size * (act + 4 + 1)
    terms = dict(parameters=params_b, client_gradients=clients * params_b,
                 aggregate_gradient=params_b, augmented=aug_b, augmentation_workspace=work_b,
                 client_coefficients=(clients + 2) * coeff_b, scan_saved=scan_b,
                 logits=logits_b)
    moments = {
        "augmentation": params_b + (clients + 1) * params_b + aug_b + work_b,
        "basis pass backward": params_b + clients * params_b + scan_b + logits_b,
        "coefficient step": params_b + aug_b + (clients + 2) * coeff_b + scan_b + logits_b,
    }
    return dict(terms=terms, moments=moments, peak=max(moments.values()))


def round_reckoning(torch, tag, arch, layers=None, clients=None, limit_gib=None):
    """:func:`train_peak_reckoning` of a round of ``arch`` at ``layers``
    layers (the model's when None) and ``clients`` clients (the spec's
    when None), the spec's batch and sequence, on the parameters' shapes
    (fake tensors: nothing is allocated), logged as ``tag`` and held at or
    under ``limit_gib`` where given."""
    from repro_torch.api import DataSpec, FedSpec, ModelSpec, tasks

    cfg = tasks.lm_model_config(ModelSpec(arch=arch))
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    data, clients = DataSpec(), clients or FedSpec().clients
    r = train_peak_reckoning(fake_params(torch, cfg), cfg, clients, data.batch, data.seq)
    log(f"{tag} reckoned card memory of a round at {cfg.num_layers} layers and {clients} "
        f"client(s) (GiB): "
        + ", ".join(f"{k.replace('_', ' ')} {v / 2**30:.2f}" for k, v in r["terms"].items())
        + "; by moment " + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in r["moments"].items())
        + f"; peak {r['peak'] / 2**30:.2f}"
        + (f" (limit {limit_gib:g})" if limit_gib is not None else ""))
    if limit_gib is not None and not r["peak"] <= limit_gib * 2**30:
        raise AssertionError(f"{tag} the reckoned peak at {clients} clients passes {limit_gib} GiB")
    return r


def _stepped_recurrence(a, b, h0):
    """``h_t = a_t ⊙ h_{t-1} + b_t`` token by token in f64 from ``h0``, each
    ``h_t`` cast back to ``a``'s dtype: the reference that holds
    ``ssm.linear_recurrence``, independent of its doubling scan."""
    import torch

    h, a64, b64, out = h0.double(), a.double(), b.double(), []
    for t in range(a.shape[1]):
        h = a64[:, t] * h + b64[:, t]
        out.append(h)
    return torch.stack(out, dim=1).to(a.dtype)


def _stepped_scan(delta, x, Bp, Cp, A, h0, scan_dt):
    """Mamba's recurrence token by token in f64 (``scan_dt`` unread: no
    rounding), ``y`` and ``h_T`` cast back to f32, differentiated by
    autograd: the check's reference for the scan kernels, independent of
    them and of their plain versions."""
    import torch

    d, xx, b, c, a, h = (t.double() for t in (delta, x, Bp, Cp, A, h0))
    ys = []
    for t in range(d.shape[1]):
        h = torch.exp(d[:, t, :, None] * a) * h + (d[:, t] * xx[:, t])[..., None] * b[:, t, None]
        ys.append(torch.sum(h * c[:, t, None], dim=-1))
    return torch.stack(ys, dim=1).float(), h.float()


#: the mixer's leaves whose gradients ``mamba_scan_against_recurrence``
#: holds, beside x's: the dense ones, and the factors' S (a dense leaf's own
#: weight where the width leaves the projection dense)
SCAN_CHECK_LEAVES = ("A_log", "D", "dt_bias", "conv_w")
SCAN_CHECK_FACTORS = ("in_x", "x_proj", "dt_proj")


def mamba_scan_against_recurrence(torch, cfg, p, B, T, seed, device="cuda",
                                  tag="[train-jamba scan]"):
    """One Mamba mixer (``ssm.mamba_mix`` without a state, the training
    branch; layer parameters ``p`` of ``cfg`` cast to f32, the projections'
    plain chain) over a seeded x of (B, T, d) in f32, its scan the
    ``selective_scan`` kernel and its backward kernel (their plain versions
    on CPU tensors), against the same mixer with the scan run token by token
    in f64 (:func:`_stepped_scan`, differentiated by autograd): the output,
    and the gradients of ``<out, P>`` (P a seeded projection) with respect
    to x, ``A_log``, ``D``, ``dt_bias``, ``conv_w`` and the S of ``in_x``,
    ``x_proj`` and ``dt_proj`` (the factors the backward's dδ, dB and dC
    train), each as max|scan - stepped| / max|stepped|, held within
    ``SCAN_RTOL``. Then the mixer as the round runs it (``p`` as trained,
    the compute dtype, the kernels on) against the same reference output, a
    reading. Returns the readings, with the scan's calls a mixer call."""
    from repro_torch.core.factorization import is_factor
    from repro_torch.models import ssm
    from repro_torch.utils.tree import tree_map

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                kernels="off")
    p32 = tree_map(lambda t: t.detach().float() if t.is_floating_point() else t, p)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device=device)
    proj = torch.randn((B, T, cfg.d_model), generator=gen, device=device)
    seen = []

    def run(scan):
        leaves = {k: p32[k].clone().requires_grad_(True) for k in SCAN_CHECK_LEAVES}
        trained = {k: (p32[k].S if is_factor(p32[k]) else p32[k]).clone().requires_grad_(True)
                   for k in SCAN_CHECK_FACTORS}
        xg = x.clone().requires_grad_(True)
        mix = dict(p32, **leaves, **{k: dataclasses.replace(p32[k], S=t) if is_factor(p32[k])
                                      else t for k, t in trained.items()})

        def counted(*a):
            seen.append(a[0].shape[1])
            return scan(*a)

        t0 = time.perf_counter()
        with unittest.mock.patch.object(ssm, "selective_scan", counted):
            out, _ = ssm.mamba_mix(mix, xg, cfg32)
            grads = torch.autograd.grad((out * proj).sum(),
                                        [xg, *leaves.values(), *trained.values()])
        if device != "cpu":
            torch.cuda.synchronize()
        return [out.detach(), *grads], time.perf_counter() - t0

    got, scan_s = run(ssm.selective_scan)
    calls = len(seen)
    want, stepped_s = run(_stepped_scan)
    labels = (("out", "grad x") + tuple(f"grad {k}" for k in SCAN_CHECK_LEAVES)
              + tuple(f"grad {k} {'S' if is_factor(p32[k]) else 'W'}"
                      for k in SCAN_CHECK_FACTORS))
    errs = {k: ((a - b).abs().max() / b.abs().max()).item() for k, a, b in zip(labels, got, want)}
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    with torch.no_grad():
        served, _ = ssm.mamba_mix(p, x.to(getattr(torch, cfg.compute_dtype)), cfg)
    served_err = ((served.float() - want[0]).abs().max() / want[0].abs().max()).item()
    d_inner, _, d_state, _ = ssm.mamba_dims(cfg)
    log(f"{tag} one Mamba mixer at B {B}, T {T}, d {cfg.d_model}, d_inner {d_inner}, N "
        f"{d_state}, f32, projections' plain chain: the scan kernels ({calls} scan call(s)) "
        f"{1e3 * scan_s:.1f} ms, token by token in f64 {1e3 * stepped_s:.1f} ms (forward and "
        f"backward)")
    log(f"{tag} the scan kernels in f32 against token by token in f64, max|a - b| / max|b| "
        f"(limit {SCAN_RTOL:g}): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the mixer in {cfg.compute_dtype} with kernels {cfg.kernels} (the round's), its "
          f"output against the same: {served_err:.3g} (a reading)")
    if not finite or not max(errs.values()) <= SCAN_RTOL:
        raise AssertionError(f"{tag} the scan kernels miss the token-by-token recurrence at "
                             f"B {B}, T {T}: {errs} (limit {SCAN_RTOL}), finite {finite}")
    return dict(B=B, T=T, calls=calls, errs=errs, served_err=served_err, scan_s=scan_s,
                stepped_s=stepped_s)


def _scan_inputs(torch, cfg, p, B, T, seed):
    """The arguments of layer 0's ``selective_scan`` call in the round's
    mixer (``p`` as trained, the compute dtype) over a seeded x of (B, T,
    d), with a seeded dy of y's shape."""
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda")
    args, real = [], ssm.selective_scan

    def record(*a):
        args[:] = a
        return real(*a)

    with torch.no_grad(), unittest.mock.patch.object(ssm, "selective_scan", record):
        ssm.mamba_mix(p, x.to(getattr(torch, cfg.compute_dtype)), cfg)
    dy = torch.randn(args[0].shape, generator=gen, device="cuda")
    return [t.contiguous() for t in args[:6]], args[6], dy


def scan_kernels_against_plain(torch, cfg, p, B, T, seed, tag="[train-jamba scan]"):
    """The two scan kernels against their plain versions on the same inputs
    (:func:`_scan_inputs`: layer 0's scan call in the trained mixer at B x
    T), in the round's state dtype and in f32: the forward with its
    checkpoints (y within ``SCAN_Y_RTOL`` of its largest entry, h_T and the
    checkpoints the same bits), the backward's dδ, dx, dB, dC, dA and dh0
    (from dy and a seeded dh_T) each within ``SCAN_BWD_RTOL`` of its largest
    entry, and a second backward call the same bits; then each kernel's
    device ms (CUDA events), its plain version's and its bound (bytes or
    operations). Launches
    made here are not the path's: the counts are put back. Returns the
    readings by state dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import SCAN_K, selective_scan, selective_scan_bwd
    from repro_torch.kernels.selective_scan import _launch_forward

    n0 = (selective_scan.launches, selective_scan_bwd.launches)
    (delta, x, Bp, Cp, A, h0), round_dt, dy = _scan_inputs(torch, cfg, p, B, T, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dhT = torch.randn(h0.shape, generator=gen, device="cuda")
    ins = (delta, x, Bp, Cp, A, h0)
    Bn, Tn, D = delta.shape
    N = Bp.shape[-1]
    out = {}
    for dt in (round_dt, torch.float32):
        name = str(dt).removeprefix("torch.")
        y, hT, ck = _launch_forward(*ins, dt, True)
        wy, whT, wck = ref.selective_scan_ref(*ins, dt, every=SCAN_K)
        y_err = ((y - wy).abs().max() / wy.abs().max()).item()
        bits = int((hT != whT).sum()) + int((ck != wck).sum())
        got = selective_scan_bwd(*ins, ck, dy, dhT, dt)
        again = selective_scan_bwd(*ins, ck, dy, dhT, dt)
        want = ref.selective_scan_bwd_ref(*ins, dy, dhT, dt)
        labels = ("ddelta", "dx", "dB", "dC", "dA", "dh0")
        errs = {k: ((a - b).abs().max() / b.abs().max()).item()
                for k, a, b in zip(labels, got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(t).all()) for t in (y, hT, ck, *got))
        fwd_ms = _event_ms(torch, lambda i: _launch_forward(*ins, dt, True), 1, 20)
        bwd_ms = _event_ms(torch, lambda i: selective_scan_bwd(*ins, ck, dy, dhT, dt), 1, 20)
        fwd_plain = _event_ms(torch, lambda i: ref.selective_scan_ref(*ins, dt, every=SCAN_K),
                              1, 2)
        bwd_plain = _event_ms(torch, lambda i: ref.selective_scan_bwd_ref(*ins, dy, dhT, dt),
                              1, 2)
        fb = scan_bound_ms(Bn, Tn, D, N, checkpoints=True)
        bb = scan_bwd_bound_ms(Bn, Tn, D, N)
        log(f"{tag} the scan kernels against their plain versions at B {Bn}, T {Tn}, D {D}, N "
            f"{N}, state {name}: y {y_err:.3g} of max (limit {SCAN_Y_RTOL:g}), differing bits "
            f"of h_T and the {ck.shape[1]} checkpoints {bits}; the backward, of each "
            f"tensor's max (limit {SCAN_BWD_RTOL:g}): "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; a second backward call {'the same bits' if same else 'DIFFERS'}")
        log(f"{tag} selective_scan (with checkpoints) {fwd_ms:.3f} ms, plain {fwd_plain:.3f} "
            f"ms, bound {fb[0]:.3f} ms ({fb[1]}: {fb[2] / 1e6:.1f} MB), "
            f"{100 * fb[0] / fwd_ms:.1f} % of the bound")
        log(f"{tag} selective_scan_bwd {bwd_ms:.3f} ms, plain {bwd_plain:.3f} ms, bound "
            f"{bb[0]:.3f} ms ({bb[1]}: {bb[2] / 1e6:.1f} MB), {100 * bb[0] / bwd_ms:.1f} % of "
            f"the bound")
        if not (finite and y_err <= SCAN_Y_RTOL and bits == 0 and same
                and max(errs.values()) <= SCAN_BWD_RTOL):
            raise AssertionError(f"{tag} {name}: the scan kernels miss their plain versions: y "
                                 f"{y_err}, state bits {bits}, backward {errs}, repeatable "
                                 f"{same}, finite {finite}")
        out[name] = dict(
            shape=[Bn, Tn, D, N], y_rel_err=y_err, state_bits_differ=bits, bwd_errs=errs,
            repeatable=same,
            max_abs_err=max([(y - wy).abs().max().item()]
                            + [(a - b).abs().max().item() for a, b in zip(got, want)]),
            forward=dict(ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
                         library_ms=None),
            backward=dict(ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb[0], bound_by=bb[1],
                          library_ms=None))
        del y, hT, ck, wy, whT, wck, got, again, want
    selective_scan.launches, selective_scan_bwd.launches = n0
    torch.cuda.empty_cache()
    return out


def scan_call_cost(torch, shape, dtype, reps=5):
    """One ``selective_scan`` call at ``shape`` (B, T, d_inner, N) with the
    state in ``dtype`` (the round's compute dtype), forward alone and
    forward with its backward (the two kernels), timed by
    :func:`call_cost`; the kernels' launch counts put back."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_bwd

    n0 = (selective_scan.launches, selective_scan_bwd.launches)
    B, T, D, N = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    delta = torch.nn.functional.softplus(torch.randn((B, T, D), generator=gen, device="cuda") - 4)
    x, dy = (torch.randn((B, T, D), generator=gen, device="cuda") for _ in range(2))
    Bp, Cp = (torch.randn((B, T, N), generator=gen, device="cuda") for _ in range(2))
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").expand(D, N).contiguous()
    h0 = torch.zeros((B, D, N), device="cuda")
    ins = [t.requires_grad_(True) for t in (delta, x, Bp, Cp, A)]

    def fwd():
        with torch.no_grad():
            selective_scan(*ins, h0, dt)

    def fwd_bwd():
        torch.autograd.grad(selective_scan(*ins, h0, dt)[0], ins, dy)

    try:
        return call_cost(torch, fwd, fwd_bwd,
                         f"[train-jamba scan] %s at {'x'.join(map(str, shape))}:", reps)
    finally:
        selective_scan.launches, selective_scan_bwd.launches = n0


def phase_train_jamba(torch, counters):
    """Jamba-1.5-Large at full width and one 8-layer period (``JAMBA_LAYERS``)
    through :func:`phase_train_arch`: the spec's four clients, their round's
    peak reckoned first (:func:`round_reckoning`), ``JAMBA_ROUNDS`` round(s) on
    ``JAMBA_TOKENS_PER_CLIENT`` tokens a client, each Mamba projection,
    attention projection, MLP factor, embedding and head one launch on the
    chain and each MoE projection one launch a layer with its 16 experts on
    the kernels' grid axis at the capacity's 80 rows, and the Mamba scan's
    kernels held to :func:`scan_launches` (one ``selective_scan`` a mixer
    call, one ``selective_scan_bwd`` a call that takes a gradient); the
    scan's calls counted by kind and shape, and ``ssm.linear_recurrence``
    held to none. After the main path, on the trained model:
    :func:`mamba_scan_against_recurrence` on layer 0 at each of
    ``SCAN_CHECK_CASES`` and :func:`scan_kernels_against_plain` at the
    round's shape (``[train-jamba scan]``), the Mamba dense leaves' move in
    the round, and one scan call's device busy and host ms at each shape the
    round ran (:func:`scan_call_cost`), which times its calls a round give
    its share of the profiled round's busy time and of the round's host
    time (an estimate). Then the kernels-off pair at the same 8 layers on
    ``JAMBA_OFF_CLIENTS`` client and ``JAMBA_OFF_TOKENS_PER_CLIENT`` tokens:
    ``kernels`` does not switch the scan, so both rounds of the pair launch
    the scan kernels, and ``[train-jamba scan]`` is what checks them."""
    from repro_torch.api import ModelSpec, tasks
    from repro_torch.models import ssm
    from repro_torch.models.transformer import _layer

    reckoned = round_reckoning(torch, "[train-jamba]", "jamba-1.5-large-398b", JAMBA_LAYERS,
                               limit_gib=PEAK_LIMIT_GIB)
    cfg = dataclasses.replace(tasks.lm_model_config(ModelSpec(arch="jamba-1.5-large-398b")),
                              num_layers=JAMBA_LAYERS)
    calls = {}  # (forward or forward_backward, shape, dtype) -> calls in the main path
    doubling = []

    @contextlib.contextmanager
    def watch():
        scan, doubling_scan = ssm.selective_scan, ssm.linear_recurrence

        def counted(delta, x, Bp, Cp, A, h0, scan_dt):
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (delta, x, Bp, Cp, A, h0))
            key = ("forward_backward" if grad else "forward",
                   tuple(delta.shape) + (Bp.shape[-1],), str(scan_dt)[6:])
            calls[key] = calls.get(key, 0) + 1
            return scan(delta, x, Bp, Cp, A, h0, scan_dt)

        with unittest.mock.patch.object(ssm, "selective_scan", counted), \
                unittest.mock.patch.object(ssm, "linear_recurrence",
                                           lambda *a: doubling.append(1) or doubling_scan(*a)):
            yield

    def check(exp, params0):
        tag = "[train-jamba scan]"
        if doubling:
            raise AssertionError(f"{tag} the round called ssm.linear_recurrence "
                                 f"{len(doubling)} times")
        mix, mix0 = (_layer(p["blocks"]["pos0"]["mamba"], 0) for p in (exp.params, params0))
        moved = {k: ((mix[k].float() - mix0[k].float()).abs().max()
                     / mix0[k].float().abs().max()).item()
                 for k in ("A_log", "D", "dt_bias", "conv_w")}
        log(f"{tag} layer 0's Mamba dense leaves moved in the round, max|after - before| / "
            f"max|before|: " + ", ".join(f"{k} {v:.3g}" for k, v in moved.items()))
        torch.backends.cuda.matmul.allow_tf32 = False
        cases = [mamba_scan_against_recurrence(torch, cfg, mix, B, T, 7 + i, tag=tag)
                 for i, (B, T) in enumerate(SCAN_CHECK_CASES)]
        (shape, _), = {(k[1], k[2]) for k in calls if k[0] == "forward_backward"}
        kernels = scan_kernels_against_plain(torch, cfg, mix, shape[0], shape[1], 11, tag)
        cost = {key: scan_call_cost(torch, *key) for key in {k[1:] for k in calls}}
        per_round = {what: sum(n * cost[key[1:]][key[0]][f"{what}_ms"]
                               for key, n in calls.items()) / JAMBA_ROUNDS / 1e3
                     for what in ("device", "host")}
        log(f"{tag} the round's scan calls, each's device busy / host ms: "
            + "; ".join(f"{n // JAMBA_ROUNDS} x {kind.replace('_', ' and ')} at "
                        f"{'x'.join(map(str, shape))} {dt} "
                        f"{cost[(shape, dt)][kind]['device_ms']:.3f} / "
                        f"{cost[(shape, dt)][kind]['host_ms']:.3f} ms "
                        f"({cost[(shape, dt)][kind]['kernels']} kernels)"
                        for (kind, shape, dt), n in sorted(calls.items()))
            + f"; a round {per_round['device']:.3f} s device busy, {per_round['host']:.3f} s "
              f"host; ssm.linear_recurrence called 0 times")
        return dict(cases=cases, kernels=kernels, dense_moved=moved,
                    scan_cost={f"{'x'.join(map(str, s))} {dt}": v for (s, dt), v in cost.items()},
                    scan_calls={f"{k} {'x'.join(map(str, s))} {dt}": n
                                for (k, s, dt), n in calls.items()},
                    scan_round_device_s=per_round["device"], scan_round_host_s=per_round["host"])

    out = phase_train_arch(torch, counters, "train-jamba", "jamba-1.5-large-398b", JAMBA_ROUNDS,
                           JAMBA_TOKENS_PER_CLIENT, JAMBA_LAYERS, JAMBA_OFF_TOKENS_PER_CLIENT,
                           watch=watch, check=check, layers=JAMBA_LAYERS,
                           off_clients=JAMBA_OFF_CLIENTS)
    busy, host = out["profile"]["device_busy_s"], out["rounds"][-1]["host_s"]
    shares = dict(device=out["check"]["scan_round_device_s"] / busy,
                  host=out["check"]["scan_round_host_s"] / host)
    log(f"[train-jamba scan] the scan's share of the profiled round's device busy time "
        f"{busy:.3f} s: {100 * shares['device']:.1f} %; of the round's host time {host:.3f} s: "
        f"{100 * shares['host']:.1f} % (estimated: its calls in the round times one call's "
        f"device busy and host ms)")
    out["check"]["scan_shares"] = shares
    log(f"[train-jamba] peak {out['rounds'][-1]['peak_gib']:.2f} GiB against "
        f"{reckoned['peak'] / 2**30:.2f} GiB reckoned")
    return dict(out, reckoned_gib={k: v / 2**30 for k, v in reckoned["moments"].items()})


#: DeepSeekMoE-16B (28 layers, d 2048, 16 heads of 128, 64 routed experts
#: top-6 of hidden 1408 beside 2 shared ones of 2816 in all, vocabulary
#: 102,400; r_max 256, the routed experts' 176): one round at 4 of its 28
#: layers on 4 x 4,096 tokens (the rows route)
DEEPSEEK_LAYERS = 4
DEEPSEEK_ROUNDS = 1
DEEPSEEK_ROUND_UNIT = ("one DeepSeekMoE-16B FeDLRT round at 4 of its 28 layers (bf16 "
                       "activations; M=512, the routed experts' G=64 stacks at M=60; atb's "
                       "embedding gather in f32)")
DEEPSEEK_TOKENS_PER_CLIENT = 4096
DEEPSEEK_OFF_LAYERS = 2
DEEPSEEK_OFF_TOKENS_PER_CLIENT = 512
#: [train-deepseek shared]: layer 0's shared experts of the trained model
#: on this many rows (the round's batch x seq) in f32
SHARED_CHECK_M = 512
#: the shared experts with kernels against the plain chain in f32, as a
#: share of each tensor's largest entry: the 3xTF32 route sums K <= 2816
#: products in another order than cuBLAS's f32 (~1e-7 to 1e-5 of max);
#: 1e-4 is the limit
SHARED_RTOL = 1e-4


def shared_against_off(torch, cfg, p, M, seed, device="cuda", tag="[train-deepseek shared]"):
    """DeepSeekMoE's shared experts (``moe._shared_ffn``: ``shared_gate``,
    ``shared_up``, ``shared_down`` of layer parameters ``p``, their U, S and
    V cast to f32) over a seeded x of (M, d) in f32, kernels ``auto``
    against ``off`` (the plain chain, TF32 off): the output and the
    gradients of ``<out, P>`` (P a seeded projection) with respect to x and
    to each factor's U, S and V, each as max|auto - off| / max|off|, held
    within ``SHARED_RTOL``. The routing, whose bf16 choices differ between
    two runs, takes no part. The kernel run must launch ``xus``, ``avt``
    and ``atb`` on the card, the plain run none (on the CPU the wrappers
    take their plain versions and launch nothing). Returns the readings."""
    from repro_torch.models import moe

    names = ("shared_gate", "shared_up", "shared_down")
    f32 = {n: dataclasses.replace(p[n], **{k: getattr(p[n], k).detach().float() for k in "USV"})
           for n in names}
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, cfg.d_model), generator=gen, device=device)
    proj = torch.randn((M, cfg.d_model), generator=gen, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)

    def run(kernels):
        leaves = {(n, k): getattr(f32[n], k).clone().requires_grad_(True)
                  for n in names for k in "USV"}
        mix = {n: dataclasses.replace(f32[n], **{k: leaves[n, k] for k in "USV"}) for n in names}
        xg = x.clone().requires_grad_(True)
        c = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                kernels=kernels)
        before = _launch_counts()
        sync()
        t0 = time.perf_counter()
        out = moe._shared_ffn(mix, xg, c)
        grads = torch.autograd.grad((out * proj).sum(), [xg, *leaves.values()])
        sync()
        seconds = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in _launch_counts().items()
                    if k in ("xus", "avt", "atb")}
        return [out.detach(), *grads], seconds, launched

    got, auto_s, launched = run("auto")
    want, off_s, off_launched = run("off")
    labels = ("out", "grad x") + tuple(f"grad {n} {k}" for n in names for k in "USV")
    errs = {k: ((a - b).abs().max() / b.abs().max()).item() for k, a, b in zip(labels, got, want)}
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    f = f32["shared_up"]
    log(f"{tag} layer 0's shared experts at M {M}, d {cfg.d_model}, hidden {f.V.shape[-2]}, "
        f"r_max {f.r_max}, f32: kernels auto {1e3 * auto_s:.1f} ms (launches {launched}), off "
        f"{1e3 * off_s:.1f} ms, forward and backward; max|auto - off| / max|off| (limit "
        f"{SHARED_RTOL:g}): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    if any(off_launched.values()) or (device != "cpu" and not all(launched.values())):
        raise AssertionError(f"{tag} kernels auto launched {launched}, off {off_launched}")
    if not finite or not max(errs.values()) <= SHARED_RTOL:
        raise AssertionError(f"{tag} the shared experts with kernels miss the plain chain: "
                             f"{errs} (limit {SHARED_RTOL}), finite {finite}")
    return dict(M=M, errs=errs, auto_s=auto_s, off_s=off_s, launches=launched)


def phase_train_deepseek(torch, counters):
    """DeepSeekMoE-16B at full width and ``DEEPSEEK_LAYERS`` of its 28
    layers through :func:`phase_train_arch`: the spec's four clients, their
    round's peak reckoned first (:func:`round_reckoning`, held under
    ``PEAK_LIMIT_GIB``), ``DEEPSEEK_ROUNDS`` round(s) on
    ``DEEPSEEK_TOKENS_PER_CLIENT`` tokens a client, each routed projection
    one launch a layer with its 64 experts on the kernels' grid axis at the
    capacity's 60 rows and each shared one a launch a layer at the batch's
    512; no profiled round (the script's time). After the main path, on
    the trained model: :func:`shared_against_off` on layer 0 (``[train-
    deepseek shared]``). Then the kernels-off pair at
    ``DEEPSEEK_OFF_LAYERS`` layers and ``DEEPSEEK_OFF_TOKENS_PER_CLIENT``
    tokens a client, and the truncation SVD drivers on the first expert
    stack's members (352 x 352)."""
    from repro_torch.api import ModelSpec, tasks
    from repro_torch.models.transformer import _layer

    reckoned = round_reckoning(torch, "[train-deepseek]", "deepseek-moe-16b", DEEPSEEK_LAYERS,
                               limit_gib=PEAK_LIMIT_GIB)
    cfg = tasks.lm_model_config(ModelSpec(arch="deepseek-moe-16b"))

    def check(exp, params0):
        return shared_against_off(torch, cfg, _layer(exp.params["blocks"]["pos0"]["moe"], 0),
                                  SHARED_CHECK_M, 11)

    out = phase_train_arch(torch, counters, "train-deepseek", "deepseek-moe-16b",
                           DEEPSEEK_ROUNDS, DEEPSEEK_TOKENS_PER_CLIENT, DEEPSEEK_OFF_LAYERS,
                           DEEPSEEK_OFF_TOKENS_PER_CLIENT, check=check, layers=DEEPSEEK_LAYERS,
                           profile=False)
    log(f"[train-deepseek] peak {out['rounds'][-1]['peak_gib']:.2f} GiB against "
        f"{reckoned['peak'] / 2**30:.2f} GiB reckoned")
    return dict(out, reckoned_gib={k: v / 2**30 for k, v in reckoned["moments"].items()})


# ---------------------------------------------------------------------------
# one recorded round of an architecture at full width and depth
# ---------------------------------------------------------------------------


def activation_reckoning(torch, cfg, B, T, device="cuda"):
    """What :func:`train_peak_reckoning` leaves out, measured: the bytes a
    forward of the ``lm`` loss of ``cfg`` keeps for its backward, by one
    layer, in each of a round's two passes: the basis pass (the factors at
    rank r, every U, S, V and dense leaf differentiated) and a client's
    coefficient step (the augmented factors at 2r, their S̃ and the dense
    leaves differentiated). The loss of a model of one and of two layers at
    full width (the training dtypes) on seeded tokens of B x (T + 1), under
    ``saved_tensors_hooks`` that sum the storages saved for the backward,
    each once, the parameters' own left out (the graph keeps none of them:
    no backward runs); the two runs' difference is a layer's. Returns {pass:
    (a layer's bytes, the one-layer model's)}."""
    from repro_torch.core.factorization import AugmentedFactor, is_factor, training_dtypes
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    def augmented(f):
        r = f.r_max
        S = torch.zeros(f.S.shape[:-2] + (2 * r, 2 * r), dtype=f.S.dtype, device=f.S.device)
        return AugmentedFactor(U=torch.cat([f.U, f.U], -1), S=S, V=torch.cat([f.V, f.V], -1),
                               rank=f.rank)

    def saved(layers, client):
        c = dataclasses.replace(cfg, num_layers=layers)
        model = build_model(c)
        gen = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            params = training_dtypes(model.init(gen)[0])
            if client:
                params = tree_map(lambda x: augmented(x) if is_factor(x) else x, params,
                                  is_leaf=is_factor)
        factors = [x for x in tree_leaves(params, is_leaf=is_factor) if is_factor(x)]
        dense = [x for x in tree_leaves(params, is_leaf=is_factor)
                 if not is_factor(x) and x.is_floating_point()]
        trained = dense + [t for f in factors for t in ((f.S,) if client else (f.U, f.S, f.V))]
        for t in trained:
            t.requires_grad_(True)
        own = {t.untyped_storage().data_ptr()
               for t in dense + [t for f in factors for t in (f.U, f.S, f.V)]}
        tokens = torch.randint(1, c.vocab_size, (B, T + 1), generator=gen, device=device)
        kept, hold = {}, []

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in own:
                kept[ptr] = max(kept.get(ptr, 0), t.untyped_storage().nbytes())
            # held here to the end, as the graph would hold it (so no address
            # is reused and counted twice); the graph keeps nothing: no
            # backward runs, and a saved output handed back whole would hold
            # its own graph in a cycle that is never freed
            hold.append(t)

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
            loss = model.loss_fn(params, {"tokens": tokens})
        del loss, params, factors, dense, trained, hold
        return sum(kept.values())

    out = {}
    for name, client in (("basis pass", False), ("client step", True)):
        one = saved(1, client)
        out[name] = (saved(2, client) - one, one)
    return out


#: tokens a client of a recorded round (``--round``), as the training phases'
RECORDED_TOKENS_PER_CLIENT = 4096
#: the cohorts a recorded round may run at, the spec's four clients first
RECORDED_COHORTS = (4, 2, 1)


def recorded_round(torch, arch, limit_gib=None):
    """One FeDLRT round of ``arch`` at full width and depth in bf16 (f32
    bases) through ``build(spec, device="cuda").run(1)`` with the spec
    defaults but the cohort, on ``RECORDED_TOKENS_PER_CLIENT`` tokens a
    client. First, for each
    cohort of ``RECORDED_COHORTS``, the round's card memory reckoned on fake tensors
    (:func:`train_peak_reckoning`) plus the layers' activations
    (:func:`activation_reckoning`, measured on a one- and a two-layer model
    at full width, added to the moments that hold a forward's saved
    tensors); the largest cohort whose sum stays at or under ``limit_gib``
    (the card's memory when None) runs, and if none does the round is not
    run. The round is held to the training phases' gates
    (:func:`gated_round`: launches equal to :func:`round_calls`', wire
    bytes to ``wire_round_bytes``, zero inactive columns, ranks in [1,
    r_max], finite losses), its peak logged beside the reckoning. Returns
    the readings."""
    from repro_torch.api import DataSpec, ExperimentSpec, FedSpec, ModelSpec, tasks

    tag = f"[round {arch}]"
    cfg = tasks.lm_model_config(ModelSpec(arch=arch))
    data = DataSpec(tokens_per_client=RECORDED_TOKENS_PER_CLIENT)
    if limit_gib is None:
        limit_gib = torch.cuda.mem_get_info()[1] / 2**30
    reckoned = {c: round_reckoning(torch, tag, arch, clients=c) for c in RECORDED_COHORTS}
    t0 = time.perf_counter()
    saved = activation_reckoning(torch, cfg, data.batch, data.seq)
    acts = {k: layer * cfg.num_layers for k, (layer, _) in saved.items()}
    torch.cuda.empty_cache()
    totals = {}
    for c, r in reckoned.items():
        moments = dict(r["moments"])
        moments["basis pass backward"] += acts["basis pass"]
        moments["coefficient step"] += acts["client step"]
        totals[c] = dict(moments, peak=max(moments.values()))
    log(f"{tag} activations saved for the backward, measured at full width in "
        f"{time.perf_counter() - t0:.1f} s: "
        + "; ".join(f"{k} {layer / 2**30:.3f} GiB a layer ({one / 2**30:.3f} GiB at one layer, "
                    f"with the embedding and the head), {acts[k] / 2**30:.2f} GiB at "
                    f"{cfg.num_layers} layers" for k, (layer, one) in saved.items())
        + "; reckoned with them by moment: "
        + "; ".join(f"{c} client(s) " + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in t.items())
                    for c, t in totals.items())
        + f" GiB (limit {limit_gib:.2f} GiB)")
    fits = [c for c in RECORDED_COHORTS if totals[c]["peak"] <= limit_gib * 2**30]
    out = dict(arch=arch, layers=cfg.num_layers, tokens_per_client=data.tokens_per_client,
               limit_gib=limit_gib,
               activations_gib_a_layer={k: v[0] / 2**30 for k, v in saved.items()},
               reckoned_gib={c: r["peak"] / 2**30 for c, r in reckoned.items()},
               reckoned_with_activations_gib={c: {k: v / 2**30 for k, v in t.items()}
                                              for c, t in totals.items()})
    if not fits:
        log(f"{tag} no cohort of {list(RECORDED_COHORTS)} fits {limit_gib:.2f} GiB: the round is not run")
        return dict(out, ran=False)
    clients = max(fits)
    spec = ExperimentSpec(name=f"chip-round-{arch}", seed=0, rounds=1, log_every=1,
                          model=ModelSpec(arch=arch), data=data, fed=FedSpec(clients=clients))
    exp, built = build_round(torch, spec, tag)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rnd = gated_round(torch, exp, tag, 0, built["want"], built["wire"], built["r_max"],
                      by_moment=True)
    wall = time.perf_counter() - t0
    log(f"{tag} {clients} client(s): the round in {wall:.1f} s; peak {rnd['peak_gib']:.2f} GiB "
        f"against {reckoned[clients]['peak'] / 2**30:.2f} GiB reckoned, "
        f"{totals[clients]['peak'] / 2**30:.2f} GiB with the activations")
    out.update(ran=True, clients=clients, round=rnd, wall_s=wall,
               **{k: v for k, v in built.items() if k not in ("round_calls", "r_max")})
    log(f"{tag} " + json.dumps(out, default=str))
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
#: 10x a fast one) lands at flush 24 at llm-100m's 12 layers (PERF.md) and
#: in flush 21 (after 21 flushes, counting from 0) at the phase's
#: ``SIM_LAYERS`` (the virtual clock's, the same on any device), and its
#: track with it: 22 flushes take every client's first arrival
SIM_FLUSHES = 22
#: rounds of the sync engine and flushes of the uniform async engine held to
#: the plain engine (2 before the script passed 900 s; the async runs above
#: carry state over their flushes)
SIM_SYNC_ROUNDS = 1


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


#: the sim phase's depth: llm-100m at full width, cut to this many of its
#: 12 layers to keep the script inside its time limit
SIM_LAYERS = 4


def phase_sim(torch, counters, workdir):
    """The system simulator (``repro_torch.fed.sim``) through ``build(spec)``,
    at llm-100m's full width cut to ``SIM_LAYERS`` layers (the preset
    replaced for the phase):

    1. ``[sim sync]``: the sync engine priced under ``SIM_PROFILE``,
       ``SIM_SYNC_ROUNDS`` rounds, bit-identical to the plain engine's
       rounds from the same params and batches; each round's virtual
       seconds recomputed as the straggler barrier;
    2. ``[sim async-uniform]``: a uniform fleet with buffer 4, as many
       flushes, bit-identical to the plain rounds, with their launches;
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
    from repro_torch.api import tasks

    cut = dataclasses.replace(tasks.PRESETS["llm-100m"], num_layers=SIM_LAYERS)
    with unittest.mock.patch.dict(tasks.PRESETS, {"llm-100m": cut}):
        return _phase_sim(torch, counters, workdir)


def _phase_sim(torch, counters, workdir):
    import numpy as np

    from repro_torch.api import ExperimentSpec, build, load_spec
    from repro_torch.core import cost_model
    from repro_torch.core.factorization import materialize
    from repro_torch.fed.sim import Fleet, make_sim_engine
    from repro_torch.fed.wire import Wire
    from repro_torch.telemetry import NULL_HUB, set_hub, validate_jsonl

    sets = ["model.preset=llm-100m"]
    configs = os.path.join(ROOT, "examples", "configs")
    n = SIM_SYNC_ROUNDS
    base = ExperimentSpec(name="chip-sim", seed=0, rounds=n, log_every=0).with_overrides(sets)

    # the plain engine's rounds: what steps 1 and 2 are held to (their
    # launches are the comparison's, outside the path's count)
    plain = build(base, device="cuda")
    params0 = _clone(plain.params)
    cfg = plain.engine.cfg
    before = _launch_counts()
    plain.run(rounds=n)
    torch.cuda.synchronize()
    plain_launches = _launch_delta(before)
    params_plain, plain_hist = plain.params, plain.history
    log(f"[sim] plain sync engine, {n} rounds: host {[round(r.seconds, 3) for r in plain_hist]} "
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
    for r in range(n):
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
    log(f"[sim sync] {n} rounds under {SIM_PROFILE}: params bit-identical to the plain engine's")
    del exp

    # 2. async, uniform fleet, buffer = C: the sync rounds
    u_spec = base.with_overrides(["engine.kind=async", f"engine.buffer_size={cfg.num_clients}"])
    exp = build(u_spec, params=_clone(params0), device="cuda")
    uniform_rows = []
    _record_flushes(torch, exp.engine, uniform_rows, check=False)
    before = _launch_counts()
    exp.run(rounds=n)
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
    log(f"[sim async-uniform] {n} flushes of {cfg.num_clients}: params bit-identical to the "
        f"sync engine's {n} rounds, launches {got} equal")
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
      the losses bit-identical, ``xus`` / ``avt`` / ``atb`` launches equal;
      then both again with ``int8_affine`` on the wire: bit-identical, the
      measured bytes equal.
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
    from repro_torch.fed.wire import Wire
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
        # the same round with int8 on the wire, both ways
        n0, wm0, wgot0, _ = round_run(lparams, wire=Wire("int8_affine"))
        sharding.set_client_mode(True)
        try:
            n1, wm1, wgot1, ws1 = round_run(dp, spec_tree=specs, client_axes=("data",),
                                            wire=Wire("int8_affine"))
        finally:
            sharding.set_client_mode(False)
        add(wgot1)
        wbytes = ("wire_bytes_down_per_client", "wire_bytes_up_per_client")
        same = _bits_equal(torch, n0, n1) and all(
            torch.equal(wm0[k], wm1[k].to_local()) for k in ("loss_before", "loss_after"))
        bytes_equal = all(wm0[k] == wm1[k] for k in wbytes)
        launches_equal = all(wgot0[k] == wgot1[k] for k in ("xus", "avt", "atb"))
        log(f"{tag} llm-100m FeDLRT round with int8_affine on the wire on the 1x1 mesh: "
            f"bit-identical to no mesh: {same}; measured bytes down / up a client "
            f"{wm1[wbytes[0]]} / {wm1[wbytes[1]]} (no mesh {wm0[wbytes[0]]} / "
            f"{wm0[wbytes[1]]}); launches equal: {launches_equal}; host {ws1:.2f} s")
        if not same or not bytes_equal or not launches_equal:
            raise AssertionError(f"{tag} the int8 round on a 1x1 mesh differs from no mesh: "
                                 f"bits {same}, bytes {bytes_equal}, launches {wgot1} vs "
                                 f"{wgot0}")
        train = dict(round_s_mesh=s1, round_s=s0, launches=got1, int8_round_s_mesh=ws1,
                     int8_bytes={k: float(wm1[k]) for k in wbytes})
        del n0, n1
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


def start_dryruns():
    """``python -m repro_torch.launch.dryrun`` on the card machine's host
    (fake tensors on the card's device; nothing runs on it): the combos of
    :data:`DRYRUNS` at once, one process each (one intra-op thread, at a
    lower priority than this process: they trace while the kernels build),
    each writing its JSON under ``results/dryrun_torch``; any still running
    when the script exits are killed. Returns the processes and their
    start."""
    out = os.path.join(ROOT, "results", "dryrun_torch")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, _ in DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", out]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=ROOT,
                                      preexec_fn=lambda: os.nice(10)))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs, time.perf_counter()


def finish_dryruns(started):
    """The dry runs :func:`start_dryruns` started (``started``), waited for
    before the first timed phase, so that no host time of the script's
    reads their tracing: their ``OK`` lines (mesh, devices, per-device
    argument / temp bytes, compute / memory / collective ms, dominant term)
    and the documented ``SKIP``. Returns their results."""
    out = os.path.join(ROOT, "results", "dryrun_torch")
    procs, t0 = started
    t_wait = time.perf_counter()
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
    log(f"[dryrun] {len(DRYRUNS)} combos traced in parallel beside the build in "
        f"{time.perf_counter() - t0:.1f} s; waited {time.perf_counter() - t_wait:.1f} s for "
        f"them after it")
    return results


def phase_dryrun(torch, records, results):
    """Every local shape at which the dry runs' traces (``results``,
    :func:`finish_dryruns`) call ``xus`` / ``avt`` / ``atb`` that the
    kernels phases lack, against its plain version on the card and its
    plan (untimed: nothing sums these shapes). Returns the new kernel
    records and the dry runs' results."""
    # a record covers its shape with S in its dtype (xus: each record also
    # counts its launches without S); the dry run's keys carry S's dtype
    have = {(r["kernel"], r["dtype"], r.get("dim"), r.get("R"), r.get("G", 1), r["M"], s)
            for r in records if r["kernel"] in ("xus", "avt")
            for s in ((r.get("S") or r["dtype"], None) if r["kernel"] == "xus" else (None,))}
    have |= {("atb", r["dtype"], r["Ka"], r["Kb"], r.get("G", 1), r["M"], None) for r in records
             if r["kernel"] == "atb"}
    shapes = set()
    for res in results.values():
        for kernel, dtype, M, dim, R, G, s, _ in res.get("kernel_shapes", []):
            shapes.add((kernel, dtype, dim, R, G, M, s))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    new = []
    for kernel, dtype, dim, R, G, M, s in sorted(shapes - have, key=str):
        if kernel == "atb":
            new.append(atb_case(torch, dtype, M, dim, R, gen, G=G, tag="[kernels dryrun]",
                                timed=False))
        else:
            new.append(kernel_case(torch, kernel, dtype, M, dim, R, gen, G=G,
                                   tag="[kernels dryrun]", timed=False,
                                   s_dtype=s if s and s != dtype else None))
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


def atb_case(torch, dtype_name, M, Ka, Kb, gen, G=1, tag="[kernels]", timed=True,
             model="dryrun"):
    """One ``atb`` shape (stacked over G where G > 1) against its plain
    version, timed (kernel, plain, ``matmul(A.T, B)``) in a CUDA graph, with
    its bound and device launches held to ``atb_plan``; logs one line.
    ``timed=False`` leaves the times None."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coeff_grad import atb, atb_plan

    dtype = getattr(torch, dtype_name)
    lead = (G,) if G > 1 else ()
    set_bytes = G * M * (Ka + Kb) * dtype.itemsize
    n_sets = max(2, min(64, math.ceil(L2_DEFEAT_BYTES / set_bytes))) if timed else 1
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
    rec = dict(kernel="atb", model=model, dtype=dtype_name, M=M, Ka=Ka, Kb=Kb, G=G,
               max_abs_err=err, ok=ok, splits=plan.splits, launches=dev,
               ms=None, plain_ms=None, library_ms=None)
    if timed:
        rec.update(ms=graph_ms(torch, lambda i: atb(*sets[i]), n_sets, reps),
                   plain_ms=graph_ms(torch, lambda i: ref.atb_ref(*sets[i]), n_sets, reps),
                   library_ms=graph_ms(torch, lambda i: torch.matmul(
                       sets[i][0].transpose(-1, -2), sets[i][1]), n_sets, reps))
    b_ms, rec["bound_by"] = _atb_bound_ms(dtype_name, M, Ka, Kb)
    rec["bound_ms"] = G * b_ms
    times = (f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
             f"library_ms={rec['library_ms']:.4f} " if timed else "untimed ")
    log(f"{tag} atb {dtype_name:8s} {f'G={G:<3d}' if G > 1 else ''}M={M:<5d} Ka={Ka:<6d} "
        f"Kb={Kb:<4d} max_abs_err={err:.3g} {'ok' if ok else 'MISMATCH'}  {times}"
        f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}) splits={plan.splits} "
        f"launches={dev}")
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
      ``atb``; then at its default preset, llm-tiny (the script's time),
      ``--rounds 3 --participation dropout:0.5`` under
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
    t0 = time.perf_counter()
    with trace_audit() as audit:
        hist = train.main(["--rounds", "3", "--participation", "dropout:0.5", "--log-every", "0"])
    got = _twin_launches(torch, before, tag)
    sizes = [r.cohort_size for r in hist]
    if len(set(sizes)) < 2:
        raise AssertionError(f"{tag}: the dropout draw gave one cohort size {sizes}")
    audit.assert_within_limit()
    if len(audit.counts) != 1:
        raise AssertionError(f"{tag}: {len(audit.counts)} round callsites, expected the "
                             f"engine's one: {audit.counts}")
    [((site_file, site_line, fn), n)] = audit.counts.items()
    log(f"{tag} llm-tiny: cohorts {sizes} padded to 4: {n} step signature at "
        f"{os.path.relpath(site_file, ROOT)}:{site_line} ({fn}) over {len(hist)} rounds; "
        f"{time.perf_counter() - t0:.1f} s")
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
                   xus_round, avt_round, encdec_sums, scan, qwen2, olmoe, rwkv, jamba, deepseek):
    """Per kernel: ``xus``/``avt`` as the sum over one Qwen2-7B decode
    step's launches (M = 4) of each measured number, with the sum over one
    decode step of each of the models phase's architectures under
    ``by_model`` (Whisper-large-v3 and LLaVA-NeXT-Mistral-7B: their paths'
    recorded calls, a decode step's with a prefill's under ``prefill``)
    and over one llm-100m round's calls under ``round``;
    ``xus``, ``avt`` and ``atb`` also summed over one bf16 Qwen2-7B round's
    calls under ``train_qwen2``, one OLMoE-1B-7B round's under
    ``train_olmoe``, one RWKV6-7B round's under ``train_rwkv``, one
    round of Jamba-1.5-Large's 8-layer period under ``train_jamba`` and
    one of DeepSeekMoE-16B's at 4 layers under ``train_deepseek``;
    ``atb`` as the sum over
    one llm-100m FeDLRT round's calls (M = 512, f32: ``phase_atb``'s
    ``[atb] round``); ``flash_attention``
    as one Qwen2-7B 4096-token causal prefill (bf16); ``selective_scan`` as
    one full-width Jamba Mamba mixer's scan over 2 x 1,100 tokens (``scan``,
    the Mamba check's record). ``launches`` is the count over the paths'
    runs; the worst error is over every checked case."""

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
                            "unit": "one llm-100m FeDLRT round (f32, M=512)"}
        out[-1]["train_qwen2"] = {**qwen2[f"{name}_round"], "unit": QWEN2_ROUND_UNIT}
        out[-1]["train_olmoe"] = {**olmoe[f"{name}_round"], "unit": OLMOE_ROUND_UNIT}
        out[-1]["train_rwkv"] = {**rwkv[f"{name}_round"], "unit": RWKV_ROUND_UNIT}
        out[-1]["train_jamba"] = {**jamba[f"{name}_round"], "unit": JAMBA_ROUND_UNIT}
        out[-1]["train_deepseek"] = {**deepseek[f"{name}_round"], "unit": DEEPSEEK_ROUND_UNIT}
    out.append({
        "name": "atb", "route": "cuda", "source": SOURCES["atb"], "replaces": REPLACES["atb"],
        **launches("atb"),
        "max_abs_err": max(r["max_abs_err"] for r in atb_records),
        "ms": atb_round["ms"], "plain_ms": atb_round["plain_ms"],
        "bound_ms": atb_round["bound_ms"],
        "bound_by": atb_round["bound_by"],
        "library_ms": atb_round["library_ms"], "calls": atb_round["calls"],
        "device_launches": atb_round["device_launches"],
        "unit": "one llm-100m FeDLRT round (f32, M=512)",
        "train_qwen2": {**qwen2["atb_round"], "unit": QWEN2_ROUND_UNIT},
        "train_olmoe": {**olmoe["atb_round"], "unit": OLMOE_ROUND_UNIT},
        "train_rwkv": {**rwkv["atb_round"], "unit": RWKV_ROUND_UNIT},
        "train_jamba": {**jamba["atb_round"], "unit": JAMBA_ROUND_UNIT},
        "train_deepseek": {**deepseek["atb_round"], "unit": DEEPSEEK_ROUND_UNIT},
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
    B, T, D, N = scan["shape"]
    trained = jamba["check"]["kernels"]
    Bt, Tt, _, _ = trained["bfloat16"]["shape"]
    train_unit = (f"one call in a Jamba-1.5-Large training round's Mamba mixer: {Bt} x {Tt} "
                  f"tokens (d_inner {D}, N {N}, bf16 state)")
    out.append({
        "name": "selective_scan", "route": "cuda", "source": SOURCES["selective_scan"],
        "replaces": REPLACES["selective_scan"], **launches("selective_scan"),
        "max_abs_err": max(scan["max_abs_err"],
                           *(v["max_abs_err"] for v in trained.values())),
        "ms": scan["ms"], "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"], "library_ms": None,
        "unit": f"one Jamba-1.5-Large Mamba mixer's state scan over {B} x {T} tokens (d_inner "
                f"{D}, N {N}, bf16 state)",
        "train_jamba": {**trained["bfloat16"]["forward"], "unit": train_unit + ", with the "
                        "checkpoints"},
    })
    bwd = trained["bfloat16"]["backward"]
    out.append({
        "name": "selective_scan_bwd", "route": "cuda", "source": SOURCES["selective_scan_bwd"],
        "replaces": REPLACES["selective_scan_bwd"], **launches("selective_scan_bwd"),
        "max_abs_err": max(v["max_abs_err"] for v in trained.values()),
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": None,
        "unit": train_unit,
    })
    return out


def train_stream_args():
    """The token streams the training phases' specs ask for (vocabulary,
    the spec's clients x tokens a client, its stream rank and seed): each
    above a vocabulary of 11,585, the rows route, 0.6–2.5 ms a token on
    the card machine's host."""
    from repro_torch.api import DataSpec, FedSpec, ModelSpec, tasks

    out = []
    for arch, tokens in (("qwen2-7b", QWEN2_TOKENS_PER_CLIENT),
                         ("olmoe-1b-7b", OLMOE_TOKENS_PER_CLIENT),
                         ("rwkv6-7b", RWKV_TOKENS_PER_CLIENT),
                         ("jamba-1.5-large-398b", JAMBA_TOKENS_PER_CLIENT),
                         ("deepseek-moe-16b", DEEPSEEK_TOKENS_PER_CLIENT)):
        kw = dict(vocab_size=tasks.lm_model_config(ModelSpec(arch=arch)).vocab_size,
                  num_tokens=FedSpec().clients * tokens, rank=DataSpec().stream_rank, seed=0)
        if kw not in out:
            out.append(kw)
    return out


def build_streams(todo_json: str, out_dir: str) -> None:
    """Each stream of ``todo_json`` (a JSON list of keyword sets) built by
    the port's ``make_token_stream`` and saved as ``<i>.npy`` under
    ``out_dir`` with its host seconds in ``<i>.s``, the ``.s`` written
    last: :func:`prefetch_token_streams`' process."""
    import numpy as np

    from repro_torch.data import make_token_stream

    for i, kw in enumerate(json.loads(todo_json)):
        t0 = time.perf_counter()
        tokens = make_token_stream(**kw)
        seconds = time.perf_counter() - t0
        np.save(os.path.join(out_dir, f"{i}.npy"), tokens)
        with open(os.path.join(out_dir, f"{i}.tmp"), "w") as fh:
            fh.write(repr(seconds))
        os.replace(os.path.join(out_dir, f"{i}.tmp"), os.path.join(out_dir, f"{i}.s"))


def prefetch_token_streams(todo):
    """:func:`build_streams` on ``todo`` in a process of its own (one
    thread, at a lower priority than this one), started after the serving
    phases (their host-bound step times run alone) beside the phases
    before the training ones, so the rows-route streams cost the script
    no time of its own; killed at exit if still running. Returns what
    :func:`memo_token_streams` reads."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_streams_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, sys.argv[3]); import chip_smoke; "
            "chip_smoke.build_streams(sys.argv[1], sys.argv[2])")
    with open(os.path.join(out_dir, "stderr"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(todo), out_dir, ROOT],
                                stdout=subprocess.DEVNULL, stderr=err, env=env, cwd=ROOT,
                                preexec_fn=lambda: os.nice(10))
    atexit.register(shutil.rmtree, out_dir, True)
    atexit.register(lambda: proc.kill() if proc.poll() is None else None)
    return dict(proc=proc, dir=out_dir, todo=todo)


def memo_token_streams():
    """From here on, each token stream is built once per argument set and
    every later build with the same arguments takes a copy: llm-100m's 4 x
    200,000 tokens at vocabulary 8,192 (~5 s on the host) are asked for by
    some twenty builds across the phases, each on the same seed. The first
    build of each stream runs the port's own code, timed where a phase
    times it; once the returned dict holds :func:`prefetch_token_streams`'
    result, a stream it builds is read from its process, waited for if not
    done, its build's host seconds logged."""
    import numpy as np

    import repro_torch.data

    make, built, prefetched = repro_torch.data.make_token_stream, {}, {}

    def fetch(i, kw):
        proc, base = prefetched["proc"], os.path.join(prefetched["dir"], str(i))
        t0 = time.perf_counter()
        while not os.path.exists(f"{base}.s"):
            if proc.poll() is not None and not os.path.exists(f"{base}.s"):
                with open(os.path.join(prefetched["dir"], "stderr")) as fh:
                    err = fh.read()[-2000:]
                raise AssertionError(f"the token streams' process ended (rc {proc.returncode}) "
                                     f"before stream {kw}: {err}")
            time.sleep(0.05)
        with open(f"{base}.s") as fh:
            seconds = float(fh.read())
        log(f"[streams] vocabulary {kw['vocab_size']}, {kw['num_tokens']} tokens: built beside "
            f"the phases in {seconds:.1f} s on the host ({1e3 * seconds / kw['num_tokens']:.3f} "
            f"ms a token), waited {time.perf_counter() - t0:.1f} s")
        return np.load(f"{base}.npy")

    def once(**kw):
        key = tuple(sorted(kw.items()))
        if key not in built:
            todo = [tuple(sorted(t.items())) for t in prefetched.get("todo", ())]
            built[key] = fetch(todo.index(key), kw) if key in todo else make(**kw)
        return np.array(built[key], copy=True)

    repro_torch.data.make_token_stream = once
    return prefetched


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The port's smoke run on one CUDA card: every "
                                 "phase, or with --round one recorded FeDLRT round.")
    ap.add_argument("--round", metavar="ARCH",
                    help="run no phase: one FeDLRT round of ARCH at full width and depth "
                         "(recorded_round)")
    ap.add_argument("--limit-gib", type=float, default=None,
                    help="--round's memory limit: the largest cohort of 4, 2 and 1 clients "
                         "whose reckoned memory fits it runs (default: the card's memory)")
    args = ap.parse_args(argv)
    if args.round:
        # a round near the card's memory: segments that grow in place leave
        # no reserved-but-unusable blocks between the round's large tensors
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    if args.round:
        phase_environment(torch)
        recorded_round(torch, args.round, limit_gib=args.limit_gib)
        return 0
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-7b")
    t_start = time.perf_counter()

    def done(phase):
        torch.cuda.empty_cache()
        log(f"[time] {phase} phase done at {time.perf_counter() - t_start:.1f} s")

    dryruns = start_dryruns()
    smi = phase_environment(torch)
    done("build")
    dryruns = finish_dryruns(dryruns)
    done("dryrun traces")
    streams = memo_token_streams()
    records = phase_kernels(torch, cfg)
    done("kernels")
    llm_calls = llm100m_round_calls()
    atb_records, atb_round = phase_atb(torch, llm_calls)
    done("atb")
    xus_train, xus_round = phase_xus_train(torch, llm_calls)
    done("xus-train")
    avt_train, avt_round = phase_avt_train(torch, llm_calls)
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
    if not counters["models"]["selective_scan"]:
        raise AssertionError(f"the models path launched no selective_scan: {counters['models']}")
    done("models")
    streams.update(prefetch_token_streams(train_stream_args()))
    ev_records, ev_stats, ev_sums = phase_encdec_vlm(torch, counters, records + model_records)
    model_records += ev_records
    done("encdec-vlm")
    mesh_stats = phase_mesh(torch, counters, serve_stats)
    done("mesh")
    dry_records, dry_stats = phase_dryrun(torch, records + model_records + atb_records, dryruns)
    model_records += [r for r in dry_records if r["kernel"] != "atb"]
    atb_records += [r for r in dry_records if r["kernel"] == "atb"]
    done("dryrun")
    train = phase_train(torch, counters)
    done("train")
    train_qwen2 = phase_train_qwen2(torch, counters)
    train_qwen2["atb_round"] = atb_round_total(torch, atb_records, train_qwen2["round_calls"],
                                               "qwen2-7b", "[train-qwen2 atb]")
    done("train-qwen2")
    train_olmoe = phase_train_olmoe(torch, counters)
    train_olmoe["atb_round"] = atb_round_total(torch, atb_records, train_olmoe["round_calls"],
                                               "olmoe-1b-7b", "[train-olmoe atb]")
    done("train-olmoe")
    train_rwkv = phase_train_rwkv(torch, counters)
    train_rwkv["atb_round"] = atb_round_total(torch, atb_records, train_rwkv["round_calls"],
                                              "rwkv6-7b", "[train-rwkv atb]")
    done("train-rwkv")
    train_jamba = phase_train_jamba(torch, counters)
    if not (counters["train-jamba"]["selective_scan"]
            and counters["train-jamba"]["selective_scan_bwd"]):
        raise AssertionError(f"the train-jamba path launched no scan kernel: "
                             f"{counters['train-jamba']}")
    train_jamba["atb_round"] = atb_round_total(torch, atb_records, train_jamba["round_calls"],
                                               "jamba-1.5-large-398b", "[train-jamba atb]")
    done("train-jamba")
    train_deepseek = phase_train_deepseek(torch, counters)
    train_deepseek["atb_round"] = atb_round_total(torch, atb_records,
                                                  train_deepseek["round_calls"],
                                                  "deepseek-moe-16b", "[train-deepseek atb]")
    done("train-deepseek")
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
    if streams["proc"].wait(timeout=60) != 0:
        raise AssertionError(f"the token streams' process: rc {streams['proc'].returncode}")
    log("[summary] " + json.dumps({"card": smi, "serve": serve_stats,
                                   "serve_quant": quant_stats, "models": model_stats,
                                   "encdec_vlm": ev_stats, "mesh": mesh_stats,
                                   "dryrun": dry_stats,
                                   "train": train,
                                   "train_qwen2": {k: v for k, v in train_qwen2.items()
                                                   if k != "round_calls"},
                                   "train_olmoe": {k: v for k, v in train_olmoe.items()
                                                   if k != "round_calls"},
                                   "train_rwkv": {k: v for k, v in train_rwkv.items()
                                                  if k != "round_calls"},
                                   "train_jamba": {k: v for k, v in train_jamba.items()
                                                   if k != "round_calls"},
                                   "train_deepseek": {k: v for k, v in train_deepseek.items()
                                                      if k != "round_calls"},
                                   "flash": flash_records, "spec": spec_stats,
                                   "sim": sim_stats, "examples": examples_stats,
                                   "xus_train": xus_train,
                                   "avt_train": avt_train}))
    print(json.dumps({"kernels": kernel_summary(
        records, model_records, atb_records, flash_records, counters, cfg, atb_round, xus_round,
        avt_round, ev_sums, model_stats["jamba mamba scan"]["kernel"], train_qwen2,
        train_olmoe, train_rwkv, train_jamba, train_deepseek)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
