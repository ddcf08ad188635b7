#!/usr/bin/env python3
"""Instruction-issue and SFU bounds of the selective-scan kernels, read from
their SASS, beside their byte bounds and measured times, on one H100.

    PYTHONPATH=src python3 tools/scan_sass_bounds.py

Builds the port's kernels (``repro_torch.kernels.build``), disassembles the
library with ``cuobjdump -sass`` and finds each scan kernel's step loops:
the innermost backward branches whose bodies issue ``MUFU.EX2`` (the
precise ``expf``). An iteration of a loop walks one step of the states a
thread holds (``SF_NS`` in the forward, ``SS_NS`` in the
backward, read from ``csrc/selective_scan.cu``). Every thread walks T
steps; the warps issue at most 4 instructions a clock an SM and the SFUs
take 16 ``MUFU.EX2`` a clock an SM, at the card's top SM clock
(``nvidia-smi``). So, for a call of shape (B, T, D, N):

    instruction bound = warps x T x instructions a step / (SMs x 4 x clock)
    SFU bound         = warps x 32 x T x MUFU.EX2 a step / (SMs x 16 x clock)

A step is counted at the shortest path through one iteration of a loop
(the compiler may make two copies of a path, of which an iteration runs
one, as it does in the backward's walk), so the bound stays a least
time; that path must hold one
``MUFU.EX2`` a state, the source's one ``expf``. The forward's compiler
keeps two copies of its step loop, with and without the checkpoint stores
(the pointer is tested once); a step is counted at the shorter. The
backward runs both of its loops (a segment's recompute and its walk back)
every step.

Then it times each kernel by CUDA events at the serving prefill's shape
(2 x 1,100, no checkpoints) and at a Jamba training round's (4 x 128, with
checkpoints, and the backward), both state dtypes, and prints one line a
(kernel, shape, dtype) and a JSON object of every reading last. It exits
non-zero where no step loop is found, where the loops found are not the
ones described above, or where a bound exceeds the time measured.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc" / "selective_scan.cu"
#: (B, T, D, N, checkpoints): the serving prefill of [models jamba mamba
#: scan] and the training round of [train-jamba scan], Jamba-1.5-Large's
#: d_inner and d_state
SHAPES = ((2, 1100, 16384, 16, False), (4, 128, 16384, 16, True))
KERNELS = {"forward": "selective_scan_kernel", "backward": "selective_scan_bwd_kernel"}
MANGLED = {"bfloat16": "I13__nv_bfloat16Li", "float32": "IfLi"}


def states_a_thread() -> dict:
    """``SF_NS`` and ``SS_NS``, the states a thread of each kernel holds, as
    the source defines them."""
    text = CSRC.read_text()
    out = {}
    for kernel, name in (("forward", "SF_NS"), ("backward", "SS_NS")):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        if m is None:
            raise SystemExit(f"{name} is not defined in {CSRC}")
        out[kernel] = int(m.group(1))
    return out


def cuobjdump() -> str:
    """``cuobjdump``: on PATH, beside ``nvcc``, under ``$CUDA_HOME/bin``, or
    the copy Triton's package carries."""
    from repro_torch.kernels import build

    dirs = [os.path.dirname(build._nvcc()),
            os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        dirs.append(os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin"))
    found = shutil.which("cuobjdump") or next(
        (os.path.join(d, "cuobjdump") for d in dirs
         if os.path.exists(os.path.join(d, "cuobjdump"))), None)
    if found is None:
        raise SystemExit("no cuobjdump: looked on PATH, beside nvcc and in Triton's package")
    return found


def _target(op, labels, addr):
    """The instruction index a ``BRA`` jumps to, or None for no branch."""
    m = re.search(r"\bBRA\b[^`;]*?(?:`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b)", op)
    if m is None:
        return None
    return labels.get(m.group(1)) if m.group(1) else addr.get(int(m.group(2), 16))


def step_loops(sass: str, needle: str) -> list:
    """The innermost loops that issue ``MUFU.EX2`` in the one function whose
    mangled name holds ``needle``: for each, the instructions and the
    ``MUFU.EX2`` on the shortest path through one iteration (from the loop's
    head to its backward branch, a predicated ``BRA`` taking either way, an
    unpredicated one only its own), and the loop's instructions in all."""
    bodies = [b for b in sass.split("Function : ")[1:] if needle in b.partition("\n")[0]]
    if len(bodies) != 1:
        raise SystemExit(f"{len(bodies)} functions match {needle} (want 1)")
    ins, addr, labels, loops = [], {}, {}, []
    for line in bodies[0].splitlines()[1:]:
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            addr[int(m.group(1), 16)] = len(ins)
            ins.append(m.group(2))
    for i, op in enumerate(ins):
        to = _target(op, labels, addr)
        if to is not None and to <= i:
            loops.append((to, i))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    out = []
    for a, b in inner:
        best = {a: (1, "MUFU.EX2" in ins[a])}  # index -> (instructions, MUFU.EX2) to it
        for i in range(a, b):
            if i not in best:
                continue
            n, ex2 = best[i]
            to = _target(ins[i], labels, addr)
            nxt = [] if to is not None and not ins[i].startswith("@") else [i + 1]
            if to is not None and i < to <= b:
                nxt.append(to)
            for j in nxt:
                cand = (n + 1, ex2 + ("MUFU.EX2" in ins[j]))
                best[j] = min(best.get(j, cand), cand)
        if b not in best:
            raise SystemExit(f"{needle}: no path through the loop at instruction {a}")
        if any("MUFU.EX2" in op for op in ins[a:b + 1]):
            out.append(dict(instructions=best[b][0], mufu_ex2=best[b][1], in_all=b - a + 1))
    if not out:
        raise SystemExit(f"no step loop found in {needle} ({len(ins)} instructions)")
    return out


def issue_bounds(loops, states, kernel, B, T, D, N, sms, clock_hz) -> dict:
    """Both bounds (ms) of one call from its kernel's step loops."""
    want = (1, 2) if kernel == "forward" else (2,)
    if len(loops) not in want or any(lp["mufu_ex2"] != states for lp in loops):
        raise SystemExit(f"{kernel}: want {' or '.join(map(str, want))} step loop(s), each "
                         f"{states} MUFU.EX2 on its shortest path; found {loops}")
    per_step = [lp["instructions"] for lp in loops]
    if kernel == "forward":
        instr, ex2 = min(per_step), states
    else:
        instr, ex2 = sum(per_step), 2 * states
    lanes = -(-N // states)
    warps = -(-(B * D * lanes) // 32)
    return dict(loops=per_step, instr_per_thread_step=instr, mufu_per_thread_step=ex2,
                instr_ms=warps * T * instr / (sms * 4 * clock_hz) * 1e3,
                sfu_ms=warps * 32 * T * ex2 / (sms * 16 * clock_hz) * 1e3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan import _launch_forward, selective_scan_bwd

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    build.load_library()
    run = subprocess.run([cuobjdump(), "-sass", str(build.library_path())],
                         capture_output=True, text=True, check=True, timeout=300)
    states = states_a_thread()
    print(f"{card}; {sms} SMs at {clock_hz / 1e6:.0f} MHz; states a thread {states}")

    readings = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T, D, N, with_ck in SHAPES:
        delta = torch.nn.functional.softplus(
            torch.randn((B, T, D), generator=gen, device="cuda") - 4)
        x, dy = (torch.randn((B, T, D), generator=gen, device="cuda") for _ in range(2))
        Bp, Cp = (torch.randn((B, T, N), generator=gen, device="cuda") for _ in range(2))
        A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").expand(D, N).contiguous()
        h0 = torch.randn((B, D, N), generator=gen, device="cuda")
        dhT = torch.randn((B, D, N), generator=gen, device="cuda")
        ins = (delta, x, Bp, Cp, A, h0)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            runs = [("forward", with_ck,
                     lambda i: _launch_forward(*ins, dt, with_ck),
                     chip_smoke.scan_bound_ms(B, T, D, N, checkpoints=with_ck))]
            if with_ck:
                ck = _launch_forward(*ins, dt, True)[2]
                runs.append(("backward", True,
                             lambda i: selective_scan_bwd(*ins, ck, dy, dhT, dt),
                             chip_smoke.scan_bwd_bound_ms(B, T, D, N)))
            for kernel, ckp, fn, (byte_ms, bound_by, nbytes) in runs:
                lanes = -(-N // states[kernel])
                needle = KERNELS[kernel] + MANGLED[dtype] + f"{lanes}E"
                loops = step_loops(run.stdout, needle)
                bounds = issue_bounds(loops, states[kernel], kernel, B, T, D, N, sms, clock_hz)
                ms = chip_smoke._event_ms(torch, fn, 1, 20)
                r = dict(kernel=kernel, shape=[B, T, D, N], state=dtype, checkpoints=ckp,
                         ms=ms, bound_ms=byte_ms, bound_by=bound_by, bytes=nbytes, **bounds)
                readings.append(r)
                print(f"{kernel} B {B} T {T} D {D} N {N} state {dtype}"
                      f"{' with checkpoints' if ckp and kernel == 'forward' else ''}: "
                      f"{ms:.4f} ms; step loops of "
                      + ", ".join(f"{n:.1f}" for n in bounds["loops"])
                      + f" instructions a thread-step, {bounds['instr_per_thread_step']:.1f} "
                      f"and {bounds['mufu_per_thread_step']} MUFU.EX2 taken; instruction "
                      f"bound {bounds['instr_ms']:.4f} ms, SFU bound {bounds['sfu_ms']:.4f} "
                      f"ms, byte bound {byte_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_by})")
        del delta, x, dy, Bp, Cp, A, h0, dhT
        torch.cuda.empty_cache()
    print(json.dumps(dict(card=card, clock_mhz=clock_hz / 1e6, sms=sms, readings=readings)))
    over = [r for r in readings
            if max(r["instr_ms"], r["sfu_ms"], r["bound_ms"]) > r["ms"]]
    if over:
        print(f"a bound exceeds the measured time in {len(over)} reading(s): the step "
              f"loops read are not the ones that run", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
