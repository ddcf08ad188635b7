"""The ``lm`` task at Jamba-1.5-Large reduced to one 8-layer period (d 256,
4 heads, 4 experts top-2 of hidden 128, d_inner 512, d_state 8,
vocabulary 512; positions 0-3 and 5-7 Mamba, 4 attention, the odd layers
MoE) in both packages, through ``build(spec).run()``, and Mamba's training
scan against its token-by-token recurrence.

Cases: (a) the task's parameter dtypes, leaf for leaf, with bf16
parameters and compute (f32 U and V, bf16 S and dense leaves, f32
``A_log``); (b) one FeDLRT round from the reference's parameters; (c) a
bf16 round's kernel calls against ``chip_smoke.round_calls`` (Mamba's
in / z / x / out projections, attention, the MLPs, the (layers,
experts) stacks at G 4 and the capacity's rows, the embedding, the head);
(d) ``ssm.linear_recurrence`` (no model path calls it since the training
mixer took the selective scan) in f32 against the recurrence run token by
token in f64, forward and gradient, within 1e-5 of each tensor's largest
entry; (e) ``chip_smoke.mamba_scan_against_recurrence`` (the card's
``[train-jamba scan]``) on the reduced layer 0: the mixer's scan (here the
scan kernels' plain versions, forward and backward) against the same scan
token by token in f64, at ``scan_chunk`` 8, the config's and 16, which
change nothing: one scan call a mixer call.

(b) runs in f32, at the training tests' tolerances (loss 1e-5 / 1e-4,
``U S Vᵀ`` 1e-4 of its largest entry). In bf16 the two packages' Mamba
mixers differ by ~1 % of their output's largest entry: the scan's state
is bf16 in both (the reference's design), each rounds it to bf16 at each
step in its own order (the port's sequential scan, and before it the
doubling scan, against ``associative_scan``'s tree), and the reference's
own jitted mixer differs from its op-by-op run by 6.1e-3 of max on the
same input, the port's doubling scan from the jitted one by 9.5e-3 (on the
CPU). Over a round that reaches the
losses and the factors: at this τ a bf16 round read loss_before 1.58e-3
and loss_after 2.28e-3 relative (the limit 2⁻⁹ = 1.95e-3), ``U S Vᵀ`` up
to 5.42e-3 of max (2⁻⁸ = 3.91e-3) and expert stacks 0.22-0.38 of their
own change (1/4), ranks equal. So the round is held in f32,
where it read 1.4e-7 / 1.5e-7 and 3.6e-6, no limit raised. In f32 too the
reference round costs ~100 s on an 8-core CPU (its jit traces and compiles
the eight distinct layers), built and run once in a module fixture.

τ of (b) sits at 0.113: the dense factors drop to rank 62 of 64, the
expert members to 31 of 32, x_proj stays at 8 of 8 (its tail at rank 7 is
0.211 of the spectrum's norm); the nearest tail norm of the round's
augmented spectra lies 9.8 % from ϑ, so no rank can flip. x_proj's
``U S Vᵀ`` moves by only 5e-7 to 2e-5 of its largest entry in the round in
both packages (its gradient reaches it through Δ and the scan's B and C,
tiny at Δ ~ 0.01), so the 1e-4 limit alone could not tell a wrong round
for it: left out of the guard that every factor moves at least 8x that
limit, each x_proj is held to 1/8 of the reference round's change of it,
but never under ``X_PROJ_FLOOR`` (2⁻¹⁹ of max, twice the worst gap read,
9.6e-7; the other factors read 1.4e-6 to 3.6e-6). That tells a round that
left x_proj unchanged at the two layers where it moves past the floor
(1.9e-5 and 3.0e-6); at the other five it moves 4.9e-7 to 1.8e-6, within
the two packages' f32 rounding, and no limit can.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.api.tasks as jtasks
from repro.checkpoint.io import _flatten as jflatten
from repro_torch import api
from repro_torch.api import tasks
from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.io import _flatten
from repro_torch.core import cost_model
from repro_torch.models import build_model, ssm
from repro_torch.models.transformer import _layer
from repro_torch.utils.tree import tree_leaves

from torch_threads import one_intra_op_thread  # noqa: F401
from torch_train_common import (LOSS_AFTER_RTOL, LOSS_BEFORE_RTOL, USVT_RTOL,
                                assert_bases_as_the_reference, assert_round_close, chip_smoke,
                                dtypes, expert_shares, fac, factors_of, jfac, round_calls_of,
                                round_moves, spec_pair, worst_usvt)

ARCH = "jamba-1.5-large-398b"
LAYERS = 8
TAU = 0.113
#: each expert stack within this share of the reference round's own change
#: past the truncation's cut (f32 reads up to 0.014)
EXPERT_OF_MOVE = 1 / 4
#: the scan in f32 against the recurrence in f64, of each tensor's largest
#: entry (f32 sums in another order)
SCAN_RTOL = 1e-5
#: the least limit of x_proj's port-against-reference gap, of its largest
#: entry: f32 rounding through the round (read up to 9.6e-7)
X_PROJ_FLOOR = 2.0**-19


def one_period(mp, dtype):
    """Both packages' ``lm`` task resolve the smoke config at one period
    (``reduced`` keeps two) with ``dtype`` parameters and compute."""
    for module in (jtasks, tasks):
        resolve = module.lm_model_config

        def cut(m, resolve=resolve):
            return dataclasses.replace(resolve(m), num_layers=LAYERS, param_dtype=dtype,
                                       compute_dtype=dtype)

        mp.setattr(module, "lm_model_config", cut)


@pytest.fixture(scope="module")
def smoke():
    return chip_smoke()


@pytest.fixture(scope="module")
def f32_round():
    """The reference's f32 experiment and one round of it and of the port
    from its parameters, with the starting parameters."""
    with pytest.MonkeyPatch.context() as mp:
        one_period(mp, "float32")
        jspec, tspec = spec_pair(ARCH, tau=TAU)
        jexp = japi.build(jspec)
        flat = {k: np.asarray(v) for k, v in jflatten(jexp.engine.params).items()}
        texp = api.build(tspec, params=params_from_numpy(flat, "cpu"), device="cpu")
        return dict(jexp=jexp, texp=texp, start=params_from_numpy(flat, "cpu"),
                    rj=jexp.run(1)[-1], rt=texp.run(1)[-1])


def test_lm_task_starts_from_the_reference_dtypes(monkeypatch):
    """(a) f32 U and V, bf16 S and dense leaves (the Mamba conv taps, D,
    ``dt_bias``), f32 ``A_log`` in both, leaf for leaf (the reference's
    task traced by ``jax.eval_shape``: its dtypes without its values);
    serving's ``model.init`` keeps bf16 bases."""
    one_period(monkeypatch, "bfloat16")
    jspec, tspec = spec_pair(ARCH)
    want = {k: str(v.dtype)
            for k, v in jflatten(jax.eval_shape(lambda: jtasks.build_task(jspec).params)).items()}
    texp = api.build(tspec, device="cpu")
    got = dtypes(_flatten(texp.engine.params))
    assert got == want
    assert {v for k, v in got.items() if k.endswith(("@U", "@V"))} == {"float32"}
    assert {v for k, v in got.items() if k.endswith("@S")} == {"bfloat16"}
    assert {v for k, v in got.items() if k.endswith(("conv_w", "|D", "dt_bias"))} == {"bfloat16"}
    assert {v for k, v in got.items() if k.endswith("A_log")} == {"float32"}

    cfg = tasks.lm_model_config(tspec.model)
    assert cfg.num_layers == LAYERS and cfg.block_pattern.count("mamba") == 7
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        served, _ = build_model(cfg).init(gen)
    assert {v for k, v in dtypes(_flatten(served)).items() if "@" in k and not
            k.endswith("@rank")} == {"bfloat16"}


def test_round_matches_the_reference(f32_round, smoke):
    """(b) one FeDLRT round in f32 from the reference's parameters: the
    doubling scan and its backward in every Mamba mixer, attention, the
    MoE blocks with their capacity, in the client loss."""
    jexp, texp, rj, rt = (f32_round[k] for k in ("jexp", "texp", "rj", "rt"))
    assert dtypes(_flatten(texp.engine.params)) == dtypes(jflatten(jexp.engine.params))
    assert_round_close(rj, rt, (LOSS_BEFORE_RTOL, LOSS_AFTER_RTOL))
    ranks = {k: set(np.ravel(v).tolist()) for k, v in rt.ranks.items()}
    assert set().union(*(v for k, v in ranks.items() if "moe" in k)) == {31.0}
    assert set().union(*(v for k, v in ranks.items() if "x_proj" in k)) == {8.0}
    assert set().union(*(v for k, v in ranks.items()
                         if "moe" not in k and "x_proj" not in k)) == {62.0}
    # 7 Mamba mixers' in / z / x / out (dt_proj dense: its 16 rows under the
    # policy's min_dim 32), 4 attention, 4 x 3 MLP, 4 x 3 expert stacks, the
    # embedding and the head
    assert len(rt.ranks) == 58
    worst = worst_usvt(jexp.engine.params, texp.engine.params)
    moves = round_moves(f32_round["start"], texp.engine.params)
    paths = [k for k, _ in smoke._factors(texp.engine.params)]
    dense = [m for (m, stacked), k in zip(moves, paths) if not stacked and "x_proj" not in k]
    x_proj = [m for (m, _), k in zip(moves, paths) if "x_proj" in k]
    shares = expert_shares(jexp.engine.params, texp.engine.params, f32_round["start"])
    x_gaps = x_proj_gaps(jexp.engine.params, texp.engine.params, f32_round["start"], paths)
    print(f"U S V^T: port vs reference {worst:.3g} (limit {USVT_RTOL:.3g}); the round's own "
          f"change {min(dense):.3g} to {max(dense):.3g}, x_proj's {min(x_proj):.3g} to "
          f"{max(x_proj):.3g}; expert stacks port vs reference {min(shares):.3g} to "
          f"{max(shares):.3g} of the reference's change past the cut; x_proj (gap, the "
          f"reference's change) " + ", ".join(f"({g:.3g}, {m:.3g})" for g, m in x_gaps))
    assert worst <= USVT_RTOL
    assert min(dense) >= 8 * USVT_RTOL
    assert len(shares) == 12 and all(s <= EXPERT_OF_MOVE for s in shares)
    assert len(x_gaps) == 7 and all(g <= max(m / 8, X_PROJ_FLOOR) for g, m in x_gaps)
    assert sum(m > X_PROJ_FLOOR for _, m in x_gaps) >= 2
    want = cost_model.wire_round_bytes(texp.engine.params)
    assert (rt.wire_bytes_down_per_client, rt.wire_bytes_up_per_client) == (
        want["down"], want["up"])
    assert_bases_as_the_reference(jexp.engine.params, texp.engine.params)
    # the Mamba dense leaves as the reference's, each moved where the
    # reference's moved: an update under half an f32 ulp of the leaf's
    # entries rounds away in both (dt_bias near -4.6 at the later layers)
    moved = set()
    for pos in ("pos0", "pos3", "pos7"):
        for name in ("A_log", "D", "dt_bias", "conv_w"):
            key = f"blocks/{pos}/mamba/{name}"
            before = f32_round["start"]["blocks"][pos]["mamba"][name]
            got = texp.engine.params["blocks"][pos]["mamba"][name]
            want = torch.from_numpy(np.array(jexp.engine.params["blocks"][pos]["mamba"][name]))
            assert (got - want).abs().max() <= USVT_RTOL * want.abs().max(), key
            assert torch.equal(got, before) == torch.equal(want, before), key
            if not torch.equal(got, before):
                moved.add(key)
    assert {f"blocks/pos0/mamba/{k}" for k in ("A_log", "D", "dt_bias", "conv_w")} <= moved

def x_proj_gaps(jparams, tparams, start, paths):
    """Each x_proj factor's max|W_port − W_ref| and the reference round's
    own change max|W_ref − W_start|, both of max|W_ref|."""
    out = []
    starts = [x for x in tree_leaves(start, is_leaf=fac.is_factor) if fac.is_factor(x)]
    for path, (jf, tf), f0 in zip(paths, factors_of(jparams, tparams), starts):
        if "x_proj" in path:
            want = np.asarray(jfac.materialize(jf), np.float32)
            scale = np.abs(want).max()
            out.append((float(np.abs(fac.materialize(tf).float().numpy() - want).max() / scale),
                        float(np.abs(want - fac.materialize(f0).float().numpy()).max() / scale)))
    return out


def test_bf16_round_kernel_calls_by_dtype(monkeypatch, smoke):
    """(c) ``chip_smoke.round_calls`` equals a reduced bf16 round's recorded
    kernel calls, one per launch by (kernel, dtype, K or N, R, S's dtype,
    G, M): Mamba's in / z / x / out projections (x_proj at its own r_max;
    dt_proj is dense at this width, a factor with its bias outside the
    chain at full width), attention, the MLPs, the expert stacks at G 4
    and the capacity's rows, the embedding and the head; and
    ``chip_smoke.scan_launches`` equals the round's calls of the scan's
    forward (one a Mamba mixer call) and of its backward (one a call that
    takes a gradient), the launches the card's round is held to."""
    scan_module = importlib.import_module("repro_torch.kernels.selective_scan")

    one_period(monkeypatch, "bfloat16")
    _, tspec = spec_pair(ARCH)
    scans, built = {"selective_scan": 0, "selective_scan_bwd": 0}, []
    real_fwd, real_bwd, real_build = (scan_module._forward, scan_module.selective_scan_bwd,
                                      api.build)

    def count(name, fn):
        return lambda *a: scans.__setitem__(name, scans[name] + 1) or fn(*a)

    monkeypatch.setattr(scan_module, "_forward", count("selective_scan", real_fwd))
    monkeypatch.setattr(scan_module, "selective_scan_bwd", count("selective_scan_bwd", real_bwd))
    monkeypatch.setattr(api, "build", lambda *a, **k: built.append(real_build(*a, **k))
                        or built[-1])
    calls, want = round_calls_of(smoke, tspec)
    assert calls == want
    assert scans == smoke.scan_launches(built[0].engine.cfg, tasks.lm_model_config(tspec.model))
    fed = built[0].engine.cfg
    assert scans["selective_scan_bwd"] == fed.num_clients * 7 * (1 + fed.s_star)
    cfg = tasks.lm_model_config(tspec.model)
    M = tspec.data.batch * tspec.data.seq
    assert {k[4] for k in calls if k[0] == "xus" and k[4]} == {"bfloat16", "float32"}
    assert {(k[5], k[6]) for k in calls if k[5] > 1} == {
        (cfg.moe.num_experts, smoke.expert_rows(cfg.moe, M))}
    d_inner, dt_rank, d_state, _ = ssm.mamba_dims(cfg)
    assert {k[2] for k in calls if k[0] == "avt"} >= {d_inner, dt_rank + 2 * d_state}


def _recurrence_inputs(B, T, C, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.85, 1.0, (B, T, C, 4)).astype(np.float32)
    b, P = (rng.standard_normal((B, T, C, 4)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, C, 4)).astype(np.float32)
    return a, b, h0, P


def _reduced_layer(scan_chunk=None):
    cfg = dataclasses.replace(tasks.lm_model_config(api.ModelSpec(arch=ARCH, smoke=True)),
                              num_layers=LAYERS)
    if scan_chunk is not None:
        cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba,
                                                                  scan_chunk=scan_chunk))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        params, _ = build_model(cfg).init(gen)
    return cfg, _layer(params["blocks"]["pos0"]["mamba"], 0)


def test_linear_recurrence_matches_the_token_recurrence(smoke):
    """(d) the doubling scan in f32 and its reverse-recurrence backward
    against ``chip_smoke._stepped_recurrence`` in f64 on the same inputs
    at T 37 from a nonzero state, decays in [0.85, 1): ``h`` and the
    gradients of ``<h, P>`` with respect to a, b and h0."""
    *ins, P = _recurrence_inputs(2, 37, 6)
    out = {}
    for name, dtype in (("scan", torch.float32), ("stepped", torch.float64)):
        xs = [torch.from_numpy(v).to(dtype).requires_grad_(True) for v in ins]
        fn = ssm.linear_recurrence if name == "scan" else smoke._stepped_recurrence
        h = fn(*xs)
        out[name] = [h, *torch.autograd.grad((h * torch.from_numpy(P).to(dtype)).sum(), xs)]
    for what, a, b in zip(("h", "a", "b", "h0"), out["scan"], out["stepped"]):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        err = ((a.double() - b).abs().max() / b.abs().max()).item()
        assert err <= SCAN_RTOL, f"{what}: {err}"


@pytest.mark.parametrize("B, T, chunk", [(2, 37, 8), (2, 40, None), (2, 40, 16)])
def test_mixer_scan_check_holds_the_reduced_layer(smoke, B, T, chunk):
    """(e) ``chip_smoke.mamba_scan_against_recurrence`` (the card's
    ``[train-jamba scan]``) on the reduced layer 0 at T 37 and 40 (two and
    three of the backward's 16-step segments, the last one short), with
    ``scan_chunk`` 8, the config's and 16: one scan call a mixer call; the
    mixer's output and the gradients with respect to x, ``A_log``, ``D``,
    ``dt_bias``, ``conv_w``, ``in_x``'s and ``x_proj``'s S and dt_proj's
    weight (dense at this width) within 1e-5 of their largest entries,
    against the mixer with the scan token by token in f64."""
    cfg, p = _reduced_layer(chunk)
    got = smoke.mamba_scan_against_recurrence(torch, cfg, p, B, T, 7, device="cpu")
    assert got["calls"] == 1
    assert set(got["errs"]) == {"out", "grad x", "grad A_log", "grad D", "grad dt_bias",
                                "grad conv_w", "grad in_x S", "grad x_proj S",
                                "grad dt_proj W"}
    assert max(got["errs"].values()) <= SCAN_RTOL, got["errs"]
    assert np.isfinite(got["served_err"])
