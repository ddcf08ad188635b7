"""The ``lm`` task at RWKV6-7B (reduced: 2 layers, d 256, 8 heads of 32,
decay LoRA 16, wkv chunks of 16, vocabulary 512) in both packages, through
``build(spec).run()``, and the chunked wkv against its token-by-token
recurrence.

Cases: (a) the task's parameter dtypes, leaf for leaf, with bf16
parameters and compute (f32 U and V, bf16 S); (b) one bf16 FeDLRT round
from the reference's parameters, at ``tests/torch_train_common.py``'s
tolerances (loss 2⁻⁹, ``U S Vᵀ`` 2⁻⁸ of its largest entry and at least 8x
below the round's own change of every factor); a bf16 round's kernel calls
against ``chip_smoke.round_calls`` (the five d x d projections, the
non-gated MLP's two factors, the embedding and the head); the port's
``_rwkv_chunked`` in f32 against ``_rwkv_stepped`` in f64, forward and
gradient, within 1e-5 of each tensor's largest entry where no clamp binds;
and ``chip_smoke.wkv_against_recurrence`` (the card's ``[train-rwkv wkv]``
check) on the reduced layer 0, with and without clamped chunks.

τ of (b) sits at 0.086: every factor drops to rank 63 of 64, and the
nearest tail norm of the round's augmented spectra lies 16.6 % from ϑ (at
0.070 and 0.100 it lies within 1 %), so no rank can flip between the two
packages. The reference side is built and run once, in a module-scoped
fixture.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.checkpoint.io import _flatten as jflatten
from repro_torch import api
from repro_torch.api import tasks
from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.io import _flatten
from repro_torch.core import cost_model
from repro_torch.models import build_model, ssm
from repro_torch.models.transformer import _layer

from torch_threads import one_intra_op_thread  # noqa: F401
from torch_train_common import (BF16_LOSS_RTOL, BF16_USVT_RTOL, assert_bases_as_the_reference,
                                assert_round_close, bf16_reduced, chip_smoke, dtypes,  # noqa: F401
                                patch_bf16, round_calls_of, round_moves, spec_pair, worst_usvt)

ARCH = "rwkv6-7b"
TAU = 0.086
#: the chunked wkv in f32 against the recurrence in f64, of each tensor's
#: largest entry (f32 sums in another order; the prefix sums of the
#: log-decays round at ~1e-7 of their size)
WKV_RTOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    return chip_smoke()


@pytest.fixture(scope="module")
def bf16_round():
    """The reference's bf16 experiment, its dtypes as built, and one round
    of it and of the port from its parameters."""
    with pytest.MonkeyPatch.context() as mp:
        patch_bf16(mp)
        jspec, tspec = spec_pair(ARCH, tau=TAU)
        jexp = japi.build(jspec)
        flat = {k: np.asarray(v) for k, v in jflatten(jexp.engine.params).items()}
        texp = api.build(tspec, params=params_from_numpy(flat, "cpu"), device="cpu")
        return dict(jdtypes=dtypes(flat), jexp=jexp, texp=texp, tspec=tspec,
                    start=params_from_numpy(flat, "cpu"), rj=jexp.run(1)[-1], rt=texp.run(1)[-1])


def test_lm_task_starts_from_the_reference_dtypes(bf16_reduced, bf16_round):
    """(a) f32 U and V, bf16 S and dense leaves (the decay LoRA, ``w0``,
    ``u``, the token-shift mixes), leaf for leaf; serving's ``model.init``
    keeps bf16 bases."""
    texp = api.build(bf16_round["tspec"], device="cpu")
    got = dtypes(_flatten(texp.engine.params))
    assert got == bf16_round["jdtypes"]
    assert {v for k, v in got.items() if k.endswith(("@U", "@V"))} == {"float32"}
    assert {v for k, v in got.items() if k.endswith("@S")} == {"bfloat16"}
    assert {v for k, v in got.items() if k.endswith(("w_lora_a", "w_lora_b", "w0", "u"))} == {
        "bfloat16"}

    cfg = tasks.lm_model_config(bf16_round["tspec"].model)
    assert cfg.block_pattern == ("rwkv",) and not cfg.gated_mlp
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        served, _ = build_model(cfg).init(gen)
    assert {v for k, v in dtypes(_flatten(served)).items() if "@" in k and not
            k.endswith("@rank")} == {"bfloat16"}


def test_bf16_round_matches_the_reference(bf16_round):
    """(b) one FeDLRT round in bf16 from the reference's parameters: the
    chunked wkv and its backward, and the decay LoRA, in the client loss."""
    jexp, texp, rj, rt = (bf16_round[k] for k in ("jexp", "texp", "rj", "rt"))
    assert dtypes(_flatten(texp.engine.params)) == dtypes(jflatten(jexp.engine.params))
    assert_round_close(rj, rt, (BF16_LOSS_RTOL, BF16_LOSS_RTOL))
    # truncation acted on every factor, one step below r_max
    assert set().union(*(set(np.ravel(v).tolist()) for v in rt.ranks.values())) == {63.0}
    assert len(rt.ranks) == 9  # r, k, v, g, out, the MLP's up and down, embed, head
    worst = worst_usvt(jexp.engine.params, texp.engine.params)
    moves = [m for m, _ in round_moves(bf16_round["start"], texp.engine.params)]
    print(f"U S V^T: port vs reference {worst:.3g} (limit {BF16_USVT_RTOL:.3g}); the round's "
          f"own change {min(moves):.3g} to {max(moves):.3g}")
    assert worst <= BF16_USVT_RTOL
    # the limit separates a wrong round: every factor moves far more
    assert min(moves) >= 8 * BF16_USVT_RTOL
    want = cost_model.wire_round_bytes(texp.engine.params)
    assert (rt.wire_bytes_down_per_client, rt.wire_bytes_up_per_client) == (
        want["down"], want["up"])
    assert_bases_as_the_reference(jexp.engine.params, texp.engine.params)
    # the decay's dense leaves as the reference's: the LoRA moves (by ~1e-3
    # of its largest entry); w0 and u, near 1, keep their bf16 values in
    # both packages (an update under half a bf16 ulp rounds away)
    for name in ("w0", "w_lora_a", "w_lora_b", "u"):
        key = f"blocks/pos0/rwkv/{name}"
        before = bf16_round["start"]["blocks"]["pos0"]["rwkv"][name].float()
        got = texp.engine.params["blocks"]["pos0"]["rwkv"][name].float()
        want = torch.from_numpy(np.asarray(
            jexp.engine.params["blocks"]["pos0"]["rwkv"][name], np.float32))
        assert torch.equal(got, before) == (name in ("w0", "u")), key
        assert (got - want).abs().max() <= BF16_USVT_RTOL * want.abs().max(), key


def test_bf16_round_kernel_calls_by_dtype(bf16_reduced, smoke):
    """``chip_smoke.round_calls`` equals a reduced bf16 round's recorded
    kernel calls, one per launch by (kernel, dtype, K or N, R, S's dtype,
    G, M): its generic branch counts RWKV's five d x d projections, the
    non-gated MLP's up and down, the head, and the embedding's own branch;
    no stack rides the grid axis (G 1 throughout)."""
    _, tspec = spec_pair(ARCH)
    calls, want = round_calls_of(smoke, tspec)
    assert calls == want
    assert {k[4] for k in calls if k[0] == "xus" and k[4]} == {"bfloat16", "float32"}
    assert {k[5] for k in calls} == {1}
    cfg = tasks.lm_model_config(tspec.model)
    d, f = cfg.d_model, cfg.d_ff
    assert {k[2] for k in calls if k[0] == "xus"} >= {d, f, cfg.vocab_size}


def _wkv_inputs(B, T, H, hd, w0, with_state, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    logw = -np.exp(w0 + 0.1 * rng.standard_normal((B, T, H, hd))).astype(np.float32)
    u = (0.5 + 0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    S0 = (with_state * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    P = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    Q = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return (r, k, v, logw, u, S0), P, Q


@pytest.mark.parametrize("T, chunk, with_state", [(37, 16, False), (150, 64, True),
                                                  (64, 64, False)])
def test_chunked_wkv_matches_the_token_recurrence(T, chunk, with_state):
    """``_rwkv_chunked`` in f32 against ``_rwkv_stepped`` in f64 on the same
    inputs: the output, the last state and the gradients of ``<o, P> +
    <S_T, Q>`` with respect to r, k, v, the log-decays, u and the first
    state. The decays are RWKV6-7B's at its start (w0 = -1), so a 64-token
    chunk's log-decay reaches ~-23.5 and the rescaled keys ~e^23.5, and no
    clamp binds (held); T 37 leaves a ragged last chunk."""
    ins, P, Q = _wkv_inputs(2, T, 3, 64 if chunk == 64 else 16, -1.0, with_state)
    logw = torch.from_numpy(ins[3])
    n = -(-T // chunk)
    lw = torch.cat([logw, logw.new_zeros((2, n * chunk - T) + logw.shape[2:])], dim=1)
    assert torch.cumsum(lw.reshape(2, n, chunk, *logw.shape[2:]), 2).min() > -ssm.CLAMP
    out = {}
    for name, dtype, fn in (("chunked", torch.float32, lambda *a: ssm._rwkv_chunked(*a, chunk)),
                            ("stepped", torch.float64, ssm._rwkv_stepped)):
        xs = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in ins]
        o, S = fn(*xs)
        loss = (o * torch.from_numpy(P).to(dtype)).sum() + (S * torch.from_numpy(Q).to(dtype)).sum()
        out[name] = [o, S, *torch.autograd.grad(loss, xs)]
    names = ("o", "S_T", "r", "k", "v", "logw", "u", "S0")
    for what, a, b in zip(names, out["chunked"], out["stepped"]):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        err = ((a.double() - b).abs().max() / b.abs().max()).item()
        assert err <= WKV_RTOL, f"{what}: {err}"


def _reduced_layer():
    cfg = tasks.lm_model_config(api.ModelSpec(arch=ARCH, smoke=True))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        params, _ = build_model(cfg).init(gen)
    return cfg, _layer(params["blocks"]["pos0"]["rwkv"], 0)


def test_time_mix_check_holds_the_reduced_layer(smoke):
    """``chip_smoke.wkv_against_recurrence`` (the card's ``[train-rwkv
    wkv]``) on the reduced model's layer 0 over 2 x 40 tokens (chunks of
    16, the last ragged): no clamp binds; the output and the gradients with
    respect to x, w0, u and the decay LoRA within 1e-5 of their largest
    entries."""
    cfg, p = _reduced_layer()
    got = smoke.wkv_against_recurrence(torch, cfg, p, 2, 40, 7, device="cpu")
    assert got["chunks"] == 3 and got["clamped_chunks"] == 0
    assert set(got["errs"]) == {"out", "grad x", "grad w0", "grad u", "grad w_lora_a",
                                "grad w_lora_b"}
    assert max(got["errs"].values()) <= WKV_RTOL, got["errs"]


def test_time_mix_check_leaves_out_clamped_chunks(smoke):
    """With w0 = 0.75 each token's log-decay is ~-2.1: a full chunk of 16
    reaches ~-34.5, past -30 (the clamps bind: its own outputs are not the
    recurrence's), the ragged last chunk of 8 ~-17. The check leaves the
    two clamped chunks out, holds the last one, whose state comes through
    them, to the recurrence within 1e-5 (the f32 prefix sums' rounding
    grows with their depth: the gradients read up to 4.8e-6 here, 1.7e-5 at
    w0 = 1.2, where a chunk reaches -54), and refuses a run in which every
    chunk is clamped."""
    cfg, p = _reduced_layer()
    p = dict(p, w0=torch.full_like(p["w0"], 0.75))
    got = smoke.wkv_against_recurrence(torch, cfg, p, 2, 40, 7, device="cpu")
    assert got["chunks"] == 3 and got["clamped_chunks"] == 2
    assert max(got["errs"].values()) <= WKV_RTOL, got["errs"]
    with pytest.raises(AssertionError, match="every chunk"):
        smoke.wkv_against_recurrence(torch, cfg, p, 2, 32, 7, device="cpu")
