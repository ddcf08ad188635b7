"""The ``lm`` task at a registered architecture (Qwen2-7B and OLMoE-1B-7B,
reduced) in both packages, through ``build(spec).run()``.

The JAX package's ``init_factor`` multiplies its bases by an f32 rank mask,
so its ``lm`` task starts a bf16 model from f32 U and V beside a bf16 S,
and its round keeps each factor's dtypes: a bf16 round carries f32 bases.
The port's task starts from the same dtypes (serving keeps bf16 bases).

Cases: (a) the task's parameter dtypes, leaf for leaf, under a reduced
config with bf16 parameters and compute; (b) one FeDLRT round of that
config from the reference's parameters; (c) the registry's own reduced
Qwen2 config (``smoke=True``, f32) at the training tests' tolerances; and
a bf16 round's kernel calls against ``chip_smoke.round_calls``. (a), (b)
and the kernel calls run for both architectures; the kernel calls also for
DeepSeekMoE-16B, whose shared experts run as dense factors beside its
routed expert stacks (the port alone: no reference round).

Tolerances of (b), in bf16: the loss 2⁻⁹ relative (half a bf16 rounding:
both packages round every activation to bf16 and differ only where an f32
sum taken in another order lands on the other side of a rounding, which the
mean over 4 × 2 × 32 tokens averages); ``U S Vᵀ`` 2⁻⁸ of its largest entry
(one bf16 rounding of the aggregated S̃ entry, the bases being f32), which
lies far below the round's own change of each factor's ``U S Vᵀ`` (over
0.1 of its largest entry; the test holds it to at least 8x the limit), so
a round that left a factor unchanged, or moved it the wrong way, fails.
Qwen2's τ sits at 0.085, where every factor drops to rank 63 of 64 and the
nearest tail norm of the round's spectra lies 17 % from ϑ: no rank can
flip.

OLMoE's expert stacks (E members in a leaf) move by only ~1e-3 of their
largest entry in a round's coefficient step, so 2⁻⁸ of max alone would pass
a round whose step left them unchanged: each expert leaf is also held
within 1/4 of the reference round's own change of it past the truncation's
cut (one bf16 rounding apart reads 0.15-0.16 of it; a step that did nothing
reads 1), and the 8x guard holds the other factors. Its τ sits at 0.113,
where the expert members drop to rank 31 of 32 (at 0.085 none is
truncated: their augmented spectra's small half lies under ϑ and the rank
stays at r_max) and the other factors to 62 of 64; the nearest tail norm
lies 9.6 % from ϑ.
"""
import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

import repro.core.factorization as jfac
from repro.checkpoint.io import _flatten as jflatten
from repro_torch import api
from repro_torch.api import tasks
from repro_torch.checkpoint.io import _flatten
from repro_torch.core import cost_model
from repro_torch.configs import get_config
from repro_torch.core import factorization as fac
from repro_torch.models import build_model, reduced

from torch_threads import one_intra_op_thread  # noqa: F401
from torch_train_common import (BF16_LOSS_RTOL, BF16_USVT_RTOL, LOSS_AFTER_RTOL,
                                LOSS_BEFORE_RTOL, USVT_RTOL, assert_bases_as_the_reference,
                                assert_round_close, bf16_reduced, chip_smoke, dtypes,  # noqa: F401
                                expert_shares, reference_dtypes, round_calls_of, round_moves,
                                run_pair, spec_pair, worst_usvt)

#: per architecture: τ of the bf16 round and the ranks it leaves, (the
#: other factors', the expert members')
BF16_ROUNDS = {"qwen2-7b": (0.085, {63.0}, set()),
               "olmoe-1b-7b": (0.113, {62.0}, {31.0})}
EXPERT_OF_MOVE = 1 / 4
ARCHS = list(BF16_ROUNDS)
#: the kernel-call count runs the port alone: DeepSeekMoE too, whose shared
#: experts are dense factors beside the routed expert stacks
CALL_ARCHS = ARCHS + ["deepseek-moe-16b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_task_starts_from_the_reference_dtypes(bf16_reduced, arch):
    """(a) f32 U and V, bf16 S and dense leaves, f32 ranks, leaf for leaf;
    serving's ``model.init`` keeps bf16 bases."""
    jspec, tspec = spec_pair(arch)
    want = reference_dtypes(jspec)
    texp = api.build(tspec, device="cpu")
    got = dtypes(_flatten(texp.engine.params))
    assert got == want
    assert {v for k, v in got.items() if k.endswith(("@U", "@V"))} == {"float32"}
    assert {v for k, v in got.items() if k.endswith("@S")} == {"bfloat16"}

    cfg = tasks.lm_model_config(tspec.model)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        served, _ = build_model(cfg).init(gen)
    assert {v for k, v in dtypes(_flatten(served)).items() if "@" in k and not
            k.endswith("@rank")} == {"bfloat16"}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_round_matches_the_reference(bf16_reduced, arch):
    """(b) one FeDLRT round in bf16 from the reference's parameters."""
    tau, dense_ranks, expert_ranks = BF16_ROUNDS[arch]
    jspec, tspec = spec_pair(arch, tau=tau)
    jexp, texp, rj, rt, start = run_pair(jspec, tspec)
    assert dtypes(_flatten(texp.engine.params)) == dtypes(jflatten(jexp.engine.params))
    assert_round_close(rj, rt, (BF16_LOSS_RTOL, BF16_LOSS_RTOL))
    # truncation acted on every factor, one or two steps below r_max
    ranks = {k: set(np.ravel(v).tolist()) for k, v in rt.ranks.items()}
    assert set().union(*(v for k, v in ranks.items() if "moe" not in k)) == dense_ranks
    assert set().union(*(v for k, v in ranks.items() if "moe" in k), set()) == expert_ranks
    worst = worst_usvt(jexp.engine.params, texp.engine.params)
    moves = round_moves(start, texp.engine.params)
    dense = [m for m, stacked in moves if not stacked]
    shares = expert_shares(jexp.engine.params, texp.engine.params, start)
    print(f"U S V^T: port vs reference {worst:.3g} (limit {BF16_USVT_RTOL:.3g}); the round's "
          f"own change {min(dense):.3g} to {max(dense):.3g}"
          + (f"; expert stacks {min(m for m, s in moves if s):.3g} to "
             f"{max(m for m, s in moves if s):.3g}, port vs reference {min(shares):.3g} to "
             f"{max(shares):.3g} of the reference's change past the cut (limit "
             f"{EXPERT_OF_MOVE})"
             if shares else ""))
    assert worst <= BF16_USVT_RTOL
    # the limit separates a wrong round: every other factor moves far more
    assert min(dense) >= 8 * BF16_USVT_RTOL
    # and an expert stack, which moves less, is held by its own change
    assert len(shares) == (3 if expert_ranks else 0)
    assert all(s <= EXPERT_OF_MOVE for s in shares)
    # the identity codec measures each tensor at its own size
    want = cost_model.wire_round_bytes(texp.engine.params)
    assert (rt.wire_bytes_down_per_client, rt.wire_bytes_up_per_client) == (
        want["down"], want["up"])
    assert_bases_as_the_reference(jexp.engine.params, texp.engine.params)


@pytest.mark.parametrize("arch", CALL_ARCHS)
def test_bf16_round_kernel_calls_by_dtype(bf16_reduced, arch):
    """``chip_smoke.round_calls``, a bf16 round's calls one per launch by
    (kernel, dtype, K or N, R, S's dtype, G, M) (the backward's products
    with S take S in f32, the gather's backward into the f32 embedding U
    runs ``atb`` in f32, an expert stack launches once a layer with its E
    experts as G at the capacity's M), equals the kernel calls of a reduced
    bf16 round on the CPU (the wrappers' plain versions). DeepSeekMoE's
    shared experts run as dense factors: G 1 at M = batch x seq."""
    smoke = chip_smoke()
    _, tspec = spec_pair(arch)
    calls, want = round_calls_of(smoke, tspec)
    assert calls == want
    moe = tasks.lm_model_config(tspec.model).moe
    M = tspec.data.batch * tspec.data.seq
    assert {k[4] for k in calls if k[0] == "xus" and k[4]} == {"bfloat16", "float32"}
    stacks = {(k[5], k[6]) for k in calls if k[5] > 1}
    assert stacks == ({(moe.num_experts, smoke.expert_rows(moe, M))} if moe else set())
    exp = api.build(tspec, device="cpu")
    blocks = exp.params["blocks"]["pos0"]
    shared = {k: v for k, v in blocks.get("moe", {}).items() if k.startswith("shared_")}
    assert len(shared) == (3 if arch == "deepseek-moe-16b" else 0)
    if shared:
        # the shared leaves' calls alone: every one at G 1 and M rows, each
        # among the round's with at least its count
        own = smoke.round_calls({"moe": shared}, exp.engine.cfg, M, "bfloat16", moe)
        assert own and {(k[5], k[6]) for k in own} == {(1, M)}
        assert all(calls.get(k, 0) >= n for k, n in own.items())
        routed = smoke.round_calls({"moe": {k: blocks["moe"][k] for k in ("up", "gate", "down")}},
                                   exp.engine.cfg, M, "bfloat16", moe)
        assert {(k[5], k[6]) for k in routed} == {(moe.num_experts, smoke.expert_rows(moe, M))}


def test_chip_activation_reckoning_keeps_no_tensor():
    """``chip_smoke.activation_reckoning`` at reduced DeepSeekMoE-16B in bf16
    on the CPU: a layer's saved bytes in the basis pass and, larger (the
    augmented rank), in a client step; the same on a second call, which
    leaves no more tensors alive than the first did (a saved output handed
    back to the graph whole would keep that graph in a cycle, never
    freed: ~4 GiB a call at Qwen1.5-32B's width on the card)."""
    smoke = chip_smoke()
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), param_dtype="bfloat16",
                              compute_dtype="bfloat16")

    def live():
        gc.collect()
        return sum(o.numel() * o.element_size() for o in gc.get_objects() if torch.is_tensor(o))

    first = smoke.activation_reckoning(torch, cfg, 4, 32, device="cpu")
    before = live()
    assert smoke.activation_reckoning(torch, cfg, 4, 32, device="cpu") == first
    assert live() == before
    (basis, _), (client, _) = first["basis pass"], first["client step"]
    assert 0 < basis < client


def test_registry_smoke_round_matches_the_reference():
    """(c) ``ModelSpec(arch="qwen2-7b", smoke=True)``: f32 end to end."""
    jspec, tspec = spec_pair()
    jexp, texp, rj, rt, _ = run_pair(jspec, tspec)
    assert_round_close(rj, rt, (LOSS_BEFORE_RTOL, LOSS_AFTER_RTOL))
    assert worst_usvt(jexp.engine.params, texp.engine.params) <= USVT_RTOL
    assert texp.comm_total_bytes() == jexp.engine.comm_total_bytes()
    assert texp.engine.comm_total_bytes_analytic() == jexp.engine.comm_total_bytes_analytic()


def test_mixed_dtype_factor_products_promote():
    """A training factor (f32 U and V, bf16 S): ``materialize`` and
    ``lr_rowlookup`` promote to f32 as ``jnp.einsum`` / ``@`` do in the
    JAX package, on the same values."""
    rng = np.random.default_rng(0)
    U = rng.standard_normal((40, 8)).astype(np.float32)
    V = rng.standard_normal((24, 8)).astype(np.float32)
    S = np.diag(rng.standard_normal(8)).astype(np.float32)
    tf = fac.LowRankFactor(U=torch.from_numpy(U), S=torch.from_numpy(S).to(torch.bfloat16),
                           V=torch.from_numpy(V), rank=torch.tensor(8.0))
    jf = jfac.LowRankFactor(U=U, S=jax.numpy.asarray(S, jax.numpy.bfloat16), V=V,
                            rank=np.float32(8.0))
    want = np.asarray(jfac.materialize(jf))
    got = fac.materialize(tf)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    idx = torch.tensor([3, 0, 39])
    rows = fac.lr_rowlookup(idx, tf)
    assert rows.dtype == torch.float32
    np.testing.assert_allclose(rows.numpy(), want[[3, 0, 39]], rtol=1e-6, atol=1e-5)
