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
and the kernel calls run for both architectures.

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
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.api.tasks as jtasks
import repro.core.factorization as jfac
from repro.checkpoint.io import _flatten as jflatten
from repro_torch import api
from repro_torch.api import tasks
from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.io import _flatten
from repro_torch.core import cost_model
from repro_torch.core import factorization as fac
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves

from torch_threads import one_intra_op_thread  # noqa: F401

LOSS_BEFORE_RTOL = 1e-5  # f32, as tests/test_torch_train.py
LOSS_AFTER_RTOL = 1e-4
USVT_RTOL = 1e-4
BF16_LOSS_RTOL = 2.0**-9
BF16_USVT_RTOL = 2.0**-8
#: per architecture: τ of the bf16 round and the ranks it leaves, (the
#: other factors', the expert members')
BF16_ROUNDS = {"qwen2-7b": (0.085, {63.0}, set()),
               "olmoe-1b-7b": (0.113, {62.0}, {31.0})}
EXPERT_OF_MOVE = 1 / 4
ARCHS = list(BF16_ROUNDS)


@pytest.fixture
def bf16_reduced(monkeypatch):
    """Both packages' ``lm`` task resolve a smoke config with bf16
    parameters and compute (``reduced`` makes them f32)."""
    for module in (jtasks, tasks):
        resolve = module.lm_model_config

        def bf16(m, resolve=resolve):
            return dataclasses.replace(resolve(m), param_dtype="bfloat16",
                                       compute_dtype="bfloat16")

        monkeypatch.setattr(module, "lm_model_config", bf16)


def spec_pair(arch="qwen2-7b", **fed):
    kw = dict(rounds=1, log_every=0)
    sections = dict(model=dict(arch=arch, smoke=True),
                    data=dict(tokens_per_client=2000, seq=32),
                    fed=dict(local_steps=2, **fed))
    return (japi.ExperimentSpec(**kw, model=japi.ModelSpec(**sections["model"]),
                                data=japi.DataSpec(**sections["data"]),
                                fed=japi.FedSpec(**sections["fed"])),
            api.ExperimentSpec(**kw, model=api.ModelSpec(**sections["model"]),
                               data=api.DataSpec(**sections["data"]),
                               fed=api.FedSpec(**sections["fed"])))


def dtypes(flat) -> dict:
    """npz member → dtype name; bf16 in either package's layout."""
    def name(x):
        if torch.is_tensor(x):
            return str(x.dtype).removeprefix("torch.")
        x = np.asarray(x)
        return "bfloat16" if x.dtype.itemsize == 2 and x.dtype.kind not in "fiu" else str(x.dtype)

    return {k: name(v) for k, v in flat.items()}


def run_pair(jspec, tspec):
    """Both experiments, the port's from the reference's parameters, each
    after one round, their round results and the starting parameters."""
    jexp = japi.build(jspec)
    flat = {k: np.asarray(v) for k, v in jflatten(jexp.engine.params).items()}
    texp = api.build(tspec, params=params_from_numpy(flat, "cpu"), device="cpu")
    return jexp, texp, jexp.run(1)[-1], texp.run(1)[-1], params_from_numpy(flat, "cpu")


def factors_of(jparams, tparams):
    jfs = [x for x in jax.tree.leaves(jparams, is_leaf=jfac.is_factor) if jfac.is_factor(x)]
    tfs = [x for x in tree_leaves(tparams, is_leaf=fac.is_factor) if fac.is_factor(x)]
    assert len(jfs) == len(tfs) > 0
    return zip(jfs, tfs)


def worst_usvt(jparams, tparams) -> float:
    worst = 0.0
    for jf, tf in factors_of(jparams, tparams):
        want = np.asarray(jfac.materialize(jf), np.float32)
        got = fac.materialize(tf).float().numpy()
        worst = max(worst, float(np.abs(got - want).max() / np.abs(want).max()))
    return worst


def round_moves(start, end) -> list:
    """Each factor's change of ``U S Vᵀ`` over the round, max|W_end −
    W_start| / max|W_end|, and whether it is an expert stack."""
    moves = []
    for a, b in zip(*(([x for x in tree_leaves(p, is_leaf=fac.is_factor) if fac.is_factor(x)])
                      for p in (start, end))):
        W0, W1 = fac.materialize(a).float(), fac.materialize(b).float()
        moves.append((float((W1 - W0).abs().max() / W1.abs().max()), a.U.dim() > 3))
    return moves


def expert_shares(jparams, tparams, start) -> list:
    """Each expert stack's max|W_port − W_ref| as a share of the reference
    round's own change of it past the truncation's cut, max|W_ref −
    W_cut|: ``W_cut`` is the start with each member's S cut to the rank the
    round left (its SVD's leading singular triples), so a round whose
    coefficient step did nothing reads 1 even where the cut itself moves
    the stack by ~0.2 of its largest entry."""
    shares = []
    starts = [x for x in tree_leaves(start, is_leaf=fac.is_factor) if fac.is_factor(x)]
    for (jf, tf), f0 in zip(factors_of(jparams, tparams), starts):
        if tf.U.dim() <= 3:
            continue
        want = np.asarray(jfac.materialize(jf), np.float32)
        got = fac.materialize(tf).float().numpy()
        P, s, Qt = torch.linalg.svd(f0.S.float())
        s = s * (torch.arange(s.shape[-1]) < tf.rank[..., None])
        W_cut = (f0.U.float() @ ((P * s[..., None, :]) @ Qt) @ f0.V.float().mT).numpy()
        shares.append(float(np.abs(got - want).max() / np.abs(want - W_cut).max()))
    return shares


def assert_round_close(rj, rt, loss_rtol):
    for name, rtol in zip(("loss_before", "loss_after"), loss_rtol):
        a, b = getattr(rt, name), getattr(rj, name)
        assert abs(a - b) <= rtol * abs(b), f"{name}: {a} vs {b} (rtol {rtol})"
    assert rj.ranks.keys() == rt.ranks.keys()
    for k in rj.ranks:
        np.testing.assert_array_equal(rt.ranks[k], rj.ranks[k], err_msg=k)
    assert rt.comm_bytes_per_client == rj.comm_bytes_per_client
    assert rt.comm_bytes_per_client_effective == rj.comm_bytes_per_client_effective
    assert rt.wire_bytes_down_per_client == rj.wire_bytes_down_per_client
    assert rt.wire_bytes_up_per_client == rj.wire_bytes_up_per_client


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_task_starts_from_the_reference_dtypes(bf16_reduced, arch):
    """(a) f32 U and V, bf16 S and dense leaves, f32 ranks, leaf for leaf;
    serving's ``model.init`` keeps bf16 bases."""
    jspec, tspec = spec_pair(arch)
    want = dtypes(jflatten(japi.build(jspec).engine.params))
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
    # the bases' orthonormality is the reference's (their bf16-rounded start
    # sets it): nothing in the round rounds them again
    for jf, tf in factors_of(jexp.engine.params, texp.engine.params):
        got, want = fac.check_invariants(tf), jfac.check_invariants(jf)
        for key in ("u_ortho_defect", "v_ortho_defect"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-4, key


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_round_kernel_calls_by_dtype(bf16_reduced, arch):
    """``chip_smoke.round_calls``, a bf16 round's calls one per launch by
    (kernel, dtype, K or N, R, S's dtype, G, M) (the backward's products
    with S take S in f32, the gather's backward into the f32 embedding U
    runs ``atb`` in f32, an expert stack launches once a layer with its E
    experts as G at the capacity's M), equals the kernel calls of a reduced
    bf16 round on the CPU (the wrappers' plain versions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_train_calls", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, tspec = spec_pair(arch)
    exp = api.build(tspec, device="cpu")
    params, cfg = exp.params, exp.engine.cfg
    calls = {}
    with smoke.kernel_calls(calls):
        exp.run(1)
    moe = tasks.lm_model_config(tspec.model).moe
    M = tspec.data.batch * tspec.data.seq
    assert calls == smoke.round_calls(params, cfg, M, "bfloat16", moe)
    assert {k[4] for k in calls if k[0] == "xus" and k[4]} == {"bfloat16", "float32"}
    stacks = {(k[5], k[6]) for k in calls if k[5] > 1}
    assert stacks == ({(moe.num_experts, smoke.expert_rows(moe, M))} if moe else set())


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
