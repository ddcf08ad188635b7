"""Helpers of the tests that train a registered architecture, reduced, in
both packages through ``build(spec).run()`` (``tests/test_torch_train_arch.py``,
``tests/test_torch_train_rwkv.py``): the spec pair, the run from the
reference's parameters, the dtype map, the ``U S Vᵀ`` comparisons, the
round's checks and ``chip_smoke.py`` loaded as a module.

Tolerances, in bf16: the loss 2⁻⁹ relative (half a bf16 rounding: both
packages round every activation to bf16 and differ only where an f32 sum
taken in another order lands on the other side of a rounding, which the
mean over 4 × 2 × 32 tokens averages); ``U S Vᵀ`` 2⁻⁸ of its largest entry
(one bf16 rounding of the aggregated S̃ entry, the bases being f32). In
f32, the training tests' (``tests/test_torch_train.py``).
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
from repro_torch.core import factorization as fac
from repro_torch.utils.tree import tree_leaves

LOSS_BEFORE_RTOL = 1e-5  # f32, as tests/test_torch_train.py
LOSS_AFTER_RTOL = 1e-4
USVT_RTOL = 1e-4
BF16_LOSS_RTOL = 2.0**-9
BF16_USVT_RTOL = 2.0**-8


def patch_bf16(monkeypatch):
    """Both packages' ``lm`` task resolve a smoke config with bf16
    parameters and compute (``reduced`` makes them f32)."""
    for module in (jtasks, tasks):
        resolve = module.lm_model_config

        def bf16(m, resolve=resolve):
            return dataclasses.replace(resolve(m), param_dtype="bfloat16",
                                       compute_dtype="bfloat16")

        monkeypatch.setattr(module, "lm_model_config", bf16)


@pytest.fixture
def bf16_reduced(monkeypatch):
    """:func:`patch_bf16` for one test."""
    patch_bf16(monkeypatch)


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


def reference_dtypes(jspec) -> dict:
    """The reference experiment's parameter dtypes, as built."""
    return dtypes(jflatten(japi.build(jspec).engine.params))


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


def assert_bases_as_the_reference(jparams, tparams):
    """The bases' orthonormality is the reference's (their bf16-rounded
    start sets it): nothing in the round rounds them again."""
    for jf, tf in factors_of(jparams, tparams):
        got, want = fac.check_invariants(tf), jfac.check_invariants(jf)
        for key in ("u_ortho_defect", "v_ortho_defect"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-4, key


def chip_smoke():
    """``chip_smoke.py`` loaded as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_train_calls", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def round_calls_of(smoke, tspec):
    """A reduced round's recorded kernel calls (the wrappers' plain versions
    on the CPU) and ``smoke.round_calls`` of its starting parameters."""
    exp = api.build(tspec, device="cpu")
    params, cfg = exp.params, exp.engine.cfg
    calls = {}
    with smoke.kernel_calls(calls):
        exp.run(1)
    moe = tasks.lm_model_config(tspec.model).moe
    M = tspec.data.batch * tspec.data.seq
    return calls, smoke.round_calls(params, cfg, M, "bfloat16", moe)
