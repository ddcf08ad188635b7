"""The port's wire layer against the JAX package's, and its pins within the
port.

Across packages, on the same numpy payloads (plain, and batched: a stacked
client axis in the JAX package, a ``Cohort`` of per-client trees in the
port): every codec measures the same ``nbytes``; identity, downcast and
topk_rank decode to the same bits; int8 codes are equal except ±1 at a
rounding tie (the two frameworks divide in another order) and dequantize
within ``scale/2``. An int8 FeDLRT round agrees on ranks and on losses
within 1e-3 relative, and on the measured bytes exactly.

Within the port: identity ≡ no wire and topk_rank ≡ no wire bit for bit for
every round program; the measured identity bytes equal
``cost_model.wire_round_bytes`` exactly; the engine's measured and analytic
totals; int8 cuts the uplink at least 3×. The codec protocol is pinned here
because the JAX package's lint rule for it (RPL006) does not reach the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.factorization as jfac
from repro.checkpoint.io import _flatten
from repro.core import FedConfig as JFedConfig
from repro.core import cost_model as jcost
from repro.core.fedlrt import fedlrt_round as jfedlrt_round
from repro.fed import wire as jwire
from repro_torch import api
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import cost_model
from repro_torch.core import factorization as fac
from repro_torch.core.baselines import fedavg_round, fedlin_round, fedlrt_naive_round
from repro_torch.core.fedlrt import fedlrt_round
from repro_torch.core.round import FedConfig
from repro_torch.fed import wire
from repro_torch.fed.engine import FederatedEngine, RoundResult
from repro_torch.utils.tree import Cohort, tree_leaves

C = 3


def to_torch(jtree):
    return params_from_numpy({k: np.asarray(v) for k, v in _flatten(jtree).items()}, "cpu")


def _demo(rng, lead=()):
    return {
        "w": (3.0 * rng.standard_normal(lead + (96, 48))).astype(np.float32),
        "b": rng.standard_normal(lead + (7,)).astype(np.float32),
        "n": np.full(lead, 4, np.int32),
    }


def _payloads(batched: bool):
    """The same values as (JAX payload tree, port payload tree)."""
    rng = np.random.default_rng(0)
    if not batched:
        tree = _demo(rng)
        return ({k: jnp.asarray(v) for k, v in tree.items()},
                {k: torch.from_numpy(v) for k, v in tree.items()})
    tree = _demo(rng, (C,))
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            Cohort({k: torch.from_numpy(np.asarray(v[c])) for k, v in tree.items()}
                   for c in range(C)))


def _stack(port_tree, batched):
    """A port payload as numpy leaves in the JAX package's layout."""
    if not batched:
        return {k: v.numpy() for k, v in port_tree.items()}
    return {k: np.stack([t[k].numpy() for t in port_tree]) for k in port_tree[0]}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind not in "iu" else a


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("spec", wire.CODEC_SPECS)
def test_codec_matches_jax(spec, batched):
    jt, tt = _payloads(batched)
    jc, tc = jwire.make_codec(spec), wire.make_codec(spec)
    assert tc.name == jc.name
    jmsg = jc.encode(jwire.Payload(jt, name="client_out", batched=batched))
    tmsg = tc.encode(wire.Payload(tt, name="client_out", batched=batched))
    assert float(tc.nbytes(tmsg)) == float(jc.nbytes(jmsg))
    jdec = jc.decode(jmsg).tensors
    tdec = _stack(tc.decode(tmsg).tensors, batched)
    for k in jdec:
        assert tdec[k].dtype == np.asarray(jdec[k]).dtype
    if spec == "int8_affine":
        codes_j = np.asarray(jmsg.buffers["w"]).astype(np.int32)
        codes_t = _stack(tmsg.buffers, batched)["w"].astype(np.int32)
        diff = np.abs(codes_j - codes_t)
        assert diff.max() <= 1 and np.mean(diff) < 1e-2  # ±1 at rounding ties only
        raw = np.asarray(jt["w"])
        axes = tuple(range(1 if batched else 0, raw.ndim))
        scale = (raw.max(axis=axes, keepdims=True) - raw.min(axis=axes, keepdims=True)) / 255
        assert np.all(np.abs(tdec["w"] - raw) <= scale / 2 * (1 + 1e-5) + 1e-7)
        for k in ("b", "n"):  # too small / integer: verbatim
            np.testing.assert_array_equal(tdec[k], np.asarray(jdec[k]))
    else:
        for k in jdec:
            np.testing.assert_array_equal(_bits(tdec[k]), _bits(jdec[k]))


def _factor_payload():
    """Full-rank and truncated factors, a stacked one with per-slice ranks,
    and an augmented one, as (JAX tree, port tree)."""
    full = jfac.init_factor(jax.random.PRNGKey(4), 40, 30, r_max=8, init_rank=8)
    m = (jnp.arange(8) < 3).astype(jnp.float32)
    low = dataclasses.replace(full, U=full.U * m, V=full.V * m,
                              S=full.S * m[:, None] * m[None, :], rank=jnp.float32(3.0))
    stacked = jfac.init_factor(jax.random.PRNGKey(5), 24, 16, r_max=6, init_rank=4,
                               batch_shape=(2,))
    jtree = {"full": full, "low": low, "stacked": stacked, "dense": jnp.ones((9, 9))}
    ttree = to_torch(jtree)
    jaug = jfac.AugmentedFactor(
        U=jnp.concatenate([low.U, jnp.zeros((40, 8))], 1),
        S=jnp.zeros((16, 16)).at[:8, :8].set(low.S),
        V=jnp.concatenate([low.V, jnp.zeros((30, 8))], 1),
        rank=jnp.float32(3.0),
    )
    taug = fac.AugmentedFactor(**{k: torch.from_numpy(np.array(getattr(jaug, k)))
                                  for k in ("U", "S", "V", "rank")})
    jtree["aug"], ttree["aug"] = jaug, taug
    return jtree, ttree


def test_topk_rank_on_factors_matches_jax():
    jt, tt = _factor_payload()
    jc, tc = jwire.TopKRankCodec(), wire.TopKRankCodec()
    jmsg, tmsg = jc.encode(jwire.Payload(jt)), tc.encode(wire.Payload(tt))
    assert isinstance(tmsg.nbytes, np.float32)
    assert float(tmsg.nbytes) == float(jmsg.nbytes)
    assert float(tmsg.nbytes) < wire.payload_nbytes(tt)
    dec = tc.decode(tmsg).tensors
    for a, b in zip(tree_leaves(dec), tree_leaves(tt)):
        assert torch.equal(a, b)  # lossless by the zero-inactive-columns invariant
    # no factor in the payload: the count stays an exact integer
    assert tc.encode(wire.Payload({"x": torch.ones(100)})).nbytes == 400


def test_codec_protocol():
    for spec in wire.CODEC_SPECS:
        codec = wire.make_codec(spec)
        assert isinstance(codec, wire.WireCodec)
        assert wire.make_codec(codec) is codec
    assert wire.make_codec("downcast:float16").wire_dtype == torch.float16
    for bad in ("gzip", "identity:3", "downcast:int8"):
        with pytest.raises(ValueError):
            wire.make_codec(bad)
    w = wire.Wire("int8_affine")
    assert w.name == "int8_affine" and w.roundtrip(None) == (None, 0)
    with pytest.raises(TypeError, match="Cohort"):
        w.roundtrip({"x": torch.ones(100)}, batched=True)


# ---------------------------------------------------------------------------
# the round data plane, within the port
# ---------------------------------------------------------------------------


def _factor_setup(seed=0):
    jf = jfac.init_factor(jax.random.PRNGKey(seed), 12, 12, r_max=4, init_rank=4)
    jparams = {"w1": jf, "b": jnp.zeros((12,))}
    rng = np.random.default_rng(1)
    batch = {k: rng.standard_normal((4, 16, 12)).astype(np.float32) for k in ("x", "y")}
    return jparams, batch


def _jloss(p, b):
    return jnp.mean((jfac.lr_matmul(b["x"], p["w1"]) + p["b"] - b["y"]) ** 2)


def _tloss(p, b):
    return torch.mean((fac.lr_matmul(b["x"], p["w1"]) + p["b"] - b["y"]) ** 2)


def _cfg(**kw):
    return FedConfig(**{**dict(num_clients=4, s_star=3, lr=0.05, correction="simplified",
                               tau=0.05), **kw})


def _lsq_loss_t(f, b):
    pred = torch.sum(((b["x"] @ f.U) @ f.S) * (b["y"] @ f.V), -1)
    return 0.5 * torch.mean((pred - b["t"]) ** 2)


def _dense_loss_t(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _programs():
    """(name, round fn, loss, params, batch, analytic method, correction)."""
    jparams, batch = _factor_setup()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = [(f"fedlrt-{c}", fedlrt_round, _tloss, to_torch(jparams), tb, "fedlrt", c)
           for c in ("none", "simplified", "full")]
    rng = np.random.default_rng(2)
    dense = {"w": torch.from_numpy(0.1 * rng.standard_normal((12, 12)).astype(np.float32)),
             "b": torch.zeros(12)}
    out += [("fedavg", fedavg_round, _dense_loss_t, dense, tb, "fedavg", "none"),
            ("fedlin", fedlin_round, _dense_loss_t, dense, tb, "fedlin", "none")]
    f = to_torch(jfac.init_factor(jax.random.PRNGKey(3), 12, 12, r_max=4, init_rank=4))
    lsq = {"x": tb["x"], "y": tb["y"], "t": torch.from_numpy(rng.standard_normal((4, 16))
                                                             .astype(np.float32))}
    out.append(("naive", fedlrt_naive_round, _lsq_loss_t, f, lsq, "fedlrt_naive", "none"))
    return out


PROGRAMS = [p[0] for p in _programs()]


def _program(name):
    return next(p for p in _programs() if p[0] == name)


@pytest.mark.parametrize("name", PROGRAMS)
def test_identity_and_topk_wire_bit_identical(name):
    _, fn, loss, params, batch, _, correction = _program(name)
    cfg = _cfg(correction=correction)
    p_off, m_off = fn(loss, params, batch, cfg)
    for codec in ("identity", "topk_rank"):
        p_on, m_on = fn(loss, params, batch, cfg, wire=wire.Wire(codec))
        a, b = tree_leaves(p_off), tree_leaves(p_on)
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), codec
        assert torch.equal(m_off["loss_after"], m_on["loss_after"])
        assert m_on["wire_bytes_down_per_client"] > 0 and m_on["wire_bytes_up_per_client"] > 0


@pytest.mark.parametrize("name", PROGRAMS)
def test_measured_identity_bytes_equal_analytic(name):
    _, fn, loss, params, batch, method, correction = _program(name)
    _, m = fn(loss, params, batch, _cfg(correction=correction), wire=wire.Wire("identity"))
    ana = cost_model.wire_round_bytes(params, method, correction=correction)
    assert isinstance(m["wire_bytes_down_per_client"], int)
    assert m["wire_bytes_down_per_client"] == ana["down"]
    assert m["wire_bytes_up_per_client"] == ana["up"]


def test_wire_round_bytes_match_jax():
    jparams, _ = _factor_setup()
    tparams = to_torch(jparams)
    for c in ("none", "simplified", "full"):
        assert cost_model.wire_round_bytes(tparams, "fedlrt", correction=c) == \
            jcost.wire_round_bytes(jparams, "fedlrt", correction=c)
    W = {"w": jnp.zeros((7, 5)), "b": jnp.zeros(5)}
    for m in ("fedavg", "fedlin"):
        assert cost_model.wire_round_bytes(to_torch(W), m) == jcost.wire_round_bytes(W, m)
    f = jfac.init_factor(jax.random.PRNGKey(0), 20, 10, r_max=5, init_rank=5)
    assert cost_model.wire_round_bytes(to_torch(f), "fedlrt_naive") == \
        jcost.wire_round_bytes(f, "fedlrt_naive")


def test_cost_model_closed_forms_match_jax():
    for method in ("fedavg", "fedlin", "fedlrt", "fedlrt_simplified", "fedlrt_full", "fedlr"):
        assert cost_model.table1(method, n=512, r=32, s_star=4, b=8) == \
            jcost.table1(method, n=512, r=32, s_star=4, b=8)
    with pytest.raises(ValueError):
        cost_model.table1("fedprox", n=4, r=1)
    assert cost_model.amortization_rank(1000) == jcost.amortization_rank(1000)
    jparams, _ = _factor_setup()
    jparams["m"] = jnp.zeros((5, 7))
    tparams = to_torch(jparams)
    for name in ("client_flops_per_local_step", "client_step_flops"):
        assert getattr(cost_model, name)(tparams, 64) == getattr(jcost, name)(jparams, 64)
    assert cost_model.factor_storage_bytes(tparams) == jcost.factor_storage_bytes(jparams)
    for gather in (False, True):
        assert cost_model.lowrank_decode_flops(640, 2560, 160, gather=gather) == \
            jcost.lowrank_decode_flops(640, 2560, 160, gather=gather)
        assert cost_model.dense_decode_flops(640, 2560, gather=gather) == \
            jcost.dense_decode_flops(640, 2560, gather=gather)


def test_int8_round_matches_jax():
    """One FeDLRT round with int8 on the wire in both packages: the same
    ranks and bytes, losses within 1e-3 relative."""
    jparams, batch = _factor_setup()
    kw = dict(num_clients=4, s_star=3, lr=0.05, correction="simplified", tau=0.05)
    jw = jwire.Wire("int8_affine")
    jnew, jm = jax.jit(lambda p, b: jfedlrt_round(_jloss, p, b, JFedConfig(**kw), wire=jw))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = fedlrt_round(_tloss, to_torch(jparams),
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            FedConfig(**kw), wire=wire.Wire("int8_affine"))
    for k in ("loss_before", "loss_after"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-3 * abs(float(jm[k])), k
    for k in ("wire_bytes_down_per_client", "wire_bytes_up_per_client"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_array_equal(tnew["w1"].rank.numpy(), np.asarray(jnew["w1"].rank))
    want = np.asarray(jfac.materialize(jnew["w1"]))
    got = fac.materialize(tnew["w1"]).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _mlp_spec(codec, rounds=3):
    return api.ExperimentSpec(
        rounds=rounds, log_every=0,
        model=api.ModelSpec(kind="mlp", dim=32, hidden=64, classes=5, r_max=8),
        data=api.DataSpec(kind="classification", batch=32, num_points=1024, holdout=128,
                          planted_rank=4),
        fed=api.FedSpec(clients=4, local_steps=3, lr=0.05, tau=0.03),
        wire=api.WireSpec(codec=codec),
    )


def test_engine_measured_vs_analytic_accounting():
    exp = api.build(_mlp_spec("identity"), device="cpu")
    hist = exp.run()
    assert all(r.wire_codec == "identity" for r in hist)
    measured = sum((r.wire_bytes_down_per_client + r.wire_bytes_up_per_client) * r.cohort_size
                   for r in hist)
    assert exp.comm_total_bytes() == pytest.approx(measured) and measured > 0
    assert exp.engine.comm_total_bytes_analytic() == pytest.approx(
        sum(r.comm_bytes_per_client * r.cohort_size for r in hist))
    assert exp.comm_total_bytes() != exp.engine.comm_total_bytes_analytic()


def test_engine_wire_none_falls_back_to_analytic():
    exp = api.build(_mlp_spec("identity", rounds=0), device="cpu")
    eng_off = FederatedEngine(exp.task.loss_fn, exp.task.params, exp.engine.cfg,
                              wire_codec=None)
    hist = eng_off.train(exp.task.batcher, 2, log_every=0)
    assert all(r.wire_codec == "" and r.wire_bytes_up_per_client == 0.0 for r in hist)
    assert eng_off.comm_total_bytes() == pytest.approx(eng_off.comm_total_bytes_analytic())


def test_comm_total_bytes_mixed_history():
    """Metered rounds count their measured bytes, unmetered ones (no wire,
    or restored from a history without wire fields) the analytic figure."""
    exp = api.build(_mlp_spec("identity", rounds=0), device="cpu")
    base = dict(loss_after=None, ranks={}, seconds=0.0)
    exp.engine.history = [
        RoundResult(round_idx=0, loss_before=1.0, comm_bytes_per_client=100.0,
                    cohort_size=2, **base),
        RoundResult(round_idx=1, loss_before=0.9, comm_bytes_per_client=999.0, cohort_size=3,
                    wire_bytes_down_per_client=30.0, wire_bytes_up_per_client=20.0,
                    wire_codec="identity", **base),
        RoundResult(round_idx=2, loss_before=0.8, comm_bytes_per_client=50.0,
                    cohort_size=4, **base),
    ]
    assert exp.comm_total_bytes() == pytest.approx(100.0 * 2 + 50.0 * 3 + 50.0 * 4)
    assert exp.engine.comm_total_bytes_analytic() == pytest.approx(
        100.0 * 2 + 999.0 * 3 + 50.0 * 4)


def test_int8_uplink_compression_headline():
    """At least 3× less measured uplink than identity, and still training."""
    hist_id = api.build(_mlp_spec("identity", 4), device="cpu").run()
    hist_q = api.build(_mlp_spec("int8_affine", 4), device="cpu").run()
    up_id = sum(r.wire_bytes_up_per_client for r in hist_id)
    up_q = sum(r.wire_bytes_up_per_client for r in hist_q)
    assert up_id / up_q >= 3.0
    assert hist_q[-1].loss_after < hist_q[0].loss_before
    assert hist_q[-1].loss_after == pytest.approx(hist_id[-1].loss_after, rel=0.25)
