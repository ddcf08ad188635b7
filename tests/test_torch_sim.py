"""The port's system simulator (``repro_torch.fed.sim``) against the JAX
package's ``repro.fed.sim``, on shared inputs.

The toy is the planted low-rank least squares of ``tests/test_sim.py``
(C = 4 clients, DIM 16 → DOUT 8, r_max capped at 4): the initial factor is
built by the JAX package and carried across as numpy, the batches come from
each package's own ``FederatedBatcher`` (bit-identical copies), and the JAX
side runs its engines as they are (jitted).

Held exactly across packages: fleets and dropout draws (both draw with
numpy), the event queue's order, every ``Timeline`` key (virtual times are
Python floats from the same FLOP counts and measured bytes), per-round
staleness, ranks and edge bytes. Held by tolerance: ``loss_before`` 1e-5
relative, every factor's ``U S Vᵀ`` 1e-4 relative to its largest entry.
Held within the port, bit for bit: the sync sim engine ≡ the plain engine,
async with a uniform fleet and ``buffer_size = C`` ≡ the sync engine, the
same seed twice ≡ the same run, and the zero inactive columns of every
factor after every flush (exact ``0.0``, where the JAX package's test
allows 1e-6).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.fed.sim as jsim
from repro.core import FedConfig as JFedConfig
from repro.core import init_factor as jinit_factor
from repro.core import lr_matmul as jlr_matmul
from repro.core.factorization import materialize as jmaterialize
from repro.fed import Participation as JParticipation
from repro.fed.engine import RoundResult as JRoundResult
from repro_torch.core import factorization as fac
from repro_torch.core.round import FedConfig
from repro_torch.data import FederatedBatcher, partition_iid
from repro_torch.fed import Participation
from repro_torch.fed import sim
from repro_torch.fed.engine import FederatedEngine, RoundResult
from repro_torch.utils.tree import tree_leaves

C, DIM, DOUT = 4, 16, 8
LOSS_RTOL = 1e-5
USVT_RTOL = 1e-4


# ---------------------------------------------------------------------------
# the toy, in both packages
# ---------------------------------------------------------------------------


def _jloss(f, batch):
    pred = jlr_matmul(batch["x"], f)
    return jnp.mean(jnp.square(pred - batch["y"]))


def _tloss(f, batch):
    pred = fac.lr_matmul(batch["x"], f, kernels="auto")
    return torch.mean(torch.square(pred - batch["y"]))


def _jdense_loss(p, batch):
    return jnp.mean(jnp.square(batch["x"] @ p["w"] - batch["y"]))


def _tdense_loss(p, batch):
    return torch.mean(torch.square(batch["x"] @ p["w"] - batch["y"]))


def _data(seed):
    rng = np.random.default_rng(seed)
    w_star = (rng.normal(size=(DIM, 3)) @ rng.normal(size=(3, DOUT))).astype(
        np.float32) / np.sqrt(DIM)
    x = rng.normal(size=(1024, DIM)).astype(np.float32)
    return {"x": x, "y": x @ w_star}


def _cfg(pkg_cfg, **kw):
    return pkg_cfg(num_clients=C, s_star=3, lr=0.05, correction="simplified", tau=0.05,
                   eval_after=False, **kw)


def _jmake(seed=0):
    """(factor, cfg, batcher) of the JAX package, as tests/test_sim.py's _make."""
    data = _data(seed)
    parts = jdata.partition_iid(1024, C, seed=seed)
    batcher = jdata.FederatedBatcher(data, parts, batch_size=32, seed=seed)
    f = jinit_factor(jax.random.PRNGKey(seed), DIM, DOUT, r_max=6, init_rank=6)
    return f, _cfg(JFedConfig), batcher


def _tmake(seed=0, device="cpu"):
    """The same toy in the port: the JAX package's factor through numpy."""
    jf = jinit_factor(jax.random.PRNGKey(seed), DIM, DOUT, r_max=6, init_rank=6)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    f = fac.LowRankFactor(U=t(jf.U), S=t(jf.S), V=t(jf.V), rank=t(jf.rank))
    data = _data(seed)
    batcher = FederatedBatcher(data, partition_iid(1024, C, seed=seed), batch_size=32,
                               seed=seed)
    return f, _cfg(FedConfig), batcher


def _dense_w():
    return 0.1 * np.eye(DIM, DOUT, dtype=np.float32)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _assert_usvt_close(jf, tf, rtol=USVT_RTOL):
    np.testing.assert_array_equal(tf.rank.numpy(), np.asarray(jf.rank))
    want = np.asarray(jmaterialize(jf))
    got = fac.materialize(tf).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"U S V^T differs by {err:.3g} relative (> {rtol})"


def _assert_zero_inactive(f):
    """Columns of U and V past the rank, and S outside its active block,
    are exactly 0.0."""
    r = int(f.rank)
    assert torch.count_nonzero(f.U[..., r:]) == 0
    assert torch.count_nonzero(f.V[..., r:]) == 0
    assert torch.count_nonzero(f.S[..., r:, :]) == 0
    assert torch.count_nonzero(f.S[..., :, r:]) == 0


def _assert_history_close(jh, th):
    assert len(jh) == len(th)
    for j, t in zip(jh, th):
        assert (t.round_idx, t.cohort_size, t.staleness_mean) == (
            j.round_idx, j.cohort_size, j.staleness_mean)
        assert (t.virtual_seconds, t.t_virtual) == (j.virtual_seconds, j.t_virtual)
        assert (t.wire_bytes_down_per_client, t.wire_bytes_up_per_client) == (
            j.wire_bytes_down_per_client, j.wire_bytes_up_per_client)
        np.testing.assert_array_equal(t.cohort, j.cohort)
        assert abs(t.loss_before - j.loss_before) <= LOSS_RTOL * abs(j.loss_before)
        assert {k: np.asarray(v).tolist() for k, v in t.ranks.items()} == {
            k: np.asarray(v).tolist() for k, v in j.ranks.items()}


def _check_each_flush(eng, check):
    """Run ``check(eng)`` after every flush of an async engine."""
    flush = eng._flush

    def checked():
        res = flush()
        check(eng)
        return res

    eng._flush = checked


# ---------------------------------------------------------------------------
# profiles, fleets, events
# ---------------------------------------------------------------------------

FLEET_SPECS = ["uniform", "straggler", "straggler:0.5", "straggler:0.25,10", "lognormal",
               "lognormal:0.6", "dropout:0.3", "dropout:0.15,straggler:0.5,4",
               "dropout:0.2,lognormal:0.3"]


@pytest.mark.parametrize("spec", FLEET_SPECS)
def test_fleet_from_spec_matches_reference(spec):
    for n, seed in ((4, 0), (7, 11)):
        j, t = jsim.Fleet.from_spec(spec, n, seed=seed), sim.Fleet.from_spec(spec, n, seed=seed)
        assert [dataclasses.asdict(p) for p in t.profiles] == [
            dataclasses.asdict(p) for p in j.profiles]
        assert (len(t), t.seed, t.is_uniform()) == (len(j), j.seed, j.is_uniform())
        draws = [(c, d) for c in range(n) for d in range(6)]
        assert [t.drop_draw(c, d) for c, d in draws] == [j.drop_draw(c, d) for c, d in draws]


@pytest.mark.parametrize("spec", ["warp_drive", "uniform:3", "straggler:2", "straggler:0.5,0.5"])
def test_fleet_from_spec_refusals_match_reference(spec):
    with pytest.raises(ValueError) as je:
        jsim.Fleet.from_spec(spec, 4)
    with pytest.raises(ValueError) as te:
        sim.Fleet.from_spec(spec, 4)
    assert str(te.value) == str(je.value)


def test_profile_pricing_and_flops_match_reference():
    p = dict(flops_per_sec=1e9, up_bytes_per_sec=1e6, down_bytes_per_sec=2e6, latency_sec=0.1)
    jp, tp = jsim.SystemProfile(**p), sim.SystemProfile(**p)
    for prof_j, prof_t in ((jp, tp), (jp.slowed(10.0), tp.slowed(10.0))):
        assert dataclasses.asdict(prof_t) == dataclasses.asdict(prof_j)
        assert prof_t.round_seconds(2e9, 2e6, 1e6) == prof_j.round_seconds(2e9, 2e6, 1e6)
    jf, _, _ = _jmake()
    tf, cfg, batcher = _tmake()
    jcfg = _cfg(JFedConfig)
    jparams = {"f": jf, "w": jnp.asarray(_dense_w()), "b": jnp.zeros(DOUT)}
    tparams = {"f": tf, "w": torch.from_numpy(_dense_w()), "b": torch.zeros(DOUT)}
    one = {k: v[0] for k, v in batcher.next_round([0]).items()}
    assert sim.client_round_flops(tparams, cfg, one) == jsim.client_round_flops(
        jparams, jcfg, one)
    tokens = {"tok": np.zeros((4, 16), np.int32)}
    from repro.fed.sim.profiles import batch_tokens as jbatch_tokens
    from repro_torch.fed.sim.profiles import batch_tokens

    for b in (tokens, one, {"tok": torch.zeros(4, 16, dtype=torch.int32)}):
        want = jbatch_tokens({k: np.asarray(v) for k, v in b.items()})
        assert batch_tokens(b) == want
    assert batch_tokens(tokens) == 64 and batch_tokens(one) == 32


def test_event_queue_order_matches_reference():
    rng = np.random.default_rng(3)
    jq, tq = jsim.EventQueue(), sim.EventQueue()
    for i in range(40):
        t, c = float(rng.integers(0, 5)), int(rng.integers(0, 4))
        kind = ["ClientFinished", "ClientDropped", "ClientAvailable"][i % 3]
        kw = {} if kind == "ClientAvailable" else {"dispatch_idx": i}
        jq.push(getattr(jsim, kind)(time=t, client_id=c, **kw))
        tq.push(getattr(sim, kind)(time=t, client_id=c, **kw))
    assert tq.peek_time() == jq.peek_time() and len(tq) == len(jq)
    got = [dataclasses.astuple(e) + (type(e).__name__,) for e in tq.pop_until(2.0)]
    want = [dataclasses.astuple(e) + (type(e).__name__,) for e in jq.pop_until(2.0)]
    assert got == want
    got = [dataclasses.astuple(tq.pop()) for _ in range(len(tq))]
    assert got == [dataclasses.astuple(jq.pop()) for _ in range(len(jq))]
    # the reference test's tie-break, on the port
    for c in (3, 1, 2, 0):
        tq.push(sim.ClientFinished(time=1.0, client_id=c))
    tq.push(sim.ClientFinished(time=0.5, client_id=9))
    assert [(e.time, e.client_id) for e in (tq.pop() for _ in range(5))] == [
        (0.5, 9), (1.0, 0), (1.0, 1), (1.0, 2), (1.0, 3)]
    with pytest.raises(IndexError):
        tq.pop()


def test_round_result_has_the_reference_fields():
    assert [f.name for f in dataclasses.fields(RoundResult)] == [
        f.name for f in dataclasses.fields(JRoundResult)]


# ---------------------------------------------------------------------------
# sync engine on the virtual clock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("participation", [None, "uniform:2", "dropout:0.5"])
def test_sync_sim_matches_reference_and_the_plain_engine(participation):
    """The straggler barrier over the round's cohort, under every
    participation policy kind (dropout pads the cohort with zero-weight
    rows; the barrier is over the active clients)."""
    def part(cls):
        if participation is None:
            return None
        mode, arg = participation.split(":")
        kw = {"cohort_size": int(arg)} if mode == "uniform" else {"dropout_prob": float(arg)}
        return cls(mode=mode, seed=5, **kw)

    fleet = "straggler:0.25,10"
    jf, jcfg, jb = _jmake(seed=1)
    jeng = jsim.SyncSimEngine(_jloss, jf, jcfg, method="fedlrt", donate=False,
                              fleet=jsim.Fleet.from_spec(fleet, C),
                              participation=part(JParticipation))
    jeng.train(jb, 3, log_every=0)
    tf, cfg, tb = _tmake(seed=1)
    teng = sim.SyncSimEngine(_tloss, tf, cfg, method="fedlrt",
                             fleet=sim.Fleet.from_spec(fleet, C), participation=part(Participation))
    teng.train(tb, 3, log_every=0)
    _assert_history_close(jeng.history, teng.history)
    assert teng.timeline.keys() == jeng.timeline.keys()
    assert all(r.virtual_seconds > 0 for r in teng.history)
    _assert_usvt_close(jeng.params, teng.params)
    # numerically the plain engine, bit for bit
    pf, pcfg, pb = _tmake(seed=1)
    plain = FederatedEngine(_tloss, pf, pcfg, method="fedlrt", participation=part(Participation))
    plain.train(pb, 3, log_every=0)
    assert _bits_equal(plain.params, teng.params)
    assert [r.loss_before for r in plain.history] == [r.loss_before for r in teng.history]


# ---------------------------------------------------------------------------
# async engine
# ---------------------------------------------------------------------------


def _async_pair(fleet_spec, flushes, *, seed=3, buffer_size=2, fleet_seed=0, method="fedlrt",
                check=None, correction="simplified", client_weights=None):
    if method == "fedlrt":
        jf, jcfg, jb = _jmake(seed)
        tf, cfg, tb = _tmake(seed)
        jcfg = dataclasses.replace(jcfg, correction=correction)
        cfg = dataclasses.replace(cfg, correction=correction)
        jl, tl = _jloss, _tloss
    else:
        _, jcfg, jb = _jmake(seed)
        _, cfg, tb = _tmake(seed)
        jcfg = dataclasses.replace(jcfg, correction="none")
        cfg = dataclasses.replace(cfg, correction="none")
        jf, tf = {"w": jnp.asarray(_dense_w())}, {"w": torch.from_numpy(_dense_w())}
        jl, tl = _jdense_loss, _tdense_loss
    jeng = jsim.AsyncFederatedEngine(
        jl, jf, jcfg, method=method, buffer_size=buffer_size, client_weights=client_weights,
        fleet=jsim.Fleet.from_spec(fleet_spec, C, seed=fleet_seed))
    jeng.train(jb, flushes, log_every=0)
    teng = sim.AsyncFederatedEngine(
        tl, tf, cfg, method=method, buffer_size=buffer_size, client_weights=client_weights,
        fleet=sim.Fleet.from_spec(fleet_spec, C, seed=fleet_seed))
    if check is not None:
        _check_each_flush(teng, check)
    teng.train(tb, flushes, log_every=0)
    return jeng, teng


def test_async_straggler_matches_reference():
    """FedBuff with a 10×-slow straggler, buffer 2, 8 flushes: the same
    timeline and staleness as the reference, the factor within tolerance,
    the zero inactive columns exact after every flush."""
    flushes = []
    jeng, teng = _async_pair(
        "straggler:0.25,10", 8,
        check=lambda eng: (_assert_zero_inactive(eng.params), flushes.append(1)))
    assert len(flushes) == 8
    assert teng.timeline.keys() == jeng.timeline.keys()
    assert any(r.staleness_mean > 0 for r in teng.history)
    _assert_history_close(jeng.history, teng.history)
    _assert_usvt_close(jeng.params, teng.params)


def test_async_fully_stale_flush_matches_reference():
    """A fleet where whole buffers arrive stale (the FedBuff branch with no
    finalize): the straggler half's buffer flushes after the fast half's."""
    jeng, teng = _async_pair("straggler:0.5,3", 6, check=lambda e: _assert_zero_inactive(e.params))
    assert teng.timeline.keys() == jeng.timeline.keys()
    # no finalize ran in a fully-stale flush: no effective-rank bytes
    stale_only = [r for r in teng.history if r.comm_bytes_per_client_effective == 0.0]
    assert stale_only and all(r.staleness_mean >= 1 for r in stale_only), "no fully-stale flush"
    _assert_history_close(jeng.history, teng.history)
    _assert_usvt_close(jeng.params, teng.params)


@pytest.mark.parametrize("correction,weights", [("full", None), ("none", [1.0, 2.0, 3.0, 4.0]),
                                                ("simplified", [4.0, 1.0, 1.0, 2.0])])
def test_async_corrections_and_weights_match_reference(correction, weights):
    """The other variance corrections, and client weights ∝ |X_c| (which
    the staleness discount multiplies)."""
    jeng, teng = _async_pair("lognormal:0.6", 6, correction=correction, client_weights=weights,
                             check=lambda e: _assert_zero_inactive(e.params))
    assert teng.timeline.keys() == jeng.timeline.keys()
    assert any(r.staleness_mean > 0 for r in teng.history)
    _assert_history_close(jeng.history, teng.history)
    _assert_usvt_close(jeng.params, teng.params)


@pytest.mark.parametrize("method", ["fedavg", "fedlin"])
def test_async_fedavg_matches_reference(method):
    """The dense programs re-anchor the plain parameter delta (``params0``)."""
    jeng, teng = _async_pair("straggler:0.25,10", 6, method=method)
    assert teng.timeline.keys() == jeng.timeline.keys()
    assert any(r.staleness_mean > 0 for r in teng.history)
    _assert_history_close(jeng.history, teng.history)
    want = np.asarray(jeng.params["w"])
    err = np.abs(teng.params["w"].numpy() - want).max() / np.abs(want).max()
    assert err <= USVT_RTOL


def test_async_dropout_fleet_same_seed_same_run():
    """The same seed twice: identical timelines (drops included) and the
    same bits; the timeline is also the reference's."""
    spec = "dropout:0.15,straggler:0.5,4"

    def run():
        f, cfg, b = _tmake(seed=2)
        eng = sim.AsyncFederatedEngine(_tloss, f, cfg, method="fedlrt", buffer_size=2,
                                       fleet=sim.Fleet.from_spec(spec, C, seed=11))
        eng.train(b, 6, log_every=0)
        return eng

    a, b = run(), run()
    assert a.timeline.keys() == b.timeline.keys()
    assert len(a.timeline.of_kind("aggregate")) == 6 and a.timeline.of_kind("drop")
    assert _bits_equal(a.params, b.params)
    assert [r.t_virtual for r in a.history] == [r.t_virtual for r in b.history]
    jf, jcfg, jb = _jmake(seed=2)
    j = jsim.AsyncFederatedEngine(_jloss, jf, jcfg, method="fedlrt", buffer_size=2,
                                  fleet=jsim.Fleet.from_spec(spec, C, seed=11))
    j.train(jb, 6, log_every=0)
    assert a.timeline.keys() == j.timeline.keys()


@pytest.mark.parametrize("codec", ["identity", "int8_affine"])
def test_async_uniform_full_buffer_is_the_sync_engine(codec):
    """Identical profiles and buffer C: every flush is a zero-staleness full
    cohort through FederatedEngine.run_round, the sync engine bit for bit."""
    f, cfg, b = _tmake()
    sync = FederatedEngine(_tloss, f, cfg, method="fedlrt", wire_codec=codec)
    sync.train(b, 4, log_every=0)
    f2, cfg2, b2 = _tmake()
    anc = sim.AsyncFederatedEngine(_tloss, f2, cfg2, method="fedlrt", wire_codec=codec,
                                   fleet=sim.Fleet.uniform(C), buffer_size=C)
    anc.train(b2, 4, log_every=0)
    assert _bits_equal(sync.params, anc.params)
    assert [r.loss_before for r in anc.history] == [r.loss_before for r in sync.history]
    assert [r.wire_bytes_up_per_client for r in anc.history] == [
        r.wire_bytes_up_per_client for r in sync.history]
    assert all(r.staleness_mean == 0.0 for r in anc.history)
    assert anc.history[-1].t_virtual > 0.0


class _PinnedSnapshots(sim.AsyncFederatedEngine):
    """Records a copy of each version's params when it is first held and
    checks, when its last in-flight client releases it, that no tensor of
    the snapshot was written in between."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.copies, self.checked = {}, 0

    def _hold(self, version):
        if version not in self._snapshots:
            self.copies[version] = [t.clone() for t in tree_leaves(self.params)]
        super()._hold(version)

    def _release(self, version):
        params = self._snapshots[version][0]
        last = self._snapshots[version][1] == 1
        super()._release(version)
        if last:
            leaves = tree_leaves(params)
            assert all(torch.equal(a, b) for a, b in zip(leaves, self.copies.pop(version)))
            self.checked += 1


def test_version_snapshots_are_never_written():
    """Snapshots are references to the params, not copies: every tensor of
    a snapshot is unchanged after the flushes that ran while it was held,
    and earlier params objects are unchanged after later flushes."""
    f, cfg, b = _tmake(seed=3)
    eng = _PinnedSnapshots(_tloss, f, cfg, method="fedlrt", buffer_size=2,
                           fleet=sim.Fleet.from_spec("straggler:0.25,10", C))
    kept = []
    _check_each_flush(eng, lambda e: kept.append(
        (tree_leaves(e.params), [t.clone() for t in tree_leaves(e.params)])))
    eng.train(b, 8, log_every=0)
    assert eng.checked > 0 and any(r.staleness_mean > 0 for r in eng.history)
    # the versions still in flight when the run stopped
    assert sorted(eng.copies) == sorted(eng._snapshots)
    for v, (params, _) in eng._snapshots.items():
        assert all(torch.equal(a, c) for a, c in zip(tree_leaves(params), eng.copies[v]))
    for leaves, copies in kept:
        assert all(torch.equal(a, c) for a, c in zip(leaves, copies))


def test_async_checkpoint_sidecar_carries_the_clock(tmp_path):
    f, cfg, b = _tmake(seed=3)
    eng = sim.AsyncFederatedEngine(_tloss, f, cfg, method="fedlrt", buffer_size=2,
                                   fleet=sim.Fleet.from_spec("straggler:0.25,10", C),
                                   checkpoint_dir=str(tmp_path), checkpoint_every=1)
    eng.train(b, 3, log_every=0)
    state = np.load(tmp_path / "round_000003.npz.state.npy", allow_pickle=True).item()
    rows = state["history"]
    json.dumps(rows)
    assert [r["t_virtual"] for r in rows] == [r.t_virtual for r in eng.history]
    assert [r["staleness_mean"] for r in rows] == [r.staleness_mean for r in eng.history]
    assert set(rows[0]) == {f.name for f in dataclasses.fields(JRoundResult)}


# ---------------------------------------------------------------------------
# hierarchical engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 2.0, 2.0]])
def test_hier_int8_edge_wire_matches_reference(weights):
    """2 edges × 2 edge rounds, identity client wire, int8 edge wire (with
    and without client weights, which weight the edges in the cloud): the
    same edge bytes, timeline and ranks; the factor within tolerance; the
    invariant exact after the cloud aggregate."""
    kw = dict(method="fedlrt", num_edges=2, edge_rounds=2, wire_codec="identity",
              edge_wire_codec="int8_affine", client_weights=weights)
    jf, jcfg, jb = _jmake()
    jeng = jsim.HierarchicalEngine(_jloss, jf, jcfg, fleet=jsim.Fleet.uniform(C), **kw)
    jeng.train(jb, 2, log_every=0)
    tf, cfg, tb = _tmake()
    teng = sim.HierarchicalEngine(_tloss, tf, cfg, fleet=sim.Fleet.uniform(C), **kw)
    teng.train(tb, 2, log_every=0)
    assert [len(e.history) for e in teng.edge_engines] == [4, 4]
    assert [c.tolist() for c in teng.edge_cohorts] == [c.tolist() for c in jeng.edge_cohorts]
    assert teng.history[0].wire_codec == "int8_affine"
    assert teng.comm_total_bytes() == jeng.comm_total_bytes()
    assert teng.timeline.keys() == jeng.timeline.keys()
    _assert_history_close(jeng.history, teng.history)
    _assert_usvt_close(jeng.params, teng.params)
    _assert_zero_inactive(teng.params)
    assert teng.params.rank <= teng.params.r_max
    # the int8 hop ships about a quarter of the identity bytes of one tree
    ident = sim.HierarchicalEngine(_tloss, teng.params, cfg, fleet=sim.Fleet.uniform(C), **{
        **kw, "edge_wire_codec": "identity"})
    _, id_bytes = ident._edge_hop(teng.params, "edge_down")
    _, i8_bytes = teng._edge_hop(teng.params, "edge_down")
    assert i8_bytes < id_bytes


def test_hier_single_edge_refactorization_preserves_weights():
    f, cfg, b = _tmake()
    hier = sim.HierarchicalEngine(_tloss, f, cfg, method="fedlrt", num_edges=1, edge_rounds=1,
                                  fleet=sim.Fleet.uniform(C))
    hier.train(b, 1, log_every=0)
    f2, cfg2, b2 = _tmake()
    sync = FederatedEngine(_tloss, f2, cfg2, method="fedlrt")
    sync.train(b2, 1, log_every=0)
    np.testing.assert_allclose(fac.materialize(hier.params).numpy(),
                               fac.materialize(sync.params).numpy(), atol=1e-5)
    assert hier.history[0].loss_before == sync.history[0].loss_before
    assert hier.comm_total_bytes() > sync.comm_total_bytes()  # + the backhaul
    assert hier.history[-1].t_virtual > 0.0
    # a 1-edge cloud aggregate of any factor keeps U S Vᵀ, σ and the rank
    again = hier._cloud_aggregate([sync.params])
    W, W2 = fac.materialize(sync.params), fac.materialize(again)
    assert float((W2 - W).abs().max() / W.abs().max()) <= USVT_RTOL
    assert torch.equal(again.rank, sync.params.rank)
    _assert_zero_inactive(again)


# ---------------------------------------------------------------------------
# the factory and its refusals
# ---------------------------------------------------------------------------


def test_make_sim_engine_builds_each_kind_with_the_reference_defaults():
    f, cfg, _ = _tmake()
    eng = sim.make_sim_engine("async", _tloss, f, cfg)
    assert isinstance(eng, sim.AsyncFederatedEngine)
    assert (eng.buffer_size, eng.staleness_power, eng.fleet.is_uniform()) == (C, 0.5, True)
    eng = sim.make_sim_engine("hier", _tloss, f, cfg, sim_profile="straggler")
    assert isinstance(eng, sim.HierarchicalEngine)
    assert (eng.num_edges, eng.edge_rounds, eng.edge_wire.name) == (2, 1, "identity")
    assert not eng.fleet.is_uniform()
    eng = sim.make_sim_engine("sync", _tloss, f, cfg, sim_profile="lognormal", seed=4)
    want = jsim.Fleet.from_spec("lognormal", C, seed=4)
    assert isinstance(eng, sim.SyncSimEngine)
    assert [p.flops_per_sec for p in eng.fleet.profiles] == [
        p.flops_per_sec for p in want.profiles]


REFUSALS = [
    ("async", dict(participation="uniform:2")),
    ("hier", dict(participation="uniform:2")),
    ("hier", dict(checkpoint_dir="ck", checkpoint_every=1)),
    ("fancy", {}),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_refusals_match_reference(case):
    kind, kw = REFUSALS[case]

    def args(part_cls):
        out = dict(kw)
        if "participation" in out:
            mode, k = out["participation"].split(":")
            out["participation"] = part_cls(mode=mode, cohort_size=int(k))
        return out

    jf, jcfg, _ = _jmake()
    tf, cfg, _ = _tmake()
    with pytest.raises(ValueError) as je:
        jsim.make_sim_engine(kind, _jloss, jf, jcfg, **args(JParticipation))
    with pytest.raises(ValueError) as te:
        sim.make_sim_engine(kind, _tloss, tf, cfg, **args(Participation))
    assert str(te.value) == str(je.value)


def test_fleet_size_must_match_the_population():
    f, cfg, _ = _tmake()
    for cls in (sim.SyncSimEngine, sim.AsyncFederatedEngine):
        with pytest.raises(ValueError, match="profiles for 4 clients"):
            cls(_tloss, f, cfg, fleet=sim.Fleet.uniform(3))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_async_uniform_full_buffer_is_the_sync_engine_on_card():
    """Runs on an H100 (``pytest -m cuda``): the async engine with a uniform
    fleet and buffer C equals the sync engine bit for bit on the card, and
    both run the factor chain on the xus / avt / atb kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    from repro_torch.kernels.coeff_grad import atb
    from repro_torch.kernels.lowrank_matmul import avt, xus

    def launches():
        return [fn.launches for fn in (xus, avt, atb)]

    f, cfg, b = _tmake(device="cuda")
    before = launches()
    sync = FederatedEngine(_tloss, f, cfg, method="fedlrt")
    sync.train(b, 3, log_every=0)
    mid = launches()
    f2, cfg2, b2 = _tmake(device="cuda")
    anc = sim.AsyncFederatedEngine(_tloss, f2, cfg2, method="fedlrt",
                                   fleet=sim.Fleet.uniform(C), buffer_size=C)
    anc.train(b2, 3, log_every=0)
    after = launches()
    torch.cuda.synchronize()
    assert anc.params.U.is_cuda and _bits_equal(sync.params, anc.params)
    sync_n = [m - a for m, a in zip(mid, before)]
    assert all(n > 0 for n in sync_n)
    assert [a - m for a, m in zip(after, mid)] == sync_n
