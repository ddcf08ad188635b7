"""Checkpoints of the port: the JAX package's npz format, written and read
by both packages, and resume.

- The npz member names equal the JAX package's ``_flatten`` for the same
  tree; float32 members are byte-identical to what the JAX package writes
  for the same values; bfloat16 members are the same 2-byte ``V2`` records.
- Port write → port resume replays the uninterrupted run bit for bit.
- JAX write → port resume, and port write → JAX restore, each agree with
  the other package's uninterrupted run within the slice-2 parity
  tolerances (losses 1e-5 / 1e-4 relative, ``U S Vᵀ`` 1e-4 relative to its
  largest entry, equal ranks and bytes). The spec-hash guard passes across
  packages because the two hash the same spec the same.
- A checkpoint of another spec is refused before any state is touched; the
  state sidecar is versioned and JSON-safe; history field drift is
  tolerated; the port serves what its engine wrote.
"""
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.checkpoint as jckpt
import repro.core.factorization as jfac
from repro.checkpoint.io import _flatten as jax_flatten
from repro_torch import api
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint import load_checkpoint, params_from_numpy, save_checkpoint
from repro_torch.core import factorization as fac
from repro_torch.fed.engine import RoundResult, history_from_state
from repro_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401

LOSS_BEFORE_RTOL = 1e-5
LOSS_AFTER_RTOL = 1e-4
USVT_RTOL = 1e-4
ROUNDS = 3

SPEC_TOML = """
name = "ckpt-parity"
seed = 0
rounds = 3
log_every = 0

[model]
kind = "lm"
preset = "llm-tiny"
smoke = true

[data]
kind = "token_stream"
batch = 2
seq = 32
tokens_per_client = 2000

[fed]
method = "fedlrt"
clients = 2
local_steps = 2
tau = 0.05

[wire]
codec = "identity"

[checkpoint]
every = 1
"""


def _specs(ckpt_dir, *more):
    """The same spec in both packages, checkpointing into ``ckpt_dir``.
    The identity codec: int8 on the wire would turn the packages' ±1 code
    differences at rounding ties into loss differences above the parity
    tolerances (``tests/test_torch_wire.py`` holds an int8 round to 1e-3)."""
    over = [f"checkpoint.dir={ckpt_dir}", *more]
    j = japi.ExperimentSpec.from_toml(SPEC_TOML).with_overrides(over)
    t = api.ExperimentSpec.from_toml(SPEC_TOML).with_overrides(over)
    assert j.spec_hash() == t.spec_hash()
    return j, t


def to_torch(jtree):
    return params_from_numpy({k: np.asarray(v) for k, v in jax_flatten(jtree).items()}, "cpu")


def _jax_lm_params():
    from repro.models import build_model
    from repro.models.config import reduced

    model = build_model(reduced(japi.tasks.PRESETS["llm-tiny"]))
    return model.init(jax.random.PRNGKey(0))[0]


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n[:-len(".npy")]: z.read(n) for n in z.namelist()}


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------


def test_npz_members_match_jax_byte_for_byte(tmp_path):
    jparams = _jax_lm_params()
    tparams = to_torch(jparams)
    assert set(tio._flatten(tparams)) == set(jax_flatten(jparams))
    meta = {"round": 3, "method": "fedlrt", "spec_hash": "0123456789ab"}
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jparams, meta=meta)
    save_checkpoint(str(tmp_path / "t.npz"), tparams, meta=meta)
    jm, tm = _members(tmp_path / "j.npz"), _members(tmp_path / "t.npz")
    assert jm.keys() == tm.keys()
    for name in jm:  # every leaf is float32 (or the meta bytes): the same bytes
        assert tm[name] == jm[name], name
    assert tio.load_checkpoint_meta(str(tmp_path / "t.npz")) == meta
    assert jckpt.load_checkpoint_meta(str(tmp_path / "t.npz")) == meta


def test_bf16_leaves_are_v2_records(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((6, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16), "r": jnp.float32(2.0)}
    ttree = {"w": torch.from_numpy(vals).to(torch.bfloat16), "r": torch.tensor(2.0)}
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jtree)
    save_checkpoint(str(tmp_path / "t.npz"), ttree)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert jz["w"].dtype.kind == tz["w"].dtype.kind == "V"
        assert jz["w"].dtype.itemsize == tz["w"].dtype.itemsize == 2
        np.testing.assert_array_equal(tz["w"].view(np.uint16), jz["w"].view(np.uint16))
    for path in ("j.npz", "t.npz"):  # the port reads both back, same bits
        back, _ = load_checkpoint(str(tmp_path / path), device="cpu")
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"].view(torch.int16), ttree["w"].view(torch.int16))


def test_factor_roundtrip_restores_ranks(tmp_path):
    jf = jfac.init_factor(jax.random.PRNGKey(2), 9, 7, r_max=4, init_rank=3, batch_shape=(2,))
    tf = to_torch(jf)
    save_checkpoint(str(tmp_path / "f.npz"), tf, meta={"round": 1})
    back, meta = load_checkpoint(str(tmp_path / "f.npz"), device="cpu")
    assert isinstance(back, fac.LowRankFactor) and meta == {"round": 1}
    for a, b in zip(tree_leaves(back), tree_leaves(tf)):
        assert torch.equal(a, b)
    jback, _ = jckpt.load_checkpoint(str(tmp_path / "f.npz"))
    np.testing.assert_array_equal(np.asarray(jback.rank), tf.rank.numpy())


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _assert_history_close(want, got):
    assert len(want) == len(got)
    for rw, rg in zip(want, got):
        assert rw.round_idx == rg.round_idx and rw.cohort_size == rg.cohort_size
        for name, rtol in (("loss_before", LOSS_BEFORE_RTOL), ("loss_after", LOSS_AFTER_RTOL)):
            a, b = getattr(rg, name), getattr(rw, name)
            assert abs(a - b) <= rtol * abs(b), (rw.round_idx, name, a, b)
        assert rg.comm_bytes_per_client == rw.comm_bytes_per_client
        assert rg.wire_bytes_up_per_client == rw.wire_bytes_up_per_client
        assert rg.wire_bytes_down_per_client == rw.wire_bytes_down_per_client
        assert rg.ranks.keys() == rw.ranks.keys()
        for k in rw.ranks:
            np.testing.assert_array_equal(np.asarray(rg.ranks[k]), np.asarray(rw.ranks[k]))


def _assert_params_close(jparams, tparams):
    jfs = [x for x in jax.tree.leaves(jparams, is_leaf=jfac.is_factor) if jfac.is_factor(x)]
    tfs = [x for x in tree_leaves(tparams, is_leaf=fac.is_factor) if fac.is_factor(x)]
    assert len(jfs) == len(tfs) > 0
    for jf, tf in zip(jfs, tfs):
        np.testing.assert_array_equal(tf.rank.numpy(), np.asarray(jf.rank))
        want = np.asarray(jfac.materialize(jf))
        err = np.abs(fac.materialize(tf).numpy() - want).max() / np.abs(want).max()
        assert err <= USVT_RTOL, err


def _no_seconds(history):
    return [{k: v for k, v in r.__dict__.items() if k != "seconds"} for r in history]


def test_port_resume_is_bit_identical(tmp_path):
    _, spec = _specs(tmp_path, "wire.codec=int8_affine")
    full = api.build(spec, device="cpu")
    hist_full = full.run()
    resumed = api.build(spec, device="cpu")
    meta = resumed.resume(str(tmp_path / "round_000001.npz"))
    assert meta["round"] == 1 and meta["spec_hash"] == spec.spec_hash()
    assert resumed.engine.round_idx == 1 and len(resumed.history) == 1
    resumed.run(rounds=ROUNDS - 1)
    a, b = tree_leaves(full.params), tree_leaves(resumed.params)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    got, want = _no_seconds(resumed.history), _no_seconds(hist_full)
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert rg.keys() == rw.keys()
        for k in rw:
            if k == "ranks":
                assert all(np.array_equal(rg[k][n], rw[k][n]) for n in rw[k])
            elif k == "cohort":
                assert np.array_equal(rg[k], rw[k])
            else:
                assert rg[k] == rw[k], k
    # resume() without a path takes the latest checkpoint of the spec's dir
    latest = api.build(spec, device="cpu")
    assert latest.resume()["round"] == ROUNDS


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jspec, tspec = _specs(tmp_path)
    jexp = japi.build(jspec)
    jhist = jexp.run()
    texp = api.build(tspec, device="cpu")
    texp.resume(str(tmp_path / "round_000001.npz"))  # the hash guard passes
    assert [r.round_idx for r in texp.history] == [0]
    texp.run(rounds=ROUNDS - 1)
    _assert_history_close(jhist, texp.history)
    _assert_params_close(jexp.params, texp.params)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jspec, tspec = _specs(tmp_path)
    texp = api.build(tspec, device="cpu")
    thist = texp.run()
    jexp = japi.build(jspec)
    jexp.resume(str(tmp_path / "round_000001.npz"))
    jexp.run(rounds=ROUNDS - 1)
    _assert_history_close(thist, jexp.history)
    _assert_params_close(jexp.params, texp.params)


def test_resume_refuses_mismatched_spec(tmp_path):
    _, spec = _specs(tmp_path)
    api.build(spec, device="cpu").run(rounds=1)
    other = api.build(spec.with_overrides(["fed.lr=0.1"]), device="cpu")
    before = [t.clone() for t in tree_leaves(other.params)]
    with pytest.raises(ValueError, match="refusing to resume"):
        other.resume(str(tmp_path / "round_000001.npz"))
    assert other.engine.round_idx == 0 and other.history == []
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(other.params)))
    with pytest.raises(ValueError, match="checkpoint.dir"):
        api.build(spec.with_overrides(["checkpoint.dir=none"]), device="cpu").resume()


def test_state_sidecar_is_versioned_and_json_safe(tmp_path):
    _, spec = _specs(tmp_path, "wire.codec=int8_affine")
    api.build(spec, device="cpu").run(rounds=2)
    state = np.load(tmp_path / "round_000002.npz.state.npy", allow_pickle=True).item()
    assert state["version"] == 1 and len(state["history"]) == 2
    json.dumps(state["history"])  # plain dicts of JSON-safe values, no pickled objects
    assert state["history"][1]["wire_codec"] == "int8_affine"
    assert {"cursors", "orders", "rng_states"} <= set(state["batcher"])


def test_history_state_tolerates_field_drift():
    rows = [{"round_idx": 0, "loss_before": 1.0, "loss_after": None,
             "comm_bytes_per_client": 8.0, "ranks": {"w": [3.0]}, "seconds": 0.1,
             "cohort": [0, 1], "t_virtual": 4.0, "staleness_mean": 0.0}]
    rows[0]["no_such_field"] = 1  # keys the dataclass lacks are dropped
    [r] = history_from_state(rows)
    assert (r.t_virtual, r.staleness_mean, r.virtual_seconds) == (4.0, 0.0, 0.0)
    assert r.cohort_size == 0 and r.wire_codec == ""  # missing ones take defaults
    np.testing.assert_array_equal(r.ranks["w"], [3.0])


def test_restore_loads_legacy_pickled_sidecar(tmp_path):
    _, spec = _specs(tmp_path)
    exp = api.build(spec.with_overrides(["checkpoint.dir=none"]), device="cpu")
    path = str(tmp_path / "round_000004.npz")
    save_checkpoint(path, exp.params, meta={"round": 4})
    legacy = [RoundResult(round_idx=3, loss_before=2.0, loss_after=None,
                          comm_bytes_per_client=1.0, ranks={}, seconds=0.0)]
    np.save(path + ".state.npy", np.asarray({"history": legacy}, dtype=object),
            allow_pickle=True)
    assert exp.resume(path)["round"] == 4 and exp.engine.round_idx == 4
    assert exp.history[0].loss_before == 2.0


def test_serve_from_the_port_checkpoint(tmp_path):
    _, spec = _specs(tmp_path)
    exp = api.build(spec, device="cpu")
    exp.run(rounds=2)
    sv = spec.with_overrides([f"serve.checkpoint={tmp_path}", "serve.max_new_tokens=4",
                              "serve.max_prompt=16", "serve.prompt_bucket=8"])
    session = api.serve(sv, device="cpu")
    for a, b in zip(tree_leaves(session.engine.params), tree_leaves(exp.params)):
        assert torch.equal(a, b)  # the latest round's params, verbatim
    outs, _ = session.generate([np.arange(1, 6), np.arange(3, 12)])
    assert [len(o) for o in outs] == [4, 4]


def test_load_checkpoint_meta_reads_no_params(tmp_path):
    path = str(tmp_path / "m.npz")
    save_checkpoint(path, {"w": torch.ones(3)}, meta={"spec_hash": "abc"})
    assert tio.load_checkpoint_meta(path) == {"spec_hash": "abc"}
    buf = io.BytesIO()
    np.savez(buf, w=np.ones(2))
    (tmp_path / "bare.npz").write_bytes(buf.getvalue())
    assert tio.load_checkpoint_meta(str(tmp_path / "bare.npz")) == {}
