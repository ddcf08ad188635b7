"""The port's training slice against the JAX package, on shared inputs.

Every case builds its inputs in the JAX package (``jax.random`` initial
factors, the numpy data generators), carries the parameters across as numpy
(``repro_torch.checkpoint.params_from_numpy``) and runs the same step in
both packages, in f32 on the CPU: the port's kernel wrappers take their
plain versions there, the JAX package runs its plain chain. QR and SVD
leave signs free, so factors are compared as ``U S Vᵀ`` and as spans, with
σ and the chosen rank; the test spectra sit away from the τ threshold.

Tolerances: ``loss_before`` 1e-5 and ``loss_after`` 1e-4 relative (f32 sums
in another order, one round of updates between them), factors' ``U S Vᵀ``
1e-4 relative to their largest entry, ranks and comm bytes equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.dlrt as jdlrt
import repro.core.factorization as jfac
import repro.data as jdata
from repro.checkpoint.io import _flatten
from repro.core import FedConfig as JFedConfig
from repro.core import cost_model as jcost
from repro.core.baselines import fedavg_round as jfedavg_round
from repro.core.baselines import fedlin_round as jfedlin_round
from repro.core.baselines import fedlrt_naive_round as jnaive_round
from repro.core.fedlrt import fedlrt_round as jfedlrt_round
from repro.fed.participation import Participation as JParticipation
from repro.optim import adam as jadam
from repro.optim import cosine_schedule as jcosine
from repro.optim import sgd as jsgd
from repro_torch import api
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import cost_model, dlrt
from repro_torch.core import factorization as fac
from repro_torch.core.baselines import fedavg_round, fedlin_round, fedlrt_naive_round
from repro_torch.core.fedlrt import fedlrt_round
from repro_torch.core.round import FedConfig, value_and_grad
from repro_torch.data import FederatedBatcher
from repro_torch.data import synthetic, partition
from repro_torch.fed.participation import Participation
from repro_torch.launch import train as launch_train
from repro_torch.models.layers import apply_embedding
from repro_torch.optim import adam, cosine_schedule, sgd
from repro_torch.utils.tree import tree_leaves

from conftest import as_batches, lsq_dense_loss, lsq_loss
from torch_threads import one_intra_op_thread  # noqa: F401

LOSS_BEFORE_RTOL = 1e-5
LOSS_AFTER_RTOL = 1e-4
USVT_RTOL = 1e-4


# ---------------------------------------------------------------------------
# carrying values across
# ---------------------------------------------------------------------------


def to_torch(jtree):
    """A JAX parameter tree as the port's, through the npz layout."""
    flat = {k: np.asarray(v) for k, v in _flatten(jtree).items()}
    return params_from_numpy(flat, "cpu")


def aug_to_torch(f) -> fac.AugmentedFactor:
    """A JAX AugmentedFactor as the port's (the npz layout has no class)."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return fac.AugmentedFactor(U=t(f.U), S=t(f.S), V=t(f.V), rank=t(f.rank))


def batches_to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def lsq_loss_t(f, batch):
    pred = torch.sum(((batch["px"] @ f.U) @ f.S) * (batch["py"] @ f.V), -1)
    return 0.5 * torch.mean((pred - batch["t"]) ** 2)


def lsq_dense_loss_t(W, batch):
    pred = torch.einsum("ni,ij,nj->n", batch["px"], W, batch["py"])
    return 0.5 * torch.mean((pred - batch["t"]) ** 2)


def assert_rel(got, want, rtol, what=""):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), f"{what}: {got} vs {want} (rtol {rtol})"


def assert_usvt_close(jf, tf, rtol=USVT_RTOL):
    want = np.asarray(jfac.materialize(jf))
    got = fac.materialize(tf).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"U S V^T differs by {err:.3g} relative (> {rtol})"


def projector(B):
    B = np.asarray(B, np.float64)
    return B @ B.T


def assert_factors_close(jparams, tparams, rtol=USVT_RTOL):
    jfs = [x for x in jax.tree.leaves(jparams, is_leaf=jfac.is_factor) if jfac.is_factor(x)]
    tfs = [x for x in tree_leaves(tparams, is_leaf=fac.is_factor) if fac.is_factor(x)]
    assert len(jfs) == len(tfs) > 0
    for jf, tf in zip(jfs, tfs):
        np.testing.assert_array_equal(tf.rank.numpy(), np.asarray(jf.rank))
        assert_usvt_close(jf, tf, rtol)


# ---------------------------------------------------------------------------
# data, partitions, batches, participation
# ---------------------------------------------------------------------------


def test_generators_are_bit_identical():
    for name, kw in [
        ("make_token_stream", dict(vocab_size=64, num_tokens=3000, rank=4, seed=3)),
        ("make_classification_data", dict(dim=16, num_classes=5, num_points=300, seed=2)),
    ]:
        a, b = getattr(jdata, name)(**kw), getattr(synthetic, name)(**kw)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for name, kw in [("make_homogeneous_lsq", dict(n=8, num_points=400, seed=1)),
                     ("make_heterogeneous_lsq", dict(n=6, num_points=200, seed=4))]:
        p, q = getattr(jdata, name)(**kw), getattr(synthetic, name)(**kw)
        for f in dataclasses.fields(p):
            assert np.array_equal(getattr(p, f.name), getattr(q, f.name)), (name, f.name)


def test_partitions_are_bit_identical():
    labels = np.random.default_rng(0).integers(0, 5, 400)
    for a, b in zip(jdata.partition_iid(400, 4, seed=2), partition.partition_iid(400, 4, seed=2)):
        assert np.array_equal(a, b)
    ja = jdata.partition_dirichlet(labels, 4, alpha=0.3, seed=1)
    ta = partition.partition_dirichlet(labels, 4, alpha=0.3, seed=1)
    for a, b in zip(ja, ta):
        assert np.array_equal(a, b)
    assert np.array_equal(jdata.partition_sizes(ja), partition.partition_sizes(ta))


@pytest.mark.parametrize("steps", [None, 3])
def test_batches_are_bit_identical(steps):
    """The port's FederatedBatcher yields repro.data's batches, bit for bit,
    through epochs, cohorts and a state snapshot."""
    tokens = jdata.make_token_stream(vocab_size=50, num_tokens=4000, seed=5)
    windows = np.lib.stride_tricks.sliding_window_view(tokens, 17)[::8]
    parts = jdata.partition_iid(len(windows), 4, seed=5)
    kw = dict(batch_size=6, steps_per_round=steps, seed=5)
    jb = jdata.FederatedBatcher({"tokens": windows}, parts, **kw)
    tb = FederatedBatcher({"tokens": windows}, parts, **kw)
    for r in range(12):
        cohort = None if r % 3 == 0 else [r % 4, (r + 2) % 4]
        a, b = jb.next_round(cohort), tb.next_round(cohort)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        if r == 5:
            tb.set_state(jb.state())
    assert tb.state()["cursors"] == jb.state()["cursors"]


@pytest.mark.parametrize("spec", ["full", "uniform:2", "round_robin:3", "dropout:0.4"])
def test_participation_cohorts_match(spec):
    jp, tp = JParticipation.from_spec(spec, seed=7), Participation.from_spec(spec, seed=7)
    for r in range(10):
        assert np.array_equal(jp.cohort(r, 5), tp.cohort(r, 5))
    assert jp.padded_size(5) == tp.padded_size(5)
    assert jp.expected_cohort_size(5) == tp.expected_cohort_size(5)


# ---------------------------------------------------------------------------
# factor algebra and the DLRT primitives
# ---------------------------------------------------------------------------


def _jfactor(n_in=40, n_out=30, r_max=6, init_rank=4, seed=0, batch_shape=()):
    return jfac.init_factor(jax.random.PRNGKey(seed), n_in, n_out, r_max=r_max,
                            init_rank=init_rank, batch_shape=batch_shape)


def test_masks_and_invariants_match():
    rank = jnp.asarray([0.0, 2.0, 5.0])
    np.testing.assert_array_equal(
        fac.augmented_mask(torch.tensor([0.0, 2.0, 5.0]), 5).numpy(),
        np.asarray(jfac.augmented_mask(rank, 5)),
    )
    S = np.random.default_rng(0).standard_normal((3, 10, 10)).astype(np.float32)
    m = jfac.augmented_mask(rank, 5)
    np.testing.assert_array_equal(
        fac.mask_coeff(torch.from_numpy(S), torch.from_numpy(np.array(m))).numpy(),
        np.asarray(jfac.mask_coeff(jnp.asarray(S), m)),
    )
    jf = _jfactor(batch_shape=(2,))
    tf = to_torch(jf)
    want, got = jax.jit(jfac.check_invariants)(jf), fac.check_invariants(tf)
    for k in want:
        assert float(got[k]) <= 1e-4 and float(want[k]) <= 1e-4
    assert fac.factor_param_count(tf) == jfac.factor_param_count(jf)
    np.testing.assert_array_equal(fac.effective_rank(tf).numpy(), np.asarray(jf.rank))
    idx = np.array([[3, 0, 3], [7, 1, 39]])
    jf1 = _jfactor()
    np.testing.assert_allclose(
        fac.lr_rowlookup(torch.from_numpy(idx), to_torch(jf1)).numpy(),
        np.asarray(jfac.lr_rowlookup(jnp.asarray(idx), jf1)), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_lr_matmul_takes_augmented_factors(kernels):
    jf = _jfactor()
    GU = jax.random.normal(jax.random.PRNGKey(1), jf.U.shape)
    GV = jax.random.normal(jax.random.PRNGKey(2), jf.V.shape)
    jaug = jdlrt.augment_basis(jf, GU, GV)
    jaug = dataclasses.replace(jaug, S=jaug.S + 0.1 * jfac.mask_coeff(
        jnp.ones_like(jaug.S), jfac.augmented_mask(jaug.rank, jaug.r_max)))
    x = np.random.default_rng(3).standard_normal((5, 7, 40)).astype(np.float32)
    want = jfac.lr_matmul(jnp.asarray(x), jaug, kernels="interpret" if kernels == "auto" else "off")
    got = fac.lr_matmul(torch.from_numpy(x), aug_to_torch(jaug), kernels=kernels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_qr_pos_matches():
    jf = _jfactor(40, 40, r_max=8, init_rank=8)
    G = np.random.default_rng(1).standard_normal((40, 8)).astype(np.float32)
    a = np.concatenate([np.asarray(jf.U), G], axis=1)
    want = np.asarray(jdlrt.qr_pos(jnp.asarray(a)))
    got = dlrt.qr_pos(torch.from_numpy(a)).numpy()
    # diag(R) >= 0 makes the QR unique: the bases themselves agree
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[:, :8], np.asarray(jf.U), atol=1e-5)


@pytest.mark.parametrize("method", ["cholqr2", "householder"])
@pytest.mark.parametrize("batch_shape", [(), (3,)])
def test_augment_basis_matches_on_spans(method, batch_shape):
    jf = _jfactor(40, 30, r_max=6, init_rank=4, batch_shape=batch_shape)
    GU = jax.random.normal(jax.random.PRNGKey(1), jf.U.shape)
    GV = jax.random.normal(jax.random.PRNGKey(2), jf.V.shape)
    jaug = jdlrt.augment_basis(jf, GU, GV, method=method)
    taug = dlrt.augment_basis(to_torch(jf), torch.from_numpy(np.asarray(GU)),
                              torch.from_numpy(np.asarray(GV)), method=method)
    np.testing.assert_array_equal(taug.S.numpy(), np.asarray(jaug.S))  # Lemma 1 assembly
    for tb, jb in ((taug.U, jaug.U), (taug.V, jaug.V)):
        tb, jb = tb.numpy().reshape((-1,) + tb.shape[-2:]), np.asarray(jb).reshape(
            (-1,) + jb.shape[-2:])
        for t, j in zip(tb, jb):
            np.testing.assert_allclose(projector(t), projector(j), atol=2e-5)
            np.testing.assert_allclose(t[:, :6], j[:, :6], atol=1e-5)  # Uᵗ kept as is
    am = fac.augmented_mask(taug.rank, 6)
    assert bool((taug.U * (1 - am)[..., None, :] == 0).all())  # inactive columns zero


def test_cholqr2_zeroes_non_finite_columns():
    """A block the Cholesky cannot factor comes back zero in both packages."""
    U = np.linalg.qr(np.random.default_rng(0).standard_normal((20, 4)))[0].astype(np.float32)
    G = np.random.default_rng(1).standard_normal((20, 4)).astype(np.float32)
    G[3, 1] = np.inf
    want = np.asarray(jdlrt._ortho_complement_cholqr2(jnp.asarray(U), jnp.asarray(G)))
    got = dlrt._ortho_complement_cholqr2(torch.from_numpy(U), torch.from_numpy(G)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got == 0, want == 0)


def test_pick_rank_matches():
    rng = np.random.default_rng(2)
    sigma = -np.sort(-np.abs(rng.standard_normal((5, 12))), axis=-1).astype(np.float32)
    norms = np.linalg.norm(sigma, axis=-1)
    for tau in (0.0, 0.07, 0.3, 0.9):
        theta = (tau * norms).astype(np.float32)
        want = np.asarray(jdlrt.pick_rank(jnp.asarray(sigma), jnp.asarray(theta), 6))
        got = dlrt.pick_rank(torch.from_numpy(sigma), torch.from_numpy(theta), 6)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("theta_abs", [None, 0.5])
def test_truncate_matches(theta_abs):
    jf = _jfactor(40, 30, r_max=6, init_rank=6, batch_shape=(2,))
    GU = jax.random.normal(jax.random.PRNGKey(3), jf.U.shape)
    GV = jax.random.normal(jax.random.PRNGKey(4), jf.V.shape)
    jaug = jdlrt.augment_basis(jf, GU, GV)
    # a coefficient with a clear spectral gap: σ = 3 … 0.03 over the 12 directions
    rng = np.random.default_rng(5)
    Q1 = np.linalg.qr(rng.standard_normal((2, 12, 12)))[0]
    Q2 = np.linalg.qr(rng.standard_normal((2, 12, 12)))[0]
    s = np.array([3, 2.5, 2, 1.6, 1.2, 1.0, 0.1, 0.08, 0.06, 0.05, 0.04, 0.03])
    S = ((Q1 * s) @ Q2.transpose(0, 2, 1)).astype(np.float32)
    jaug = dataclasses.replace(jaug, S=jnp.asarray(S), rank=jnp.asarray([6.0, 6.0]))
    jout, jinfo = jdlrt.truncate(jaug, tau=0.05, theta_abs=theta_abs)
    tout, tinfo = dlrt.truncate(aug_to_torch(jaug), tau=0.05, theta_abs=theta_abs)
    np.testing.assert_array_equal(tout.rank.numpy(), np.asarray(jout.rank))
    for k in ("theta", "sigma_max"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), rtol=1e-5)
    # trunc_err = sqrt(Σσ² − Σσ_kept²): the difference of two f32 sums of
    # about 24 that differ by 0.025 keeps ~4 digits
    np.testing.assert_allclose(tinfo["trunc_err"].numpy(), np.asarray(jinfo["trunc_err"]),
                               rtol=1e-4)
    assert_usvt_close(jout, tout)
    inv = fac.check_invariants(tout)
    assert max(float(v) for v in inv.values()) <= 1e-4


def test_bug_round_dense_loss_matches():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, 24)).astype(np.float32)
    y = rng.standard_normal((64, 20)).astype(np.float32)
    jf = _jfactor(24, 20, r_max=5, init_rank=5, seed=1)
    jout, jinfo = jax.jit(lambda f: jdlrt.bug_round_dense_loss(
        lambda g: jnp.mean((jfac.lr_matmul(jnp.asarray(x), g) - y) ** 2), f, lr=0.1, tau=0.02))(jf)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tout, tinfo = dlrt.bug_round_dense_loss(
        lambda f: torch.mean((fac.lr_matmul(tx, f) - ty) ** 2), to_torch(jf), lr=0.1, tau=0.02)
    assert float(tout.rank) == float(jout.rank)
    assert_usvt_close(jout, tout)


def test_value_and_grad_never_differentiates_rank():
    jf = _jfactor()
    tf = to_torch(jf)
    x = torch.ones(3, 40)
    loss, g = value_and_grad(lambda f, b: fac.lr_matmul(b, f).sum(), tf, x)
    assert not tf.rank.requires_grad and not loss.requires_grad
    assert isinstance(g, fac.LowRankFactor) and torch.equal(g.rank, torch.zeros_like(tf.rank))
    _, jg = jax.value_and_grad(lambda f: jfac.lr_matmul(jnp.ones((3, 40)), f).sum())(jf)
    for name in ("U", "S", "V"):
        np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(jg, name)),
                                   rtol=1e-5, atol=1e-5)


def test_embedding_gather_backward_matches_plain_index():
    """The embedding's deterministic row-gather backward gives the values of
    a plain index backward."""
    jf = _jfactor(30, 16, r_max=4, init_rank=4)
    tokens = torch.tensor([[1, 5, 1, 29], [5, 5, 0, 1]])
    grads = []
    for gather in (True, False):
        U = to_torch(jf).U.requires_grad_(True)
        f = dataclasses.replace(to_torch(jf), U=U)
        emb = apply_embedding(f, tokens) if gather else (U[tokens] @ f.S) @ f.V.T
        (g,) = torch.autograd.grad((emb * torch.arange(16.0)).sum(), U)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizers, schedules, comm bytes
# ---------------------------------------------------------------------------


def test_tree_helpers_match():
    """``repro_torch.utils``' tree arithmetic against ``repro.utils``' on a
    tree with a factor leaf (its U, S, V and rank are leaves in both)."""
    import repro.utils as jutils
    import repro_torch.utils as tutils

    rng = np.random.default_rng(9)

    def draw():
        g = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
        return {"w": g(3, 4), "b": {"x": g(5), "y": g(2, 2)},
                "f": dict(U=g(6, 2), S=g(2, 2), V=g(5, 2), rank=np.float32(2.0))}

    def trees(d):
        j = {"w": jnp.asarray(d["w"]), "b": {k: jnp.asarray(v) for k, v in d["b"].items()},
             "f": jfac.LowRankFactor(**{k: jnp.asarray(v) for k, v in d["f"].items()})}
        t = {"w": torch.from_numpy(d["w"]),
             "b": {k: torch.from_numpy(v) for k, v in d["b"].items()},
             "f": fac.LowRankFactor(**{k: torch.as_tensor(v) for k, v in d["f"].items()})}
        return j, t

    (ja, ta), (jb, tb) = trees(draw()), trees(draw())

    def same(t, j, rtol=0.0):
        tl, jl = tree_leaves(t), jax.tree.leaves(j)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=0)

    same(tutils.tree_add(ta, tb), jutils.tree_add(ja, jb))
    same(tutils.tree_sub(ta, tb), jutils.tree_sub(ja, jb))
    same(tutils.tree_scale(ta, 0.3), jutils.tree_scale(ja, 0.3))
    same(tutils.tree_axpy(-1.7, ta, tb), jutils.tree_axpy(-1.7, ja, jb))
    same(tutils.tree_zeros_like(ta), jutils.tree_zeros_like(ja))
    assert_rel(tutils.tree_global_norm(ta), jutils.tree_global_norm(ja), 1e-6, "global norm")
    assert float(tutils.tree_global_norm({})) == float(jutils.tree_global_norm({})) == 0.0


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adam"])
def test_optimizers_match(name):
    rng = np.random.default_rng(7)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
             for _ in range(3)]
    mk = {"sgd": (jsgd(0.1), sgd(0.1)), "sgd_momentum": (jsgd(0.1, momentum=0.9), sgd(0.1, momentum=0.9)),
          "adam": (jadam(jcosine(0.1, 0.01, 3)), adam(cosine_schedule(0.1, 0.01, 3)))}[name]
    jopt, topt = mk
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for s, g in enumerate(grads):
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jnp.int32(s))
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, s, tp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_sgd_weight_decay_folds_l2_into_the_gradient():
    p, g = {"w": torch.ones(3)}, {"w": torch.zeros(3)}
    upd, _ = sgd(0.5, weight_decay=0.1).update(g, (), 0, p)
    torch.testing.assert_close(upd["w"], torch.full((3,), -0.05))
    with pytest.raises(ValueError, match="needs params"):
        sgd(0.5, weight_decay=0.1).update(g, (), 0)


@pytest.mark.parametrize("correction", ["none", "simplified", "full"])
def test_comm_bytes_match(correction):
    from repro.models import build_model as jbuild_model
    from repro.models.config import reduced

    model = jbuild_model(reduced(japi.tasks.PRESETS["llm-tiny"]))
    jparams, _ = model.init(jax.random.PRNGKey(0))
    tparams = to_torch(jparams)
    assert cost_model.fedlrt_round_comm_bytes(tparams, correction) == \
        jcost.fedlrt_round_comm_bytes(jparams, correction)
    assert float(cost_model.fedlrt_round_comm_bytes_effective(tparams, correction)) == \
        float(jcost.fedlrt_round_comm_bytes_effective(jparams, correction))
    W = {"w": jnp.zeros((7, 5)), "b": jnp.zeros(5)}
    for m in ("fedavg", "fedlin"):
        assert cost_model.dense_round_comm_bytes(to_torch(W), m) == jcost.dense_round_comm_bytes(W, m)
    assert cost_model.round_total_comm_bytes(tparams, correction=correction, cohort_size=3) == \
        jcost.round_total_comm_bytes(jparams, correction=correction, cohort_size=3)


# ---------------------------------------------------------------------------
# one round of each program
# ---------------------------------------------------------------------------


def _round_pair(jround, tround, jloss, tloss, jparams, jbatches, cfg_kw, **kw):
    jcfg = JFedConfig(**cfg_kw)
    jnew, jm = jax.jit(lambda p, b, **k: jround(jloss, p, b, jcfg, **k))(jparams, jbatches, **kw)
    tkw = {k: (None if v is None else np.asarray(v)) for k, v in kw.items()}
    tnew, tm = tround(tloss, to_torch(jparams), batches_to_torch(jbatches),
                      FedConfig(**cfg_kw), **tkw)
    assert_rel(tm["loss_before"], jm["loss_before"], LOSS_BEFORE_RTOL, "loss_before")
    if "loss_after" in jm:
        assert_rel(tm["loss_after"], jm["loss_after"], LOSS_AFTER_RTOL, "loss_after")
    assert float(tm["comm_bytes_per_client"]) == float(jm["comm_bytes_per_client"])
    return (jnew, jm), (tnew, tm)


@pytest.mark.parametrize("correction", ["none", "simplified", "full"])
@pytest.mark.parametrize("prob", ["homo_prob", "hetero_prob"])
def test_fedlrt_round_matches_on_lsq(request, prob, correction):
    prob = request.getfixturevalue(prob)
    n = prob.px.shape[-1]
    jf = jfac.init_factor(jax.random.PRNGKey(0), n, n, r_max=min(8, n // 2),
                          init_rank=min(8, n // 2), spectrum_scale=1.0)
    cfg = dict(num_clients=4, s_star=5, lr=0.05, correction=correction, tau=0.05,
               track_drift=True)
    (jnew, jm), (tnew, tm) = _round_pair(
        jfedlrt_round, fedlrt_round, lsq_loss, lsq_loss_t, jf, as_batches(prob), cfg)
    assert_factors_close(jnew, tnew)
    assert float(tm["comm_bytes_per_client_effective"]) == float(jm["comm_bytes_per_client_effective"])
    assert_rel(tm["max_coeff_drift"], jm["max_coeff_drift"], 1e-4, "drift")
    assert_rel(tm["grad_norm_S"], jm["grad_norm_S"], 1e-5, "grad_norm_S")
    assert tm["rank"].keys() == jm["rank"].keys()


def test_fedlrt_round_weighted_and_per_step(homo_prob):
    """Weighted aggregation and the (C, s*, ...) per-step batch layout."""
    rng = np.random.default_rng(8)
    idx = rng.integers(0, homo_prob.px.shape[1], (4, 3, 32))
    jb = {k: jnp.asarray(np.take_along_axis(v, idx.reshape(4, -1)[..., None] if v.ndim == 3
                                            else idx.reshape(4, -1), 1).reshape(
        (4, 3, 32) + v.shape[2:]))
          for k, v in (("px", homo_prob.px), ("py", homo_prob.py), ("t", homo_prob.target))}
    jf = jfac.init_factor(jax.random.PRNGKey(1), 20, 20, r_max=6, init_rank=6, spectrum_scale=1.0)
    cfg = dict(num_clients=4, s_star=3, lr=0.05, correction="full", tau=0.05,
               per_step_batches=True)
    w = jnp.asarray([1.0, 3.0, 0.5, 2.0])
    (jnew, _), (tnew, _) = _round_pair(jfedlrt_round, fedlrt_round, lsq_loss, lsq_loss_t,
                                       jf, jb, cfg, client_weights=w)
    assert_factors_close(jnew, tnew)


@pytest.mark.parametrize("method", ["fedavg", "fedlin"])
def test_dense_baselines_match(hetero_prob, method):
    jround, tround = {"fedavg": (jfedavg_round, fedavg_round),
                      "fedlin": (jfedlin_round, fedlin_round)}[method]
    W0 = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (10, 10))
    cfg = dict(num_clients=4, s_star=5, lr=0.1, correction="none")
    (jnew, _), (tnew, _) = _round_pair(jround, tround, lsq_dense_loss, lsq_dense_loss_t, W0,
                                       as_batches(hetero_prob), cfg)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), rtol=1e-4, atol=1e-5)


def test_naive_round_matches(homo_prob):
    jf = jfac.init_factor(jax.random.PRNGKey(3), 20, 20, r_max=6, init_rank=6, spectrum_scale=1.0)
    cfg = dict(num_clients=4, s_star=1, lr=0.1, correction="none", tau=0.02)
    (jnew, jm), (tnew, tm) = _round_pair(jnaive_round, fedlrt_naive_round, lsq_loss, lsq_loss_t,
                                         jf, as_batches(homo_prob), cfg)
    assert float(tm["rank"]) == float(jm["rank"])
    assert_usvt_close(jnew, tnew)


# ---------------------------------------------------------------------------
# tasks through build(spec): mlp and the llm-tiny LM
# ---------------------------------------------------------------------------


def _spec_pair(**kw):
    """The same ExperimentSpec in both packages (section by section)."""
    jkw, tkw = {}, {}
    for k, v in kw.items():
        if isinstance(v, tuple):  # (section name, fields)
            section, fields = v
            jkw[k] = getattr(japi, section)(**fields)
            tkw[k] = getattr(api, section)(**fields)
        else:
            jkw[k] = tkw[k] = v
    return japi.ExperimentSpec(**jkw), api.ExperimentSpec(**tkw)


def _run_pair(jspec, tspec, rounds):
    jexp = japi.build(jspec)
    texp = api.build(tspec, params=to_torch(jexp.engine.params), device="cpu")
    return jexp, texp, jexp.run(rounds), texp.run(rounds)


def _assert_history_close(jh, th, loss_rtol=(LOSS_BEFORE_RTOL, LOSS_AFTER_RTOL)):
    assert len(jh) == len(th)
    for rj, rt in zip(jh, th):
        assert rj.round_idx == rt.round_idx and rj.cohort_size == rt.cohort_size
        assert np.array_equal(np.asarray(rj.cohort), np.asarray(rt.cohort))
        assert_rel(rt.loss_before, rj.loss_before, loss_rtol[0], f"round {rj.round_idx} loss_before")
        if rj.loss_after is not None:
            assert_rel(rt.loss_after, rj.loss_after, loss_rtol[1], f"round {rj.round_idx} loss_after")
        assert rt.comm_bytes_per_client == rj.comm_bytes_per_client
        assert rt.comm_bytes_per_client_effective == rj.comm_bytes_per_client_effective
        assert rt.wire_codec == rj.wire_codec
        assert rt.wire_bytes_down_per_client == rj.wire_bytes_down_per_client
        assert rt.wire_bytes_up_per_client == rj.wire_bytes_up_per_client
        assert rj.ranks.keys() == rt.ranks.keys()
        for k in rj.ranks:
            np.testing.assert_array_equal(rt.ranks[k], rj.ranks[k])


@pytest.mark.parametrize("method", ["fedlrt", "fedavg"])
def test_mlp_task_matches(method):
    jspec, tspec = _spec_pair(
        rounds=2, log_every=0,
        model=("ModelSpec", dict(kind="mlp", dim=32, hidden=64, classes=5, r_max=8)),
        data=("DataSpec", dict(kind="classification", num_points=1200, holdout=200, batch=32)),
        fed=("FedSpec", dict(method=method, local_steps=3, tau=0.05)),
    )
    jexp, texp, jh, th = _run_pair(jspec, tspec, 2)
    _assert_history_close(jh, th)
    if method == "fedlrt":
        assert_factors_close(jexp.engine.params, texp.engine.params)
    assert abs(texp.evaluate() - jexp.evaluate()) <= 1 / 200  # at most one flipped argmax


def test_llm_tiny_round_matches():
    """One FeDLRT round of the llm-tiny LM (reduced depth) through both
    packages' build(spec): every factorized layer forward and backward,
    the embedding's gradient through the chain's dU slot."""
    jspec, tspec = _spec_pair(
        rounds=1, log_every=0,
        model=("ModelSpec", dict(preset="llm-tiny", smoke=True)),
        data=("DataSpec", dict(tokens_per_client=2000, seq=32)),
        fed=("FedSpec", dict(local_steps=2, tau=0.05)),
    )
    jexp, texp, jh, th = _run_pair(jspec, tspec, 1)
    _assert_history_close(jh, th)
    assert_factors_close(jexp.engine.params, texp.engine.params)
    assert texp.comm_total_bytes() == jexp.engine.comm_total_bytes()  # measured, both
    assert texp.engine.comm_total_bytes_analytic() == jexp.engine.comm_total_bytes_analytic()


@pytest.mark.parametrize("participation", ["uniform:2", "dropout:0.5"])
def test_engine_rounds_match_under_partial_participation(participation):
    """Three engine rounds of the lsq task with a cohort policy (dropout:
    zero-weight filler clients): cohorts and ranks identical, losses 1e-3."""
    jspec, tspec = _spec_pair(
        rounds=3, log_every=0,
        model=("ModelSpec", dict(kind="lsq", dim=12, r_max=4)),
        data=("DataSpec", dict(kind="lsq", num_points=800, holdout=0, planted_rank=3, batch=50)),
        fed=("FedSpec", dict(local_steps=3, lr=0.05, tau=0.05, weighted=True)),
        participation=("ParticipationSpec", dict(
            mode=participation.split(":")[0],
            **({"cohort_size": 2} if participation.startswith("uniform")
               else {"dropout_prob": 0.5}))),
    )
    jexp, texp, jh, th = _run_pair(jspec, tspec, 3)
    _assert_history_close(jh, th, loss_rtol=(1e-3, 1e-3))
    assert texp.comm_total_bytes() == jexp.engine.comm_total_bytes()  # measured, both
    assert texp.engine.comm_total_bytes_analytic() == jexp.engine.comm_total_bytes_analytic()


# ---------------------------------------------------------------------------
# entry points, devices, specs
# ---------------------------------------------------------------------------


def _cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour without a card")


def test_build_defaults_to_cuda_and_raises_without_one():
    _cuda_absent()
    spec = api.ExperimentSpec(model=api.ModelSpec(preset="llm-tiny", smoke=True), rounds=1)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        api.build(spec)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        launch_train.main(["--preset", "llm-tiny", "--smoke", "--rounds", "1"])


def test_launch_train_runs_on_cpu_when_asked(capsys):
    hist = launch_train.main([
        "--preset", "llm-tiny", "--smoke", "--device", "cpu", "--rounds", "2", "--seq", "16",
        "--local-steps", "1", "--clients", "2", "--participation", "uniform:1",
        "--log-every", "1",
    ])
    out = capsys.readouterr().out
    assert len(hist) == 2 and "device=cpu" in out and "cohort=1/2" in out
    assert "done: loss" in out


@pytest.mark.parametrize("flag", [
    ["--edge-wire-codec", "int8_affine"], ["--async-buffer", "2"], ["--edges", "2"],
    ["--engine", "async"], ["--sim-profile", "uniform"], ["--telemetry-dir", "tel"],
    ["--telemetry"],
])
def test_launch_train_flags_not_ported_raise(flag):
    """The engine / sim / edge-wire flags and the telemetry flags, each
    refused until its part was ported, now set the spec as the JAX
    package's CLI does."""
    from repro.launch.train import spec_from_argv as jspec_from_argv

    argv = ["--preset", "llm-tiny", *flag]
    if flag[0].startswith("--telemetry"):
        tel = launch_train.spec_from_argv(argv).telemetry
        assert (tel.enabled, tel.dir) == (("--telemetry" in flag), "tel" if "tel" in flag else None)
        return
    # flags that need an engine to be valid get the one they configure
    needs = {"--edge-wire-codec": ["--engine", "hier"], "--async-buffer": ["--engine", "async"],
             "--edges": ["--engine", "hier"]}
    argv += needs.get(flag[0], [])
    t, j = launch_train.spec_from_argv(argv), jspec_from_argv(argv)
    assert t.to_dict() == j.to_dict() and t.spec_hash() == j.spec_hash()
    field = {"--edge-wire-codec": t.wire.edge_codec, "--async-buffer": t.engine.buffer_size,
             "--edges": t.engine.edges, "--engine": t.engine.kind,
             "--sim-profile": t.sim.profile}[flag[0]]
    assert str(field) == flag[1]


SIM_ARGVS = [
    ["--engine", "async", "--async-buffer", "2", "--staleness-power", "0.25",
     "--sim-profile", "dropout:0.1,straggler:0.25,10"],
    ["--engine", "hier", "--edges", "2", "--edge-rounds", "3", "--edge-wire-codec",
     "int8_affine", "--wire-codec", "downcast"],
    ["--engine", "sync", "--sim-profile", "lognormal:0.4"],
    ["--engine", "async", "--staleness-power", "1", "--set", "engine.buffer_size=3"],
]


@pytest.mark.parametrize("argv", SIM_ARGVS, ids=range(len(SIM_ARGVS)))
def test_launch_train_sim_flags_match_the_jax_cli(argv):
    """All seven engine / simulator / edge-wire flags resolve to the JAX
    package's spec."""
    from repro.launch.train import spec_from_argv as jspec_from_argv

    argv = ["--preset", "llm-tiny", *argv]
    t, j = launch_train.spec_from_argv(argv), jspec_from_argv(argv)
    assert t.to_dict() == j.to_dict() and t.spec_hash() == j.spec_hash()


def test_launch_train_runs_the_simulator_on_cpu(capsys):
    hist = launch_train.main([
        "--preset", "llm-tiny", "--smoke", "--device", "cpu", "--rounds", "1", "--seq", "16",
        "--local-steps", "1", "--engine", "hier", "--edges", "2", "--edge-wire-codec",
        "int8_affine", "--log-every", "1",
    ])
    out = capsys.readouterr().out
    assert len(hist) == 1 and "[hier/fedlrt] cloud round    0" in out
    assert "; virtual time " in out and "s [hier]" in out and "MB analytic" not in out


def test_launch_train_spec_matches_the_jax_cli():
    from repro.launch.train import spec_from_argv as jspec_from_argv

    argv = ["--preset", "llm-100m", "--method", "fedlin", "--clients", "8", "--local-steps", "2",
            "--batch", "2", "--seq", "64", "--lr", "0.1", "--tau", "0.02", "--seed", "3",
            "--participation", "dropout:0.25", "--weighted", "--kernels", "off", "--rounds", "5"]
    j, t = jspec_from_argv(argv), launch_train.spec_from_argv(argv)
    for section in ("model", "data", "fed", "participation"):
        for f in dataclasses.fields(getattr(t, section)):
            if hasattr(getattr(j, section), f.name):
                assert getattr(getattr(t, section), f.name) == getattr(getattr(j, section), f.name), f
    assert (t.rounds, t.seed, t.log_every) == (j.rounds, j.seed, j.log_every)


def test_not_ported_parts_raise():
    """An async engine and a sync engine with a fleet profile, refused until
    ``fed/sim/`` was ported, now build on the simulator and run a round on
    the virtual clock."""
    base = api.ExperimentSpec(
        model=api.ModelSpec(preset="llm-tiny", smoke=True), rounds=1,
        data=api.DataSpec(tokens_per_client=2000, seq=32),
        fed=api.FedSpec(local_steps=1),
    )
    for spec, cls in ((base.replace(engine=api.EngineSpec(kind="async")), "AsyncFederatedEngine"),
                      (base.replace(sim=api.SimSpec(profile="straggler:0.25,10")),
                       "SyncSimEngine")):
        exp = api.build(spec, device="cpu")
        assert exp.is_simulated and type(exp.engine).__name__ == cls
        [res] = exp.run(log_every=0)
        assert res.t_virtual > 0 and res.virtual_seconds > 0 and np.isfinite(res.loss_before)


SPEC_ERRORS = [
    dict(fed=("FedSpec", dict(correction="bogus"))),
    dict(fed=("FedSpec", dict(method="fedavg", correction="full"))),
    dict(fed=("FedSpec", dict(clients=0))),
    dict(fed=("FedSpec", dict(local_steps=-1))),
    dict(fed=("FedSpec", dict(lr=0.0))),
    dict(fed=("FedSpec", dict(tau=1.0))),
    dict(fed=("FedSpec", dict(method="fedprox"))),
    dict(data=("DataSpec", dict(batch=0))),
    dict(data=("DataSpec", dict(holdout=20_000))),
    dict(data=("DataSpec", dict(partition="iid:3"))),
    dict(data=("DataSpec", dict(partition="dirichlet:-1"))),
    dict(data=("DataSpec", dict(partition="zipf"))),
    dict(data=("DataSpec", dict(partition="dirichlet:0.5"))),
    dict(data=("DataSpec", dict(kind="classification"))),
    dict(model=("ModelSpec", dict(kind="vision"))),
    dict(model=("ModelSpec", dict(preset="llm-huge"))),
    dict(model=("ModelSpec", dict(kind="mlp", hidden=0))),
    dict(participation=("ParticipationSpec", dict(mode="uniform"))),
    dict(participation=("ParticipationSpec", dict(mode="uniform", cohort_size=9))),
    dict(participation=("ParticipationSpec", dict(mode="dropout", dropout_prob=1.5))),
    dict(model=("ModelSpec", dict(kind="lsq")),
         data=("DataSpec", dict(kind="lsq", num_points=1001, holdout=0))),
    dict(model=("ModelSpec", dict(kind="lsq")),
         data=("DataSpec", dict(kind="lsq", partition="dirichlet:1", holdout=0))),
    dict(rounds=-1),
]


def _spec(pkg, kw):
    return pkg.ExperimentSpec(**{
        k: getattr(pkg, v[0])(**v[1]) if isinstance(v, tuple) else v for k, v in kw.items()
    })


@pytest.mark.parametrize("case", range(len(SPEC_ERRORS)))
def test_spec_validation_matches_the_jax_package(case):
    """Each invalid spec is refused by both packages, at spec time."""
    kw = dict(SPEC_ERRORS[case])
    model = dict(kw.get("model", ("ModelSpec", {}))[1])
    if model.get("kind", "lm") == "lm":
        model.setdefault("preset", "llm-tiny")
    kw["model"] = ("ModelSpec", model)
    with pytest.raises(ValueError):
        _spec(japi, kw)
    with pytest.raises(ValueError):
        _spec(api, kw)


def test_fed_config_validation_matches():
    for bad in (dict(correction="x"), dict(num_clients=0), dict(s_star=0), dict(lr=-1.0),
                dict(tau=1.5)):
        kw = {**dict(num_clients=2, s_star=1), **bad}
        with pytest.raises(ValueError):
            JFedConfig(**kw)
        with pytest.raises(ValueError):
            FedConfig(**kw)
