"""Baselines the paper compares against, as round programs (the JAX
package's ``repro.core.baselines`` in PyTorch).

- :func:`fedavg_round`: Algorithm 3 (McMahan et al.).
- :func:`fedlin_round`: Algorithm 4 (Mitra et al.): FedAvg + variance
  correction, an extra communication round for the global gradient.
- :func:`fedlrt_naive_round`: Algorithm 6, per-client low-rank training with
  client-local bases; aggregation reconstructs the full weight matrix and
  re-factorizes it with an ``n×n`` SVD, the cost FeDLRT's shared basis
  removes. For a single factorized layer (the paper's setting).
"""
from __future__ import annotations

import torch

from repro_torch.core import cost_model
from repro_torch.core.dlrt import qr_pos
from repro_torch.core.factorization import (
    AugmentedFactor,
    LowRankFactor,
    augmented_mask,
    mask_coeff,
    rank_mask,
)
from repro_torch.core.round import (
    SERVER,
    FedConfig,
    LossFn,
    RoundContext,
    first_step_batch,
    local_sgd_scan,
    run_round,
    value_and_grad,
    variance_correction,
)
from repro_torch.utils.tree import Cohort, unzip


# ---------------------------------------------------------------------------
# Algorithms 3 and 4: dense FedAvg / FedLin
# ---------------------------------------------------------------------------


class _DenseProgram:
    """Shared skeleton of the dense baselines; subclasses pick the
    correction (none for FedAvg, control-variate for FedLin)."""

    method: str = "fedavg"
    corrected: bool = False

    def broadcast(self, loss_fn: LossFn, params, client_batches, ctx: RoundContext):
        first = first_step_batch(client_batches, ctx.cfg)
        if self.corrected:
            losses, g_c = unzip(
                ctx.vmap_c(lambda p, b: value_and_grad(loss_fn, p, b), in_axes=(None, 0))(
                    params, first)
            )
            corr_c = variance_correction(ctx.aggregate(g_c), g_c)
        else:
            with torch.no_grad():
                losses = ctx.vmap_c(loss_fn, in_axes=(None, 0))(params, first)
            corr_c = None  # FedAvg sends no per-client correction
        shared = {"params0": params, SERVER: {"loss_before": ctx.aggregate(losses)}}
        return shared, corr_c

    def client_step(self, loss_fn, shared, corr, batches, ctx: RoundContext):
        p, _ = local_sgd_scan(loss_fn, shared["params0"], corr, batches, ctx.cfg)
        return p

    def aggregate(self, shared, client_out, ctx: RoundContext):
        return ctx.aggregate(client_out)

    def finalize(self, loss_fn, params, shared, agg, client_batches, ctx: RoundContext):
        new_params = agg
        metrics = {
            "loss_before": shared[SERVER]["loss_before"],
            "comm_bytes_per_client": float(
                cost_model.dense_round_comm_bytes(params, self.method)
            ),
        }
        if ctx.cfg.eval_after:
            first = first_step_batch(client_batches, ctx.cfg)
            with torch.no_grad():
                metrics["loss_after"] = ctx.aggregate(
                    ctx.vmap_c(loss_fn, in_axes=(None, 0))(new_params, first)
                )
        return new_params, metrics


class FedAvgProgram(_DenseProgram):
    """Algorithm 3: local SGD, aggregate by (weighted) averaging."""

    method = "fedavg"
    corrected = False


class FedLinProgram(_DenseProgram):
    """Algorithm 4: FedAvg + variance correction (Eq. (4)).
    Effective client gradient: ∇L_c(w) − ∇L_c(wᵗ) + ∇L(wᵗ)."""

    method = "fedlin"
    corrected = True


def fedavg_round(loss_fn: LossFn, params, client_batches, cfg: FedConfig, *,
                 round_idx: int = 0, client_weights=None, wire=None, spec_tree=None,
                 client_axes=None):
    """Algorithm 3: local SGD, aggregate by averaging. ``spec_tree`` /
    ``client_axes``: under a mesh, as in :func:`repro_torch.core.fedlrt.fedlrt_round`."""
    return run_round(FedAvgProgram(), loss_fn, params, client_batches, cfg,
                     round_idx=round_idx, client_weights=client_weights, wire=wire,
                     spec_tree=spec_tree, client_axes=client_axes)


def fedlin_round(loss_fn: LossFn, params, client_batches, cfg: FedConfig, *,
                 round_idx: int = 0, client_weights=None, wire=None, spec_tree=None,
                 client_axes=None):
    """Algorithm 4: FedAvg + variance correction (extra comm round).
    ``spec_tree`` / ``client_axes``: under a mesh, as in
    :func:`repro_torch.core.fedlrt.fedlrt_round`."""
    return run_round(FedLinProgram(), loss_fn, params, client_batches, cfg,
                     round_idx=round_idx, client_weights=client_weights, wire=wire,
                     spec_tree=spec_tree, client_axes=client_axes)


# ---------------------------------------------------------------------------
# Algorithm 6: naive per-client low-rank (client-local bases)
# ---------------------------------------------------------------------------


def _naive_client_round(loss_fn, f: LowRankFactor, batch, cfg: FedConfig):
    """One client's local basis augmentation + one coefficient step (Alg. 6)."""
    r_max = f.r_max
    _, g = value_and_grad(lambda p, b: loss_fn(p, b), f, batch)
    m = rank_mask(f.rank, r_max, dtype=f.U.dtype)
    U_t = qr_pos(torch.cat([f.U, g.U * m[None, :]], dim=1))
    V_t = qr_pos(torch.cat([f.V, g.V * m[None, :]], dim=1))
    S_t = torch.zeros((2 * r_max, 2 * r_max), dtype=f.S.dtype, device=f.S.device)
    S_t[:r_max, :r_max] = f.S
    amask = augmented_mask(f.rank, r_max, dtype=S_t.dtype)
    # Alg. 6 does one coefficient step per round
    aug = AugmentedFactor(U=U_t, S=S_t, V=V_t, rank=f.rank)
    _, ga = value_and_grad(lambda p, b: loss_fn(p, b), aug, batch)
    S_c = S_t - cfg.lr * mask_coeff(ga.S, amask)
    return U_t, S_c, V_t


class FedLRTNaiveProgram:
    """Algorithm 6 on a single factorized layer (the paper's setting).

    Per-client bases diverge, so the server reconstructs
    ``W* = mean_c Ũ_c S̃_c Ṽ_cᵀ`` and runs a full ``n×n`` SVD.
    """

    def broadcast(self, loss_fn, f: LowRankFactor, client_batches, ctx: RoundContext):
        with torch.no_grad():
            losses = ctx.vmap_c(lambda b: loss_fn(f, b))(client_batches)
        return {"f": f, SERVER: {"loss_before": ctx.aggregate(losses)}}, None

    def client_step(self, loss_fn, shared, _pc, batch, ctx: RoundContext):
        return _naive_client_round(loss_fn, shared["f"], batch, ctx.cfg)

    def aggregate(self, shared, client_out, ctx: RoundContext):
        U_c, S_c, V_c = unzip(client_out)
        return ctx.aggregate(Cohort(U @ S @ V.T for U, S, V in zip(U_c, S_c, V_c)))

    def finalize(self, loss_fn, f, shared, W_star, client_batches, ctx: RoundContext):
        cfg = ctx.cfg
        P, sigma, Qt = torch.linalg.svd(W_star, full_matrices=False)
        r_max = f.r_max
        tail = torch.flip(torch.cumsum(torch.flip(torch.square(sigma), [0]), 0), [0])
        theta = cfg.tau * torch.linalg.norm(sigma)
        ok = tail < torch.square(theta)
        r1 = torch.where(ok.any(), torch.argmax(ok.to(torch.int8)), sigma.shape[0])
        r1 = torch.clamp(r1, 1, r_max).to(torch.float32)
        keep = rank_mask(r1, r_max)
        # masking U/V is value-neutral (S's zero rows annihilate the junk
        # columns) but keeps the zero-inactive-columns layout literally true
        new_f = LowRankFactor(
            U=P[:, :r_max] * keep[None, :],
            S=torch.diag(sigma[:r_max] * keep),
            V=Qt[:r_max, :].T * keep[None, :],
            rank=r1,
        )
        metrics = {
            "loss_before": shared[SERVER]["loss_before"],
            "rank": new_f.rank,
            # Alg. 6 communicates augmented bases and coefficients per client
            "comm_bytes_per_client": float(
                4 * (
                    (f.n_in + f.n_out) * 2 * f.r_max
                    + (2 * f.r_max) ** 2
                    + (f.n_in + f.n_out) * f.r_max
                    + f.r_max**2
                )
            ),
        }
        if cfg.eval_after:
            with torch.no_grad():
                metrics["loss_after"] = ctx.aggregate(
                    ctx.vmap_c(lambda b: loss_fn(new_f, b))(client_batches)
                )
        return new_f, metrics


def fedlrt_naive_round(loss_fn: LossFn, f: LowRankFactor, client_batches, cfg: FedConfig, *,
                       round_idx: int = 0, client_weights=None, wire=None):
    """Algorithm 6 round (a :func:`run_round` wrapper)."""
    return run_round(FedLRTNaiveProgram(), loss_fn, f, client_batches, cfg,
                     round_idx=round_idx, client_weights=client_weights, wire=wire)
