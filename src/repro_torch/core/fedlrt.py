"""FeDLRT: one federated aggregation round (paper Algorithms 1 and 5), the
JAX package's ``repro.core.fedlrt`` in PyTorch.

The round is a :class:`~repro_torch.core.round.RoundProgram` over a
parameter tree whose leaves are either :class:`LowRankFactor` (FeDLRT-
managed weight matrices) or plain tensors (norm scales, biases: these get
FedLin-style full aggregation, which is cheap for O(n) objects).

Round structure (Alg. 1 / Alg. 5) mapped onto the phases:
  broadcast:
    1. broadcast {U,V,S}           → every client reads the same params
    2. client basis gradients      → ∇L_c at the shared point, per client
       server aggregate            → weighted mean over C   [comm: 2nr (+r²)]
    3. server basis augmentation   → CholeskyQR2 (dlrt.augment_basis)
       broadcast {Ū,V̄}            →                         [comm: 2nr]
    4. (full v/c only) aggregate augmented coefficient gradients  [comm: 4r²×2]
  client_step:
    5. client coefficient loop     → s* masked SGD steps on S̃
  aggregate:
    6. aggregate S̃* = mean_c S̃_c  → Eq. (10)               [comm: 4r²]
  finalize:
    7. truncation (2r×2r SVD)      → automatic compression
"""
from __future__ import annotations

import dataclasses
import torch

from repro_torch.core import cost_model
from repro_torch.core.dlrt import augment_basis, coeff_grad_mask, truncate
from repro_torch.core.factorization import (
    AugmentedFactor,
    LowRankFactor,
    is_factor,
    mask_coeff,
)
from repro_torch.core.round import (
    SERVER,
    FedConfig,
    LossFn,
    RoundContext,
    first_step_batch,
    grad,
    last_step_batch,
    local_sgd_scan,
    run_round,
    value_and_grad,
    variance_correction,
)
from repro_torch.utils.tree import Cohort, tree_map, tree_map_with_path, unzip

__all__ = ["FedConfig", "FedLRTProgram", "fedlrt_round", "make_fedlrt_step"]


# ---------------------------------------------------------------------------
# tree plumbing: factor leaves vs dense leaves
# ---------------------------------------------------------------------------


def _map_params(fn, params, *rest):
    """tree_map over params treating LowRankFactor/AugmentedFactor as leaves."""
    return tree_map(fn, params, *rest, is_leaf=is_factor)


def trainable_of(aug_params):
    """Per-client trainable view: S̃ for factor leaves, the tensor itself else."""
    return _map_params(lambda x: x.S if is_factor(x) else x, aug_params)


def merge_trainable(aug_params, trainable):
    """Inverse of :func:`trainable_of`."""
    return _map_params(
        lambda x, t: dataclasses.replace(x, S=t) if is_factor(x) else t,
        aug_params,
        trainable,
    )


def _mask_coeff_grads(aug_params, grads):
    """Restrict coefficient gradients to the paper's 2r active directions."""
    return _map_params(
        lambda x, g: mask_coeff(g, coeff_grad_mask(x)) if is_factor(x) else g,
        aug_params,
        grads,
    )


def _mask_trainable(aug_params, trainable):
    return _map_params(
        lambda x, t: mask_coeff(t, coeff_grad_mask(x)) if is_factor(x) else t,
        aug_params,
        trainable,
    )


def _coeff_drift(aug_params, trainable, trainable0) -> torch.Tensor:
    """‖S̃ − S̃⁰‖ over factor-coefficient leaves only."""
    sq = []
    _map_params(
        lambda x, a, b: sq.append(torch.sum(torch.square((a - b).float())))
        if is_factor(x) else None,
        aug_params, trainable, trainable0,
    )
    return torch.sqrt(sum(sq)) if sq else torch.zeros(())


def _coeff_grad_norm(params, g_global) -> torch.Tensor:
    """‖∇_S L‖ over all factor leaves (enters the Thm. 1/2 diagnostics)."""
    sq = []
    _map_params(
        lambda p, g: sq.append(torch.sum(torch.square(g.S.float())))
        if isinstance(p, LowRankFactor) else None,
        params, g_global,
    )
    return torch.sqrt(sum(sq)) if sq else torch.zeros(())


# ---------------------------------------------------------------------------
# the round program
# ---------------------------------------------------------------------------


class FedLRTProgram:
    """Algorithms 1 (full correction) / 5 (simplified) as a round program."""

    def broadcast(self, loss_fn: LossFn, params, client_batches, ctx: RoundContext):
        cfg = ctx.cfg
        first_batch = first_step_batch(client_batches, cfg)

        # -- 1/2: client basis (and coefficient) gradients at the shared point
        losses, per_client_g = unzip(
            ctx.vmap_c(lambda b: value_and_grad(loss_fn, params, b))(first_batch)
        )
        loss_before = ctx.aggregate(losses)
        g_global = ctx.aggregate(per_client_g)  # server aggregate

        # -- 3: server-side basis augmentation, Lemma-1 S̃ assembly -----------
        aug_params = _map_params(
            lambda p, g: augment_basis(p, g.U, g.V) if isinstance(p, LowRankFactor) else p,
            params,
            g_global,
        )
        trainable0 = trainable_of(aug_params)
        local_loss = self._local_loss(loss_fn, aug_params)

        # -- 4: variance correction term per client -------------------------
        # corr_c enters the update as S̃ ← S̃ − λ(∇L_c(S̃_c) + corr_c),
        # corr_c = G_S̃ − G_S̃,c (global minus own; paper Eq. (8)).
        if cfg.correction == "full":
            # extra communication round: ∇_S̃ L_c at the augmented point
            g0_c = ctx.vmap_c(lambda b: grad(local_loss, trainable0, b))(first_batch)
            corr_c = variance_correction(ctx.aggregate(g0_c), g0_c)
        elif cfg.correction == "simplified":
            # reuse the round's first gradients: ∇_S L padded into the
            # top-left block (Eq. (9)); dense leaves get the FedLin
            # correction from the same gradients. No extra communication.
            def simpl(p, gbar, gc):
                if isinstance(p, LowRankFactor):
                    r_max = p.r_max
                    block = torch.zeros(
                        gc.S.shape[:-2] + (2 * r_max, 2 * r_max),
                        dtype=gc.S.dtype, device=gc.S.device,
                    )
                    block[..., :r_max, :r_max] = gbar.S - gc.S
                    return block
                return gbar - gc

            corr_c = Cohort(
                tree_map(simpl, params, g_global, gc, is_leaf=is_factor)
                for gc in per_client_g
            )
        else:  # "none"
            corr_c = None  # uncorrected: nothing to send down per client

        shared = {
            "aug_params": aug_params,
            SERVER: {"g_global": g_global, "loss_before": loss_before},
        }
        return shared, corr_c

    @staticmethod
    def _local_loss(loss_fn, aug_params):
        def local_loss(trainable, batch):
            return loss_fn(merge_trainable(aug_params, trainable), batch)

        return local_loss

    def client_step(self, loss_fn, shared, corr, batches, ctx: RoundContext):
        # -- 5: client coefficient optimization (s* local steps) ------------
        cfg = ctx.cfg
        aug_params = shared["aug_params"]
        trainable0 = trainable_of(aug_params)
        drift_fn = (
            (lambda tr: _coeff_drift(aug_params, tr, trainable0))
            if cfg.track_drift
            else None
        )
        return local_sgd_scan(
            self._local_loss(loss_fn, aug_params),
            trainable0,
            corr,
            batches,
            cfg,
            transform_grads=lambda g: _mask_coeff_grads(aug_params, g),
            # keep the zero-padding invariant exact under momentum etc.
            project=lambda tr: _mask_trainable(aug_params, tr),
            drift_fn=drift_fn,
        )

    def aggregate(self, shared, client_out, ctx: RoundContext):
        # -- 6: aggregation  S̃* = mean_c S̃_c^{s*}  (Eq. (10)) ---------------
        trainable_c, drift_c = unzip(client_out)
        return ctx.aggregate(trainable_c), drift_c

    def finalize(self, loss_fn, params, shared, agg, client_batches, ctx: RoundContext):
        # -- 7: truncation (automatic compression) --------------------------
        cfg = ctx.cfg
        trainable_star, drift_c = agg
        merged = merge_trainable(shared["aug_params"], trainable_star)
        infos = {}

        def _truncate(path, x):
            if isinstance(x, AugmentedFactor):
                new_f, info = truncate(x, tau=cfg.tau)
                infos[path] = info
                return new_f
            return x

        new_params = tree_map_with_path(_truncate, merged, is_leaf=is_factor)
        metrics = {
            "loss_before": shared[SERVER]["loss_before"],
            "rank": {k: v["rank"] for k, v in infos.items()},
            "trunc_err": {k: v["trunc_err"] for k, v in infos.items()},
            "grad_norm_S": _coeff_grad_norm(params, shared[SERVER]["g_global"]),
            # static r_max bound …
            "comm_bytes_per_client": float(
                cost_model.fedlrt_round_comm_bytes(params, cfg.correction)
            ),
            # … and the effective-rank bytes of the post-truncation state,
            # the figure that shrinks as truncation adapts ranks
            "comm_bytes_per_client_effective": (
                cost_model.fedlrt_round_comm_bytes_effective(new_params, cfg.correction)
            ),
        }
        if cfg.track_drift:
            metrics["max_coeff_drift"] = torch.max(torch.stack(list(drift_c)))
        if cfg.eval_after:
            last_batch = last_step_batch(client_batches, cfg)
            with torch.no_grad():
                losses_after = ctx.vmap_c(lambda b: loss_fn(new_params, b))(last_batch)
            metrics["loss_after"] = ctx.aggregate(losses_after)
        return new_params, metrics


def fedlrt_round(loss_fn: LossFn, params, client_batches, cfg: FedConfig, *,
                 round_idx: int = 0, client_weights=None, wire=None):
    """One full FeDLRT aggregation round. Returns ``(new_params, metrics)``.

    ``client_batches`` leaves lead with the client axis ``C`` (``(C, s*,
    ...)`` if ``cfg.per_step_batches``). ``client_weights`` (optional,
    shape (C,)): aggregation weights ∝ |X_c| (the paper's §2 weighted
    average), applied to every aggregate of the round and normalized here.
    ``wire`` (optional :class:`repro_torch.fed.wire.Wire`): the codec for
    the round's payloads; the metrics then gain the measured
    ``wire_bytes_{down,up}_per_client``.
    """
    return run_round(
        FedLRTProgram(), loss_fn, params, client_batches, cfg,
        round_idx=round_idx, client_weights=client_weights, wire=wire,
    )


def make_fedlrt_step(loss_fn: LossFn, cfg: FedConfig):
    """``(params, client_batches, round_idx) → (params, metrics)``; the JAX
    package jits this step, PyTorch runs it eagerly."""

    def step(params, client_batches, round_idx):
        return fedlrt_round(loss_fn, params, client_batches, cfg, round_idx=round_idx)

    return step

