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

Under a mesh (``spec_tree``, ``client_axes``) the per-client gradients, the
augmented factors and the truncated ones are pinned to the parameters'
layout (:func:`_constrain_clientwise`, :func:`_constrain_factor`), as the
JAX package pins them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import cost_model
from repro_torch.core.dlrt import augment_basis, coeff_grad_mask, truncate
from repro_torch.core.factorization import (
    AugmentedFactor,
    LowRankFactor,
    is_factor,
    mask_coeff,
    pad_coeff,
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
from repro_torch.utils import meshctx
from repro_torch.utils.meshctx import P
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


def _constrain_factor(x, spec):
    """Re-pin U/V's tensor-parallel sharding on augmented and truncated
    factors. The rank dim widens r → 2r through augmentation but the spec
    (which shards only the feature dim) still applies."""
    if spec is None or not is_factor(x):
        return x
    return dataclasses.replace(
        x, U=meshctx.constrain(x.U, spec.U), V=meshctx.constrain(x.V, spec.V)
    )


def _constrain_clientwise(cohort, ctx: RoundContext):
    """Pin each client's tree to the parameters' specs. The JAX package pins
    the stacked (C, …) tree to ``P(client_axes, *spec)``; here the client
    axis is the rank's own slice of the cohort, so each client's tree takes
    the spec itself."""
    if ctx.spec_tree is None or ctx.client_axes is None:
        return cohort

    def one(g, s):
        if is_factor(g):
            return tree_map(meshctx.constrain, g, s, is_leaf=meshctx.is_spec)
        return meshctx.constrain(g, s)

    return Cohort(_map_params(one, tree, ctx.spec_tree) for tree in cohort)


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
            ctx.vmap_c(lambda p, b: value_and_grad(loss_fn, p, b), in_axes=(None, 0))(
                params, first_batch)
        )
        per_client_g = _constrain_clientwise(per_client_g, ctx)
        loss_before = ctx.aggregate(losses)
        g_global = ctx.aggregate(per_client_g)  # server aggregate

        # -- 3: server-side basis augmentation, Lemma-1 S̃ assembly -----------
        def _augment(p, g, spec=None):
            if isinstance(p, LowRankFactor):
                u_spec = spec.U if spec is not None and is_factor(spec) else None
                v_spec = spec.V if spec is not None and is_factor(spec) else None
                return augment_basis(p, g.U, g.V, u_spec=u_spec, v_spec=v_spec)
            return p

        if ctx.spec_tree is not None:
            aug_params = _map_params(_augment, params, g_global, ctx.spec_tree)
            if cfg.replicate_augmented:
                repl = tree_map(lambda s: P(), ctx.spec_tree, is_leaf=meshctx.is_spec)
                aug_params = _map_params(_constrain_factor, aug_params, repl)
            else:
                aug_params = _map_params(_constrain_factor, aug_params, ctx.spec_tree)
        else:
            aug_params = _map_params(_augment, params, g_global)
        trainable0 = trainable_of(aug_params)
        local_loss = self._local_loss(loss_fn, aug_params)

        # -- 4: variance correction term per client -------------------------
        # corr_c enters the update as S̃ ← S̃ − λ(∇L_c(S̃_c) + corr_c),
        # corr_c = G_S̃ − G_S̃,c (global minus own; paper Eq. (8)).
        if cfg.correction == "full":
            # extra communication round: ∇_S̃ L_c at the augmented point
            g0_c = ctx.vmap_c(
                lambda a, t, b: grad(self._local_loss(loss_fn, a), t, b), in_axes=(None, None, 0)
            )(aug_params, trainable0, first_batch)
            corr_c = variance_correction(ctx.aggregate(g0_c), g0_c)
        elif cfg.correction == "simplified":
            # reuse the round's first gradients: ∇_S L padded into the
            # top-left block (Eq. (9)); dense leaves get the FedLin
            # correction from the same gradients. No extra communication.
            def simpl(p, gbar, gc):
                if isinstance(p, LowRankFactor):
                    r_max = p.r_max
                    if isinstance(gc.S, DTensor):  # the same zero padding
                        return pad_coeff(gbar.S - gc.S, r_max)
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

        # the server keeps ‖∇_S L‖ for the round's metrics, not the
        # aggregate gradient: its bases (the model's bases again, in f32)
        # would stay on the card through every client's steps
        shared = {
            "aug_params": aug_params,
            SERVER: {"grad_norm_S": _coeff_grad_norm(params, g_global),
                     "loss_before": loss_before},
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
        if ctx.spec_tree is not None:
            new_params = _map_params(_constrain_factor, new_params, ctx.spec_tree)
        metrics = {
            "loss_before": shared[SERVER]["loss_before"],
            "rank": {k: v["rank"] for k, v in infos.items()},
            "trunc_err": {k: v["trunc_err"] for k, v in infos.items()},
            "grad_norm_S": shared[SERVER]["grad_norm_S"],
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
            metrics["max_coeff_drift"] = (
                ctx.reduce_max(drift_c) if ctx.reduce_max is not None
                else torch.max(torch.stack(list(drift_c)))
            )
        if cfg.eval_after:
            last_batch = last_step_batch(client_batches, cfg)
            with torch.no_grad():
                losses_after = ctx.vmap_c(loss_fn, in_axes=(None, 0))(new_params, last_batch)
            metrics["loss_after"] = ctx.aggregate(losses_after)
        return new_params, metrics


def fedlrt_round(loss_fn: LossFn, params, client_batches, cfg: FedConfig, *,
                 round_idx: int = 0, spec_tree=None, client_axes=None,
                 client_weights=None, wire=None):
    """One full FeDLRT aggregation round. Returns ``(new_params, metrics)``.

    ``client_batches`` leaves lead with the client axis ``C`` (``(C, s*,
    ...)`` if ``cfg.per_step_batches``). ``client_weights`` (optional,
    shape (C,)): aggregation weights ∝ |X_c| (the paper's §2 weighted
    average), applied to every aggregate of the round and normalized here.
    ``wire`` (optional :class:`repro_torch.fed.wire.Wire`): the codec for
    the round's payloads; the metrics then gain the measured
    ``wire_bytes_{down,up}_per_client``.

    ``spec_tree`` (the parameters' spec tree, under a mesh) keeps the
    augmented and truncated factors on their tensor-parallel layout;
    ``client_axes`` names the mesh axes of the client dim: each rank then
    runs its slice of the cohort and the aggregates all-reduce over those
    axes (:func:`repro_torch.core.round.make_context`). ``params`` are then
    DTensors laid out by ``spec_tree``.
    """
    return run_round(
        FedLRTProgram(), loss_fn, params, client_batches, cfg,
        round_idx=round_idx, client_weights=client_weights, wire=wire,
        spec_tree=spec_tree, client_axes=client_axes,
    )


def make_fedlrt_step(loss_fn: LossFn, cfg: FedConfig):
    """``(params, client_batches, round_idx) → (params, metrics)``; the JAX
    package jits this step, PyTorch runs it eagerly."""

    def step(params, client_batches, round_idx):
        return fedlrt_round(loss_fn, params, client_batches, cfg, round_idx=round_idx)

    return step

