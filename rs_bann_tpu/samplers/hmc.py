"""Hamiltonian Monte Carlo for one branch, as compiled ``lax.scan`` loops.

Compiled rebuild of the reference's ``hmc_step`` / ``hmc_step_joint`` /
``gradient_descent`` (/root/reference/src/net/branch/branch_sampler.rs:
1192-1299, 1070-1178, 964-1016):

  * The leapfrog loop is a ``lax.scan`` over a static number of integration
    steps. The reference's mid-trajectory abort on Hamiltonian error
    (branch_sampler.rs:1264-1279) becomes a masked no-op continuation: once
    the |ΔH| threshold is crossed (or H goes NaN), the carried state freezes
    and the step is counted as RejectedEarly, restoring the initial state —
    observably identical, but jit-compatible.
  * Gradients come from ``jax.value_and_grad`` of the log density, which also
    yields U(q) and the branch prediction in the same fused forward pass —
    the reference pays an extra forward pass per step for its Hamiltonian
    check (branch_sampler.rs:905-909,1253).
  * Momentum is sampled masked so padded (ragged-width) coordinates never
    move.

Step-size modes (mcmc_cfg.rs:264-270 and per-branch impls):
  izmailov   ε = factor·π/(2√λ·L) per weight group (ridge/std_normal;
             ridge_base.rs:82-115); lasso uses factor/(4λL)
             (lasso_base.rs:84-117)
  std_scaled ε = factor/√λ (ridge_base.rs:52-80); extended elementwise to ARD
             (the reference left ARD unimplemented)
  random     ε ~ U(0,1)·factor·n_params^(-1/4) per coordinate
             (branch_sampler.rs:654-704)
  uniform    ε = factor (branch_sampler.rs:706-732)

Result codes: 0 = accepted, 1 = rejected at end, 2 = rejected early.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import density as D
from .mcmc_cfg import MCMCCfg

ACCEPTED, REJECTED, REJECTED_EARLY = 0, 1, 2


class HMCResult(NamedTuple):
    weights: tuple
    biases: tuple
    code: jax.Array  # int32, one of ACCEPTED/REJECTED/REJECTED_EARLY
    y_pred: jax.Array  # [n] prediction at the RETURNED params
    log_density: jax.Array  # -U at the returned params
    accept_prob: jax.Array  # Metropolis acceptance probability (0 if diverged)
    # first leapfrog step (1-based) where the trajectory u-turned
    # (Σ (q_t − q_0)·p_t < 0, the reference's net_movement diagnostic,
    # branch_sampler.rs:551-592), 0 if never within the integrated steps.
    # None for transitions that do not track it (joint HMC, GD).
    uturn_step: object = None


class HMCProposal(NamedTuple):
    """Raw HMC proposal with everything an EXTERNAL Metropolis test needs.

    The leapfrog map is reversible and volume-preserving for ANY smooth
    potential — the target density enters only the accept ratio. So the
    trajectory may integrate a STALE potential (e.g. a frozen-residual
    branch conditional, letting all branches integrate in parallel) while
    the accept runs later against the LIVE conditional:

        log α_g = [prior(θ') − λ_e·rss_live(θ')/2 − K(p')]
                − [prior(θ)  − λ_e·rss_live(θ)/2  − K(p)]

    This is exact random-scan Metropolis-within-Gibbs with stale-gradient
    proposals — unlike accepting against the stale target, which leaves
    the joint posterior non-invariant (measured bias: PARITY.json r2,
    'parallel' row before live-accept).
    """

    weights: tuple  # proposal θ' (frozen pre-divergence state when dead)
    biases: tuple
    y_pred_prop: jax.Array  # [n] branch prediction at θ'
    # [n] branch prediction at θ (the SAME prediction operator as
    # y_pred_prop). The live accept computes rss_old from this, NOT from
    # the bookkept snapshot prediction: under reduced-precision dots
    # (--bf16, --x-bf16) the transition's operator f̂ and the sweep's
    # D.predict operator differ by a state-dependent δ(θ) with λ·Σ e·δ up
    # to several log-units at n >= 1e5 — mixing operators inside one
    # accept ratio is a noisy-MH bias that measurably drifts the chain.
    # Using f̂ at BOTH endpoints makes the ratio exact for the f̂ model.
    y_pred0: jax.Array
    prior_prop: jax.Array  # marginal log-prior terms at θ'
    prior0: jax.Array  # ... at θ
    kin_prop: jax.Array  # K(p_final)
    kin0: jax.Array  # K(p_initial)
    dead: jax.Array  # bool: diverged (always reject)
    uturn_step: jax.Array


def _tree_mul_add(xs, eps, ps, frac=1.0):
    return tuple(x + frac * e * p for x, e, p in zip(xs, eps, ps))


def _kinetic(*momenta_trees):
    k = 0.0
    for tree in momenta_trees:
        for p in tree:
            k = k + jnp.sum(p * p)
    return 0.5 * k


def step_sizes(
    key,
    model_type: str,
    cfg: MCMCCfg,
    weights,
    biases,
    w_precisions,
    b_precisions,
    n_params,
    step_factor=None,
    mass_w=None,
    mass_b=None,
):
    """Per-coordinate leapfrog step sizes for (weights, biases).

    ``step_factor`` overrides the static cfg factor (may be a traced scalar —
    used by dual-averaging adaptation, which scales the izmailov shape).

    ``mass_w``/``mass_b`` (tuples of per-coordinate posterior-std estimates,
    same shapes as weights/biases) switch on the diagonal-mass-matrix form:
    leapfrog with unit momenta and per-coordinate ε_i = ε·σ̂_i is exactly
    equivalent to HMC with mass matrix M_ii = 1/σ̂_i² — the izmailov rule
    ε ∝ π/(2√λ·L) (ridge_base.rs:82-115) is the special case σ̂ = prior std,
    so this replaces the prior scale by the warmup-estimated posterior scale.
    """
    mode = cfg.hmc_step_size_mode
    factor = cfg.hmc_step_size_factor if step_factor is None else step_factor
    if mode == "dual_averaging":
        mode = "izmailov"
    L = cfg.hmc_integration_length
    if mass_w is not None:
        if mode == "std_scaled":
            scale = factor
        else:  # izmailov shape: ε_i = factor·(π/2L)·σ̂_i for every prior family
            scale = factor * math.pi / (2.0 * L)
        eps_w = tuple(scale * s for s in mass_w)
        eps_b = tuple(scale * s for s in mass_b)
        return eps_w, eps_b
    if mode == "uniform":
        eps_w = tuple(jnp.full(w.shape, factor) for w in weights)
        eps_b = tuple(jnp.full(b.shape, factor) for b in biases)
    elif mode == "random":
        prop = n_params ** (-0.25) * factor
        keys = jax.random.split(key, len(weights) + len(biases))
        eps_w = tuple(
            jax.random.uniform(k, w.shape) * prop for k, w in zip(keys, weights)
        )
        eps_b = tuple(
            jax.random.uniform(k, b.shape) * prop
            for k, b in zip(keys[len(weights) :], biases)
        )
    elif mode == "std_scaled":
        eps_w = tuple(
            jnp.broadcast_to(factor / jnp.sqrt(lam), w.shape)
            for w, lam in zip(weights, w_precisions)
        )
        eps_b = tuple(
            jnp.broadcast_to(factor / jnp.sqrt(lam), b.shape)
            for b, lam in zip(biases, b_precisions)
        )
    elif mode == "izmailov":
        if D.is_lasso(model_type):
            eps_w = tuple(
                jnp.broadcast_to(factor / (4.0 * lam * L), w.shape)
                for w, lam in zip(weights, w_precisions)
            )
        else:
            # the reference's std_normal izmailov ignores the factor
            # (std_normal_branch.rs:244-249); adaptation overrides that
            fac = 1.0 if (model_type == "std_normal" and step_factor is None) else factor
            eps_w = tuple(
                jnp.broadcast_to(fac * math.pi / (2.0 * jnp.sqrt(lam) * L), w.shape)
                for w, lam in zip(weights, w_precisions)
            )
        bias_fac = 1.0 if (model_type == "std_normal" and step_factor is None) else factor
        eps_b = tuple(
            jnp.broadcast_to(bias_fac * math.pi / (2.0 * jnp.sqrt(lam) * L), b.shape)
            for b, lam in zip(biases, b_precisions)
        )
    else:  # pragma: no cover
        raise ValueError(mode)
    return eps_w, eps_b


NUMERICAL_DELTA = 1e-3  # branch_sampler.rs:30


def flatten_wb(ws, bs):
    """Padded-flat vector: raveled weights per layer, then biases."""
    return jnp.concatenate(
        [w.reshape(-1) for w in ws] + [b.reshape(-1) for b in bs]
    )


def unflatten_wb(vec, like_w, like_b):
    ws, bs, ix = [], [], 0
    for w in like_w:
        ws.append(vec[ix : ix + w.size].reshape(w.shape))
        ix += w.size
    for b in like_b:
        bs.append(vec[ix : ix + b.size].reshape(b.shape))
        ix += b.size
    return tuple(ws), tuple(bs)


def make_hmc_step(
    model_type: str, act_name: str, cfg: MCMCCfg, freeze_output=False,
    defer_accept=False,
):
    """Build the jittable marginal HMC transition for one branch.

    Returned signature:
      hmc(key, weights, biases, w_precisions, b_precisions, error_precision,
          x, y, masks_w, masks_b, n_params[, step_factor, mass_w, mass_b,
          traj_len])
        -> HMCResult
    (-> (HMCResult, traj dict) when cfg.trajectories is set; traj holds
    per-leapfrog-step padded-flat params/ldg and the Hamiltonian series,
    trajectory.rs:4-43.)

    ``freeze_output`` pins the output-layer weights during the trajectory
    (zero step size AND zero momentum — the leapfrog provably leaves them
    untouched and they contribute no kinetic energy). Used by the
    spike-and-slab sweep, whose collapsed conjugate Gibbs move owns that
    layer.
    """
    L = cfg.hmc_integration_length
    max_err = cfg.hmc_max_hamiltonian_error
    record = cfg.trajectories
    # Lean leapfrog body for deferred-accept (parallel/hybrid live-accept)
    # transitions: the default body's per-step masked-freeze machinery (a
    # where-select over every carry leaf), u-turn statistic and Hamiltonian
    # series cost more memory traffic than the value-and-grad itself.
    # Divergence handling moves to the END of the trajectory: dead iff the
    # final |ΔH| > max_err or non-finite. Forced rejection on |ΔH| is
    # symmetric under trajectory reversal (ΔH' = -ΔH), so detailed balance
    # holds; the only behavioral change vs the masked-freeze body is that a
    # trajectory whose H spikes mid-way but recovers is no longer censored
    # (slightly HIGHER acceptance, still exact). u-turn tracking is only
    # needed by the uturn-adaptive trajectory-length mode, which keeps the
    # default body.
    lean_ok = (
        defer_accept
        and not record
        and not cfg.num_grad
        and not cfg.num_grad_traj
        and cfg.hmc_traj_length_mode == "fixed"
    )

    def potential(weights, biases, w_precisions, error_precision, x, y):
        _, acts = D.forward(act_name, weights, biases, x)
        y_pred = acts[-1][:, 0]
        r = y_pred - y
        rss = jnp.sum(r * r)
        prior = D.log_density_wrt_weights(
            model_type, weights, w_precisions
        ) + D.log_density_wrt_biases(model_type, biases)
        ld = prior - error_precision * rss / 2.0
        return ld, (y_pred, prior)

    vg_exact = jax.value_and_grad(potential, argnums=(0, 1), has_aux=True)

    def make_num_vg(masks_w, masks_b):
        """Forward finite differences, masked to true coordinates — the
        reference's numerical_ldg (branch_sampler.rs:480-504), vmapped over
        the perturbation basis instead of a host loop."""

        def num_ldg(weights, biases, w_precisions, error_precision, x, y, ld0):
            flat = flatten_wb(weights, biases)
            mask = flatten_wb(masks_w, masks_b)

            def one(e):
                ws, bs = unflatten_wb(flat + NUMERICAL_DELTA * e, weights, biases)
                ld_i, _ = potential(ws, bs, w_precisions, error_precision, x, y)
                return (ld_i - ld0) / NUMERICAL_DELTA

            basis = jnp.eye(flat.shape[0]) * mask[:, None]
            g_flat = jax.vmap(one)(basis) * mask
            return unflatten_wb(g_flat, weights, biases)

        def vg(weights, biases, w_precisions, error_precision, x, y):
            ld, aux = potential(weights, biases, w_precisions, error_precision, x, y)
            g = num_ldg(weights, biases, w_precisions, error_precision, x, y, ld)
            return (ld, aux), g

        return vg

    def hmc(
        key,
        weights,
        biases,
        w_precisions,
        b_precisions,
        error_precision,
        x,
        y,
        masks_w,
        masks_b,
        n_params,
        step_factor=None,
        mass_w=None,
        mass_b=None,
        traj_len=None,
        row_freeze=None,
    ):
        """``traj_len`` (traced int scalar, 1..L) truncates the trajectory to
        that many leapfrog steps by freezing the scan carry — the compiled
        program always runs L steps (static shapes), but the proposal is the
        state after ``traj_len`` steps. Drawn independently of the state by
        the sweep (randomized-length HMC / u-turn-adaptive mode), so detailed
        balance holds per drawn length."""
        vg = make_num_vg(masks_w, masks_b) if cfg.num_grad else vg_exact
        num_vg = make_num_vg(masks_w, masks_b) if cfg.num_grad_traj else None
        k_eps, k_mom, k_acc = jax.random.split(key, 3)
        eps_w, eps_b = step_sizes(
            k_eps, model_type, cfg, weights, biases, w_precisions, b_precisions,
            n_params, step_factor, mass_w, mass_b,
        )
        if freeze_output:
            eps_w = eps_w[:-1] + (jnp.zeros_like(eps_w[-1]),)
            masks_w = masks_w[:-1] + (jnp.zeros_like(masks_w[-1]),)
        if row_freeze is not None:
            # per-marker spike-and-slab: excluded layer-0 rows are pinned at
            # the spike (zero step size AND zero momentum — the leapfrog
            # provably leaves them at exactly 0); the collapsed conjugate
            # move owns their re-entry (models/net.py _marker_ss_scan)
            fr = row_freeze[:, None]
            # where, not multiply: an excluded row's PRIOR-drawn ARD
            # precision can be ~0, making its izmailov ε infinite — inf·0
            # is NaN and would poison the whole leapfrog
            eps_w = (jnp.where(fr > 0, eps_w[0], 0.0),) + eps_w[1:]
            masks_w = (masks_w[0] * fr,) + masks_w[1:]
        mkeys = jax.random.split(k_mom, len(weights) + len(biases))
        p_w = tuple(
            jax.random.normal(k, w.shape) * m
            for k, w, m in zip(mkeys, weights, masks_w)
        )
        p_b = tuple(
            jax.random.normal(k, b.shape) * m
            for k, b, m in zip(mkeys[len(weights) :], biases, masks_b)
        )

        (ld0, (y_pred0, prior0)), (g_w, g_b) = vg(
            weights, biases, w_precisions, error_precision, x, y
        )
        kin0 = _kinetic(p_w, p_b)
        neg_h0 = ld0 - kin0

        if lean_ok and traj_len is None:

            def lean_body(carry, _):
                w, b, pw, pb, gw, gb = carry
                pw = _tree_mul_add(pw, eps_w, gw, 0.5)
                pb = _tree_mul_add(pb, eps_b, gb, 0.5)
                w = _tree_mul_add(w, eps_w, pw)
                b = _tree_mul_add(b, eps_b, pb)
                (_, _), (gw, gb) = vg(
                    w, b, w_precisions, error_precision, x, y
                )
                pw = _tree_mul_add(pw, eps_w, gw, 0.5)
                pb = _tree_mul_add(pb, eps_b, gb, 0.5)
                return (w, b, pw, pb, gw, gb), None

            (w_f, b_f, pw_f, pb_f, _, _), _ = jax.lax.scan(
                lean_body, (weights, biases, p_w, p_b, g_w, g_b), None,
                length=L,
            )
            # final value through the SAME vg operator as the initial one
            # (an extra backward vs a value-only pass, ~1/(3L) of the
            # leapfrog cost) so y_pred0/y_pred_prop share the operator —
            # see the HMCProposal.y_pred0 note
            (ld_f, (yp_f, pri_f)), _ = vg(
                w_f, b_f, w_precisions, error_precision, x, y
            )
            kin_f = _kinetic(pw_f, pb_f)
            dead = ~(jnp.abs((ld_f - kin_f) - neg_h0) <= max_err)
            return HMCProposal(
                weights=w_f,
                biases=b_f,
                y_pred_prop=yp_f,
                y_pred0=y_pred0,
                prior_prop=pri_f,
                prior0=prior0,
                kin_prop=kin_f,
                kin0=kin0,
                dead=dead,
                uturn_step=jnp.zeros((), jnp.int32),
            )

        init = (
            weights, biases, p_w, p_b, g_w, g_b, ld0, y_pred0, prior0,
            jnp.asarray(False), jnp.asarray(False),
        )

        def body(carry, t):
            w, b, pw, pb, gw, gb, ld, yp, pri, dead, done = carry
            pw1 = _tree_mul_add(pw, eps_w, gw, 0.5)
            pb1 = _tree_mul_add(pb, eps_b, gb, 0.5)
            w1 = _tree_mul_add(w, eps_w, pw1)
            b1 = _tree_mul_add(b, eps_b, pb1)
            (ld1, (yp1, pri1)), (gw1, gb1) = vg(
                w1, b1, w_precisions, error_precision, x, y
            )
            pw1 = _tree_mul_add(pw1, eps_w, gw1, 0.5)
            pb1 = _tree_mul_add(pb1, eps_b, gb1, 0.5)
            neg_h = ld1 - _kinetic(pw1, pb1)
            # NaN-safe: NaN comparisons are False, so ~(|ΔH| <= max) catches NaN
            dead1 = dead | (~done & ~(jnp.abs(neg_h - neg_h0) <= max_err))
            frozen = dead1 | done
            keep = lambda old, new: jax.tree.map(
                lambda o, n: jnp.where(frozen, o, n), old, new
            )
            # u-turn statistic at the (possibly discarded) new point:
            # Σ (q_t − q_0)·p_t over true coordinates (p is 0 on padding)
            move = sum(
                jnp.sum((a1 - a0) * p1)
                for a1, a0, p1 in zip(w1 + b1, weights + biases, pw1 + pb1)
            )
            uturn_here = ~frozen & (move < 0.0)
            done1 = frozen if traj_len is None else (frozen | (t + 1 >= traj_len))
            new = (
                keep(w, w1),
                keep(b, b1),
                keep(pw, pw1),
                keep(pb, pb1),
                keep(gw, gw1),
                keep(gb, gb1),
                jnp.where(frozen, ld, ld1),
                jnp.where(frozen, yp, yp1),
                jnp.where(frozen, pri, pri1),
                dead1,
                done1,
            )
            if record:
                ys = {
                    "hamiltonian": neg_h,
                    "params": flatten_wb(w1, b1),
                    "ldg": flatten_wb(gw1, gb1),
                    "uturn": uturn_here,
                }
                if num_vg is not None:
                    _, (ngw, ngb) = num_vg(
                        w1, b1, w_precisions, error_precision, x, y
                    )
                    ys["num_ldg"] = flatten_wb(ngw, ngb)
            else:
                ys = {"hamiltonian": neg_h, "uturn": uturn_here}
            return new, ys

        (w_f, b_f, pw_f, pb_f, _, _, ld_f, yp_f, pri_f, dead, _), traj = (
            jax.lax.scan(body, init, jnp.arange(L))
        )
        uturn_flags = traj.pop("uturn")  # [L] bool
        uturn_step = jnp.where(
            jnp.any(uturn_flags), jnp.argmax(uturn_flags) + 1, 0
        ).astype(jnp.int32)

        if defer_accept:
            prop = HMCProposal(
                weights=w_f,
                biases=b_f,
                y_pred_prop=yp_f,
                y_pred0=y_pred0,
                prior_prop=pri_f,
                prior0=prior0,
                kin_prop=_kinetic(pw_f, pb_f),
                kin0=kin0,
                dead=dead,
                uturn_step=uturn_step,
            )
            if record:
                traj = dict(traj)
                traj["hamiltonian"] = jnp.concatenate(
                    [neg_h0[None], traj["hamiltonian"]]
                )
                return prop, traj
            return prop

        neg_h_f = ld_f - _kinetic(pw_f, pb_f)
        log_acc = neg_h_f - neg_h0
        u = jax.random.uniform(k_acc, ())
        # accepted iff not dead and u < exp(log_acc); NaN log_acc -> reject
        mh_ok = jnp.log(u) < log_acc
        accepted = ~dead & mh_ok
        code = jnp.where(dead, REJECTED_EARLY, jnp.where(mh_ok, ACCEPTED, REJECTED))
        sel = lambda new, old: jax.tree.map(
            lambda n, o: jnp.where(accepted, n, o), new, old
        )
        alpha = jnp.where(
            dead | jnp.isnan(log_acc), 0.0, jnp.minimum(1.0, jnp.exp(log_acc))
        )
        res = HMCResult(
            weights=sel(w_f, weights),
            biases=sel(b_f, biases),
            code=code.astype(jnp.int32),
            y_pred=jnp.where(accepted, yp_f, y_pred0),
            log_density=jnp.where(accepted, ld_f, ld0),
            accept_prob=alpha,
            uturn_step=uturn_step,
        )
        if record:
            traj = dict(traj)
            traj["hamiltonian"] = jnp.concatenate(
                [neg_h0[None], traj["hamiltonian"]]
            )
            return res, traj
        return res

    return hmc


def make_hmc_step_joint(
    model_type: str,
    act_name: str,
    cfg: MCMCCfg,
    sample_error: bool = True,
    sample_output: bool = True,
):
    """Joint HMC over params AND precisions (branch_sampler.rs:1070-1178).

    The reference always falls back to random step sizes for joint sampling
    (branch_sampler.rs:1094-1099); we do the same.

    ``sample_error`` / ``sample_output`` freeze the shared scalars (error
    precision, output-layer precision) as HMC coordinates — used by the
    parallel/hybrid schedules, where concurrent branch updates cannot each
    move a shared coordinate; the sweep draws those from their conjugate
    conditionals instead (a valid systematic-scan variant).

    Returned signature:
      hmc(key, weights, biases, w_prec, b_prec, err_prec, x, y, masks_w,
          masks_b, n_params, n_precisions, hyper, statics_g, reg_sum_others,
          n_out_global)
        -> (HMCResult, new_w_prec, new_b_prec, new_err_prec)
        (-> ((...), traj dict) when cfg.trajectories is set; traj adds the
         per-step flat precision vector next to params/ldg/hamiltonian,
         matching the reference's joint Trajectory, trajectory.rs:4-43.)
    """
    L = cfg.hmc_integration_length
    max_err = cfg.hmc_max_hamiltonian_error
    factor = cfg.hmc_step_size_factor
    record = cfg.trajectories

    def potential(wb, precs, x, y, hyper, statics_g, reg_sum_others, n_out_global):
        weights, biases = wb
        w_prec, b_prec, err_prec = precs
        _, acts = D.forward(act_name, weights, biases, x)
        y_pred = acts[-1][:, 0]
        r = y_pred - y
        rss = jnp.sum(r * r)
        ld = D.log_density_joint(
            model_type,
            weights,
            biases,
            w_prec,
            b_prec,
            err_prec,
            rss,
            hyper,
            statics_g,
            reg_sum_others,
            n_out_global,
            jnp.asarray(y.shape[0], jnp.float32),
        )
        return ld, y_pred

    vg = jax.value_and_grad(potential, argnums=(0, 1), has_aux=True)

    def hmc(
        key,
        weights,
        biases,
        w_prec,
        b_prec,
        err_prec,
        x,
        y,
        masks_w,
        masks_b,
        n_params,
        n_precisions,
        hyper,
        statics_g,
        reg_sum_others,
        n_out_global,
    ):
        k_eps, k_mom, k_acc = jax.random.split(key, 3)
        prop = (n_params + n_precisions) ** (-0.25) * factor
        q0 = (
            (weights, biases),
            (w_prec, b_prec, jnp.asarray(err_prec, jnp.float32)),
        )
        masks = (
            (masks_w, masks_b),
            (
                tuple(statics_g.row_masks[l] if w_prec[l].ndim == 2 and w_prec[l].shape[0] > 1 else jnp.ones_like(w_prec[l]) for l in range(len(w_prec))),
                tuple(jnp.ones_like(b) for b in b_prec),
                jnp.asarray(1.0),
            ),
        )
        # 1.0 = free coordinate, 0.0 = frozen (zero step size AND momentum:
        # the leapfrog then provably leaves the coordinate untouched)
        free = (
            (tuple(1.0 for _ in weights), tuple(1.0 for _ in biases)),
            (
                tuple(
                    1.0 if (l < len(w_prec) - 1 or sample_output) else 0.0
                    for l in range(len(w_prec))
                ),
                tuple(1.0 for _ in b_prec),
                1.0 if sample_error else 0.0,
            ),
        )
        leaves, treedef = jax.tree.flatten(q0)
        mask_leaves = jax.tree.leaves(masks)
        free_leaves = jax.tree.leaves(free)
        ekeys = jax.random.split(k_eps, len(leaves))
        mkeys = jax.random.split(k_mom, len(leaves))
        eps = [
            jax.random.uniform(k, l.shape) * prop * s
            for k, l, s in zip(ekeys, leaves, free_leaves)
        ]
        if not sample_output:
            # The Gibbs-refreshed shared output precision can be large, and
            # the random-mode ε (which the reference mandates for joint
            # sampling) does not shrink with it — the output-weight direction
            # then blows up the Hamiltonian. λ_out is FROZEN during the
            # trajectory here, so conditioning ε on it is exact (same
            # justification as the marginal izmailov rule, ridge_base.rs:82).
            lam_out = w_prec[-1].reshape(())
            if D.is_lasso(model_type):
                e_out = factor / (4.0 * lam_out * L)
            else:
                e_out = factor * math.pi / (2.0 * jnp.sqrt(lam_out) * L)
            out_ix = len(weights) - 1  # flatten order: weights leaves first
            eps[out_ix] = jnp.full_like(leaves[out_ix], jnp.minimum(e_out, prop))
        mom = [
            jax.random.normal(k, l.shape) * m * s
            for k, l, m, s in zip(mkeys, leaves, mask_leaves, free_leaves)
        ]

        def unflat(ls):
            return jax.tree.unflatten(treedef, ls)

        def vg_flat(ls):
            (ld, yp), g = vg(
                *unflat(ls), x, y, hyper, statics_g, reg_sum_others, n_out_global
            )
            return ld, yp, jax.tree.leaves(g)

        ld0, yp0, g0 = vg_flat(leaves)
        k0 = 0.5 * sum(jnp.sum(p * p) for p in mom)
        neg_h0 = ld0 - k0

        def body(carry, _):
            q, p, g, ld, yp, dead = carry
            p1 = [pi + 0.5 * e * gi for pi, e, gi in zip(p, eps, g)]
            q1 = [qi + e * pi for qi, e, pi in zip(q, eps, p1)]
            ld1, yp1, g1 = vg_flat(q1)
            p1 = [pi + 0.5 * e * gi for pi, e, gi in zip(p1, eps, g1)]
            neg_h = ld1 - 0.5 * sum(jnp.sum(pi * pi) for pi in p1)
            dead1 = dead | ~(jnp.abs(neg_h - neg_h0) <= max_err)
            w = lambda o, n: jnp.where(dead1, o, n)
            if record:
                (w1, b1), precs1 = unflat(q1)
                (gw1, gb1), _ = unflat(g1)
                ys = {
                    "hamiltonian": neg_h,
                    "params": flatten_wb(w1, b1),
                    "ldg": flatten_wb(gw1, gb1),
                    "precisions": jnp.concatenate(
                        [x.reshape(-1) for x in jax.tree.leaves(precs1)]
                    ),
                }
            else:
                ys = None
            return (
                [w(a, b) for a, b in zip(q, q1)],
                [w(a, b) for a, b in zip(p, p1)],
                [w(a, b) for a, b in zip(g, g1)],
                w(ld, ld1),
                w(yp, yp1),
                dead1,
            ), ys

        (q_f, p_f, _, ld_f, yp_f, dead), traj = jax.lax.scan(
            body, (leaves, mom, g0, ld0, yp0, jnp.asarray(False)), None, length=L
        )
        neg_h_f = ld_f - 0.5 * sum(jnp.sum(pi * pi) for pi in p_f)
        log_acc = neg_h_f - neg_h0
        mh_ok = jnp.log(jax.random.uniform(k_acc, ())) < log_acc
        accepted = ~dead & mh_ok
        code = jnp.where(dead, REJECTED_EARLY, jnp.where(mh_ok, ACCEPTED, REJECTED))
        sel = [jnp.where(accepted, n, o) for n, o in zip(q_f, leaves)]
        (w_new, b_new), (wp_new, bp_new, ep_new) = unflat(sel)
        res = HMCResult(
            weights=w_new,
            biases=b_new,
            code=code.astype(jnp.int32),
            y_pred=jnp.where(accepted, yp_f, yp0),
            log_density=jnp.where(accepted, ld_f, ld0),
            accept_prob=jnp.where(
                dead | jnp.isnan(log_acc), 0.0, jnp.minimum(1.0, jnp.exp(log_acc))
            ),
        )
        if record:
            traj = dict(traj)
            traj["hamiltonian"] = jnp.concatenate([neg_h0[None], traj["hamiltonian"]])
            return (res, wp_new, bp_new, ep_new), traj
        return res, wp_new, bp_new, ep_new

    return hmc


def make_gradient_descent(model_type: str, act_name: str, cfg: MCMCCfg):
    """MAP optimization replacing HMC (branch_sampler.rs:964-1016): per
    iteration, a doubling/halving line search on the rss along the log-density
    gradient direction, as a ``lax.while_loop``."""
    L = cfg.hmc_integration_length
    factor = cfg.hmc_step_size_factor

    def potential(weights, biases, w_precisions, error_precision, x, y):
        _, acts = D.forward(act_name, weights, biases, x)
        y_pred = acts[-1][:, 0]
        r = y_pred - y
        rss = jnp.sum(r * r)
        ld = D.log_density(
            model_type, weights, biases, w_precisions, error_precision, rss
        )
        return ld, (y_pred, rss)

    vg = jax.value_and_grad(potential, argnums=(0, 1), has_aux=True)

    def rss_at(weights, biases, x, y):
        _, acts = D.forward(act_name, weights, biases, x)
        r = acts[-1][:, 0] - y
        return jnp.sum(r * r)

    def gd(
        key,
        weights,
        biases,
        w_precisions,
        b_precisions,
        error_precision,
        x,
        y,
        masks_w,
        masks_b,
        n_params,
        step_factor=None,
    ):
        del key, b_precisions, n_params, step_factor

        def outer(carry, _):
            w, b = carry
            (_, _), (gw, gb) = vg(w, b, w_precisions, error_precision, x, y)

            def probe(ss):
                w1 = _tree_mul_add(w, [jnp.asarray(ss)] * len(gw), gw)
                b1 = _tree_mul_add(b, [jnp.asarray(ss)] * len(gb), gb)
                return rss_at(w1, b1, x, y)

            ss0 = jnp.asarray(factor)
            prev = probe(ss0)
            fac = jnp.where(probe(2.0 * ss0) < prev, 2.0, 0.5)
            ss = ss0 * fac
            curr = probe(ss)

            def cond(state):
                _, prev_r, curr_r = state
                return curr_r < prev_r

            def step(state):
                ss_i, _, curr_r = state
                ss_n = ss_i * fac
                return (ss_n, curr_r, probe(ss_n))

            ss_f, _, _ = jax.lax.while_loop(cond, step, (ss, prev, curr))
            ss_f = ss_f / fac
            w = _tree_mul_add(w, [ss_f] * len(gw), gw)
            b = _tree_mul_add(b, [ss_f] * len(gb), gb)
            return (w, b), None

        (w_f, b_f), _ = jax.lax.scan(outer, (weights, biases), None, length=L)
        (ld, (yp, _)), _ = vg(w_f, b_f, w_precisions, error_precision, x, y)
        return HMCResult(
            weights=w_f,
            biases=b_f,
            code=jnp.asarray(ACCEPTED, jnp.int32),
            y_pred=yp,
            log_density=ld,
            accept_prob=jnp.asarray(1.0),
        )

    return gd


def make_gradient_descent_joint(model_type: str, act_name: str, cfg: MCMCCfg):
    """Fixed-step gradient ascent on the JOINT density over params and
    precisions (branch_sampler.rs:1019-1066). Rejects (restoring the initial
    state) if the error precision goes non-positive.

    Signature matches make_hmc_step_joint.
    """
    L = cfg.hmc_integration_length
    factor = cfg.hmc_step_size_factor

    def potential(wb, precs, x, y, hyper, statics_g, reg_sum_others, n_out_global):
        weights, biases = wb
        w_prec, b_prec, err_prec = precs
        _, acts = D.forward(act_name, weights, biases, x)
        y_pred = acts[-1][:, 0]
        r = y_pred - y
        rss = jnp.sum(r * r)
        ld = D.log_density_joint(
            model_type, weights, biases, w_prec, b_prec, err_prec, rss,
            hyper, statics_g, reg_sum_others, n_out_global,
            jnp.asarray(y.shape[0], jnp.float32),
        )
        return ld, y_pred

    vg = jax.value_and_grad(potential, argnums=(0, 1), has_aux=True)

    def gd(
        key, weights, biases, w_prec, b_prec, err_prec, x, y,
        masks_w, masks_b, n_params, n_precisions, hyper, statics_g,
        reg_sum_others, n_out_global,
    ):
        del key, n_params, n_precisions
        q0 = ((weights, biases), (w_prec, b_prec, jnp.asarray(err_prec, jnp.float32)))

        def step(q, _):
            (ld, yp), g = vg(*q, x, y, hyper, statics_g, reg_sum_others, n_out_global)
            q = jax.tree.map(lambda a, da: a + factor * da, q, g)
            return q, None

        q_f, _ = jax.lax.scan(step, q0, None, length=L)
        (ld, yp), _ = vg(*q_f, x, y, hyper, statics_g, reg_sum_others, n_out_global)
        (w_f, b_f), (wp_f, bp_f, ep_f) = q_f
        ok = ep_f > 0.0
        sel = lambda new, old: jax.tree.map(lambda a, b: jnp.where(ok, a, b), new, old)
        res = HMCResult(
            weights=sel(w_f, weights),
            biases=sel(b_f, biases),
            code=jnp.where(ok, ACCEPTED, REJECTED).astype(jnp.int32),
            y_pred=jnp.where(ok, yp, D.predict(act_name, weights, biases, x)),
            log_density=ld,
            accept_prob=jnp.where(ok, 1.0, 0.0),
        )
        return res, sel(wp_f, w_prec), sel(bp_f, b_prec), jnp.where(ok, ep_f, err_prec)

    return gd
