"""The block net: grouped branch networks + blocked Gibbs-within-MCMC training.

Compiled rebuild of the reference's ``Net<B>`` (reference src/net/
net.rs:76-702). The reference drives a host-side loop per branch per
iteration, round-tripping parameters between host and device at every update
(branch_struct.rs:12-29, branch_sampler.rs:155-171). Here the entire Gibbs
sweep over branches — precision Gibbs draws, HMC trajectories, residual
bookkeeping, output-bias update — is ONE compiled XLA program:

  * ``update_mode="sequential"``: a ``lax.scan`` over a freshly shuffled
    branch order per sweep; exact random-scan Gibbs semantics of the
    reference (net.rs:251-334), including immediate propagation of the shared
    error precision, output-layer precision and output-weight summary
    statistic between consecutive branch updates.
  * ``update_mode="parallel"``: a block systematic-scan variant — every
    branch runs HMC against the residual snapshot y − bias − Σ_{g'≠g} pred_g'
    from the start of the sweep, and the shared scalars are Gibbs-updated
    once per sweep. Branches become embarrassingly parallel (vmap) and shard
    across a device mesh. Tests validate this statistically against the
    sequential mode.

Multiple chains are a leading vmap axis over the whole sweep.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..samplers import gibbs
from ..samplers.hmc import (
    HMCResult,
    make_gradient_descent,
    make_gradient_descent_joint,
    make_hmc_step,
    make_hmc_step_joint,
)
from ..samplers.mcmc_cfg import MCMCCfg
from . import density as D
from . import params as P
from .arch import NetArch
from .params import NetState, StackedParams, StackedPrecisions

_HIGHEST = D._HIGHEST  # f32 dots at full f32 precision (models/density.py)


class TrainCarry(NamedTuple):
    state: NetState
    residual: jax.Array  # [n]
    lpd_local: jax.Array  # [G]
    lpd_out: jax.Array
    lpd_rss: jax.Array
    counts: jax.Array  # [3] int32: accepted / rejected / rejected-early
    key: jax.Array
    # dual-averaging step-size adaptation state (Hoffman & Gelman 2014),
    # per branch; inert unless hmc_step_size_mode == "dual_averaging"
    da_log_eps: jax.Array  # [G]
    da_log_eps_bar: jax.Array  # [G]
    da_h_bar: jax.Array  # [G]
    da_t: jax.Array  # scalar sweep counter
    # diagonal-mass-matrix adaptation state (cfg.mass_adaptation): Welford
    # mean/M2 of the padded-flat branch params over warmup sweeps; [G, 0]
    # placeholders when the feature is off so the pytree stays uniform
    mm_mean: jax.Array  # [G, P_flat]
    mm_m2: jax.Array  # [G, P_flat]
    # inverse temperature of this chain slot (cfg.tempering): the sweep
    # targets p(θ)·L(θ)^β — β scales the error precision seen by HMC and
    # the (rss, n) evidence of the error-precision / output-bias Gibbs
    # draws. Always 1.0 when tempering is off.
    beta: jax.Array  # scalar
    # per-branch nominal trajectory length (cfg.hmc_traj_length_mode ==
    # "uturn"): running estimate of the first-u-turn step, adapted during
    # warmup; 0.0 = uninitialized (treated as the full integration length)
    tl_avg: jax.Array  # [G]
    # spike-and-slab state (cfg.spike_slab): current inclusion indicators,
    # the (possibly Gibbs-updated) prior inclusion probability π, and the
    # post-burn-in running mean of z (posterior inclusion probabilities)
    ss_z: jax.Array  # [G] float32 in {0, 1}
    ss_pi: jax.Array  # scalar
    ss_pip: jax.Array  # [G]
    # per-marker spike-and-slab state (cfg.ss_markers): layer-0 row
    # inclusion indicators, the marker-level prior inclusion probability,
    # and the post-burn-in running mean of z_m; [G, 0] placeholders when
    # the feature is off so the pytree stays uniform
    ssm_z: jax.Array = ()  # [G, m_pad] float32 in {0, 1}
    ssm_pi: jax.Array = ()  # scalar
    ssm_pip: jax.Array = ()  # [G, m_pad]


# dual-averaging constants (Hoffman & Gelman 2014, NUTS paper defaults)
_DA_GAMMA, _DA_T0, _DA_KAPPA = 0.05, 10.0, 0.75

# pseudo-observations shrinking the Welford variance toward the prior
# variance (Stan's windowed-adaptation regularization, retargeted at the
# prior scale so count=0 exactly reproduces the izmailov rule)
_MASS_SHRINK = 5.0


def _da_update(cfg, t, h_bar, log_eps_bar, alpha, mu):
    """One dual-averaging update; returns (h_bar, log_eps, log_eps_bar)."""
    eta = 1.0 / (t + _DA_T0)
    h_bar = (1.0 - eta) * h_bar + eta * (cfg.target_accept - alpha)
    log_eps = mu - jnp.sqrt(t) / _DA_GAMMA * h_bar
    w = t ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return h_bar, log_eps, log_eps_bar


def _prior_var_trees(model_type, wp_g, bp_g, w_like, b_like):
    """Per-coordinate prior variances (the mass-estimate shrinkage target):
    ridge N(0, 1/λ) -> 1/λ; lasso Laplace(λ) -> 2/λ²; biases always ridge."""
    if D.is_lasso(model_type):
        var_w = tuple(
            jnp.broadcast_to(2.0 / (lam * lam), w.shape)
            for w, lam in zip(w_like, wp_g)
        )
    else:
        var_w = tuple(
            jnp.broadcast_to(1.0 / lam, w.shape) for w, lam in zip(w_like, wp_g)
        )
    var_b = tuple(
        jnp.broadcast_to(1.0 / lam, b.shape) for b, lam in zip(b_like, bp_g)
    )
    return var_w, var_b


def _mass_std(model_type, mean_g, m2_g, count, wp_g, bp_g, w_like, b_like):
    """Per-coordinate posterior-std estimate for one branch: the Welford
    variance over warmup states, shrunk toward the current prior variance."""
    from ..samplers.hmc import unflatten_wb

    emp_var = m2_g / jnp.maximum(count - 1.0, 1.0)
    ew, eb = unflatten_wb(emp_var, w_like, b_like)
    pw, pb = _prior_var_trees(model_type, wp_g, bp_g, w_like, b_like)
    wgt = count / (count + _MASS_SHRINK)
    mass_w = tuple(jnp.sqrt(wgt * e + (1.0 - wgt) * p) for e, p in zip(ew, pw))
    mass_b = tuple(jnp.sqrt(wgt * e + (1.0 - wgt) * p) for e, p in zip(eb, pb))
    return mass_w, mass_b


def _draw_traj_len(key, tl_avg, L: int, mode: str):
    """Per-branch leapfrog-step count for this update (any tl_avg shape).

    jittered: l ~ U{1..L}. uturn: l ~ U{⌈nom/2⌉..nom} around the adapted
    nominal length (0.0 sentinel = not yet adapted → the full L)."""
    if mode == "jittered":
        return jax.random.randint(key, tl_avg.shape, 1, L + 1)
    nom = jnp.clip(jnp.round(jnp.where(tl_avg > 0.0, tl_avg, float(L))), 1.0, float(L))
    lo = jnp.ceil(0.5 * nom)
    u = jax.random.uniform(key, tl_avg.shape)
    return (lo + jnp.floor(u * (nom - lo + 1.0))).astype(jnp.int32)


_TL_EMA = 0.1  # u-turn length adaptation rate


def _tl_update(tl, uturn_step, drawn, code, warm, L: int):
    """EMA update of the nominal trajectory length from one observation:
    the first-u-turn step if one occurred within the ``drawn`` integrated
    steps, else min(2·drawn, L) (the u-turn lies beyond what we integrated —
    push the estimate up). Divergent trajectories (code 2) are skipped.
    Elementwise over any shape."""
    seen = uturn_step > 0
    obs = jnp.where(seen, uturn_step, jnp.minimum(2 * drawn, L)).astype(jnp.float32)
    ok = warm & (code != 2)
    fresh = tl <= 0.0
    new = jnp.where(fresh, obs, (1.0 - _TL_EMA) * tl + _TL_EMA * obs)
    return jnp.where(ok, new, tl)


def _spike_slab_update(key, A, target, lam_e, lam_out, pi, out_mask,
                       force_include=False):
    """Collapsed conjugate Gibbs move for one branch's (z, w_out).

    Given the summary activations A [n, s_pad] and the branch target
    r = residual + old branch prediction, the output layer is linear-
    Gaussian: r ~ N(A w, λ_e⁻¹ I) with slab prior w ~ N(0, λ_out⁻¹ I).
    The marginal-likelihood Bayes factor of slab vs spike (w = 0) is

        log BF = ½(s·log λ_out − log det M) + ½ uᵀu,
        M = λ_out I + λ_e AᵀA,  L Lᵀ = M,  L u = λ_e Aᵀ r

    and w | z=1 ~ N(μ, M⁻¹) with μ = Lᵀ⁻¹ u. Padded columns of A are
    exactly zero, making M block-diagonal between live and padded
    coordinates — the padded block contributes 0 to log BF and is masked
    out of the draw, so padding invariance is exact.

    Returns (z [float {0,1}], w_new [s_pad, 1], log_bf).
    """
    s_pad = A.shape[1]
    k_z, k_w = jax.random.split(key)
    AtA = jax.lax.dot_general(
        A, A, (((0,), (0,)), ((), ())), precision=_HIGHEST,
        preferred_element_type=jnp.float32,
    )
    At_r = jnp.dot(A.T, target, precision=_HIGHEST)  # [s_pad]
    M = lam_out * jnp.eye(s_pad) + lam_e * AtA
    L = jnp.linalg.cholesky(M)
    u = jax.scipy.linalg.solve_triangular(L, lam_e * At_r, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    log_bf = 0.5 * (s_pad * jnp.log(lam_out) - logdet) + 0.5 * jnp.dot(u, u)
    logit = jnp.log(pi) - jnp.log1p(-pi) + log_bf
    z = jax.random.bernoulli(k_z, jax.nn.sigmoid(logit)).astype(jnp.float32)
    # ss_warmup: keep the branch in (the w draw below is then an ordinary
    # conjugate Gibbs move on the output layer, unconditionally valid)
    z = jnp.where(force_include, 1.0, z)
    mu = jax.scipy.linalg.solve_triangular(L.T, u, lower=False)
    xi = jax.random.normal(k_w, (s_pad,))
    w = mu + jax.scipy.linalg.solve_triangular(L.T, xi, lower=False)
    # where (not multiply): the spike must stay exactly 0 even if the slab
    # draw is non-finite (0 * nan = nan)
    w_new = jnp.where(z > 0.0, w, 0.0)[:, None] * out_mask
    return z, w_new, log_bf


def _marker_ss_scan(
    key, x_g, W0, b0, w_out_col, resid0, lam_e, lam_rows, pi_m, row_mask,
    col_mask0, force_include, lasso=False,
):
    """Sequential collapsed conjugate Gibbs over one branch's layer-0 rows
    (markers), for identity-activation depth-0 branches (cfg.ss_markers).

    The branch output is pred = X (W0 w) + b0·w with w = w_out, so row
    W0[j] enters the likelihood only through its component a_j along
    ŵ = w/|w| (effective marker effect β_j = a_j·|w|). Per marker, in a
    fresh random order against a LIVE residual, with a Gaussian slab
    N(0, diag(1/η_j)) per row:

      * collapse a_j: prior var v_a = ŵᵀdiag(1/η_j)ŵ, λ_a = 1/v_a
          q_a = λ_a + λ_e·(x_jᵀx_j)·|w|²,  u = x_jᵀ e_{-j}
          log BF = ½ log(λ_a/q_a) + ½ (λ_e|w|u)²/q_a
      * z_j ~ Bern(σ(logit π_m + log BF))
      * slab row: a_j ~ N(λ_e|w|u/q_a, 1/q_a), then row | a_j from the
        conditional of N(0, diag(1/η_j)) given ŵᵀrow = a_j
        (= (Dŵ/v_a)·a_j + ξ − Dŵ(ŵᵀξ)/v_a, ξ ~ N(0, D)); spike: 0.

    Slab precisions η_j:

      * ridge / std_normal: isotropic η_jk = λ_j (the ARD row precision /
        unit), recovering the N(0, λ_j^{-1} I) slab exactly.
      * lasso (``lasso=True``): the row prior is Laplace(rate λ_j), not
        Gaussian — the conjugate move comes from the Park & Casella (2008)
        scale-mixture augmentation: w|s ~ N(0, s), s ~ Exp(λ_j²/2) has the
        Laplace marginal, so per sweep η_jk is drawn from its conditional
        1/s | w ~ InvGauss(λ_j/|w_jk|, λ_j²) (prior Exp draw where
        w_jk = 0), and the collapsed move above runs on the conditionally
        Gaussian slab. η is redrawn fresh each sweep (never carried), so
        composing with the Laplace-gradient HMC afterwards is valid.

    ``x_g`` is dense [n, m_pad] or a PackedX slice (columns decode on the
    fly). Note (ADVICE r4): since the blocked rewrite, the packed path's
    q_a uses the data-computed Gram diagonal gram[t,t] = x_jᵀx_j — the
    pre-r4 packed code pinned sxx to exactly n for standardized columns.
    gram[t,t] is the true sum of squares (the dense path always used it),
    so this is the correct kernel, but packed-path draws for a given seed
    differ from r3 runs; the sequential-replica exactness test covers both
    dense AND packed x_g. ``resid0`` is the branch's residual
    y − bias − Σ_g' pred_g' at
    the CURRENT params (callers already hold it — the scan starts from it
    instead of re-running the branch forward pass). Returns
    (z [m_pad], W0_new, e_final) with e_final the live residual at the
    updated W0 (exact by construction).
    """
    m_pad, s_pad = W0.shape
    w = w_out_col[:, 0]  # [s_pad]
    wn2 = jnp.dot(w, w)
    wn2_safe = jnp.maximum(wn2, 1e-30)
    wnorm = jnp.sqrt(wn2_safe)
    what = w / wnorm

    key, k_eta = jax.random.split(key)
    # per-element slab precisions [m_pad, s_pad]; floors/clips protect
    # against underflowed draws (see the prior-draw clip in
    # _gibbs_local_precisions)
    if lasso:
        rate = jnp.maximum(lam_rows, 1e-6)[:, None]  # Laplace rate λ_j
        k_ig, k_ex = jax.random.split(k_eta)
        eta_w = gibbs.inverse_gaussian(
            k_ig, rate / jnp.maximum(jnp.abs(W0), 1e-12), rate * rate
        )
        s_prior = jax.random.exponential(k_ex, W0.shape) / (rate * rate / 2.0)
        eta = jnp.where(jnp.abs(W0) > 0, eta_w, 1.0 / s_prior)
    else:
        eta = jnp.broadcast_to(
            jnp.maximum(lam_rows, 1e-6)[:, None], (m_pad, s_pad)
        )
    eta = jnp.clip(eta, 1e-6, 1e12)

    packed = isinstance(x_g, D.PackedX)
    if packed:
        from ..ops.packed_matmul import unpack_strided

        n = x_g.n

    e0 = resid0
    k_perm, k_scan = jax.random.split(key)
    order = jax.random.permutation(k_perm, m_pad)

    # Blocked execution of the SAME random scan (VERDICT r3 #4): the
    # permuted order is processed in blocks of kb markers. Within a block
    # the sequential dependence runs in COEFFICIENT space — maintain
    # u_vec = X_Jᵀe and the block Gram matrix X_J X_Jᵀ, so each marker's
    # update touches kb-vectors instead of the length-n residual; the
    # residual itself updates once per block (e −= Δβᵀ X_J). Exactly the
    # marker-by-marker kernel (same order, same per-marker keys, same
    # draws), with the n-length traffic per marker cut ~kb-fold — the
    # sequential rank-1 scan dominated ssm wall clock at UKB scale
    # (2,392 s vs 1,207 s for branch-SS at equal chains).
    kb = next(k for k in (16, 8, 4, 2, 1) if m_pad % k == 0)
    blocks = order.reshape(m_pad // kb, kb)

    def marker_move(t, j, u_j_mj, sxx_j, row):
        """One marker's collapsed (z_j, row) draw given u_j = x_jᵀe_{−j}."""
        kj = jax.random.fold_in(k_scan, j)
        k_z, k_a, k_o = jax.random.split(kj, 3)
        d_j = col_mask0 / eta[j]  # slab variances (0 on padded columns)
        dw = d_j * what
        v_a = jnp.maximum(jnp.dot(what, dw), 1e-30)  # prior var of a_j
        lam_a = 1.0 / v_a
        q_a = lam_a + lam_e * sxx_j * wn2
        log_bf = (
            0.5 * jnp.log(lam_a / q_a)
            + 0.5 * (lam_e * wnorm * u_j_mj) ** 2 / q_a
        )
        logit = jnp.log(pi_m) - jnp.log1p(-pi_m) + log_bf
        zj = jnp.where(
            force_include,
            1.0,
            jax.random.bernoulli(k_z, jax.nn.sigmoid(logit)).astype(jnp.float32),
        )
        zj = zj * row_mask[j]  # padded markers never enter
        a = lam_e * wnorm * u_j_mj / q_a + jax.random.normal(k_a, ()) / jnp.sqrt(q_a)
        xi = jax.random.normal(k_o, row.shape) * jnp.sqrt(d_j)
        xi = xi - dw * (jnp.dot(xi, what) / v_a)
        new_row = jnp.where(zj > 0, (dw / v_a) * a + xi, 0.0)
        return zj, new_row

    def block_body(carry, J):
        e, W0_c, z_c = carry
        if packed:
            raw = unpack_strided(x_g.bytes[J], n)  # [kb, n]
            X_J = (raw - x_g.shift[J][:, None]) * x_g.w_scale[J][:, None]
        elif isinstance(x_g, D.FeatX):
            X_J = x_g.xT[J]
        else:
            X_J = x_g[:, J].T  # [kb, n]
        gram = jnp.dot(X_J, X_J.T, precision=_HIGHEST)  # [kb, kb]
        u0 = jnp.dot(X_J, e, precision=_HIGHEST)  # [kb]
        W0_blk = W0_c[J]  # [kb, s_pad]

        def inner(c2, t):
            u_vec, W0_b, z_b, dbeta = c2
            j = J[t]
            row = W0_b[t]
            beta_old = jnp.dot(row, w)
            u_j_mj = u_vec[t] + gram[t, t] * beta_old
            zj, new_row = marker_move(t, j, u_j_mj, gram[t, t], row)
            beta_new = jnp.dot(new_row, w)
            db = beta_new - beta_old
            u_vec = u_vec - gram[:, t] * db
            return (
                u_vec,
                W0_b.at[t].set(new_row),
                z_b.at[t].set(zj),
                dbeta.at[t].set(db),
            ), None

        (u_f, W0_blk, z_blk, dbeta), _ = jax.lax.scan(
            inner,
            (u0, W0_blk, jnp.zeros(kb), jnp.zeros(kb)),
            jnp.arange(kb),
        )
        e_new = e - jnp.dot(dbeta, X_J, precision=_HIGHEST)
        return (e_new, W0_c.at[J].set(W0_blk), z_c.at[J].set(z_blk)), None

    (e_f, W0_f, z_f), _ = jax.lax.scan(
        block_body, (e0, W0, jnp.zeros(m_pad)), blocks
    )
    return z_f, W0_f, e_f


def _welford(mean, m2, x, n):
    """One Welford update at new count ``n`` (elementwise over any shape)."""
    delta = x - mean
    mean = mean + delta / n
    m2 = m2 + delta * (x - mean)
    return mean, m2


class SweepStats(NamedTuple):
    counts: jax.Array  # cumulative [3]
    mse_train: jax.Array
    lpd: jax.Array
    # per-leapfrog-step trajectories (cfg.trajectories): dict with
    # "params"/"ldg" [G, L, P_pad_flat], "hamiltonian" [G, L+1], optionally
    # "num_ldg", plus "perm" [G] (branch update order); () when disabled
    traj: object = ()
    # branches currently included (spike-and-slab; = G otherwise)
    n_incl: jax.Array = ()


# --------------------------------------------------------------------------
# Gibbs draws
# --------------------------------------------------------------------------


def _row_mixture_z(key, w0, c, shape, scale, pi, lam_spike, row_mask, force):
    """ζ_j | w_j for the two-component ARD row prior (cfg.ss_rows).

    Per-marker selection for NONLINEAR branches (any depth/activation):
    layer-0 row j has prior  ζ_j·N(0, λ_j⁻¹I) + (1−ζ_j)·N(0, λ_spike⁻¹I)
    with λ_j ~ Gamma(shape, scale) under the slab. Unlike the depth-0
    collapsed move (cfg.ss_markers), no conjugate (ζ, row) joint move
    exists through a nonlinearity — but the INDICATOR given the row is
    exact: integrating λ_j out of the slab gives the closed-form
    multivariate-t row marginal

      p_slab(w) = Γ(k+c/2)/Γ(k) · (2π)^{-c/2} θ^{-k} (‖w‖²/2 + 1/θ)^{-(k+c/2)}

    against the Gaussian spike density, so ζ_j ~ Bern(σ(logit π + log BF))
    is a valid Gibbs draw. HMC then feels λ_spike on spiked rows (strong
    but finite shrinkage — the spike is a narrow Gaussian, not δ₀, so rows
    with real signal climb back out through the likelihood gradient and
    re-enter when ‖w‖ grows). Selection is soft; PIP = E[ζ].

    ``c`` is the true layer-0 fan-out (padded columns hold exact zeros, so
    the unmasked ssq is exact but the EXPONENT must count true columns).
    """
    from jax.scipy.special import gammaln

    ssq = jnp.sum(w0 * w0, axis=1)  # [in_pad]
    log_slab = (
        gammaln(shape + c / 2.0)
        - gammaln(shape)
        - (c / 2.0) * jnp.log(2.0 * jnp.pi)
        - shape * jnp.log(scale)
        - (shape + c / 2.0) * jnp.log(ssq / 2.0 + 1.0 / scale)
    )
    log_spike = (c / 2.0) * (
        jnp.log(lam_spike) - jnp.log(2.0 * jnp.pi)
    ) - lam_spike * ssq / 2.0
    logit = jnp.log(pi) - jnp.log1p(-pi) + log_slab - log_spike
    z = jax.random.bernoulli(key, jax.nn.sigmoid(logit)).astype(jnp.float32)
    return jnp.where(force, 1.0, z) * row_mask


def _ssr_flip_scan(
    key, x_g, weights, biases, act, lam_rows, z_rows, target, err_hmc,
    pi, lam_spike, s_shape, s_scale, row_mask,
):
    """Whitened scaled-flip MH over one branch's layer-0 rows (cfg.ss_rows).

    The ζ_j | w_j Gibbs draw alone cannot mix: a null row equilibrates at
    slab scale (‖w‖ ~ 1/√λ_slab), where the narrow spike density is
    astronomically smaller — and a spiked row never random-walks back out.
    This move jumps BETWEEN scales: in the whitened parameterization
    u_j = w_j·√λ_j (prior N(0, I) regardless of component), propose

        ζ'_j = 1 − ζ_j,   λ'_j ~ p(λ | ζ'_j)  (slab Gamma prior / δ_spike),
        u unchanged  ⇒  w'_j = w_j·√(λ_j / λ'_j)

    The λ-prior and u-prior terms cancel against the proposal, leaving
    log α = logit(π)·(ζ'−ζ) + (err/2)·(rss − rss') — one branch-tail
    forward per row. Rows are visited sequentially (flips interact through
    the likelihood) with the layer-0 pre-activation Z = x @ W0 maintained
    by rank-1 updates, so each step costs only the downstream layers.

    Returns (z_new [m_pad], lam_new [m_pad], W0_new, pred_final [n]).
    """
    from ..ops.activations import activation as _act_of

    h = _act_of(act)
    m_pad = weights[0].shape[0]
    L = len(weights)
    k_perm, k_lam, k_u = jax.random.split(key, 3)
    order = jax.random.permutation(k_perm, m_pad)
    lam_slab_prop = jnp.clip(
        jax.random.gamma(k_lam, s_shape, (m_pad,)) * s_scale, 1e-6, 1e8
    )
    us = jax.random.uniform(k_u, (m_pad,))
    feat = isinstance(x_g, D.FeatX)

    def col(j):
        return x_g.xT[j] if feat else x_g[:, j]

    def x_w0(W0):
        if feat:
            return D.matmul_fm(W0, x_g.xT).T  # [n, out0]
        return D.matmul(x_g, W0)

    def tail(Z):
        a = h(Z + biases[0][None, :])
        for l in range(1, L - 1):
            a = h(D.matmul(a, weights[l]) + biases[l][None, :])
        return D.matmul(a, weights[-1])[:, 0]

    Z0 = x_w0(weights[0])
    pred0 = tail(Z0)
    r0 = target - pred0
    logit_pi = jnp.log(pi) - jnp.log1p(-pi)

    def body(carry, i):
        Z, W0_c, lam_c, z_c, rss = carry
        j = order[i]
        z_j = z_c[j]
        lam_j = lam_c[j]
        lam_new = jnp.where(z_j > 0, lam_spike, lam_slab_prop[j])
        scale_f = jnp.sqrt(lam_j / lam_new)
        w_row = W0_c[j]
        dw = w_row * (scale_f - 1.0)
        Z_p = Z + col(j)[:, None] * dw[None, :]
        pred_p = tail(Z_p)
        r_p = target - pred_p
        rss_p = jnp.sum(r_p * r_p)
        z_new = 1.0 - z_j
        log_acc = logit_pi * (z_new - z_j) + err_hmc * (rss - rss_p) / 2.0
        ok = (jnp.log(us[i]) < log_acc) & (row_mask[j] > 0)
        Z = jnp.where(ok, Z_p, Z)
        return (
            Z,
            W0_c.at[j].set(jnp.where(ok, w_row * scale_f, w_row)),
            lam_c.at[j].set(jnp.where(ok, lam_new, lam_j)),
            z_c.at[j].set(jnp.where(ok, z_new, z_j)),
            jnp.where(ok, rss_p, rss),
        ), None

    (Z_f, W0_f, lam_f, z_f, _), _ = jax.lax.scan(
        body,
        (Z0, weights[0], lam_rows, z_rows, jnp.sum(r0 * r0)),
        jnp.arange(m_pad),
    )
    return z_f, lam_f, W0_f, tail(Z_f)


def _gibbs_local_precisions(
    key, model_type, w_g, b_g, statics_g, hyper, num_layers, z_rows0=None,
    ssr=None, lam_floor=0.0,
):
    """Per-branch Gibbs update of local weight+bias precisions.

    ridge_base.rs:235-253, ridge_ard.rs:271-301, lasso_base.rs:235-253,
    lasso_ard.rs. Bias precisions are always ridge-updated.

    ``z_rows0`` (per-marker spike-and-slab): [in_pad] inclusion indicators
    for layer 0 — an EXCLUDED row is the spike δ₀, not a slab draw, so its
    precision's conditional is the PRIOR Gamma(shape, scale) (treating the
    zero row as data would drive λ_j → large and bar re-entry through the
    collapsed move's Bayes factor).

    ``ssr`` (cfg.ss_rows, ridge_ard only): (pi, lam_spike, force) — draw
    the layer-0 row indicators ζ via ``_row_mixture_z`` and set spiked
    rows' precisions to λ_spike instead of the slab posterior. Returns
    (wp, bp, ζ) then; (wp, bp, None) otherwise.
    """
    L = num_layers
    keys = jax.random.split(key, 2 * (L - 1))
    z_rows = None
    new_wp, new_bp = [], []
    for l in range(L - 1):
        shape, scale = hyper.layer(l, L)
        w = w_g[l]
        if D.is_ard(model_type):
            ncols = statics_g.out_counts[l]
            if D.is_lasso(model_type):
                l1_rows = jnp.sum(jnp.abs(w), axis=1, keepdims=True)
                lam = gibbs.lasso_precision_posterior(keys[l], shape, scale, l1_rows, ncols)
            else:
                ssq_rows = jnp.sum(w * w, axis=1, keepdims=True)
                lam = gibbs.ridge_precision_posterior(keys[l], shape, scale, ssq_rows, ncols)
            if l == 0 and ssr is not None:
                pi_r, lam_spike, force, s_shape, s_scale = ssr
                # the slab hyperprior is ssr's own (cfg.ssr_shape/scale) —
                # consistently for the indicator AND the λ Gibbs redraw
                k_z = jax.random.fold_in(keys[l], 0x77)
                z_rows = _row_mixture_z(
                    k_z, w, ncols, s_shape, s_scale, pi_r, lam_spike,
                    statics_g.row_masks[0][:, 0], force,
                )
                ssq_rows = jnp.sum(w * w, axis=1, keepdims=True)
                lam_slab = gibbs.ridge_precision_posterior(
                    jax.random.fold_in(keys[l], 0x78), s_shape, s_scale,
                    ssq_rows, ncols,
                )
                lam = jnp.where(z_rows[:, None] > 0, lam_slab, lam_spike)
            if l == 0 and z_rows0 is not None:
                k_prior = jax.random.fold_in(keys[l], 0x55)
                # clip: the CLI-default Gamma(0.001, 1000) hyperprior is
                # nearly improper — half its mass underflows f32 to exactly
                # 0, and a 0 slab precision makes the re-entry draw's
                # orthogonal component infinite. The clipped draw is the
                # prior conditioned on λ ∈ [1e-6, 1e8], which data-informed
                # draws never leave anyway.
                lam_prior = jnp.clip(
                    jax.random.gamma(k_prior, shape, lam.shape) * scale,
                    1e-6, 1e8,
                )
                lam = jnp.where(z_rows0[:, None] > 0, lam, lam_prior)
        else:
            nvar = statics_g.w_counts[l]
            if D.is_lasso(model_type):
                lam = gibbs.lasso_precision_posterior(
                    keys[l], shape, scale, jnp.sum(jnp.abs(w)), nvar
                ).reshape(1, 1)
            else:
                lam = gibbs.ridge_precision_posterior(
                    keys[l], shape, scale, jnp.sum(w * w), nvar
                ).reshape(1, 1)
        if lam_floor > 0:
            # divergence guard (mcmc_cfg.lam_row_floor): cut the
            # scale-degeneracy ridge (W0 -> cW0, w_out -> w_out/c with the
            # near-improper hyperprior chasing the growth down). max() is
            # the identity for healthy weight draws. BIAS precisions are
            # deliberately exempt: biases are unregularized coordinates in
            # the marginal potential, so their lambda legitimately wanders
            # low (it only scales the izmailov step size) — flooring them
            # changed reference mixing behavior (measured r5: parity rows
            # jumped +0.04-0.11 ABOVE the oracle because capped bias steps
            # raised acceptance in the reference's low-acceptance canonical
            # workload).
            lam = jnp.maximum(lam, lam_floor)
        new_wp.append(lam)
        bp = gibbs.ridge_precision_posterior(
            keys[L - 1 + l], shape, scale, jnp.sum(b_g[l] ** 2), statics_g.b_counts[l]
        ).reshape(1)
        new_bp.append(bp)
    if ssr is not None:
        return tuple(new_wp), tuple(new_bp), z_rows
    return tuple(new_wp), tuple(new_bp)


def _gibbs_output_precision(key, model_type, reg_all, n_out, hyper):
    """Shared output-layer precision draw (branch_sampler.rs:178-188)."""
    if model_type == "std_normal":
        return jnp.asarray(1.0)
    if D.is_lasso(model_type):
        lam = gibbs.lasso_precision_posterior(
            key, hyper.output_shape, hyper.output_scale, reg_all, n_out
        )
    else:
        lam = gibbs.ridge_precision_posterior(
            key, hyper.output_shape, hyper.output_scale, reg_all, n_out
        )
    # spike-and-slab can drive n_out to 0 (all branches excluded), making
    # this a pure prior draw: Gamma(0.001) mass below f32-tiny is ~90%, and
    # a 0 precision then poisons log λ downstream — floor it (harmless for
    # data-informed draws, which are orders of magnitude larger)
    return jnp.maximum(lam, 1e-10)


def default_block_size(G: int) -> int:
    """Largest divisor of G not exceeding ~G/8 (min 1): ~8 sequential block
    rounds per sweep, the regime measured to preserve statistical quality
    while keeping within-block parallelism."""
    target = max(G // 8, 1)
    for b in range(target, 0, -1):
        if G % b == 0:
            return b
    return 1


def _reg_all(model_type, params: StackedParams):
    w_out = params.weights[-1]
    if D.is_lasso(model_type):
        return jnp.sum(jnp.abs(w_out))
    return jnp.sum(w_out * w_out)


def _update_output_bias(cfg, hyper, key, residual, bias, bias_prec, err_prec):
    """net.rs:319-332: add bias back, resample (or ML), subtract again.

    Note: the reference's sampled-bias prior-precision draw passes the output
    prior *shape* for both Gamma parameters (net.rs:61-66); we use
    (shape, scale) as evidently intended.
    """
    k1, k2 = jax.random.split(key)
    residual = residual + bias
    if cfg.sampled_output_bias:
        bias_prec = gibbs.ridge_single_precision_posterior(
            k1, hyper.output_shape, hyper.output_scale, bias
        )
        bias = gibbs.sample_output_bias(k2, residual, err_prec, bias_prec)
    else:
        bias = jnp.mean(residual)
    residual = residual - bias
    return residual, bias, bias_prec


# --------------------------------------------------------------------------
# Sweep builders
# --------------------------------------------------------------------------


def make_sweep(model_type: str, act: str, arch: NetArch, cfg: MCMCCfg, hyper):
    """Build the one-iteration Gibbs sweep.

    Returns sweep(carry: TrainCarry, X [G,n,m_pad], y [n]) ->
    (TrainCarry, SweepStats). Jit (and optionally vmap over chains) at the
    call site.
    """
    # HOST numpy constants (see params.weight_masks): converted to device
    # constants INSIDE each sweep function, at trace time — embedding them
    # from host memory at lowering instead of paying a device->host readback
    # per array per compile
    statics_h = D.branch_statics(arch)
    masks_w_h = P.weight_masks(arch)
    masks_b_h = P.bias_masks(arch)

    def _device_consts():
        return (
            jax.tree.map(jnp.asarray, statics_h),
            tuple(jnp.asarray(m) for m in masks_w_h),
            tuple(jnp.asarray(m) for m in masks_b_h),
        )

    G = arch.num_branches
    L = arch.num_layers
    n_out_tot = float(arch.total_output_weights)
    gibbs_precisions = not (cfg.joint_hmc or cfg.gradient_descent_joint)
    sample_local = (
        gibbs_precisions
        and not cfg.fixed_param_precisions
        and model_type != "std_normal"
    )

    ss_on = cfg.spike_slab and not (
        cfg.joint_hmc or cfg.gradient_descent or cfg.gradient_descent_joint
    )
    if ss_on:
        assert not D.is_lasso(model_type), (
            "spike_slab needs a Gaussian (conjugate) slab on the output "
            "layer; lasso models have a Laplace output prior"
        )
    ssm_on = cfg.ss_markers and not (
        cfg.joint_hmc or cfg.gradient_descent or cfg.gradient_descent_joint
    )
    if ssm_on:
        assert arch.depth == 0 and arch.activation == "identity", (
            "ss_markers needs the identity depth-0 architecture (the branch "
            "output must be linear in each layer-0 row for the collapsed "
            "conjugate move; docs/GENOME_SCALE.md production recipe)"
        )
        assert D.is_ard(model_type) or model_type == "std_normal", (
            "ss_markers needs per-row slab precisions (ridge_ard/lasso_ard) "
            "or fixed unit precisions (std_normal); base models share one "
            "precision per layer"
        )
        # lasso_ard is supported via the Park-Casella scale-mixture
        # augmentation inside _marker_ss_scan (lasso=True below)
    ssr_on = cfg.ss_rows and not (
        cfg.joint_hmc or cfg.gradient_descent or cfg.gradient_descent_joint
    )
    if ssr_on:
        assert model_type == "ridge_ard", (
            "ss_rows needs the Gaussian per-row ARD slab (ridge_ard); its "
            "indicator draw integrates a Gamma-Normal row marginal"
        )
        assert not cfg.fixed_param_precisions, (
            "ss_rows draws row precisions; incompatible with fixed "
            "param precisions"
        )
        assert not (ssm_on or ss_on), (
            "ss_rows is an alternative selection level; do not stack with "
            "ss_markers or spike_slab"
        )
    out_w_counts = statics_h.w_counts[L - 1]  # [G] true output weights per branch

    if cfg.gradient_descent:
        transition = make_gradient_descent(model_type, act, cfg)
        joint = False
    elif cfg.gradient_descent_joint:
        transition = make_gradient_descent_joint(model_type, act, cfg)
        joint = True
    elif cfg.joint_hmc:
        # Outside the sequential schedule the shared scalars (error
        # precision, output-layer precision) cannot each be moved by
        # concurrent branch HMC updates; they are frozen as HMC coordinates
        # and drawn from their conjugate conditionals once per sweep/block.
        seq = cfg.update_mode == "sequential"
        transition = make_hmc_step_joint(
            model_type, act, cfg, sample_error=seq, sample_output=seq
        )
        joint = True
    if cfg.gradient_descent or cfg.gradient_descent_joint or cfg.joint_hmc:
        live_accept = False
    else:
        # exact parallel/hybrid schedules: parallel stale-potential
        # trajectories + sequential live-residual accepts (HMCProposal doc).
        # The branch-level spike-and-slab paths mutate params between the
        # prediction snapshot and the HMC call, which breaks the
        # y_pred0 == preds[g] identity the live accept relies on — they
        # keep the stale accept. The per-marker path (ssm) REBASES the
        # snapshot predictions after its collapsed scan instead (r5), so
        # the production ssm recipe gets the exact live accept.
        live_accept = (
            cfg.live_accept
            and cfg.update_mode in ("parallel", "hybrid")
            and not (ss_on or ssr_on)
        )
        transition = make_hmc_step(
            model_type, act, cfg, freeze_output=ss_on,
            defer_accept=live_accept,
        )
        joint = False
    n_precisions = float(
        1 + 2 * (L - 1) + 1
    )  # rough per-branch precision count for joint step sizing
    adaptive = cfg.hmc_step_size_mode == "dual_averaging"
    mass_adapt = cfg.mass_adaptation and not (
        joint or cfg.gradient_descent or cfg.gradient_descent_joint
    )
    # cfg validation forbids tempering with joint/GD modes, but the trainer's
    # GD warm start rebuilds the sweep with gradient_descent=True while
    # keeping cfg.tempering — gate on the effective mode here too
    temper = cfg.tempering and not (
        joint or cfg.gradient_descent or cfg.gradient_descent_joint
    )
    burn_f = float(cfg.burn_in)
    # dynamic trajectory lengths (marginal HMC only; cfg validates)
    dyn_len = cfg.hmc_traj_length_mode != "fixed" and not (
        joint or cfg.gradient_descent or cfg.gradient_descent_joint
    )
    uturn_adapt = dyn_len and cfg.hmc_traj_length_mode == "uturn"
    L_int = cfg.hmc_integration_length
    record_traj = cfg.trajectories and not (
        cfg.gradient_descent or cfg.gradient_descent_joint
    )
    import math as _math

    da_mu = _math.log(10.0 * cfg.hmc_step_size_factor)
    # divergence guard floors (mcmc_cfg lam_e_floor / lam_row_floor):
    # identity for healthy draws, containment for the measured ssm
    # lambda_e spiral (VERDICT r4 #2)
    lam_e_floor = float(cfg.lam_e_floor)
    lam_row_floor = float(cfg.lam_row_floor)

    def _guard_err(err_prec, y):
        if lam_e_floor <= 0:
            return err_prec
        return jnp.maximum(err_prec, lam_e_floor / (jnp.var(y) + 1e-30))


    def branch_update(carry: TrainCarry, g, X, y, statics, masks_w, masks_b):
        state, residual = carry.state, carry.residual
        params, precisions = state.params, state.precisions
        (key, k_e, k_loc, k_out, k_hmc, k_bias, k_len, k_ss, k_prior, k_ssm) = (
            jax.random.split(carry.key, 10)
        )

        w_g = tuple(w[g] for w in params.weights)
        b_g = tuple(b[g] for b in params.biases)
        mw_g = tuple(m[g] for m in masks_w)
        mb_g = tuple(m[g] for m in masks_b)
        st_g = D.slice_branch(statics, g)
        x_g = X[g]

        err_prec = precisions.error
        wp = precisions.weights
        bp = precisions.biases

        if gibbs_precisions:
            err_prec = _guard_err(
                gibbs.error_precision_posterior(
                    k_e, hyper, residual, carry.beta if temper else None
                ),
                y,
            )
        # tempered likelihood L^β enters HMC and the bias draw as β·λ_e;
        # the stored λ_e and the LPD bookkeeping stay untempered
        err_hmc = err_prec * carry.beta if temper else err_prec
        z_r = None
        if sample_local:
            if ssr_on:
                new_wp_g, new_bp_g, z_r = _gibbs_local_precisions(
                    k_loc, model_type, w_g, b_g, st_g, hyper, L,
                    ssr=(carry.ssm_pi, cfg.ssr_spike,
                         carry.da_t < float(cfg.ssr_warmup),
                         cfg.ssr_shape, cfg.ssr_scale),
                    lam_floor=lam_row_floor,
                )
            else:
                new_wp_g, new_bp_g = _gibbs_local_precisions(
                    k_loc, model_type, w_g, b_g, st_g, hyper, L,
                    z_rows0=carry.ssm_z[g] if ssm_on else None,
                    lam_floor=lam_row_floor,
                )
            wp = tuple(
                wp[l].at[g].set(new_wp_g[l]) if l < L - 1 else wp[l]
                for l in range(L)
            )
            bp = tuple(bp[l].at[g].set(new_bp_g[l]) for l in range(L - 1))
            # spike-and-slab: the shared λ_out posterior counts only the
            # INCLUDED branches' output weights (excluded ones are the spike,
            # not draws from the slab)
            n_out_gibbs = (
                jnp.sum(carry.ss_z * out_w_counts) if ss_on else n_out_tot
            )
            lam_out = _gibbs_output_precision(
                k_out, model_type, _reg_all(model_type, params), n_out_gibbs, hyper
            )
            # zero included output weights (total branch exclusion) would
            # make this a pure Gamma(0.001) prior draw — 0-or-huge, which
            # flattens the spike-and-slab evidence and makes exclusion
            # absorbing (measured NaN collapse, UKB finer x bss). Skipping
            # the update keeps the kernel valid and the state recoverable.
            lam_out = jnp.where(
                n_out_gibbs > 0, lam_out, wp[L - 1].reshape(-1)[0]
            )
            wp = tuple(
                jnp.full_like(wp[l], lam_out) if l == L - 1 else wp[l]
                for l in range(L)
            )

        wp_g = tuple(a[g] for a in wp)
        bp_g = tuple(a[g] for a in bp)

        if ss_on and not ssm_on:
            # one forward serves both the old prediction and the summary
            # activations A for the collapsed move
            _, acts0 = D.forward(act, w_g, b_g, x_g)
            pred_old = acts0[-1][:, 0]
        else:
            pred_old = D.predict(act, w_g, b_g, x_g)
        target = residual + pred_old

        ssm_z = carry.ssm_z
        if z_r is not None:  # ss_rows indicators share the ssm carry slots
            ssm_z = ssm_z.at[g].set(z_r)
        if ssm_on:
            # per-marker collapsed (z_j, W0[j]) scan against a live residual,
            # conditioning on the current output layer; HMC below then moves
            # the remaining coordinates with excluded rows frozen
            lam_rows = jnp.broadcast_to(wp_g[0][:, 0], (w_g[0].shape[0],))
            z_m, W0_new, _ = _marker_ss_scan(
                k_ssm, x_g, w_g[0], b_g[0], w_g[-1], residual, err_hmc,
                lam_rows, carry.ssm_pi, st_g.row_masks[0][:, 0], mb_g[0],
                carry.da_t < float(cfg.ssm_warmup),
                lasso=D.is_lasso(model_type),
            )
            w_g = (W0_new,) + w_g[1:]
            ssm_z = ssm_z.at[g].set(z_m)
            if ss_on:  # branch-level move needs A at the UPDATED layer 0
                _, acts0 = D.forward(act, w_g, b_g, x_g)

        if ssr_on:
            # whitened scaled-flip MH across scales (k_ssm is unused when
            # ss_rows is on — the modes are mutually exclusive)
            z_new, lam_new, W0_new, _ = _ssr_flip_scan(
                k_ssm, x_g, w_g, b_g, act, wp_g[0][:, 0], ssm_z[g], target,
                err_hmc, carry.ssm_pi, cfg.ssr_spike, cfg.ssr_shape,
                cfg.ssr_scale, st_g.row_masks[0][:, 0],
            )
            w_g = (W0_new,) + w_g[1:]
            wp = (wp[0].at[g].set(lam_new[:, None]),) + wp[1:]
            wp_g = (lam_new[:, None],) + wp_g[1:]
            ssm_z = ssm_z.at[g].set(z_new)

        ss_z = carry.ss_z
        if ss_on:
            # collapsed conjugate (z, w_out) move FIRST, from the current
            # hidden params: the output layer is owned by this exact draw;
            # HMC below then updates the hidden layers (output frozen) only
            # for included branches. Excluded branches' hidden weights are
            # redrawn from their prior — which IS their conditional given
            # z = 0 — refreshing the summary projection A every sweep, so
            # re-entry is not tied to one stale projection. Biases keep an
            # identity kernel: their marginal-mode prior is improper-flat
            # (branch_sampler.rs:104-112) and only the likelihood anchors
            # them, so they must not random-walk while excluded.
            z_g, w_out_new, _ = _spike_slab_update(
                k_ss, acts0[-2], target, err_hmc, wp_g[-1].reshape(()),
                carry.ss_pi, mw_g[-1],
                force_include=carry.da_t < float(cfg.ss_warmup),
            )
            w_g = w_g[:-1] + (w_out_new,)
            ss_z = ss_z.at[g].set(z_g)

        traj = ()
        if joint:
            reg_sum_others = _reg_all(model_type, params) - D.summary_stat(
                model_type, w_g[-1]
            )
            out = transition(
                k_hmc, w_g, b_g, wp_g, bp_g, err_prec, x_g, target,
                mw_g, mb_g, st_g.n_params, jnp.asarray(n_precisions),
                hyper, st_g, reg_sum_others, n_out_tot,
            )
            if record_traj:
                (res, wp_g_new, bp_g_new, err_new), traj = out
            else:
                res, wp_g_new, bp_g_new, err_new = out
            accepted = res.code == 0
            # local (non-output) precisions are per-branch; the accepted
            # output-layer precision is SHARED: it becomes the value every
            # subsequent branch sees, as the reference propagates it via
            # GlobalParams (net.rs:304, params.rs:41-56)
            wp = tuple(
                wp[l].at[g].set(jnp.where(accepted, wp_g_new[l], wp_g[l]))
                if l < L - 1
                else jnp.full_like(
                    wp[l], jnp.where(accepted, wp_g_new[l], wp_g[l]).reshape(())
                )
                for l in range(L)
            )
            bp = tuple(
                bp[l].at[g].set(jnp.where(accepted, bp_g_new[l], bp_g[l]))
                for l in range(L - 1)
            )
            err_prec = jnp.where(accepted, err_new, err_prec)
        else:
            step_factor = None
            if adaptive:
                warm = carry.da_t < cfg.burn_in
                step_factor = jnp.exp(
                    jnp.where(warm, carry.da_log_eps[g], carry.da_log_eps_bar[g])
                )
            extra = ()
            if mass_adapt:
                cnt = jnp.minimum(carry.da_t, burn_f)
                extra = _mass_std(
                    model_type, carry.mm_mean[g], carry.mm_m2[g], cnt,
                    wp_g, bp_g, w_g, b_g,
                )
            kw = {}
            traj_len = None
            if dyn_len:
                traj_len = _draw_traj_len(
                    k_len, carry.tl_avg[g], L_int, cfg.hmc_traj_length_mode
                )
                kw["traj_len"] = traj_len
            if ssm_on:
                kw["row_freeze"] = z_m
            out = transition(
                k_hmc, w_g, b_g, wp_g, bp_g, err_hmc, x_g, target,
                mw_g, mb_g, st_g.n_params, step_factor, *extra, **kw,
            )
            res, traj = out if record_traj else (out, ())

        res_weights, res_biases, y_pred_new = res.weights, res.biases, res.y_pred
        inc = jnp.asarray(True)
        if ss_on:
            inc = z_g > 0.0
            pk = jax.random.split(k_prior, L - 1)
            prior_w = [
                jax.random.normal(pk[l], w_g[l].shape)
                / jnp.sqrt(wp_g[l]) * mw_g[l]
                for l in range(L - 1)
            ]
            if ssm_on:  # spiked rows stay exactly 0 in the prior redraw too
                prior_w[0] = prior_w[0] * z_m[:, None]
            res_weights = tuple(
                jnp.where(inc, res.weights[l], prior_w[l]) for l in range(L - 1)
            ) + (w_out_new,)
            res_biases = tuple(
                jnp.where(inc, res.biases[l], b_g[l]) for l in range(L - 1)
            )
            y_pred_new = jnp.where(inc, res.y_pred, jnp.zeros_like(res.y_pred))

        tl_avg = carry.tl_avg
        if uturn_adapt:
            tl_avg = tl_avg.at[g].set(
                _tl_update(
                    tl_avg[g], res.uturn_step, traj_len, res.code,
                    (carry.da_t < burn_f) & inc, L_int,
                )
            )

        da_log_eps, da_log_eps_bar, da_h_bar = (
            carry.da_log_eps, carry.da_log_eps_bar, carry.da_h_bar
        )
        if adaptive and not joint:
            warm = (carry.da_t < cfg.burn_in) & inc
            t = carry.da_t + 1.0
            h_new, le_new, leb_new = _da_update(
                cfg, t, carry.da_h_bar[g], carry.da_log_eps_bar[g],
                res.accept_prob, da_mu,
            )
            da_h_bar = da_h_bar.at[g].set(jnp.where(warm, h_new, da_h_bar[g]))
            da_log_eps = da_log_eps.at[g].set(
                jnp.where(warm, le_new, da_log_eps[g])
            )
            da_log_eps_bar = da_log_eps_bar.at[g].set(
                jnp.where(warm, leb_new, da_log_eps_bar[g])
            )

        residual = target - y_pred_new
        params = StackedParams(
            tuple(params.weights[l].at[g].set(res_weights[l]) for l in range(L)),
            tuple(params.biases[l].at[g].set(res_biases[l]) for l in range(L - 1)),
        )
        precisions = StackedPrecisions(wp, bp, err_prec)

        mm_mean, mm_m2 = carry.mm_mean, carry.mm_m2
        if mass_adapt:
            from ..samplers.hmc import flatten_wb

            warm_mm = carry.da_t < burn_f
            flat = flatten_wb(res_weights, res_biases)
            mean_new, m2_new = _welford(mm_mean[g], mm_m2[g], flat, carry.da_t + 1.0)
            mm_mean = mm_mean.at[g].set(jnp.where(warm_mm, mean_new, mm_mean[g]))
            mm_m2 = mm_m2.at[g].set(jnp.where(warm_mm, m2_new, mm_m2[g]))

        # ---- log posterior density bookkeeping (log_posterior_density.rs)
        w_g = tuple(w[g] for w in params.weights)
        b_g = tuple(b[g] for b in params.biases)
        wp_g = tuple(a[g] for a in wp)
        bp_g = tuple(a[g] for a in bp)
        lpd_local = carry.lpd_local.at[g].set(
            D.joint_local_term(model_type, w_g, b_g, wp_g, bp_g, hyper, st_g)
        )
        reg_sum_others = _reg_all(model_type, params) - D.summary_stat(
            model_type, w_g[-1]
        )
        lpd_out = D.joint_output_term(
            model_type, w_g, wp_g, hyper, reg_sum_others,
            jnp.sum(ss_z * out_w_counts) if ss_on else n_out_tot,
        )
        lpd_rss = D.joint_rss_term(
            err_prec, jnp.sum(residual**2), hyper,
            jnp.asarray(residual.shape[0], jnp.float32),
        )

        residual, bias, bias_prec = _update_output_bias(
            cfg, hyper, k_bias, residual, state.output_bias,
            state.output_bias_precision, err_hmc,
        )

        new_carry = TrainCarry(
            state=NetState(params, precisions, bias, bias_prec),
            residual=residual,
            lpd_local=lpd_local,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
            counts=carry.counts.at[res.code].add(
                inc.astype(jnp.int32) if ss_on else 1
            ),
            key=key,
            da_log_eps=da_log_eps,
            da_log_eps_bar=da_log_eps_bar,
            da_h_bar=da_h_bar,
            da_t=carry.da_t,
            mm_mean=mm_mean,
            mm_m2=mm_m2,
            beta=carry.beta,
            tl_avg=tl_avg,
            ss_z=ss_z,
            ss_pi=carry.ss_pi,
            ss_pip=carry.ss_pip,
            ssm_z=ssm_z,
            ssm_pi=carry.ssm_pi,
            ssm_pip=carry.ssm_pip,
        )
        return new_carry, (traj if record_traj else ())

    def ss_sweep_end(carry: TrainCarry, k_pi) -> TrainCarry:
        """π Gibbs draw (Beta(1,1) hyperprior) + posterior-inclusion-
        probability running mean; call after da_t was incremented."""
        pi = carry.ss_pi
        if cfg.ss_update_pi:
            nz = jnp.sum(carry.ss_z)
            pi = jnp.clip(
                jax.random.beta(k_pi, 1.0 + nz, 1.0 + G - nz), 0.01, 0.99
            )
        post_k = carry.da_t - burn_f
        pip = jnp.where(
            post_k > 0.0,
            carry.ss_pip
            + (carry.ss_z - carry.ss_pip) / jnp.maximum(post_k, 1.0),
            carry.ss_pip,
        )
        return carry._replace(ss_pi=pi, ss_pip=pip)

    marker_rows = statics_h.row_masks[0][:, :, 0]  # [G, m_pad] numpy
    n_markers_tot = float(marker_rows.sum())

    def ssm_sweep_end(carry: TrainCarry, k_pi) -> TrainCarry:
        """Marker-level π_m Beta(1,1) Gibbs draw + per-marker PIP running
        mean; call after da_t was incremented."""
        pi = carry.ssm_pi
        fixed = cfg.ssm_fixed_pi if ssm_on else cfg.ssr_fixed_pi
        if not fixed:
            nz = jnp.sum(carry.ssm_z * marker_rows)
            # lower clip well below 1/M: genome-scale truths can be <1%
            pi = jnp.clip(
                jax.random.beta(k_pi, 1.0 + nz, 1.0 + n_markers_tot - nz),
                1e-4, 0.999,
            )
        post_k = carry.da_t - burn_f
        pip = jnp.where(
            post_k > 0.0,
            carry.ssm_pip
            + (carry.ssm_z - carry.ssm_pip) / jnp.maximum(post_k, 1.0),
            carry.ssm_pip,
        )
        return carry._replace(ssm_pi=pi, ssm_pip=pip)

    def finish(carry: TrainCarry, traj=()) -> SweepStats:
        n = jnp.asarray(carry.residual.shape[0], jnp.float32)
        return SweepStats(
            counts=carry.counts,
            mse_train=jnp.sum(carry.residual**2) / n,
            lpd=carry.lpd_rss + carry.lpd_out + jnp.sum(carry.lpd_local),
            traj=traj,
            n_incl=jnp.sum(carry.ss_z).astype(jnp.int32),
        )

    # ---------------------------------------------------------- sequential
    def _live_accept_select(key, residual0, preds_blk, prop, err_hmc,
                            old_w, old_b):
        """Sequential live-residual Metropolis accepts for a block of
        parallel stale-potential HMC proposals (samplers.hmc.HMCProposal).

        ``residual0`` is y − bias − Σ_g pred_old_g over ALL branches;
        ``preds_blk`` the block's snapshot predictions (== each proposal's
        y_pred at its initial params, so rss_old(live) = ‖residual‖²).
        Branches are visited in a fresh random order; an accepted branch
        moves the live residual the next branch tests against. Cost: two
        length-n reductions + one vector update per branch — no matmuls.
        Returns an HMCResult with accept-selected params/codes/alphas.
        """
        B_ = preds_blk.shape[0]
        k_ord, k_u = jax.random.split(key)
        order = jax.random.permutation(k_ord, B_)
        us = jax.random.uniform(k_u, (B_,))

        def body(r, i):
            g = order[i]
            tgt = r + preds_blk[g]
            # rss at BOTH endpoints through the transition's own prediction
            # operator (samplers/hmc.HMCProposal.y_pred0): ||r||^2 would
            # evaluate the initial state under the sweep's D.predict
            # operator while the proposal uses the transition's — under
            # reduced-precision dots that operator mismatch is a measured
            # noisy-MH drift at n >= 1e5 (r5)
            d0 = tgt - prop.y_pred0[g]
            rss_old = jnp.sum(d0 * d0)
            d = tgt - prop.y_pred_prop[g]
            rss_new = jnp.sum(d * d)
            log_acc = (
                prop.prior_prop[g] - err_hmc * rss_new / 2.0
                - prop.kin_prop[g]
            ) - (
                prop.prior0[g] - err_hmc * rss_old / 2.0 - prop.kin0[g]
            )
            dead_g = prop.dead[g]
            mh_ok = jnp.log(us[i]) < log_acc
            accept = ~dead_g & mh_ok
            code = jnp.where(
                dead_g, 2, jnp.where(mh_ok, 0, 1)
            ).astype(jnp.int32)
            alpha = jnp.where(
                dead_g | jnp.isnan(log_acc), 0.0,
                jnp.minimum(1.0, jnp.exp(log_acc)),
            )
            r = jnp.where(accept, tgt - prop.y_pred_prop[g], r)
            return r, (g, accept, code, alpha)

        _, (gs, accs, codes, alphas) = jax.lax.scan(
            body, residual0, jnp.arange(B_)
        )
        accept_g = jnp.zeros(B_, bool).at[gs].set(accs)
        sel = lambda new, old: jnp.where(
            accept_g.reshape((B_,) + (1,) * (new.ndim - 1)), new, old
        )
        return HMCResult(
            weights=tuple(sel(wn, wo) for wn, wo in zip(prop.weights, old_w)),
            biases=tuple(sel(bn, bo) for bn, bo in zip(prop.biases, old_b)),
            code=jnp.zeros(B_, jnp.int32).at[gs].set(codes),
            y_pred=jnp.where(accept_g[:, None], prop.y_pred_prop, preds_blk),
            log_density=jnp.zeros(B_),
            accept_prob=jnp.zeros(B_).at[gs].set(alphas),
            uturn_step=prop.uturn_step,
        )

    def sweep_sequential(carry: TrainCarry, X, y):
        statics, masks_w, masks_b = _device_consts()
        key, k_perm, k_pi, k_pim = jax.random.split(carry.key, 4)
        carry = carry._replace(key=key)
        perm = jax.random.permutation(k_perm, G)

        def body(c, g):
            return branch_update(c, g, X, y, statics, masks_w, masks_b)

        carry, trajs = jax.lax.scan(body, carry, perm)
        carry = carry._replace(da_t=carry.da_t + 1.0)
        if ss_on:
            carry = ss_sweep_end(carry, k_pi)
        if ssm_on or ssr_on:
            carry = ssm_sweep_end(carry, k_pim)
        if record_traj:
            trajs = dict(trajs)
            trajs["perm"] = perm
        return carry, finish(carry, trajs if record_traj else ())

    # ------------------------------------------------------------ parallel
    def sweep_parallel(carry: TrainCarry, X, y):
        statics, masks_w, masks_b = _device_consts()
        state = carry.state
        params, precisions = state.params, state.precisions
        (key, k_e, k_loc, k_out, k_hmc, k_bias, k_len, k_ss, k_pi,
         k_prior, k_ssm, k_pim, k_lacc) = jax.random.split(carry.key, 13)

        # shared scalar Gibbs draws once per sweep, from the snapshot
        err_prec = precisions.error
        wp, bp = precisions.weights, precisions.biases
        if gibbs_precisions or joint:
            # in parallel-joint mode the shared scalars are frozen inside the
            # per-branch HMC and drawn here from their conjugate conditionals
            err_prec = _guard_err(
                gibbs.error_precision_posterior(
                    k_e, hyper, carry.residual, carry.beta if temper else None
                ),
                y,
            )
        err_hmc = err_prec * carry.beta if temper else err_prec
        if joint:
            lam_out = _gibbs_output_precision(
                k_out, model_type, _reg_all(model_type, params), n_out_tot, hyper
            )
            wp = tuple(
                jnp.full_like(wp[l], lam_out) if l == L - 1 else wp[l]
                for l in range(L)
            )
        z_r_all = None
        if sample_local:
            loc_keys = jax.random.split(k_loc, G)

            if ssr_on:
                ssr_force = carry.da_t < float(cfg.ssr_warmup)

                def draw_local_ssr(k, w_g, b_g, st_g):
                    return _gibbs_local_precisions(
                        k, model_type, w_g, b_g, st_g, hyper, L,
                        ssr=(carry.ssm_pi, cfg.ssr_spike, ssr_force,
                             cfg.ssr_shape, cfg.ssr_scale),
                        lam_floor=lam_row_floor,
                    )

                new_wp, new_bp, z_r_all = jax.vmap(draw_local_ssr)(
                    loc_keys,
                    tuple(params.weights[l] for l in range(L)),
                    tuple(params.biases[l] for l in range(L - 1)),
                    statics,
                )
            else:

                def draw_local(k, w_g, b_g, st_g, z0):
                    return _gibbs_local_precisions(
                        k, model_type, w_g, b_g, st_g, hyper, L,
                        z_rows0=z0, lam_floor=lam_row_floor,
                    )

                new_wp, new_bp = jax.vmap(draw_local)(
                    loc_keys,
                    tuple(params.weights[l] for l in range(L)),
                    tuple(params.biases[l] for l in range(L - 1)),
                    statics,
                    carry.ssm_z if ssm_on else None,
                )
            wp = tuple(new_wp[l] if l < L - 1 else wp[l] for l in range(L))
            bp = tuple(new_bp)
            n_out_gibbs = (
                jnp.sum(carry.ss_z * out_w_counts) if ss_on else n_out_tot
            )
            lam_out = _gibbs_output_precision(
                k_out, model_type, _reg_all(model_type, params), n_out_gibbs, hyper
            )
            # zero included output weights (total branch exclusion) would
            # make this a pure Gamma(0.001) prior draw — 0-or-huge, which
            # flattens the spike-and-slab evidence and makes exclusion
            # absorbing (measured NaN collapse, UKB finer x bss). Skipping
            # the update keeps the kernel valid and the state recoverable.
            lam_out = jnp.where(
                n_out_gibbs > 0, lam_out, wp[L - 1].reshape(-1)[0]
            )
            wp = tuple(
                jnp.full_like(wp[l], lam_out) if l == L - 1 else wp[l]
                for l in range(L)
            )

        # per-branch predictions from the snapshot; frozen residual base
        ss_z = carry.ss_z
        if ss_on and not ssm_on:
            # one forward serves both the snapshot predictions and the
            # summary activations A of the collapsed (z, w_out) move (see
            # the sequential path for the rationale); HMC below only
            # applies to included branches
            A_all = jax.vmap(
                lambda w, b, x: D.summary_acts(act, w, b, x)
            )(params.weights, params.biases, X)  # [G, n, s_pad]
            preds = jnp.einsum(
                "gns,gso->gn", A_all, params.weights[-1], precision=_HIGHEST
            )
        else:
            preds = jax.vmap(lambda w, b, x: D.predict(act, w, b, x))(
                params.weights, params.biases, X
            )  # [G, n]
        targets = carry.residual[None, :] + preds  # y - bias - sum_{g'!=g} pred
        residual = carry.residual

        ssm_z = carry.ssm_z
        if z_r_all is not None:  # ss_rows indicators share the ssm slots
            ssm_z = z_r_all
        z_m = None
        if ssm_on:
            # per-marker collapsed scans, vmapped over branches, each a
            # live-residual random scan within its branch (see the
            # sequential path)
            ssm_keys = jax.random.split(k_ssm, G)
            lam_rows_all = jnp.broadcast_to(
                wp[0][:, :, 0], (G, arch.m_pad)
            )
            ssm_force = carry.da_t < float(cfg.ssm_warmup)
            z_m, W0_new, _ = jax.vmap(
                lambda k, x, W0, b0, wo, r, lr, rm, cm: _marker_ss_scan(
                    k, x, W0, b0, wo, r, err_hmc, lr, carry.ssm_pi, rm, cm,
                    ssm_force, lasso=D.is_lasso(model_type),
                )
            )(
                ssm_keys, X, params.weights[0], params.biases[0],
                params.weights[-1],
                jnp.broadcast_to(carry.residual, (G, carry.residual.shape[0])),
                lam_rows_all,
                statics.row_masks[0][:, :, 0], masks_b[0],
            )
            params = StackedParams(
                (W0_new,) + params.weights[1:], params.biases
            )
            ssm_z = z_m
            if ss_on:  # branch-level move needs A at the UPDATED layer 0
                A_all = jax.vmap(
                    lambda w, b, x: D.summary_acts(act, w, b, x)
                )(params.weights, params.biases, X)
            # (live-accept rebase to the post-scan state happens after the
            # transition, using the proposal's own y_pred0 — saves a full
            # forward; see the res handling below)

        if ssr_on:
            # whitened scaled-flip MH, vmapped over branches (k_ssm is
            # unused when ss_rows is on — the modes are mutually exclusive)
            flip_keys = jax.random.split(k_ssm, G)
            z_new, lam_new, W0_new, _ = jax.vmap(
                lambda k, x, w_gg, b_gg, lam0, z0, t, rm: _ssr_flip_scan(
                    k, x, w_gg, b_gg, act, lam0, z0, t, err_hmc,
                    carry.ssm_pi, cfg.ssr_spike, cfg.ssr_shape,
                    cfg.ssr_scale, rm,
                )
            )(
                flip_keys, X, params.weights, params.biases,
                wp[0][:, :, 0], ssm_z, targets,
                statics.row_masks[0][:, :, 0],
            )
            params = StackedParams(
                (W0_new,) + params.weights[1:], params.biases
            )
            wp = (lam_new[:, :, None],) + wp[1:]
            ssm_z = z_new

        if ss_on:
            ss_keys = jax.random.split(k_ss, G)
            ss_force = carry.da_t < float(cfg.ss_warmup)
            ss_z, w_out_new, _ = jax.vmap(
                lambda k, A, t, lo, m: _spike_slab_update(
                    k, A, t, err_hmc, lo, carry.ss_pi, m,
                    force_include=ss_force,
                )
            )(ss_keys, A_all, targets, wp[-1].reshape(G), masks_w[-1])
            params = StackedParams(
                params.weights[:-1] + (w_out_new,), params.biases
            )

        hmc_keys = jax.random.split(k_hmc, G)

        if adaptive:
            warm = carry.da_t < cfg.burn_in
            step_factors = jnp.exp(
                jnp.where(warm, carry.da_log_eps, carry.da_log_eps_bar)
            )
        else:
            step_factors = jnp.ones(G)

        if joint:
            reg_all = _reg_all(model_type, params)
            reg_others = jax.vmap(
                lambda w_last: reg_all - D.summary_stat(model_type, w_last)
            )(params.weights[-1])

            def one_joint(k, w_g, b_g, wp_g, bp_g, x_g, t_g, mw_g, mb_g, npar, st_g, ro):
                return transition(
                    k, w_g, b_g, wp_g, bp_g, err_prec, x_g, t_g, mw_g, mb_g,
                    npar, jnp.asarray(n_precisions), hyper, st_g, ro, n_out_tot,
                )

            out = jax.vmap(one_joint)(
                hmc_keys, params.weights, params.biases, wp, bp, X, targets,
                masks_w, masks_b, statics.n_params, statics, reg_others,
            )
            if record_traj:
                (res, wp_new, bp_new, _), trajs = out
                trajs = dict(trajs)
                trajs["perm"] = jnp.arange(G)
            else:
                (res, wp_new, bp_new, _), trajs = out, ()
            # local precisions moved in-HMC (accept-selected inside the
            # transition); the shared output row stays the Gibbs draw
            wp = tuple(wp_new[l] if l < L - 1 else wp[l] for l in range(L))
            bp = tuple(bp_new)
        else:
            traj_lens = (
                _draw_traj_len(k_len, carry.tl_avg, L_int, cfg.hmc_traj_length_mode)
                if dyn_len
                else None
            )

            def one(k, w_g, b_g, wp_g, bp_g, x_g, t_g, mw_g, mb_g, npar, fac,
                    mass, tl, rf):
                kw = {}
                if mass is not None:
                    kw["mass_w"], kw["mass_b"] = mass
                if tl is not None:
                    kw["traj_len"] = tl
                if rf is not None:
                    kw["row_freeze"] = rf
                return transition(
                    k, w_g, b_g, wp_g, bp_g, err_hmc, x_g, t_g, mw_g, mb_g, npar,
                    fac if adaptive else None, **kw,
                )

            mass = None
            if mass_adapt:
                cnt = jnp.minimum(carry.da_t, burn_f)
                mass = jax.vmap(
                    lambda mn, m2, wp_g, bp_g, w_g, b_g: _mass_std(
                        model_type, mn, m2, cnt, wp_g, bp_g, w_g, b_g
                    )
                )(carry.mm_mean, carry.mm_m2, wp, bp, params.weights, params.biases)
            out = jax.vmap(one)(
                hmc_keys,
                params.weights,
                params.biases,
                wp,
                bp,
                X,
                targets,
                masks_w,
                masks_b,
                statics.n_params,
                step_factors,
                mass,
                traj_lens,
                z_m,
            )
            if record_traj:
                res, trajs = out
                trajs = dict(trajs)
                trajs["perm"] = jnp.arange(G)
            else:
                res, trajs = out, ()
            if live_accept:
                if ssm_on:
                    # rebase the snapshot to the post-scan state via the
                    # proposal's OWN initial-state prediction (r5): keeps
                    # the accept operator-consistent AND absorbs the
                    # collapsed scan's prediction change without an extra
                    # forward pass
                    residual = residual + jnp.sum(
                        preds - res.y_pred0, axis=0
                    )
                    preds = res.y_pred0
                # res is an HMCProposal batch: accepts run sequentially
                # against the live residual (exact kernel; HMCProposal doc)
                res = _live_accept_select(
                    k_lacc, residual, preds, res, err_hmc,
                    params.weights, params.biases,
                )
        res_weights, res_biases, y_pred_new = res.weights, res.biases, res.y_pred
        inc = jnp.ones(G, bool)
        if ss_on:
            inc = ss_z > 0.0
            pks = jax.random.split(k_prior, L - 1)
            sel = lambda a, b_: jnp.where(
                inc.reshape((G,) + (1,) * (a.ndim - 1)), a, b_
            )
            prior_ws = [
                jax.random.normal(pks[l], params.weights[l].shape)
                / jnp.sqrt(wp[l]) * masks_w[l]
                for l in range(L - 1)
            ]
            if ssm_on:  # spiked rows stay exactly 0 in the prior redraw too
                prior_ws[0] = prior_ws[0] * z_m[:, :, None]
            res_weights = tuple(
                sel(res.weights[l], prior_ws[l]) for l in range(L - 1)
            ) + (params.weights[-1],)
            res_biases = tuple(
                sel(res.biases[l], params.biases[l]) for l in range(L - 1)
            )
            y_pred_new = jnp.where(inc[:, None], res.y_pred, 0.0)
        params = StackedParams(res_weights, res_biases)
        precisions = StackedPrecisions(wp, bp, err_prec)
        residual = residual + jnp.sum(preds - y_pred_new, axis=0)

        tl_avg = carry.tl_avg
        if uturn_adapt:
            tl_avg = _tl_update(
                tl_avg, res.uturn_step, traj_lens, res.code,
                (carry.da_t < burn_f) & inc, L_int,
            )

        mm_mean, mm_m2 = carry.mm_mean, carry.mm_m2
        if mass_adapt:
            from ..samplers.hmc import flatten_wb

            warm_mm = carry.da_t < burn_f
            flat = jax.vmap(flatten_wb)(params.weights, params.biases)  # [G, P]
            mean_new, m2_new = _welford(mm_mean, mm_m2, flat, carry.da_t + 1.0)
            mm_mean = jnp.where(warm_mm, mean_new, mm_mean)
            mm_m2 = jnp.where(warm_mm, m2_new, mm_m2)

        # LPD bookkeeping, vectorized
        lpd_local = jax.vmap(
            lambda w_g, b_g, wp_g, bp_g, st_g: D.joint_local_term(
                model_type, w_g, b_g, wp_g, bp_g, hyper, st_g
            )
        )(params.weights, params.biases, wp, bp, statics)
        reg_all = _reg_all(model_type, params)
        w0 = tuple(w[0] for w in params.weights)
        wp0 = tuple(a[0] for a in wp)
        lpd_out = D.joint_output_term(
            model_type, w0, wp0, hyper,
            reg_all - D.summary_stat(model_type, w0[-1]),
            jnp.sum(ss_z * out_w_counts) if ss_on else n_out_tot,
        )
        lpd_rss = D.joint_rss_term(
            err_prec, jnp.sum(residual**2), hyper,
            jnp.asarray(residual.shape[0], jnp.float32),
        )

        residual, bias, bias_prec = _update_output_bias(
            cfg, hyper, k_bias, residual, state.output_bias,
            state.output_bias_precision, err_hmc,
        )

        counts = carry.counts
        for code in range(3):
            counts = counts.at[code].add(jnp.sum((res.code == code) & inc))

        da_log_eps, da_log_eps_bar, da_h_bar = (
            carry.da_log_eps, carry.da_log_eps_bar, carry.da_h_bar
        )
        if adaptive:
            warm = (carry.da_t < cfg.burn_in) & inc
            t = carry.da_t + 1.0
            h_new, le_new, leb_new = _da_update(
                cfg, t, carry.da_h_bar, carry.da_log_eps_bar,
                res.accept_prob, da_mu,
            )
            da_h_bar = jnp.where(warm, h_new, da_h_bar)
            da_log_eps = jnp.where(warm, le_new, da_log_eps)
            da_log_eps_bar = jnp.where(warm, leb_new, da_log_eps_bar)

        carry = TrainCarry(
            state=NetState(params, precisions, bias, bias_prec),
            residual=residual,
            lpd_local=lpd_local,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
            counts=counts,
            key=key,
            da_log_eps=da_log_eps,
            da_log_eps_bar=da_log_eps_bar,
            da_h_bar=da_h_bar,
            da_t=carry.da_t + 1.0,
            mm_mean=mm_mean,
            mm_m2=mm_m2,
            beta=carry.beta,
            tl_avg=tl_avg,
            ss_z=ss_z,
            ss_pi=carry.ss_pi,
            ss_pip=carry.ss_pip,
            ssm_z=ssm_z,
            ssm_pi=carry.ssm_pi,
            ssm_pip=carry.ssm_pip,
        )
        if ss_on:
            carry = ss_sweep_end(carry, k_pi)
        if ssm_on or ssr_on:
            carry = ssm_sweep_end(carry, k_pim)
        return carry, finish(carry, trajs)

    # ------------------------------------------------------------- hybrid
    from jax.custom_batching import custom_vmap as _custom_vmap

    @_custom_vmap
    def _shared_perm(t):
        k = jax.random.fold_in(
            jax.random.key(cfg.seed ^ 0x5EED5EED), t.astype(jnp.int32)
        )
        return jax.random.permutation(k, G)

    @_shared_perm.def_vmap
    def _shared_perm_rule(axis_size, in_batched, t):
        (tb,) = in_batched
        # every chain's sweep counter is identical; evaluate once and mark
        # the permutation unbatched so X[ixs] stays shared over chains
        return _shared_perm(t[0] if tb else t), False

    def sweep_hybrid(carry: TrainCarry, X, y):
        """Sequential scan over random blocks; parallel updates within a
        block. Shared scalars (error precision, output precision, summary
        stats) refresh per block, like the sequential schedule refreshes
        them per branch — bounding the stale-residual coupling that degrades
        the fully-parallel kernel at large G to block_size branches."""
        statics, masks_w, masks_b = _device_consts()
        B = cfg.block_size if cfg.block_size > 0 else default_block_size(G)
        assert G % B == 0, f"block_size {B} must divide num_branches {G}"
        R = G // B
        key, k_perm, k_pi, k_pim = jax.random.split(carry.key, 4)
        carry = carry._replace(key=key)
        if cfg.hybrid_shared_perm:
            # r5: the per-sweep block permutation is a SHARED draw, keyed on
            # (cfg.seed, sweep counter) instead of the per-chain carry key.
            # Under a chain vmap the custom_vmap rule marks it unbatched, so
            # the block genotype slice X[ixs] stays shared over chains: one
            # gather of the block's X, and each leapfrog dot reads it once
            # for all chains. Chains remain independent given the
            # schedule — a common random scan order is the multi-chain
            # analog of systematic-scan Gibbs (the reference shuffles a
            # single chain's order, net.rs:257). Value-identical between
            # vmapped and lax.map arrangements; draws differ from
            # hybrid_shared_perm=False runs (the pre-r5 behavior).
            perm = _shared_perm(carry.da_t)
        else:
            perm = jax.random.permutation(k_perm, G)
        perm = perm.reshape(R, B)

        def block_update(c: TrainCarry, ixs):
            state, residual = c.state, c.residual
            params, precisions = state.params, state.precisions
            (key, k_e, k_loc, k_out, k_hmc, k_bias, k_len, k_ss, k_prior,
             k_ssm, k_lacc) = jax.random.split(c.key, 11)

            err_prec = precisions.error
            wp, bp = precisions.weights, precisions.biases
            if gibbs_precisions or joint:
                err_prec = _guard_err(
                    gibbs.error_precision_posterior(
                        k_e, hyper, residual, c.beta if temper else None
                    ),
                    y,
                )
            err_hmc = err_prec * c.beta if temper else err_prec
            if joint:
                lam_out = _gibbs_output_precision(
                    k_out, model_type, _reg_all(model_type, params), n_out_tot, hyper
                )
                wp = tuple(
                    jnp.full_like(wp[l], lam_out) if l == L - 1 else wp[l]
                    for l in range(L)
                )
            gather = lambda tree: jax.tree.map(lambda a: a[ixs], tree)
            w_b = tuple(w[ixs] for w in params.weights)
            b_b = tuple(b[ixs] for b in params.biases)
            st_b = gather(statics)
            z_r_blk = None
            if sample_local:
                loc_keys = jax.random.split(k_loc, B)

                if ssr_on:
                    ssr_force = c.da_t < float(cfg.ssr_warmup)

                    def draw_local_ssr(k, w_g, b_g, st_g):
                        return _gibbs_local_precisions(
                            k, model_type, w_g, b_g, st_g, hyper, L,
                            ssr=(c.ssm_pi, cfg.ssr_spike, ssr_force,
                                 cfg.ssr_shape, cfg.ssr_scale),
                            lam_floor=lam_row_floor,
                        )

                    new_wp, new_bp, z_r_blk = jax.vmap(draw_local_ssr)(
                        loc_keys, w_b, b_b, st_b
                    )
                else:

                    def draw_local(k, w_g, b_g, st_g, z0):
                        return _gibbs_local_precisions(
                            k, model_type, w_g, b_g, st_g, hyper, L,
                            z_rows0=z0, lam_floor=lam_row_floor,
                        )

                    new_wp, new_bp = jax.vmap(draw_local)(
                        loc_keys, w_b, b_b, st_b,
                        c.ssm_z[ixs] if ssm_on else None,
                    )
                wp = tuple(
                    wp[l].at[ixs].set(new_wp[l]) if l < L - 1 else wp[l]
                    for l in range(L)
                )
                bp = tuple(bp[l].at[ixs].set(new_bp[l]) for l in range(L - 1))
                n_out_gibbs = (
                    jnp.sum(c.ss_z * out_w_counts) if ss_on else n_out_tot
                )
                lam_out = _gibbs_output_precision(
                    k_out, model_type, _reg_all(model_type, params), n_out_gibbs, hyper
                )
                # see the parallel path: keep the previous shared precision
                # when no output weights are included
                lam_out = jnp.where(
                    n_out_gibbs > 0, lam_out, wp[L - 1].reshape(-1)[0]
                )
                wp = tuple(
                    jnp.full_like(wp[l], lam_out) if l == L - 1 else wp[l]
                    for l in range(L)
                )

            wp_b = tuple(a[ixs] for a in wp)
            bp_b = tuple(a[ixs] for a in bp)
            x_b = X[ixs]
            ss_z = c.ss_z
            if ss_on and not ssm_on:
                # one forward serves both the block predictions and the
                # summary activations A of the collapsed move; HMC applies
                # to included branches only (see the sequential path)
                A_blk = jax.vmap(
                    lambda w, b, x: D.summary_acts(act, w, b, x)
                )(w_b, b_b, x_b)  # [B, n, s_pad]
                preds = jnp.einsum(
                    "gns,gso->gn", A_blk, w_b[-1], precision=_HIGHEST
                )
            else:
                preds = jax.vmap(lambda w, b, x: D.predict(act, w, b, x))(
                    w_b, b_b, x_b
                )  # [B, n]
            targets = residual[None, :] + preds

            ssm_z = c.ssm_z
            if z_r_blk is not None:  # ss_rows indicators share the ssm slots
                ssm_z = ssm_z.at[ixs].set(z_r_blk)
            z_m = None
            if ssm_on:
                # per-marker collapsed scans for the block (see the
                # sequential path)
                ssm_keys = jax.random.split(k_ssm, B)
                lam_rows_b = jnp.broadcast_to(
                    wp[0][:, :, 0], (G, arch.m_pad)
                )[ixs]
                ssm_force = c.da_t < float(cfg.ssm_warmup)
                z_m, W0_new, _ = jax.vmap(
                    lambda k, x, W0, b0, wo, r, lr, rm, cm: _marker_ss_scan(
                        k, x, W0, b0, wo, r, err_hmc, lr, c.ssm_pi, rm, cm,
                        ssm_force, lasso=D.is_lasso(model_type),
                    )
                )(
                    ssm_keys, x_b, w_b[0], b_b[0], w_b[-1],
                    jnp.broadcast_to(residual, (B, residual.shape[0])),
                    lam_rows_b, statics.row_masks[0][ixs][:, :, 0],
                    masks_b[0][ixs],
                )
                w_b = (W0_new,) + w_b[1:]
                ssm_z = ssm_z.at[ixs].set(z_m)
                if ss_on:  # branch move needs A at the UPDATED layer 0
                    A_blk = jax.vmap(
                        lambda w, b, x: D.summary_acts(act, w, b, x)
                    )(w_b, b_b, x_b)
                # (live-accept rebase moved after the transition, via the
                # proposal's y_pred0 — see below)

            if ssr_on:
                # whitened scaled-flip MH for the block (k_ssm unused when
                # ss_rows is on — the modes are mutually exclusive)
                flip_keys = jax.random.split(k_ssm, B)
                z_new, lam_new, W0_new, _ = jax.vmap(
                    lambda k, x, w_gg, b_gg, lam0, z0, t, rm: _ssr_flip_scan(
                        k, x, w_gg, b_gg, act, lam0, z0, t, err_hmc,
                        c.ssm_pi, cfg.ssr_spike, cfg.ssr_shape,
                        cfg.ssr_scale, rm,
                    )
                )(
                    flip_keys, x_b, w_b, b_b, wp_b[0][:, :, 0],
                    ssm_z[ixs], targets,
                    statics.row_masks[0][ixs][:, :, 0],
                )
                w_b = (W0_new,) + w_b[1:]
                wp = (wp[0].at[ixs].set(lam_new[:, :, None]),) + wp[1:]
                wp_b = (lam_new[:, :, None],) + wp_b[1:]
                ssm_z = ssm_z.at[ixs].set(z_new)

            if ss_on:
                ss_keys = jax.random.split(k_ss, B)
                ss_force = c.da_t < float(cfg.ss_warmup)
                z_blk, w_out_new, _ = jax.vmap(
                    lambda k, A, t, lo, m: _spike_slab_update(
                        k, A, t, err_hmc, lo, c.ss_pi, m,
                        force_include=ss_force,
                    )
                )(ss_keys, A_blk, targets, wp[-1][ixs].reshape(B),
                  masks_w[-1][ixs])
                w_b = w_b[:-1] + (w_out_new,)
                ss_z = ss_z.at[ixs].set(z_blk)

            if adaptive:
                warm = c.da_t < cfg.burn_in
                step_factors = jnp.exp(
                    jnp.where(warm, c.da_log_eps[ixs], c.da_log_eps_bar[ixs])
                )
            else:
                step_factors = jnp.ones(B)

            hmc_keys = jax.random.split(k_hmc, B)

            if joint:
                reg_all = _reg_all(model_type, params)
                reg_others = jax.vmap(
                    lambda w_last: reg_all - D.summary_stat(model_type, w_last)
                )(w_b[-1])

                def one_joint(
                    k, w_g, b_g, wp_g, bp_g, x_g, t_g, mw_g, mb_g, npar, st_g, ro
                ):
                    return transition(
                        k, w_g, b_g, wp_g, bp_g, err_prec, x_g, t_g, mw_g, mb_g,
                        npar, jnp.asarray(n_precisions), hyper, st_g, ro, n_out_tot,
                    )

                out = jax.vmap(one_joint)(
                    hmc_keys, w_b, b_b, wp_b, bp_b, x_b, targets,
                    tuple(m[ixs] for m in masks_w),
                    tuple(m[ixs] for m in masks_b),
                    statics.n_params[ixs], st_b, reg_others,
                )
                if record_traj:
                    (res, wp_new, bp_new, _), traj_blk = out
                else:
                    (res, wp_new, bp_new, _), traj_blk = out, ()
                wp = tuple(
                    wp[l].at[ixs].set(wp_new[l]) if l < L - 1 else wp[l]
                    for l in range(L)
                )
                bp = tuple(bp[l].at[ixs].set(bp_new[l]) for l in range(L - 1))
            else:
                traj_lens = (
                    _draw_traj_len(
                        k_len, c.tl_avg[ixs], L_int, cfg.hmc_traj_length_mode
                    )
                    if dyn_len
                    else None
                )

                def one(k, w_g, b_g, wp_g, bp_g, x_g, t_g, mw_g, mb_g, npar,
                        fac, mass, tl, rf):
                    kw = {}
                    if mass is not None:
                        kw["mass_w"], kw["mass_b"] = mass
                    if tl is not None:
                        kw["traj_len"] = tl
                    if rf is not None:
                        kw["row_freeze"] = rf
                    return transition(
                        k, w_g, b_g, wp_g, bp_g, err_hmc, x_g, t_g, mw_g, mb_g,
                        npar, fac if adaptive else None, **kw,
                    )

                mass = None
                if mass_adapt:
                    cnt = jnp.minimum(c.da_t, burn_f)
                    mass = jax.vmap(
                        lambda mn, m2, wp_g, bp_g, w_g, b_g: _mass_std(
                            model_type, mn, m2, cnt, wp_g, bp_g, w_g, b_g
                        )
                    )(c.mm_mean[ixs], c.mm_m2[ixs], wp_b, bp_b, w_b, b_b)
                out = jax.vmap(one)(
                    hmc_keys, w_b, b_b, wp_b, bp_b, x_b, targets,
                    tuple(m[ixs] for m in masks_w),
                    tuple(m[ixs] for m in masks_b),
                    statics.n_params[ixs],
                    step_factors,
                    mass,
                    traj_lens,
                    z_m,
                )
                res, traj_blk = out if record_traj else (out, ())
                if live_accept:
                    if ssm_on:
                        # rebase to the post-scan state via the proposal's
                        # own initial-state prediction (see sweep_parallel)
                        residual = residual + jnp.sum(
                            preds - res.y_pred0, axis=0
                        )
                        preds = res.y_pred0
                    # block proposals accept sequentially against the live
                    # residual (exact kernel; HMCProposal doc)
                    res = _live_accept_select(
                        k_lacc, residual, preds, res, err_hmc, w_b, b_b
                    )
            res_weights, res_biases, y_pred_new = (
                res.weights, res.biases, res.y_pred
            )
            inc = jnp.ones(B, bool)
            if ss_on:
                inc = z_blk > 0.0
                pks = jax.random.split(k_prior, L - 1)
                sel = lambda a, b_: jnp.where(
                    inc.reshape((B,) + (1,) * (a.ndim - 1)), a, b_
                )
                prior_ws = [
                    jax.random.normal(pks[l], w_b[l].shape)
                    / jnp.sqrt(wp_b[l]) * masks_w[l][ixs]
                    for l in range(L - 1)
                ]
                if ssm_on:  # spiked rows stay exactly 0
                    prior_ws[0] = prior_ws[0] * z_m[:, :, None]
                res_weights = tuple(
                    sel(res.weights[l], prior_ws[l]) for l in range(L - 1)
                ) + (w_b[-1],)
                res_biases = tuple(
                    sel(res.biases[l], b_b[l]) for l in range(L - 1)
                )
                y_pred_new = jnp.where(inc[:, None], res.y_pred, 0.0)
            params = StackedParams(
                tuple(params.weights[l].at[ixs].set(res_weights[l]) for l in range(L)),
                tuple(params.biases[l].at[ixs].set(res_biases[l]) for l in range(L - 1)),
            )
            precisions = StackedPrecisions(wp, bp, err_prec)
            residual = residual + jnp.sum(preds - y_pred_new, axis=0)

            tl_avg = c.tl_avg
            if uturn_adapt:
                tl_avg = tl_avg.at[ixs].set(
                    _tl_update(
                        tl_avg[ixs], res.uturn_step, traj_lens, res.code,
                        (c.da_t < burn_f) & inc, L_int,
                    )
                )

            mm_mean, mm_m2 = c.mm_mean, c.mm_m2
            if mass_adapt:
                from ..samplers.hmc import flatten_wb

                warm_mm = c.da_t < burn_f
                flat = jax.vmap(flatten_wb)(res_weights, res_biases)  # [B, P]
                mean_new, m2_new = _welford(
                    mm_mean[ixs], mm_m2[ixs], flat, c.da_t + 1.0
                )
                mm_mean = mm_mean.at[ixs].set(
                    jnp.where(warm_mm, mean_new, mm_mean[ixs])
                )
                mm_m2 = mm_m2.at[ixs].set(jnp.where(warm_mm, m2_new, mm_m2[ixs]))

            lpd_block = jax.vmap(
                lambda w_g, b_g, wp_g, bp_g, st_g: D.joint_local_term(
                    model_type, w_g, b_g, wp_g, bp_g, hyper, st_g
                )
            )(
                tuple(w[ixs] for w in params.weights),
                tuple(b[ixs] for b in params.biases),
                tuple(a[ixs] for a in wp),
                tuple(a[ixs] for a in bp),
                st_b,
            )
            lpd_local = c.lpd_local.at[ixs].set(lpd_block)
            reg_all = _reg_all(model_type, params)
            w0 = tuple(w[0] for w in params.weights)
            wp0 = tuple(a[0] for a in wp)
            lpd_out = D.joint_output_term(
                model_type, w0, wp0, hyper,
                reg_all - D.summary_stat(model_type, w0[-1]),
                jnp.sum(ss_z * out_w_counts) if ss_on else n_out_tot,
            )
            lpd_rss = D.joint_rss_term(
                err_prec, jnp.sum(residual**2), hyper,
                jnp.asarray(residual.shape[0], jnp.float32),
            )

            residual, bias, bias_prec = _update_output_bias(
                cfg, hyper, k_bias, residual, state.output_bias,
                state.output_bias_precision, err_hmc,
            )

            counts = c.counts
            for code in range(3):
                counts = counts.at[code].add(jnp.sum((res.code == code) & inc))

            da_log_eps, da_log_eps_bar, da_h_bar = (
                c.da_log_eps, c.da_log_eps_bar, c.da_h_bar
            )
            if adaptive:
                warm = (c.da_t < cfg.burn_in) & inc
                t = c.da_t + 1.0
                h_new, le_new, leb_new = _da_update(
                    cfg, t, c.da_h_bar[ixs], c.da_log_eps_bar[ixs],
                    res.accept_prob, da_mu,
                )
                da_h_bar = da_h_bar.at[ixs].set(
                    jnp.where(warm, h_new, da_h_bar[ixs])
                )
                da_log_eps = da_log_eps.at[ixs].set(
                    jnp.where(warm, le_new, da_log_eps[ixs])
                )
                da_log_eps_bar = da_log_eps_bar.at[ixs].set(
                    jnp.where(warm, leb_new, da_log_eps_bar[ixs])
                )

            return TrainCarry(
                state=NetState(params, precisions, bias, bias_prec),
                residual=residual,
                lpd_local=lpd_local,
                lpd_out=lpd_out,
                lpd_rss=lpd_rss,
                counts=counts,
                key=key,
                da_log_eps=da_log_eps,
                da_log_eps_bar=da_log_eps_bar,
                da_h_bar=da_h_bar,
                da_t=c.da_t,
                mm_mean=mm_mean,
                mm_m2=mm_m2,
                beta=c.beta,
                tl_avg=tl_avg,
                ss_z=ss_z,
                ss_pi=c.ss_pi,
                ss_pip=c.ss_pip,
                ssm_z=ssm_z,
                ssm_pi=c.ssm_pi,
                ssm_pip=c.ssm_pip,
            ), traj_blk

        carry, trajs = jax.lax.scan(block_update, carry, perm)
        carry = carry._replace(da_t=carry.da_t + 1.0)
        if ss_on:
            carry = ss_sweep_end(carry, k_pi)
        if ssm_on or ssr_on:
            carry = ssm_sweep_end(carry, k_pim)
        if record_traj:
            # scan stacks block trajectories [R, B, ...] -> flatten to the
            # branch-update order [G, ...]; "perm" maps rows to branch ixs
            trajs = dict(jax.tree.map(
                lambda a: a.reshape((G,) + a.shape[2:]), trajs
            ))
            trajs["perm"] = perm.reshape(-1)
        else:
            trajs = ()
        return carry, finish(carry, trajs)

    if cfg.gradient_descent_joint and cfg.update_mode != "sequential":
        raise NotImplementedError("gradient_descent_joint requires sequential mode")

    return {
        "sequential": sweep_sequential,
        "parallel": sweep_parallel,
        "hybrid": sweep_hybrid,
    }[cfg.update_mode]


# --------------------------------------------------------------------------
# Net
# --------------------------------------------------------------------------


class Net:
    """Full model: architecture + hyperparameters + sampler state.

    Mirrors the public surface of the reference ``Net<B>``: train /
    train-single-branch (the sequential sweep covers both), predict,
    branch_r2s, activations, gradient, population_effect_sizes, save/load.
    """

    def __init__(
        self,
        model_type: str,
        arch: NetArch,
        hyper: D.Hyperparameters,
        state: NetState,
    ):
        assert model_type in D.MODEL_TYPES, model_type
        self.model_type = model_type
        self.arch = arch
        self.hyper = hyper
        self.state = state

    # ------------------------------------------------------------- predict
    def _n_of(self, X) -> int:
        return X.n if isinstance(X, (D.PackedX, D.FeatX)) else X.shape[1]

    def _branch_map(self, f, X, *per_branch_trees):
        """Map ``f(x_g, *slices)`` over branches: vmap when the stacked
        per-branch activations fit comfortably in HBM, else a sequential
        ``lax.map`` so only ONE branch's activations materialize at a time
        (vmapping all G branches over UKB-scale n allocates
        G x n x width f32 — measured 23.6 GB at G=100, n=460k)."""
        n = self._n_of(X)
        width = max(
            self.arch.layer_out_pad(l) for l in range(self.arch.num_layers)
        )
        stacked_bytes = 4 * self.arch.num_branches * n * width
        if stacked_bytes <= 2_000_000_000:
            return jax.vmap(f)(X, *per_branch_trees)
        return jax.lax.map(lambda args: f(*args), (X, *per_branch_trees))

    def predict(self, X, state: Optional[NetState] = None) -> jax.Array:
        """y_hat [n] = bias + sum of branch predictions (net.rs:545-559)."""
        state = state if state is not None else self.state
        act = self.arch.activation
        preds = self._branch_map(
            lambda x, w, b: D.predict(act, w, b, x),
            X, state.params.weights, state.params.biases,
        )
        return state.output_bias + jnp.sum(preds, axis=0)

    def mse(self, X, y, state: Optional[NetState] = None) -> jax.Array:
        r = self.predict(X, state) - y
        return jnp.sum(r * r) / y.shape[0]

    def branch_r2s(self, X, y, state: Optional[NetState] = None) -> jax.Array:
        """Per-branch 1 - rss/ssq(y) (branch_sampler.rs:911-913)."""
        state = state if state is not None else self.state
        act = self.arch.activation

        def one(x, w, b):
            r = D.predict(act, w, b, x) - y
            return 1.0 - jnp.sum(r * r) / jnp.sum(y * y)

        return self._branch_map(
            one, X, state.params.weights, state.params.biases
        )

    def activations(self, X, state: Optional[NetState] = None):
        """Per-branch per-layer activations (net.rs:509-518)."""
        state = state if state is not None else self.state
        act = self.arch.activation
        out = []
        for g in range(self.arch.num_branches):
            w = tuple(w[g] for w in state.params.weights)
            b = tuple(b[g] for b in state.params.biases)
            _, acts = D.forward(act, w, b, X[g])
            if isinstance(X, D.FeatX):  # intermediates are feature-major
                acts = [a.T for a in acts[:-1]] + [acts[-1]]
            out.append([np.asarray(a) for a in acts])
        return out

    def gradients(self, X, y, state: Optional[NetState] = None):
        """Per-branch marginal log-density gradients (net.rs:520-527)."""
        state = state if state is not None else self.state
        act = self.arch.activation
        pot = D.potential_fn(self.model_type, act)
        grads = []
        for g in range(self.arch.num_branches):
            w = tuple(w[g] for w in state.params.weights)
            b = tuple(b[g] for b in state.params.biases)
            wp = tuple(a[g] for a in state.precisions.weights)
            gw, gb = jax.grad(pot, argnums=(0, 1))(
                w, b, wp, state.precisions.error, X[g], y
            )
            grads.append((tuple(np.asarray(a) for a in gw),
                          tuple(np.asarray(a) for a in gb)))
        return grads

    def effect_sizes(self, X, state: Optional[NetState] = None):
        """[G, n, m_pad] input gradients (branch_sampler.rs:787-811).

        Works on dense and packed genotypes (the input gradient only needs
        the forward activations and the weights, never a gradient through
        the 2-bit decode); branches are mapped with the HBM-aware strategy
        so genome-scale n does not materialize all activations at once.
        """
        state = state if state is not None else self.state
        act = self.arch.activation
        return self._branch_map(
            lambda x, w, b: D.effect_sizes(act, w, b, x),
            X, state.params.weights, state.params.biases,
        )

    def population_effect_sizes(self, X, state: Optional[NetState] = None):
        """Per-marker population mean of d y_hat/d x (net.rs:529-543)."""
        es = self.effect_sizes(X, state)  # [G, n, m_pad]
        means = jnp.mean(es, axis=1)  # [G, m_pad]
        out = []
        for g in range(self.arch.num_branches):
            out.extend(np.asarray(means[g, : self.arch.m[g]]).tolist())
        return out

    # --------------------------------------------------------------- io
    def save(self, path: str, state: Optional[NetState] = None):
        state = state if state is not None else self.state
        arrays = {}
        for l, w in enumerate(state.params.weights):
            arrays[f"w{l}"] = np.asarray(w)
        for l, b in enumerate(state.params.biases):
            arrays[f"b{l}"] = np.asarray(b)
        for l, w in enumerate(state.precisions.weights):
            arrays[f"wp{l}"] = np.asarray(w)
        for l, b in enumerate(state.precisions.biases):
            arrays[f"bp{l}"] = np.asarray(b)
        arrays["error_precision"] = np.asarray(state.precisions.error)
        arrays["output_bias"] = np.asarray(state.output_bias)
        arrays["output_bias_precision"] = np.asarray(state.output_bias_precision)
        meta = {
            "model_type": self.model_type,
            "arch": {
                "m": list(self.arch.m),
                "h": list(self.arch.h),
                "s": list(self.arch.s),
                "depth": self.arch.depth,
                "activation": self.arch.activation,
                "pad_multiple": self.arch.pad_multiple,
            },
            "hyper": list(self.hyper),
        }
        arrays["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str) -> "Net":
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        meta = json.loads(bytes(z["meta_json"]).decode())
        a = meta["arch"]
        arch = NetArch(
            m=tuple(a["m"]), h=tuple(a["h"]), s=tuple(a["s"]), depth=a["depth"],
            activation=a["activation"], pad_multiple=a["pad_multiple"],
        )
        L = arch.num_layers
        params = StackedParams(
            tuple(jnp.asarray(z[f"w{l}"]) for l in range(L)),
            tuple(jnp.asarray(z[f"b{l}"]) for l in range(L - 1)),
        )
        precisions = StackedPrecisions(
            tuple(jnp.asarray(z[f"wp{l}"]) for l in range(L)),
            tuple(jnp.asarray(z[f"bp{l}"]) for l in range(L - 1)),
            jnp.asarray(z["error_precision"]),
        )
        state = NetState(
            params, precisions,
            jnp.asarray(z["output_bias"]),
            jnp.asarray(z["output_bias_precision"]),
        )
        return Net(
            meta["model_type"], arch, D.Hyperparameters(*meta["hyper"]), state
        )

    def perturb(self, params_by: Optional[float], precisions_by: Optional[float]):
        """Additive perturbation of true (unpadded) entries (net.rs:187-199)."""
        mw = P.weight_masks(self.arch)
        mb = P.bias_masks(self.arch)
        s = self.state
        if params_by is not None:
            s = s._replace(
                params=StackedParams(
                    tuple(w + params_by * m for w, m in zip(s.params.weights, mw)),
                    tuple(b + params_by * m for b, m in zip(s.params.biases, mb)),
                )
            )
        if precisions_by is not None:
            s = s._replace(
                precisions=StackedPrecisions(
                    tuple(w + precisions_by for w in s.precisions.weights),
                    tuple(b + precisions_by for b in s.precisions.biases),
                    s.precisions.error + precisions_by,
                )
            )
        self.state = s
        return self

    # ------------------------------------------------------------- training
    def init_carry(
        self, X, y, key, step_size_factor: float = 1.0,
        mass_adaptation: bool = False,
        beta=1.0,
        ss_pi: float = 0.5,
        state: Optional[NetState] = None,
        ss_markers: bool = False,
        ssm_pi: float = 0.5,
    ) -> TrainCarry:
        """residual = y − bias − Σ_g pred_g and initial LPD (net.rs:158-171).

        ``mass_adaptation`` sizes the Welford accumulators ([G, P_flat] when
        on, [G, 0] placeholders when off — the state is two param-sized
        copies, so it is only allocated when the feature is used).

        ``beta`` is this chain slot's inverse temperature (parallel
        tempering); 1.0 targets the true posterior.

        ``state``: pass the NetState explicitly when calling under jit —
        the default ``self.state`` is a CLOSED-OVER device pytree, which
        jit would bake in as constants and read back from the device at
        every lowering."""
        s = self.state if state is None else state
        residual = y - self.predict(X, s)
        statics = D.branch_statics(self.arch)

        def local(w_g, b_g, wp_g, bp_g, st_g):
            return D.joint_local_term(
                self.model_type, w_g, b_g, wp_g, bp_g, self.hyper, st_g
            )

        lpd_local = jax.vmap(local)(
            s.params.weights, s.params.biases,
            s.precisions.weights, s.precisions.biases, statics,
        )
        reg_all = _reg_all(self.model_type, s.params)
        w0 = tuple(w[0] for w in s.params.weights)
        wp0 = tuple(a[0] for a in s.precisions.weights)
        lpd_out = D.joint_output_term(
            self.model_type, w0, wp0, self.hyper,
            reg_all - D.summary_stat(self.model_type, w0[-1]),
            jnp.asarray(float(self.arch.total_output_weights)),
        )
        lpd_rss = D.joint_rss_term(
            s.precisions.error, jnp.sum(residual**2), self.hyper,
            jnp.asarray(residual.shape[0], jnp.float32),
        )
        import math as _math

        G = self.arch.num_branches
        log_eps0 = _math.log(step_size_factor)
        if mass_adaptation:
            flat_dim = sum(
                int(np.prod(w.shape[1:])) for w in s.params.weights
            ) + sum(int(np.prod(b.shape[1:])) for b in s.params.biases)
        else:
            flat_dim = 0
        return TrainCarry(
            state=s,
            residual=residual,
            lpd_local=lpd_local,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
            counts=jnp.zeros(3, jnp.int32),
            key=key,
            da_log_eps=jnp.full(G, log_eps0),
            da_log_eps_bar=jnp.full(G, log_eps0),
            da_h_bar=jnp.zeros(G),
            da_t=jnp.asarray(0.0),
            mm_mean=jnp.zeros((G, flat_dim)),
            mm_m2=jnp.zeros((G, flat_dim)),
            beta=jnp.asarray(beta, jnp.float32),
            # 0.0 sentinel = no u-turn length adapted yet (full length used)
            tl_avg=jnp.zeros(G),
            # spike-and-slab: start fully included; π from cfg.ss_pi
            ss_z=jnp.ones(G),
            ss_pi=jnp.asarray(ss_pi, jnp.float32),
            ss_pip=jnp.zeros(G),
            # per-marker spike-and-slab ([G, 0] placeholders when off)
            ssm_z=jnp.ones((G, self.arch.m_pad if ss_markers else 0)),
            ssm_pi=jnp.asarray(ssm_pi, jnp.float32),
            ssm_pip=jnp.zeros((G, self.arch.m_pad if ss_markers else 0)),
        )

    def make_sweep(self, cfg: MCMCCfg):
        return make_sweep(
            self.model_type, self.arch.activation, self.arch, cfg, self.hyper
        )
