"""Pure-NumPy mirror of the reference binary's sequential training algorithm.

Rust/cargo is not available in this image, so the actual reference binary
(/root/reference) cannot be executed. This module is the runnable stand-in:
a straight, host-driven, branch-at-a-time implementation of the reference's
EXACT update order and f32 arithmetic, used to establish statistical parity
of this framework's samplers against the reference algorithm.

Mirrored, line for line in structure (all refs relative /root/reference/):

  * outer Gibbs-over-branches loop          src/net/net.rs:251-334
      shuffle branch order; per branch: inject globals, Gibbs error/param
      precisions, residual += old pred, hmc_step, residual -= new/old pred,
      propagate globals, output-bias ML update
  * hmc_step                                src/net/branch/branch_sampler.rs:1192-1299
      per-mode step sizes, N(0,1) momenta, leapfrog with per-step
      |dH| > max_error early abort (restores init params), Metropolis accept
  * backprop gradient                       branch_sampler.rs:813-875
      note the reference's d_rss arrays are HALF the rss gradient (no factor
      2); consistent because its log density uses rss/2
  * marginal log density                    branch_sampler.rs:72-128 +
      ridge_base.rs:165-178 / lasso_base.rs:163-175 (biases unregularized)
  * Gibbs precision posteriors              src/net/gibbs_steps.rs:9-129
  * output-weight summary-stat bookkeeping  branch_struct.rs:26 (from_cfg
      subtracts own stat), branch_sampler.rs:155-171 (to_cfg adds it back),
      branch_sampler.rs:178-188 (add/draw/subtract around the shared
      output-precision draw)
  * init                                    branch_cfg_builder.rs:180-233
      (default N(0,1/m) / fixed-variance / Gamma-mean inits), per-group
      maximum-likelihood initial precisions (:237-251, :308-328)
  * architectures                           architectures.rs:175-236 (pooled
      ML output precision across branches; GlobalParams{2.0, 0.05})

RNG: a single numpy Generator stands in for the reference's host ThreadRng +
ArrayFire device RNG. Comparisons against this oracle are therefore
distributional (posterior summaries within Monte Carlo error), never bitwise.

Scope: ridge_base and lasso_base (the canonical sim_train_pred.sh workload
is lasso_base), std_normal, ridge_ard (per-row precisions in all but the
output layer, per-row Gibbs — ridge_ard.rs:271-301), and joint HMC over
params AND precisions (branch_sampler.rs:1070-1178).

Joint-HMC accept quirk (upstream): the reference's ``hmc_step_joint``
initializes the Hamiltonian from the JOINT density
(``neg_hamiltonian_joint``, branch_sampler.rs:1105-1108) but its final
Metropolis test reuses the shared ``accept_or_reject_hmc_state``
(branch_sampler.rs:1163-1168), which recomputes the MARGINAL density
(branch_sampler.rs:938-951) — the acceptance ratio therefore compares
mismatched densities and the chain does not satisfy detailed balance for
the joint posterior. ``OracleCfg.joint_accept`` selects "reference"
(mirror the quirk exactly) or "consistent" (joint density on both sides —
what the JAX sampler implements; see DESIGN.md deviations).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

F = np.float32


# --------------------------------------------------------------------------
# containers
# --------------------------------------------------------------------------


@dataclass
class OracleBranch:
    """Host snapshot of one branch = the reference's BranchCfg.

    ``w_prec`` entries are scalars for Base priors, or per-input-row
    [in]-arrays for ARD layers (all but the output layer — ridge_ard.rs);
    the output entry is always a scalar (shared across branches).
    """

    weights: List[np.ndarray]  # per layer [in, out] f32
    biases: List[np.ndarray]  # per layer [out] f32, no output bias
    w_prec: List[object]  # per layer scalar, or [in] f32 array (ARD)
    b_prec: List[float]

    def num_weights_layer(self, l: int) -> int:
        return self.weights[l].size


@dataclass
class OracleHyper:
    """NetworkPrecisionHyperparameters (params.rs:144-163); defaults are the
    CLI's dpk/dps/spk/sps/opk/ops defaults (cli.rs:350-404)."""

    dense_shape: float = 0.001
    dense_scale: float = 1000.0
    summary_shape: float = 0.001
    summary_scale: float = 1000.0
    output_shape: float = 0.001
    output_scale: float = 1000.0

    def layer(self, l: int, num_layers: int):
        if l == num_layers - 1:
            return self.output_shape, self.output_scale
        if l == num_layers - 2:
            return self.summary_shape, self.summary_scale
        return self.dense_shape, self.dense_scale


@dataclass
class OracleCfg:
    chain_length: int = 100
    burn_in: Optional[int] = None  # default chain_length - 1 (mcmc_cfg.rs:152)
    hmc_integration_length: int = 300
    hmc_step_size_factor: float = 1.0
    hmc_max_hamiltonian_error: float = 10.0
    hmc_step_size_mode: str = "izmailov"  # izmailov|std_scaled|random|uniform
    fixed_param_precisions: bool = False
    sampled_output_bias: bool = False
    joint_hmc: bool = False  # HMC over params AND precisions (:1070-1178)
    # "reference": final Metropolis test uses the MARGINAL density against
    # the joint initial Hamiltonian — the upstream quirk (module docstring);
    # "consistent": joint density on both sides (the JAX sampler's choice)
    joint_accept: str = "consistent"

    def __post_init__(self):
        if self.burn_in is None:
            self.burn_in = self.chain_length - 1


def _act(z):
    return np.tanh(z)


def _dact(z):
    t = np.tanh(z)
    return (1.0 - t * t).astype(F)


# --------------------------------------------------------------------------
# Gibbs posteriors (gibbs_steps.rs)
# --------------------------------------------------------------------------


def ridge_multi_precision(rng, shape, scale, ssq, n):
    """gibbs_steps.rs:76-94: Gamma(shape + n/2, 2s/(2 + s*ssq)) (scale-param)."""
    post_shape = shape + n / 2.0
    post_scale = 2.0 * scale / (2.0 + scale * ssq)
    return rng.gamma(post_shape, post_scale)


def lasso_multi_precision(rng, shape, scale, l1, n):
    """gibbs_steps.rs:25-39: Gamma(shape + n, s/(1 + s*l1))."""
    return rng.gamma(shape + n, scale / (1.0 + scale * l1))


def ridge_single_precision(rng, shape, scale, val):
    """gibbs_steps.rs:9-23."""
    return rng.gamma(shape + 0.5, 2.0 * scale / (2.0 + scale * val * val))


# --------------------------------------------------------------------------
# the net
# --------------------------------------------------------------------------


class OracleNet:
    """Sequential reference algorithm on the host. One chain, f32 arrays."""

    def __init__(
        self,
        model_type: str,
        branches: List[OracleBranch],
        hyper: OracleHyper,
        # GlobalParams init (architectures.rs:216-236)
        error_precision: float = 2.0,
        output_layer_precision: float = 0.05,
    ):
        assert model_type in (
            "ridge_base", "lasso_base", "std_normal", "ridge_ard"
        )
        self.model_type = model_type
        self.is_ard = model_type == "ridge_ard"
        self.branches = branches
        self.hyper = hyper
        self.num_layers = len(branches[0].weights)
        # global summary stats over ALL branches' output weights
        self.global_reg_sum = float(
            sum(self._stat(b.weights[-1]) for b in branches)
        )
        self.global_num_out = float(sum(b.weights[-1].size for b in branches))
        self.global_error_precision = error_precision
        self.global_output_precision = output_layer_precision
        self.output_bias = 0.0
        self.output_bias_precision = 1.0
        # training stats
        self.counts = np.zeros(3, np.int64)  # accepted/rejected/early
        self.mse_train: List[float] = []
        self.samples: List[List[OracleBranch]] = []
        self.sample_biases: List[float] = []
        # per-saved-sample shared scalars, for posterior-summary parity
        self.sample_err_prec: List[float] = []
        self.sample_out_prec: List[float] = []

    # -------------------------------------------------------------- helpers
    def _stat(self, w) -> float:
        """summary_stat_fn: ssq for ridge/std_normal, l1 for lasso."""
        if self.model_type == "lasso_base":
            return float(np.sum(np.abs(w)))
        return float(np.sum(w * w))

    def _forward(self, br: OracleBranch, x):
        """forward_feed (branch_sampler.rs:743-758): returns (pre_acts, acts);
        output neuron is linear, no bias."""
        pre, acts = [], []
        a = x
        for l in range(self.num_layers - 1):
            z = (a @ br.weights[l] + br.biases[l]).astype(F)
            pre.append(z)
            a = _act(z).astype(F)
            acts.append(a)
        acts.append((a @ br.weights[-1]).astype(F)[:, 0])
        return pre, acts

    def predict_branch(self, br, x):
        return self._forward(br, x)[1][-1]

    def predict(self, X_groups):
        y = np.full(X_groups[0].shape[0], self.output_bias, F)
        for br, x in zip(self.branches, X_groups):
            y = y + self.predict_branch(br, x)
        return y

    def _rss(self, br, x, y):
        r = self.predict_branch(br, x) - y
        return float(r @ r)

    def _log_density(self, br, w_prec, err_prec, rss):
        """branch_sampler.rs:72-77 + ridge_base.rs:165-178 /
        lasso_base.rs:163-175 / ridge_ard.rs:171-194: -lam_e*rss/2 -
        sum_l prior(w_l); ARD layers dot per-row precisions with row sums
        of squares; biases carry no prior term in marginal mode
        (branch_sampler.rs:104-112)."""
        ld = -err_prec * rss / 2.0
        for l in range(self.num_layers):
            if self.model_type == "lasso_base":
                ld -= w_prec[l] * float(np.sum(np.abs(br.weights[l])))
            elif self.is_ard and l < self.num_layers - 1:
                row_ssq = np.sum(br.weights[l] ** 2, axis=1)
                ld -= 0.5 * float(row_ssq @ np.asarray(w_prec[l], F))
            else:
                ld -= float(w_prec[l]) * float(np.sum(br.weights[l] ** 2)) / 2.0
        return ld

    def _gradient(self, br, x, y, err_prec):
        """backpropagate (branch_sampler.rs:813-875) + prior terms
        (ridge_base.rs:175-184 / lasso_base.rs:175-185). d_rss arrays here
        are A^T error (half the rss gradient), as in the reference."""
        pre, acts = self._forward(br, x)
        gw = [None] * self.num_layers
        gb = [None] * (self.num_layers - 1)
        err = (acts[-1] - y).astype(F)  # [n]
        gw[-1] = (acts[-2].T @ err[:, None]).astype(F)
        err2 = err[:, None] @ br.weights[-1].T  # [n, out]
        for l in range(self.num_layers - 2, -1, -1):
            delta = (_dact(pre[l]) * err2).astype(F)
            gb[l] = delta.sum(axis=0).astype(F)
            inp = x if l == 0 else acts[l - 1]
            gw[l] = (inp.T @ delta).astype(F)
            if l > 0:
                err2 = delta @ br.weights[l].T
        # prior terms -> full log-density gradient
        for l in range(self.num_layers):
            if self.model_type == "lasso_base":
                prior = br.w_prec[l] * np.sign(br.weights[l])
            elif self.is_ard and l < self.num_layers - 1:
                # per-row precisions tiled over columns (ridge_ard.rs:200-209)
                prior = np.asarray(br.w_prec[l], F)[:, None] * br.weights[l]
            else:
                prior = br.w_prec[l] * br.weights[l]
            gw[l] = (-(err_prec * gw[l] + prior)).astype(F)
        for l in range(self.num_layers - 1):
            gb[l] = (-(err_prec * gb[l])).astype(F)
        return gw, gb

    def _step_sizes(self, rng, br, cfg: OracleCfg):
        """Per-mode step sizes (ridge_base.rs:52-115, lasso_base.rs:84-117,
        branch_sampler.rs:654-732)."""
        mode, fac = cfg.hmc_step_size_mode, cfg.hmc_step_size_factor
        L = cfg.hmc_integration_length
        eps_w, eps_b = [], []
        if mode == "izmailov":
            for l in range(self.num_layers):
                if self.model_type == "lasso_base":
                    e = fac / (4.0 * br.w_prec[l] * L)
                elif self.is_ard and l < self.num_layers - 1:
                    # per-row eps tiled over columns (ridge_ard.rs:72-86)
                    e_rows = fac * math.pi / (
                        2.0 * np.sqrt(np.asarray(br.w_prec[l], F)) * L
                    )
                    eps_w.append(
                        np.tile(e_rows[:, None], (1, br.weights[l].shape[1])).astype(F)
                    )
                    continue
                else:
                    e = fac * math.pi / (2.0 * math.sqrt(br.w_prec[l]) * L)
                eps_w.append(np.full_like(br.weights[l], F(e)))
            for l in range(self.num_layers - 1):
                e = fac * math.pi / (2.0 * math.sqrt(br.b_prec[l]) * L)
                eps_b.append(np.full_like(br.biases[l], F(e)))
        elif mode == "std_scaled":
            for l in range(self.num_layers):
                eps_w.append(
                    np.full_like(br.weights[l], F(fac / math.sqrt(br.w_prec[l])))
                )
            for l in range(self.num_layers - 1):
                eps_b.append(
                    np.full_like(br.biases[l], F(fac / math.sqrt(br.b_prec[l])))
                )
        elif mode == "random":
            n_params = sum(w.size for w in br.weights) + sum(
                b.size for b in br.biases
            )
            prop = n_params ** (-0.25) * fac
            for l in range(self.num_layers):
                eps_w.append(
                    (rng.random(br.weights[l].shape, dtype=np.float32) * prop).astype(F)
                )
            for l in range(self.num_layers - 1):
                eps_b.append(
                    (rng.random(br.biases[l].shape, dtype=np.float32) * prop).astype(F)
                )
        else:  # uniform
            for l in range(self.num_layers):
                eps_w.append(np.full_like(br.weights[l], F(fac)))
            for l in range(self.num_layers - 1):
                eps_b.append(np.full_like(br.biases[l], F(fac)))
        return eps_w, eps_b

    # ------------------------------------------------------------ HMC step
    def _hmc_step(self, rng, br: OracleBranch, x, y, err_prec, cfg: OracleCfg):
        """branch_sampler.rs:1192-1299. Mutates br in place; returns
        (code, y_pred or None): 0 accepted / 1 rejected / 2 rejected early."""
        init_w = [w.copy() for w in br.weights]
        init_b = [b.copy() for b in br.biases]
        eps_w, eps_b = self._step_sizes(rng, br, cfg)
        p_w = [rng.standard_normal(w.shape, dtype=np.float32) for w in br.weights]
        p_b = [rng.standard_normal(b.shape, dtype=np.float32) for b in br.biases]

        def kinetic():
            return 0.5 * (
                sum(float(np.sum(p * p)) for p in p_w)
                + sum(float(np.sum(p * p)) for p in p_b)
            )

        neg_h0 = (
            self._log_density(br, br.w_prec, err_prec, self._rss(br, x, y))
            - kinetic()
        )
        gw, gb = self._gradient(br, x, y, err_prec)
        for _step in range(cfg.hmc_integration_length):
            for l in range(self.num_layers):
                p_w[l] = (p_w[l] + 0.5 * eps_w[l] * gw[l]).astype(F)
                br.weights[l] = (br.weights[l] + eps_w[l] * p_w[l]).astype(F)
            for l in range(self.num_layers - 1):
                p_b[l] = (p_b[l] + 0.5 * eps_b[l] * gb[l]).astype(F)
                br.biases[l] = (br.biases[l] + eps_b[l] * p_b[l]).astype(F)
            gw, gb = self._gradient(br, x, y, err_prec)
            for l in range(self.num_layers):
                p_w[l] = (p_w[l] + 0.5 * eps_w[l] * gw[l]).astype(F)
            for l in range(self.num_layers - 1):
                p_b[l] = (p_b[l] + 0.5 * eps_b[l] * gb[l]).astype(F)
            neg_h = (
                self._log_density(br, br.w_prec, err_prec, self._rss(br, x, y))
                - kinetic()
            )
            if not (abs(neg_h - neg_h0) <= cfg.hmc_max_hamiltonian_error):
                br.weights, br.biases = init_w, init_b
                return 2, None
        # accept_or_reject (branch_sampler.rs:928-962)
        y_pred = self.predict_branch(br, x)
        r = y_pred - y
        ld = self._log_density(br, br.w_prec, err_prec, float(r @ r))
        log_acc = (ld - kinetic()) - neg_h0
        acc_p = 1.0 if log_acc >= 0.0 else math.exp(log_acc)
        if rng.random() < acc_p:
            return 0, y_pred
        br.weights, br.biases = init_w, init_b
        return 1, None

    # -------------------------------------------------------- joint density
    def _joint_log_density(self, br, err_prec, rss, reg_sum_others, n):
        """log_density_joint (branch_sampler.rs:292-305): local weights
        (ridge_base.rs:117-136 / ridge_ard.rs:119-148), output weights with
        global stats (ridge_base.rs:138-157), l2 biases
        (branch_sampler.rs:260-279), rss + error precision
        (branch_sampler.rs:240-257)."""
        hy = self.hyper
        L = self.num_layers
        ld = 0.0
        for l in range(L - 1):
            shape, scale = hy.layer(l, L)
            w = br.weights[l]
            if self.is_ard:
                row_ssq = np.sum(w * w, axis=1)
                lam = np.asarray(br.w_prec[l], F)
                ld -= float((row_ssq / 2.0 + 1.0 / scale) @ lam)
                ld += (shape + (w.shape[1] - 2.0) / 2.0) * float(
                    np.sum(np.log(lam))
                )
            else:
                lam = float(br.w_prec[l])
                ld -= (float(np.sum(w * w)) / 2.0 + 1.0 / scale) * lam
                ld += (shape + (w.size - 2.0) / 2.0) * math.log(lam)
        shape, scale = hy.layer(L - 1, L)
        lam = float(br.w_prec[-1])
        tot = float(np.sum(br.weights[-1] ** 2)) + reg_sum_others
        ld -= (0.5 * tot + 1.0 / scale) * lam
        ld += (shape + (self.global_num_out - 2.0) / 2.0) * math.log(lam)
        for l in range(L - 1):
            shape, scale = hy.layer(l, L)
            lb = float(br.b_prec[l])
            b = br.biases[l]
            ld -= lb * (float(np.sum(b * b)) / 2.0 + 1.0 / scale)
            ld += (shape + (b.size - 2.0) / 2.0) * math.log(lb)
        ld += (hy.output_shape + (n - 2.0) / 2.0) * math.log(err_prec)
        ld -= err_prec * (rss / 2.0 + 1.0 / hy.output_scale)
        return ld

    def _joint_gradient(self, br, x, y, err_prec, reg_sum_others):
        """Joint gradient (branch_sampler.rs:406-426): params part with
        l2-regularized biases (:333-345), precision parts
        (ridge_base.rs:221-249 / ridge_ard.rs:221-250, bias :348-367,
        error :369-378). Returns (gw, gb, g_wprec, g_bprec, g_err, rss)."""
        hy = self.hyper
        L = self.num_layers
        pre, acts = self._forward(br, x)
        err = (acts[-1] - y).astype(F)
        rss = float(err @ err)
        gw = [None] * L
        gb = [None] * (L - 1)
        gw[-1] = (acts[-2].T @ err[:, None]).astype(F)
        err2 = err[:, None] @ br.weights[-1].T
        for l in range(L - 2, -1, -1):
            delta = (_dact(pre[l]) * err2).astype(F)
            gb[l] = delta.sum(axis=0).astype(F)
            inp = x if l == 0 else acts[l - 1]
            gw[l] = (inp.T @ delta).astype(F)
            if l > 0:
                err2 = delta @ br.weights[l].T
        for l in range(L):
            if self.is_ard and l < L - 1:
                prior = np.asarray(br.w_prec[l], F)[:, None] * br.weights[l]
            else:
                prior = float(br.w_prec[l]) * br.weights[l]
            gw[l] = (-(err_prec * gw[l] + prior)).astype(F)
        for l in range(L - 1):
            gb[l] = (
                -(float(br.b_prec[l]) * br.biases[l] + err_prec * gb[l])
            ).astype(F)
        g_wprec = []
        for l in range(L - 1):
            shape, scale = hy.layer(l, L)
            w = br.weights[l]
            if self.is_ard:
                lam = np.asarray(br.w_prec[l], F)
                row_ssq = np.sum(w * w, axis=1)
                g_wprec.append(
                    (
                        (2.0 * shape + w.shape[1] - 2.0) / (2.0 * lam)
                        - 1.0 / scale
                        - row_ssq / 2.0
                    ).astype(F)
                )
            else:
                lam = float(br.w_prec[l])
                g_wprec.append(
                    F(
                        (2.0 * shape + w.size - 2.0) / (2.0 * lam)
                        - 1.0 / scale
                        - float(np.sum(w * w)) / 2.0
                    )
                )
        shape, scale = hy.layer(L - 1, L)
        lam = float(br.w_prec[-1])
        g_wprec.append(
            F(
                (2.0 * shape + self.global_num_out - 2.0) / (2.0 * lam)
                - 1.0 / scale
                - (float(np.sum(br.weights[-1] ** 2)) + reg_sum_others) / 2.0
            )
        )
        g_bprec = []
        for l in range(L - 1):
            shape, scale = hy.layer(l, L)
            b = br.biases[l]
            g_bprec.append(
                F(
                    (2.0 * shape + b.size - 2.0) / (2.0 * float(br.b_prec[l]))
                    - 1.0 / scale
                    - float(np.sum(b * b)) / 2.0
                )
            )
        g_err = F(
            (2.0 * hy.output_shape + y.size - 2.0) / (2.0 * err_prec)
            - 1.0 / hy.output_scale
            - rss / 2.0
        )
        return gw, gb, g_wprec, g_bprec, g_err, rss

    def _hmc_step_joint(self, rng, br, x, y, err_prec, cfg, reg_sum_others):
        """branch_sampler.rs:1070-1178: leapfrog over params AND precisions
        with mandatory random step sizes. Returns (code, y_pred or None,
        new_err_prec). NaN Hamiltonians abort early (like the JAX sampler;
        Rust's NaN > max is false so the reference instead carries NaN to a
        guaranteed end-rejection — same outcome, different counter)."""
        n = y.size
        init_w = [w.copy() for w in br.weights]
        init_b = [b.copy() for b in br.biases]
        init_wp = [np.array(p, F) if isinstance(p, np.ndarray) else p
                   for p in br.w_prec]
        init_bp = list(br.b_prec)
        init_err = err_prec

        L = self.num_layers
        n_params = sum(w.size for w in br.weights) + sum(
            b.size for b in br.biases
        )
        n_prec = (
            sum(np.size(p) for p in br.w_prec) + len(br.b_prec) + 1
        )
        prop = (n_params + n_prec) ** (-0.25) * cfg.hmc_step_size_factor
        r = lambda shp: (rng.random(shp, dtype=np.float32) * prop).astype(F)
        eps_w = [r(w.shape) for w in br.weights]
        eps_b = [r(b.shape) for b in br.biases]
        eps_wp = [r(np.shape(p)) if np.ndim(p) else F(rng.random() * prop)
                  for p in br.w_prec]
        eps_bp = [F(rng.random() * prop) for _ in br.b_prec]
        eps_e = F(rng.random() * prop)

        sn = lambda shp: rng.standard_normal(shp, dtype=np.float32)
        p_w = [sn(w.shape) for w in br.weights]
        p_b = [sn(b.shape) for b in br.biases]
        p_wp = [sn(np.shape(p)) if np.ndim(p) else F(rng.standard_normal())
                for p in br.w_prec]
        p_bp = [F(rng.standard_normal()) for _ in br.b_prec]
        p_e = F(rng.standard_normal())

        def kinetic():
            k = sum(float(np.sum(p * p)) for p in p_w)
            k += sum(float(np.sum(p * p)) for p in p_b)
            k += sum(float(np.sum(np.asarray(p) ** 2)) for p in p_wp)
            k += sum(float(p * p) for p in p_bp)
            k += float(p_e * p_e)
            return 0.5 * k

        def restore():
            br.weights, br.biases = init_w, init_b
            br.w_prec, br.b_prec = init_wp, init_bp

        rss0 = self._rss(br, x, y)
        neg_h0 = (
            self._joint_log_density(br, err_prec, rss0, reg_sum_others, n)
            - kinetic()
        )
        g = self._joint_gradient(br, x, y, err_prec, reg_sum_others)
        for _step in range(cfg.hmc_integration_length):
            gw, gb, g_wp, g_bp, g_e, _ = g
            for l in range(L):
                p_w[l] = (p_w[l] + 0.5 * eps_w[l] * gw[l]).astype(F)
                br.weights[l] = (br.weights[l] + eps_w[l] * p_w[l]).astype(F)
            for l in range(L - 1):
                p_b[l] = (p_b[l] + 0.5 * eps_b[l] * gb[l]).astype(F)
                br.biases[l] = (br.biases[l] + eps_b[l] * p_b[l]).astype(F)
            for l in range(L):
                p_wp[l] = np.asarray(p_wp[l] + 0.5 * eps_wp[l] * g_wp[l], F)
                br.w_prec[l] = np.asarray(
                    np.asarray(br.w_prec[l], F) + eps_wp[l] * p_wp[l], F
                ) if np.ndim(br.w_prec[l]) else F(
                    br.w_prec[l] + eps_wp[l] * p_wp[l]
                )
            for l in range(L - 1):
                p_bp[l] = F(p_bp[l] + 0.5 * eps_bp[l] * g_bp[l])
                br.b_prec[l] = F(br.b_prec[l] + eps_bp[l] * p_bp[l])
            p_e = F(p_e + 0.5 * eps_e * g_e)
            err_prec = F(err_prec + eps_e * p_e)

            with np.errstate(invalid="ignore", divide="ignore"):
                g = self._joint_gradient(br, x, y, err_prec, reg_sum_others)
                gw, gb, g_wp, g_bp, g_e, rss = g
                for l in range(L):
                    p_w[l] = (p_w[l] + 0.5 * eps_w[l] * gw[l]).astype(F)
                for l in range(L - 1):
                    p_b[l] = (p_b[l] + 0.5 * eps_b[l] * gb[l]).astype(F)
                for l in range(L):
                    p_wp[l] = np.asarray(p_wp[l] + 0.5 * eps_wp[l] * g_wp[l], F)
                for l in range(L - 1):
                    p_bp[l] = F(p_bp[l] + 0.5 * eps_bp[l] * g_bp[l])
                p_e = F(p_e + 0.5 * eps_e * g_e)
                neg_h = (
                    self._joint_log_density(
                        br, err_prec, rss, reg_sum_others, n
                    )
                    - kinetic()
                    if err_prec > 0
                    and all(np.all(np.asarray(p) > 0) for p in br.w_prec)
                    and all(p > 0 for p in br.b_prec)
                    else float("nan")
                )
            if not (abs(neg_h - neg_h0) <= cfg.hmc_max_hamiltonian_error):
                restore()
                return 2, None, init_err
        y_pred = self.predict_branch(br, x)
        rr = y_pred - y
        rss_f = float(rr @ rr)
        if cfg.joint_accept == "reference":
            # the upstream quirk: marginal density vs joint init Hamiltonian
            ld_f = self._log_density(br, br.w_prec, err_prec, rss_f)
        else:
            ld_f = self._joint_log_density(
                br, err_prec, rss_f, reg_sum_others, n
            )
        log_acc = (ld_f - kinetic()) - neg_h0
        acc_p = 1.0 if log_acc >= 0.0 else math.exp(log_acc)
        if rng.random() < acc_p:
            return 0, y_pred, float(err_prec)
        restore()
        return 1, None, init_err

    # ---------------------------------------------------------------- train
    def train(
        self,
        X_groups: List[np.ndarray],  # per-branch standardized [n, m_g] f32
        y: np.ndarray,
        cfg: OracleCfg,
        seed: int = 0,
        X_test: Optional[List[np.ndarray]] = None,
        y_test: Optional[np.ndarray] = None,
    ):
        """net.rs:201-358. Keeps per-iteration mse and post-burn-in samples."""
        rng = np.random.default_rng(seed)
        y = np.asarray(y, F)
        G = len(self.branches)
        residual = (y - self.predict(X_groups)).astype(F)
        self.mse_train.append(float(residual @ residual) / y.shape[0])
        self.mse_test = []
        if X_test is not None:
            r = self.predict(X_test) - y_test
            self.mse_test.append(float(r @ r) / y_test.shape[0])
        if cfg.burn_in == 0:
            self._save_sample()

        for chain_ix in range(1, cfg.chain_length + 1):
            order = rng.permutation(G)
            for g in order:
                br = self.branches[g]
                # cfg.update_global_params (branch_cfg.rs:59-63) + from_cfg
                # (branch_struct.rs:26): inject shared scalars, remove own
                # output stat from the global sum
                err_prec = self.global_error_precision
                br.w_prec[-1] = self.global_output_precision
                reg_sum_others = self.global_reg_sum - self._stat(br.weights[-1])

                # Gibbs draws (net.rs:270-277); joint HMC moves precisions
                # inside the trajectory instead (net.rs:270: the draws are
                # skipped when joint_hmc is set)
                if self.model_type != "std_normal" and not cfg.joint_hmc:
                    err_prec = ridge_multi_precision(
                        rng,
                        self.hyper.output_shape,
                        self.hyper.output_scale,
                        float(residual @ residual),
                        residual.size,
                    )
                    if not cfg.fixed_param_precisions:
                        # sample_prior_precisions (ridge_base.rs:235-253 /
                        # lasso_base.rs:235-253): local layers only
                        for l in range(self.num_layers - 1):
                            shape, scale = self.hyper.layer(l, self.num_layers)
                            w = br.weights[l]
                            if self.model_type == "lasso_base":
                                br.w_prec[l] = lasso_multi_precision(
                                    rng, shape, scale,
                                    float(np.sum(np.abs(w))), w.size,
                                )
                            elif self.is_ard:
                                # per-row Gibbs (ridge_ard.rs:271-301):
                                # posterior shape counts the ROW's ncols
                                post_shape = shape + w.shape[1] / 2.0
                                row_ssq = np.sum(w * w, axis=1)
                                br.w_prec[l] = np.asarray(
                                    [
                                        rng.gamma(
                                            post_shape,
                                            2.0 * scale / (2.0 + scale * ss),
                                        )
                                        for ss in row_ssq
                                    ],
                                    F,
                                )
                            else:
                                br.w_prec[l] = ridge_multi_precision(
                                    rng, shape, scale,
                                    float(np.sum(w * w)), w.size,
                                )
                            br.b_prec[l] = ridge_multi_precision(
                                rng, shape, scale,
                                float(np.sum(br.biases[l] ** 2)),
                                br.biases[l].size,
                            )
                        # sample_output_weight_precisions
                        # (branch_sampler.rs:178-188): draw from the GLOBAL
                        # stat incl. own current output weights
                        own = self._stat(br.weights[-1])
                        if self.model_type == "lasso_base":
                            lam = lasso_multi_precision(
                                rng, self.hyper.output_shape,
                                self.hyper.output_scale,
                                reg_sum_others + own, self.global_num_out,
                            )
                        else:
                            lam = ridge_multi_precision(
                                rng, self.hyper.output_shape,
                                self.hyper.output_scale,
                                reg_sum_others + own, self.global_num_out,
                            )
                        br.w_prec[-1] = lam

                # residual += old prediction (net.rs:279-280)
                prev_pred = self.predict_branch(br, X_groups[g])
                residual = (residual + prev_pred).astype(F)

                if cfg.joint_hmc:
                    code, y_pred, err_prec = self._hmc_step_joint(
                        rng, br, X_groups[g], residual, err_prec, cfg,
                        reg_sum_others,
                    )
                else:
                    code, y_pred = self._hmc_step(
                        rng, br, X_groups[g], residual, err_prec, cfg
                    )
                self.counts[code] += 1
                if code == 0:
                    residual = (residual - y_pred).astype(F)
                else:
                    residual = (residual - prev_pred).astype(F)

                # to_cfg + update_from_branch_cfg (net.rs:302-304): share the
                # new error/output precisions and the refreshed global stat
                self.global_reg_sum = reg_sum_others + self._stat(br.weights[-1])
                self.global_error_precision = err_prec
                self.global_output_precision = br.w_prec[-1]

                # output bias (net.rs:319-332), ML by default
                residual = (residual + F(self.output_bias)).astype(F)
                if cfg.sampled_output_bias:
                    self.output_bias_precision = ridge_single_precision(
                        rng, self.hyper.output_shape, self.hyper.output_shape,
                        self.output_bias,
                    )
                    n = residual.size
                    denom = n * err_prec + self.output_bias_precision
                    nu = err_prec / denom
                    self.output_bias = rng.normal(
                        nu * float(residual.sum()), math.sqrt(1.0 / denom)
                    )
                else:
                    self.output_bias = float(residual.mean())
                residual = (residual - F(self.output_bias)).astype(F)

            self.mse_train.append(float(residual @ residual) / y.shape[0])
            if X_test is not None:
                r = self.predict(X_test) - y_test
                self.mse_test.append(float(r @ r) / y_test.shape[0])
            if chain_ix >= cfg.burn_in:
                self._save_sample()
        return self

    def _save_sample(self):
        self.samples.append(
            [
                OracleBranch(
                    [w.copy() for w in b.weights],
                    [bb.copy() for bb in b.biases],
                    [np.array(p) if isinstance(p, np.ndarray) else p
                     for p in b.w_prec],
                    list(b.b_prec),
                )
                for b in self.branches
            ]
        )
        self.sample_biases.append(self.output_bias)
        self.sample_err_prec.append(float(self.global_error_precision))
        self.sample_out_prec.append(float(self.global_output_precision))

    def posterior_predict(self, X_groups) -> np.ndarray:
        """predict subcommand: one row per saved sample (rs-bann.rs:291-311)."""
        out = []
        for sample, bias in zip(self.samples, self.sample_biases):
            yhat = np.full(X_groups[0].shape[0], bias, F)
            for br, x in zip(sample, X_groups):
                yhat = yhat + self.predict_branch(br, x)
            out.append(yhat)
        return np.stack(out)

    def posterior_branch_means(self, X_groups) -> np.ndarray:
        """Posterior-mean per-branch genetic values [G, n] (the quantity
        behind the reference's branch_r2s, net.rs:648-656)."""
        acc = None
        for sample in self.samples:
            cur = np.stack(
                [
                    self.predict_branch(br, x)
                    for br, x in zip(sample, X_groups)
                ]
            )
            acc = cur if acc is None else acc + cur
        return acc / len(self.samples)

    # ------------------------------------------------------------- builders
    @staticmethod
    def build(
        model_type: str,
        num_markers: List[int],
        hidden: int,
        depth: int,
        summary: int,
        hyper: OracleHyper = None,
        init_gamma: Optional[tuple] = None,  # (shape, scale) -> Gamma-mean init
        init_param_variance: Optional[float] = None,
        seed: int = 0,
    ) -> "OracleNet":
        """BlockNetCfg::build_net (architectures.rs:187-236) +
        BranchCfgBuilder inits (branch_cfg_builder.rs:180-328)."""
        rng = np.random.default_rng(seed)
        hyper = hyper or OracleHyper()
        branches = []
        for m in num_markers:
            widths = [m] + [hidden] * depth + [summary, 1]
            L = len(widths) - 1
            ws, bs = [], []
            for l in range(L):
                fan_in, fan_out = widths[l], widths[l + 1]
                if init_gamma is not None:
                    k, s = init_gamma
                    std = math.sqrt(1.0 / (k * s))  # gamma MEAN precision
                elif init_param_variance is not None:
                    std = math.sqrt(init_param_variance)
                else:
                    std = math.sqrt(1.0 / m)  # default_param_init
                ws.append(rng.normal(0.0, std, (fan_in, fan_out)).astype(F))
            for l in range(L - 1):
                if init_gamma is not None:
                    k, s = init_gamma
                    bs.append(
                        rng.normal(
                            0.0, math.sqrt(1.0 / (k * s)), widths[l + 1]
                        ).astype(F)
                    )
                elif init_param_variance is not None:
                    bs.append(
                        rng.normal(
                            0.0, math.sqrt(init_param_variance), widths[l + 1]
                        ).astype(F)
                    )
                else:
                    bs.append(np.zeros(widths[l + 1], F))
            # maximum-likelihood initial precisions (:237-251; ARD per-row
            # :308-328); zero-variance groups (all-zero default biases)
            # yield inf, as in the reference
            if model_type == "ridge_ard":
                w_prec = []
                for l, w in enumerate(ws):
                    if l < L - 1:
                        row_ssq = np.sum(w * w, axis=1)
                        w_prec.append(
                            np.where(
                                row_ssq > 0,
                                w.shape[1] / np.maximum(row_ssq, 1e-30),
                                np.inf,
                            ).astype(F)
                        )
                    else:
                        ssq = float(np.sum(w * w))
                        w_prec.append(w.size / ssq if ssq > 0 else np.inf)
            else:
                w_prec = [
                    float(w.size) / float(np.sum(w * w)) if np.sum(w * w) > 0 else np.inf
                    for w in ws
                ]
            b_prec = [
                float(b.size) / float(np.sum(b * b)) if np.sum(b * b) > 0 else np.inf
                for b in bs
            ]
            branches.append(OracleBranch(ws, bs, w_prec, b_prec))
        # pooled output precision (architectures.rs:175-185)
        pooled = len(branches) / sum(
            float(np.sum(b.weights[-1] ** 2)) for b in branches
        )
        for b in branches:
            b.w_prec[-1] = pooled
        if model_type == "std_normal":
            for b in branches:
                b.w_prec = [1.0] * len(b.w_prec)
                b.b_prec = [1.0] * len(b.b_prec)
        return OracleNet(model_type, branches, hyper)
