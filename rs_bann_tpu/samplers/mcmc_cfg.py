"""MCMC configuration.

Mirror of the reference ``MCMCCfg`` (/root/reference/src/net/mcmc_cfg.rs),
as a frozen dataclass whose fields are static under jit.
"""

from __future__ import annotations

import dataclasses
import os

STEP_SIZE_MODES = ("uniform", "random", "std_scaled", "izmailov", "dual_averaging")


@dataclasses.dataclass(frozen=True)
class MCMCCfg:
    hmc_step_size_factor: float = 1.0
    hmc_max_hamiltonian_error: float = 10.0
    hmc_integration_length: int = 100
    hmc_step_size_mode: str = "izmailov"
    chain_length: int = 100
    burn_in: int = -1  # -1 -> chain_length - 1 (reference default, mcmc_cfg.rs:152-156)
    outpath: str = "./"
    trace: bool = False
    trajectories: bool = False
    num_grad_traj: bool = False
    num_grad: bool = False
    gradient_descent: bool = False
    gradient_descent_joint: bool = False
    joint_hmc: bool = False
    fixed_param_precisions: bool = False
    sampled_output_bias: bool = False
    effect_sizes: bool = False
    num_chains: int = 1  # extension: vectorized chains (reference: 1)
    seed: int = 0  # extension: fully reproducible runs (reference: none)
    target_accept: float = 0.8  # dual-averaging adaptation target (extension)
    sweeps_per_call: int = 0  # 0 = auto: batch K sweeps per compiled call
    update_mode: str = "sequential"  # "sequential" (reference-exact random-scan
    # Gibbs), "parallel" (block systematic-scan: all branches HMC against a
    # frozen residual snapshot; shared scalars updated once per sweep), or
    # "hybrid" (sequential over random blocks of block_size branches,
    # parallel within a block: interpolates statistical quality vs throughput
    # and matches the sharding granularity)
    block_size: int = 0  # hybrid mode: branches per parallel block
    hybrid_shared_perm: bool = True  # hybrid mode (r5): draw the per-sweep
    # block permutation from (seed, sweep counter) shared across chains
    # instead of each chain's carry key, so the block's X slice stays
    # unbatched under a chain vmap (one X read per dot for all chains);
    # value-identical between vmapped and lax.map chain arrangements.
    # False restores the pre-r5 per-chain permutation draws.
    ss_rows: bool = False  # extension: per-marker selection for
    # NONLINEAR branches (any depth/activation; ridge_ard only). Two-
    # component mixture on layer-0 row priors: slab = the usual
    # Gamma-ARD row prior; spike = N(0, 1/ssr_spike) (narrow Gaussian,
    # not delta-zero). The indicator given the row is an EXACT Gibbs draw
    # (slab marginal = closed-form multivariate-t; net._row_mixture_z);
    # HMC feels lam_spike on spiked rows. Where the depth-0 identity
    # collapsed move applies, prefer --ss-markers (exact delta-spike);
    # ss_rows is the lever the nonlinear flagship family otherwise lacks.
    # Reuses the ssm carry/PIP/analysis plumbing (mutually exclusive with
    # ss_markers and spike_slab).
    ssr_pi: float = 0.5  # row prior inclusion probability (initial/fixed)
    ssr_fixed_pi: bool = False  # fix pi instead of Beta(1,1) Gibbs
    ssr_spike: float = 1e4  # spike precision (soft zero scale ~ 0.01)
    ssr_warmup: int = 0  # force slab for the first N sweeps
    # layer-0 slab hyperprior when ss_rows is on, used consistently in the
    # indicator draw AND the row-precision Gibbs. The CLI-default dense
    # hyperprior Gamma(0.001, 1000) is nearly improper — its t row-marginal
    # is practically scale-free, so the slab/spike Bayes factor cannot
    # discriminate (measured: null-row PIP 0.83). A proper unit-scale slab
    # restores selection. (The LPD report still uses the dense hyperprior
    # for layer 0 — a constant-offset misreport, sampling is unaffected.)
    ssr_shape: float = 1.0
    ssr_scale: float = 1.0
    lam_e_floor: float = 0.01  # divergence guard (r5, VERDICT r4 #2): floor
    # the Gibbs-drawn error precision at lam_e_floor / var(y) — i.e. cap the
    # error VARIANCE at var(y)/lam_e_floor (default 100x var(y), far beyond
    # any sane model). Healthy chains never touch the floor (their lambda_e
    # ~ 1/var_e >> floor), so draws are bitwise unchanged; a diverging chain
    # (coefficients explode -> rss explodes -> lambda_e -> 0 -> likelihood
    # goes flat -> coefficients random-walk further: the measured ssm
    # lambda_e spiral, BASELINE_SELF ukb_ssm_pi01_4chain_run) keeps an
    # informative likelihood and the conjugate coefficient draws contract it
    # back. Statistically this truncates the lambda_e prior support at the
    # floor. 0 disables.
    lam_row_floor: float = 0.01  # divergence guard, second loop: floor the
    # Gibbs-drawn local weight/bias precisions (incl. ARD per-row lambdas),
    # i.e. cap every weight-group prior std at 1/sqrt(floor) = 10. This cuts
    # the SCALE-DEGENERACY RIDGE of the identity depth-0 architecture
    # (predictions are invariant under W0 -> c W0, w_out -> w_out/c; the
    # near-improper Gamma(0.001, 1000) hyperprior lets lambda_row chase a
    # growing row down — measured r5 at n=1e5: rows slide to |W| ~ 1e3 with
    # lambda_row pinned at the old 1e-6 floor while mse still looks fine,
    # then bf16 trajectory noise on the huge intermediates destroys the
    # run; this IS r4's recorded "lambda_e spiral" divergence mode).
    # Standardized-genotype effect scales are <= O(1), so healthy lambdas
    # sit orders of magnitude above 0.01 and draws are bitwise unchanged
    # outside the pathology. Applies to WEIGHT-group precisions only —
    # bias precisions are exempt (unregularized coordinates whose lambda
    # only scales step sizes; flooring them measurably changed reference
    # mixing, net._gibbs_local_precisions). 0 disables.
    live_accept: bool = True  # extension (parallel/hybrid marginal HMC):
    # integrate all branch trajectories in parallel against the FROZEN
    # residual (the expensive leapfrogs stay batched), but run
    # the Metropolis accepts SEQUENTIALLY against the LIVE residual — the
    # leapfrog map is reversible/volume-preserving for any potential, so
    # the stale target only shapes the proposal while the accept targets
    # the true conditional. This makes the parallel/hybrid schedules an
    # EXACT random-scan Metropolis-within-Gibbs kernel (stale-gradient
    # proposals), removing the measured invariant-distribution bias of
    # accept-against-stale (PARITY.json 'parallel' row, r2). False restores
    # the old approximate behavior. Ignored for sequential/joint/GD and the
    # spike-and-slab paths (those mutate params between snapshot and HMC).
    gd_warmup: int = 0  # run N gradient-descent sweeps before sampling
    mass_adaptation: bool = False  # extension: estimate per-coordinate
    # posterior variances during warmup (Welford over kept branch states,
    # shrunk toward the prior variance) and use them as a diagonal mass
    # matrix — per-coordinate step sizes ε_i = ε·σ̂_i replacing the
    # prior-scale izmailov rule. Marginal HMC only.
    hmc_traj_length_mode: str = "fixed"  # extension: dynamic trajectory
    # lengths. "fixed" = always hmc_integration_length steps (reference
    # behavior). "jittered" = per branch update draw l ~ U{1..L}: randomized
    # path lengths break the resonance/periodicity of fixed-length HMC.
    # "uturn" = NUTS-style: during warmup, adapt a per-branch nominal length
    # toward the first u-turn step of the trajectory (the statistic the
    # reference computes only to log a warning, branch_sampler.rs:551-592),
    # then draw l ~ U{nominal/2 .. nominal} — trajectories stop doubling
    # back on themselves, raising effective samples per sweep. The compiled
    # scan always runs L steps (static shapes); truncation freezes the carry,
    # so pick hmc_integration_length as an upper bound. Marginal HMC only.
    spike_slab: bool = False  # extension: spike-and-slab branch
    # selection. The branch output layer is linear-Gaussian given the
    # summary activations A_g, so a per-branch inclusion indicator z_g has
    # an EXACT collapsed conjugate Gibbs move: w_out is integrated out for
    # the Bayes factor (spike δ₀ vs slab N(0, 1/λ_out)), z_g drawn, and
    # w_out redrawn from its conditional Gaussian. HMC moves the hidden
    # layers with the output layer frozen; excluded branches (w_out = 0)
    # sample their hidden weights from the prior. Posterior inclusion
    # probabilities per branch accumulate post-burn-in (written to
    # <outpath>/inclusion_probs). Marginal HMC + Gaussian slab only
    # (ridge/std_normal models; lasso's Laplace output prior is not
    # conjugate).
    ss_pi: float = 0.5  # prior inclusion probability (initial value when
    # ss_update_pi, else fixed)
    ss_update_pi: bool = True  # Gibbs-update π under a Beta(1,1) hyperprior:
    # π | z ~ Beta(1 + Σz, 1 + G − Σz) once per sweep — the sparsity level
    # adapts to the data
    ss_warmup: int = -1  # force z = 1 for the first N sweeps (-1 -> half the
    # burn-in): a branch's evidence flows through its learned summary
    # projection, and projections only align with their signal WHILE the
    # branch is included — without this warmup, weakly-signalled branches
    # excluded early can never re-enter (measured: total collapse on diffuse
    # genetic architectures). The collapsed w_out draw still runs during the
    # forced phase (a plain conjugate Gibbs move on the output layer).
    ss_markers: bool = False  # extension: PER-MARKER (within-branch)
    # spike-and-slab. For identity-activation depth-0 branches (the
    # genome-scale production architecture, docs/GENOME_SCALE.md) the
    # branch output is linear in each layer-0 row W0[j]: only the component
    # along w_out is likelihood-identified, so each marker's indicator z_j
    # has an EXACT collapsed conjugate Gibbs move — the row is integrated
    # out for the Bayes factor (spike δ₀ vs slab N(0, λ_j^{-1} I)), z_j is
    # drawn, and the row is redrawn from its conditional Gaussian (posterior
    # along w_out, prior in the orthogonal complement). Runs as a sequential
    # random-scan over the branch's markers against a live residual; HMC
    # then moves the remaining coordinates with excluded rows frozen, and
    # the ARD row precisions of excluded rows are drawn from their prior.
    # Per-marker posterior inclusion probabilities land in
    # <outpath>/inclusion_probs under "pip_markers". Marginal HMC +
    # identity activation + depth 0 + per-row precisions only (ridge_ard,
    # lasso_ard, std_normal); lasso's Laplace rows become conditionally
    # Gaussian through the Park-Casella scale-mixture augmentation (a
    # fresh InvGauss per-element precision draw each sweep).
    ssm_pi: float = 0.5  # prior marker-inclusion probability (Gibbs-updated
    # under Beta(1,1) once per sweep unless ssm_fixed_pi)
    ssm_fixed_pi: bool = False
    ssm_warmup: int = 0  # force all markers included for the first N sweeps
    # (markers need no projection-alignment warmup — their evidence flows
    # through x_j directly — so the default is off, unlike branch-level
    # ss_warmup)
    tempering: bool = False  # extension: parallel tempering (replica
    # exchange) across the chain axis. Chain slot c targets the tempered
    # posterior p(θ)·L(θ)^β_c with a geometric ladder β_c from 1 down to
    # 1/max_temperature; adjacent slots propose state swaps after every
    # sweep (alternating even/odd pairs). Only slot 0 (β=1) is the true
    # posterior — the trainer saves models from it alone. Marginal HMC only.
    max_temperature: float = 4.0  # hottest chain's temperature 1/β_last

    def __post_init__(self):
        if self.burn_in < 0:
            object.__setattr__(self, "burn_in", max(self.chain_length - 1, 0))
        assert self.hmc_step_size_mode in STEP_SIZE_MODES, self.hmc_step_size_mode
        assert self.update_mode in ("sequential", "parallel", "hybrid")
        if self.fixed_param_precisions:
            assert not (self.joint_hmc or self.gradient_descent_joint), (
                "Fixed precisions and joint hmc / gd are mutually exclusive"
            )
        if self.tempering:
            assert self.num_chains >= 2, (
                "tempering needs num_chains >= 2 (one slot per temperature)"
            )
            assert self.max_temperature > 1.0, "max_temperature must be > 1"
            assert not (
                self.joint_hmc
                or self.gradient_descent
                or self.gradient_descent_joint
            ), "tempering applies to marginal HMC only"
        if self.spike_slab:
            assert not (
                self.joint_hmc
                or self.gradient_descent
                or self.gradient_descent_joint
            ), "spike_slab applies to marginal HMC only"
            assert 0.0 < self.ss_pi < 1.0, "ss_pi must be in (0, 1)"
            if self.ss_warmup < 0:
                object.__setattr__(self, "ss_warmup", self.burn_in // 2)
        if self.ss_markers:
            assert not (
                self.joint_hmc
                or self.gradient_descent
                or self.gradient_descent_joint
            ), "ss_markers applies to marginal HMC only"
            assert 0.0 < self.ssm_pi < 1.0, "ssm_pi must be in (0, 1)"
        assert self.hmc_traj_length_mode in ("fixed", "jittered", "uturn")
        if self.hmc_traj_length_mode != "fixed":
            assert not (
                self.joint_hmc
                or self.gradient_descent
                or self.gradient_descent_joint
            ), "dynamic trajectory lengths apply to marginal HMC only"
        if self.hmc_traj_length_mode == "uturn":
            # the izmailov rule sets ε ∝ 1/L, which places the u-turn at a
            # FIXED ~2L steps whatever L is — adapting L toward the u-turn
            # would chase its own tail. Require a step-size mode whose ε is
            # length-independent (dual_averaging's adapted factor absorbs
            # the izmailov 1/L shape).
            assert self.hmc_step_size_mode in (
                "uniform",
                "random",
                "std_scaled",
                "dual_averaging",
            ), (
                "uturn trajectory-length adaptation needs a length-"
                "independent step size (uniform/random/std_scaled/"
                "dual_averaging), not plain izmailov"
            )
        if self.mass_adaptation:
            assert not (self.joint_hmc or self.gradient_descent_joint), (
                "mass adaptation applies to marginal HMC only"
            )
            assert self.hmc_step_size_mode in (
                "izmailov",
                "std_scaled",
                "dual_averaging",
            ), "mass adaptation needs a precision-shaped step-size mode"

    # ---- output path helpers (mcmc_cfg.rs:232-262)
    def hyperparam_path(self):
        return os.path.join(self.outpath, "hyperparams")

    def trace_path(self):
        return os.path.join(self.outpath, "trace")

    def trajectories_path(self):
        return os.path.join(self.outpath, "traj")

    def args_path(self):
        return os.path.join(self.outpath, "args.json")

    def models_path(self):
        return os.path.join(self.outpath, "models")

    def effect_sizes_path(self):
        return os.path.join(self.outpath, "effect_sizes")
