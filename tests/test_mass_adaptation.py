"""Diagonal mass-matrix adaptation tests (extension; no reference
counterpart — the reference's izmailov rule is the count=0 special case)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from rs_bann_tpu.models import density as D
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import stack_standardized
from rs_bann_tpu.models.init import InitCfg, init_net
from rs_bann_tpu.models.net import Net, _mass_std, _welford
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg


def test_welford_matches_numpy():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((20, 7)).astype(np.float32)
    mean = jnp.zeros(7)
    m2 = jnp.zeros(7)
    for i, x in enumerate(xs):
        mean, m2 = _welford(mean, m2, jnp.asarray(x), float(i + 1))
    np.testing.assert_allclose(np.asarray(mean), xs.mean(0), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(m2) / (len(xs) - 1), xs.var(0, ddof=1), rtol=1e-4
    )


def test_mass_std_shrinks_to_prior_at_zero_count():
    """count=0 must reproduce the izmailov scale exactly: std = 1/sqrt(lam)."""
    w_like = (jnp.zeros((3, 2)), jnp.zeros((2, 1)))
    b_like = (jnp.zeros(2),)
    wp = (jnp.full((1, 1), 4.0), jnp.full((1, 1), 9.0))
    bp = (jnp.full((1,), 16.0),)
    P = sum(x.size for x in w_like) + sum(x.size for x in b_like)
    mw, mb = _mass_std(
        "ridge_base", jnp.zeros(P), jnp.zeros(P), jnp.asarray(0.0),
        wp, bp, w_like, b_like,
    )
    np.testing.assert_allclose(np.asarray(mw[0]), 0.5, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mw[1]), 1.0 / 3.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mb[0]), 0.25, rtol=1e-6)
    # lasso target: Laplace(lam) variance 2/lam^2
    mw, _ = _mass_std(
        "lasso_base", jnp.zeros(P), jnp.zeros(P), jnp.asarray(0.0),
        wp, bp, w_like, b_like,
    )
    np.testing.assert_allclose(np.asarray(mw[0]), np.sqrt(2.0) / 4.0, rtol=1e-6)


def _sim(arch, seed=7, n=300, h2=0.7):
    rng = np.random.default_rng(seed)
    ts, _ = init_net(
        arch, "ridge_base",
        InitCfg(init_gamma_shape=3.0, init_gamma_scale=1.0, seed=seed),
    )
    tn = Net("ridge_base", arch, D.Hyperparameters(), ts)
    m_tot = sum(arch.m)
    X = rng.binomial(2, rng.uniform(0.1, 0.5, m_tot), size=(n, m_tot)).astype(
        np.float32
    )
    cols, off = [], 0
    for g in range(arch.num_branches):
        cols.append(X[:, off : off + arch.m[g]])
        off += arch.m[g]
    d = stack_standardized(arch, cols, np.zeros(n))
    gv = np.asarray(tn.predict(d.X))
    y = gv + rng.normal(0, np.sqrt(gv.var() * (1 / h2 - 1)), n)
    return d._replace(y=jnp.asarray(y.astype(np.float32)))


@pytest.mark.slow
def test_mass_estimate_freezes_after_burnin_and_tracks_chain_variance():
    arch = NetArch(m=(8,), h=(4,), s=(4,), depth=0)
    data = _sim(arch)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    burn = 40
    cfg = MCMCCfg(
        chain_length=1, burn_in=burn, hmc_integration_length=20,
        hmc_step_size_mode="dual_averaging", mass_adaptation=True, seed=3,
    )
    sweep = jax.jit(net.make_sweep(cfg))
    carry = net.init_carry(data.X, data.y, jax.random.key(3), 1.0, True)
    from rs_bann_tpu.samplers.hmc import flatten_wb

    flats = []
    for i in range(burn):
        carry, _ = sweep(carry, data.X, data.y)
        w = tuple(a[0] for a in carry.state.params.weights)
        b = tuple(a[0] for a in carry.state.params.biases)
        flats.append(np.asarray(flatten_wb(w, b)))
    m2_frozen = np.asarray(carry.mm_m2).copy()
    assert m2_frozen.max() > 0.0
    # Welford over warmup == batch variance of the recorded warmup states
    flats = np.stack(flats)
    emp = flats.var(0, ddof=1)
    welford = m2_frozen[0] / (burn - 1)
    live = emp > 1e-8  # padded coordinates never move
    np.testing.assert_allclose(welford[live], emp[live], rtol=1e-3)
    # past burn-in: frozen
    for _ in range(3):
        carry, _ = sweep(carry, data.X, data.y)
    np.testing.assert_array_equal(np.asarray(carry.mm_m2), m2_frozen)


@pytest.mark.slow
def test_mass_adaptation_posterior_matches_unadapted(tmp_path):
    """Same posterior with and without the mass matrix (it only changes the
    proposal): posterior-mean predictions must agree within MCMC error."""
    from rs_bann_tpu.train import train

    arch = NetArch(m=(10, 10), h=(5, 5), s=(5, 5), depth=0)
    data = _sim(arch)
    preds = {}
    for mass in (False, True):
        state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
        net = Net("ridge_base", arch, D.Hyperparameters(), state)
        cfg = MCMCCfg(
            chain_length=120, burn_in=40, hmc_integration_length=30,
            hmc_step_size_mode="dual_averaging", mass_adaptation=mass,
            outpath=str(tmp_path / f"mass{mass}"), seed=5,
        )
        _, stats = train(net, data, cfg, verbose=False)
        assert stats.acceptance_rate() > 0.3, (mass, stats.acceptance_rate())
        import glob

        files = sorted(glob.glob(str(tmp_path / f"mass{mass}" / "models" / "*.npz")))
        ps = []
        for f in files:
            m = Net.load(f)
            ps.append(np.asarray(m.predict(data.X)))
        preds[mass] = np.stack(ps).mean(0)
    r = np.corrcoef(preds[False], preds[True])[0, 1]
    assert r > 0.95, r
