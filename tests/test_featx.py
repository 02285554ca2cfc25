"""Feature-major dense layout (models/density.FeatX) equivalence tests.

FeatX is a pure LAYOUT change — [G, m_pad, n] instead of [G, n, m_pad] —
with the large n axis minor (see the FeatX docstring). Every quantity the
sweep computes must agree with the sample-major path to float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_bann_tpu.models import density as D
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import stack_standardized
from rs_bann_tpu.models.init import InitCfg, init_net
from rs_bann_tpu.models.net import Net
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg


def _setup(G=3, n=64, depth=1, act="tanh", seed=0, model="ridge_base"):
    rng = np.random.default_rng(seed)
    ms = ([5, 7, 4, 6, 5, 8] * 2)[:G]
    arch = NetArch(m=tuple(ms), h=(3,) * G, s=(2,) * G, depth=depth,
                   activation=act)
    cols = [rng.standard_normal((n, m), dtype=np.float32) for m in ms]
    y = rng.standard_normal(n).astype(np.float32)
    ds = stack_standardized(arch, cols, y)
    df = stack_standardized(arch, cols, y, feature_major=True)
    state, _ = init_net(arch, model, InitCfg(seed=1))
    net = Net(model, arch, D.Hyperparameters(), state)
    return arch, net, ds, df, y


@pytest.mark.parametrize("act", ["tanh", "relu", "identity"])
def test_forward_predict_match(act):
    arch, net, ds, df, y = _setup(act=act)
    for g in range(arch.num_branches):
        w = tuple(w[g] for w in net.state.params.weights)
        b = tuple(b[g] for b in net.state.params.biases)
        pd = D.predict(arch.activation, w, b, ds.X[g])
        pf = D.predict(arch.activation, w, b, df.X[g])
        np.testing.assert_allclose(np.asarray(pd), np.asarray(pf), rtol=2e-5,
                                   atol=1e-6)
        # summary activations come back sample-major from both layouts
        Ad = D.summary_acts(arch.activation, w, b, ds.X[g])
        Af = D.summary_acts(arch.activation, w, b, df.X[g])
        assert Ad.shape == Af.shape
        np.testing.assert_allclose(np.asarray(Ad), np.asarray(Af), rtol=2e-5,
                                   atol=1e-6)


def test_potential_and_grads_match():
    arch, net, ds, df, y = _setup()
    pot = D.potential_fn("ridge_base", arch.activation)
    for g in range(arch.num_branches):
        w = tuple(w[g] for w in net.state.params.weights)
        b = tuple(b[g] for b in net.state.params.biases)
        wp = tuple(a[g] for a in net.state.precisions.weights)
        vg = jax.value_and_grad(pot, argnums=(0, 1))
        (vd, gd) = vg(w, b, wp, 1.7, ds.X[g], ds.y)
        (vf, gf) = vg(w, b, wp, 1.7, df.X[g], df.y)
        assert float(vd) == pytest.approx(float(vf), rel=1e-5)
        for a, bb in zip(jax.tree.leaves(gd), jax.tree.leaves(gf)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(bb),
                                       rtol=1e-4, atol=1e-5)


def test_net_methods_match():
    arch, net, ds, df, y = _setup()
    pd = net.predict(ds.X)
    pf = net.predict(df.X)
    np.testing.assert_allclose(np.asarray(pd), np.asarray(pf), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(net.branch_r2s(ds.X, ds.y)),
        np.asarray(net.branch_r2s(df.X, df.y)), rtol=1e-4, atol=1e-6,
    )
    # activations: same (sample-major) orientation from both layouts
    ad = net.activations(ds.X)
    af = net.activations(df.X)
    for la, lb in zip(ad, af):
        for xa, xb in zip(la, lb):
            assert xa.shape == xb.shape
            np.testing.assert_allclose(xa, xb, rtol=2e-5, atol=1e-6)
    # effect sizes densify internally for FeatX
    ed = np.asarray(net.effect_sizes(ds.X))
    ef = np.asarray(net.effect_sizes(df.X))
    np.testing.assert_allclose(ed, ef, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["sequential", "parallel", "hybrid"])
def test_sweep_runs_and_matches(mode):
    """One full sweep with the same RNG key: layouts must agree to float
    tolerance (identical draws; only matmul association order differs)."""
    arch, net, ds, df, y = _setup(G=4, n=48)
    cfg = MCMCCfg(chain_length=1, burn_in=10, hmc_integration_length=8,
                  update_mode=mode, block_size=2, seed=0)
    sweep = jax.jit(net.make_sweep(cfg))
    key = jax.random.key(3)
    cd = net.init_carry(ds.X, ds.y, key)
    cf = net.init_carry(df.X, df.y, key)
    cd2, sd = sweep(cd, ds.X, ds.y)
    cf2, sf = sweep(cf, df.X, df.y)
    assert np.asarray(sd.counts).sum() == np.asarray(sf.counts).sum()
    np.testing.assert_allclose(np.asarray(sd.mse_train),
                               np.asarray(sf.mse_train), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(cd2.residual),
                               np.asarray(cf2.residual), rtol=1e-3, atol=1e-4)


def test_marker_ss_scan_featx_matches_dense():
    """The per-marker collapsed scan sees identical columns through FeatX."""
    from rs_bann_tpu.models.net import _marker_ss_scan

    rng = np.random.default_rng(0)
    n, m_pad, s_pad = 40, 8, 4
    x = rng.standard_normal((n, m_pad)).astype(np.float32)
    W0 = (rng.standard_normal((m_pad, s_pad)) * 0.3).astype(np.float32)
    w_out = rng.standard_normal((s_pad, 1)).astype(np.float32)
    resid = rng.standard_normal(n).astype(np.float32)
    lam_rows = np.full(m_pad, 2.0, np.float32)
    row_mask = np.ones(m_pad, np.float32)
    col_mask = np.ones(s_pad, np.float32)
    key = jax.random.key(7)
    args = (jnp.asarray(W0), jnp.zeros(s_pad), jnp.asarray(w_out),
            jnp.asarray(resid), 1.3, jnp.asarray(lam_rows), 0.4,
            jnp.asarray(row_mask), jnp.asarray(col_mask), False)
    zd, Wd, ed = _marker_ss_scan(key, jnp.asarray(x), *args)
    zf, Wf, ef = _marker_ss_scan(key, D.FeatX(jnp.asarray(x.T)), *args)
    np.testing.assert_allclose(np.asarray(zd), np.asarray(zf))
    np.testing.assert_allclose(np.asarray(Wd), np.asarray(Wf), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(ed), np.asarray(ef), rtol=1e-4,
                               atol=1e-5)
