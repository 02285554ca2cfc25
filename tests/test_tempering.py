"""Parallel tempering tests (extension; the reference has no multi-chain
capability at all — SURVEY.md §2.7)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from rs_bann_tpu.models import density as D
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import stack_standardized
from rs_bann_tpu.models.init import InitCfg, init_net
from rs_bann_tpu.models.net import Net
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import _pt_swap, tempering_ladder, train


def test_ladder_geometric():
    b = tempering_ladder(4, 4.0)
    np.testing.assert_allclose(b, [1.0, 4 ** (-1 / 3), 4 ** (-2 / 3), 0.25],
                               rtol=1e-12)
    np.testing.assert_allclose(tempering_ladder(2, 8.0), [1.0, 0.125])


def _stacked_carry(C, n=16, seed=0):
    arch = NetArch(m=(4,), h=(2,), s=(2,), depth=0)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=seed))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.standard_normal((1, n, arch.m_pad)).astype(np.float32))
    y = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    keys = jax.random.split(jax.random.key(seed), C)
    betas = jnp.asarray(tempering_ladder(C, 4.0), jnp.float32)
    carry = jax.vmap(lambda k, b: net.init_carry(X, y, k, 1.0, False, b))(
        keys, betas
    )
    return carry


def test_swap_exchanges_state_not_beta():
    """A pair with a huge likelihood advantage in the hot slot must swap:
    states/residuals exchange, betas and keys stay with the slot."""
    carry = _stacked_carry(2)
    # make slot 1's state wildly more likely: tiny rss vs huge rss
    carry = carry._replace(
        residual=jnp.stack([
            jnp.full_like(carry.residual[0], 100.0),  # cold slot: awful fit
            jnp.zeros_like(carry.residual[0]),  # hot slot: perfect fit
        ]),
    )
    r_before = np.asarray(carry.residual)
    b_before = np.asarray(carry.beta)
    out, proposed, accepted = _pt_swap(carry, parity=jnp.asarray(0))
    assert bool(proposed[0]) and bool(accepted[0])
    np.testing.assert_array_equal(np.asarray(out.residual), r_before[::-1])
    np.testing.assert_array_equal(np.asarray(out.beta), b_before)  # unmoved
    # parity 1 with C=2: pair (0,1) not proposed, nothing moves
    out2, proposed2, accepted2 = _pt_swap(carry, parity=jnp.asarray(1))
    assert not bool(proposed2[0]) and not bool(accepted2[0])
    np.testing.assert_array_equal(np.asarray(out2.residual), r_before)


def test_swap_rejects_unfavorable():
    """Cold slot already holds the better state -> log-ratio << 0, reject."""
    carry = _stacked_carry(2)
    carry = carry._replace(
        residual=jnp.stack([
            jnp.zeros_like(carry.residual[0]),
            jnp.full_like(carry.residual[0], 100.0),
        ]),
    )
    out, proposed, accepted = _pt_swap(carry, parity=jnp.asarray(0))
    assert bool(proposed[0]) and not bool(accepted[0])
    np.testing.assert_array_equal(
        np.asarray(out.residual), np.asarray(carry.residual)
    )


def test_tempered_error_precision_conditional():
    """The β-tempered conjugate draw is Gamma(k + βn/2, 2s/(2 + s·β·rss)):
    check the sample mean against the analytic mean."""
    from rs_bann_tpu.samplers.gibbs import error_precision_posterior

    hyper = D.Hyperparameters()
    rng = np.random.default_rng(0)
    residual = jnp.asarray(rng.standard_normal(200).astype(np.float32))
    rss = float(jnp.sum(residual**2))
    beta = 0.3
    keys = jax.random.split(jax.random.key(1), 4000)
    draws = jax.vmap(
        lambda k: error_precision_posterior(k, hyper, residual, beta)
    )(keys)
    k_, s_ = hyper.output_shape, hyper.output_scale
    shape = k_ + beta * 200 / 2
    scale = 2 * s_ / (2 + s_ * beta * rss)
    np.testing.assert_allclose(
        float(jnp.mean(draws)), shape * scale, rtol=0.05
    )


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
def test_tempering_posterior_matches_single_chain(tmp_path):
    """Replica exchange leaves the cold-chain posterior invariant: the
    posterior-mean predictions of a tempered 4-slot run must agree with a
    plain single-chain run within MCMC error, swaps must actually happen,
    and only cold-chain samples may be written."""
    import glob

    arch = NetArch(m=(10, 10), h=(5, 5), s=(5, 5), depth=0)
    data = _sim(arch)
    preds = {}
    for label, kw in (
        ("plain", dict(num_chains=1)),
        ("pt", dict(num_chains=4, tempering=True, max_temperature=4.0)),
    ):
        state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
        net = Net("ridge_base", arch, D.Hyperparameters(), state)
        cfg = MCMCCfg(
            chain_length=120, burn_in=40, hmc_integration_length=30,
            hmc_step_size_mode="dual_averaging",
            outpath=str(tmp_path / label), seed=5, **kw,
        )
        _, stats = train(net, data, cfg, verbose=False)
        assert stats.acceptance_rate() > 0.3, (label, stats.acceptance_rate())
        if label == "pt":
            assert stats.pt_swaps_proposed > 0
            assert 0.05 < stats.pt_swap_rate() <= 1.0, stats.pt_swap_rate()
        files = sorted(glob.glob(str(tmp_path / label / "models" / "*.npz")))
        assert len(files) == 81, (label, len(files))  # flat dir, cold only
        ps = [np.asarray(Net.load(f).predict(data.X)) for f in files]
        preds[label] = np.stack(ps).mean(0)
    r = np.corrcoef(preds["plain"], preds["pt"])[0, 1]
    assert r > 0.95, r
