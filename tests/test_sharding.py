"""Mesh-sharded sweep tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_bann_tpu.models import density as D
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.init import InitCfg, init_net
from rs_bann_tpu.models.net import Net
from rs_bann_tpu.parallel.sharding import make_mesh, make_sharded_sweep
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _setup(G=8, n=32, m=8, C=2):
    arch = NetArch.uniform(G, m, 4, 1, 4)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=0))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(0)
    X = np.zeros((G, n, arch.m_pad), np.float32)
    X[:, :, :m] = rng.standard_normal((G, n, m), dtype=np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return net, jnp.asarray(X), jnp.asarray(y)


@pytest.mark.slow
def test_sharded_parallel_sweep_matches_single_device():
    net, X, y = _setup()
    cfg = MCMCCfg(
        chain_length=1, burn_in=10**9, hmc_integration_length=4,
        update_mode="parallel", num_chains=2, seed=0,
    )
    keys = jax.random.split(jax.random.key(0), 2)

    # single-device reference
    sweep = jax.jit(jax.vmap(net.make_sweep(cfg), in_axes=(0, None, None)))
    carry0 = jax.vmap(lambda k: net.init_carry(X, y, k))(keys)
    ref, ref_stats = sweep(carry0, X, y)

    # sharded over chain x branch mesh
    mesh = make_mesh(2, 4)
    ssweep, place_carry, place_data = make_sharded_sweep(net, cfg, mesh)
    carry1 = place_carry(jax.vmap(lambda k: net.init_carry(X, y, k))(keys))
    Xs, ys = place_data(X, y)
    out, out_stats = ssweep(carry1, Xs, ys)

    np.testing.assert_allclose(
        np.asarray(ref.residual), np.asarray(out.residual), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_array_equal(
        np.asarray(ref_stats.counts), np.asarray(out_stats.counts)
    )
    for a, b in zip(
        jax.tree.leaves(ref.state.params), jax.tree.leaves(out.state.params)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5)


@pytest.mark.slow
def test_sharded_sweep_multiple_iterations_stay_sharded():
    net, X, y = _setup()
    cfg = MCMCCfg(
        chain_length=1, burn_in=10**9, hmc_integration_length=3,
        update_mode="parallel", num_chains=2, seed=1,
    )
    mesh = make_mesh(2, 4)
    ssweep, place_carry, place_data = make_sharded_sweep(net, cfg, mesh)
    keys = jax.random.split(jax.random.key(1), 2)
    carry = place_carry(jax.vmap(lambda k: net.init_carry(X, y, k))(keys))
    Xs, ys = place_data(X, y)
    for _ in range(3):
        carry, stats = ssweep(carry, Xs, ys)
    assert np.all(np.isfinite(np.asarray(stats.mse_train)))
    # weights stay sharded over the branch axis
    shard_shapes = {
        s.data.shape for s in carry.state.params.weights[0].addressable_shards
    }
    assert all(sh[1] == 2 for sh in shard_shapes)  # 8 branches / 4 shards


@pytest.mark.slow
def test_graft_entry_dryrun():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", "/root/repo/__graft_entry__.py"
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    fn, args = m.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1024,)
    m.dryrun_multichip(8)


@pytest.mark.slow
def test_fused_dense_sharded_matches_single_device():
    """The dense feature-major parallel sweep under the (chain, branch,
    data) mesh — including the data/individuals axis — must match the
    single-device chain-vmapped run."""
    G, n, m, h, C = 8, 64, 8, 4, 2
    arch = NetArch.uniform(G, m, h, 1, h)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=0))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(0)
    Xf = np.zeros((G, arch.m_pad, n), np.float32)
    Xf[:, :m, :] = rng.standard_normal((G, m, n), dtype=np.float32)
    X = D.FeatX(jnp.asarray(Xf))
    y = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    cfg = MCMCCfg(
        chain_length=1, burn_in=10**9, hmc_integration_length=4,
        update_mode="parallel", num_chains=C, seed=0,
    )
    keys = jax.random.split(jax.random.key(0), C)
    sweep = jax.jit(jax.vmap(net.make_sweep(cfg), in_axes=(0, None, None)))
    carry0 = jax.vmap(lambda k: net.init_carry(X, y, k))(keys)
    ref, ref_stats = sweep(carry0, X, y)

    mesh = make_mesh(2, 2, 2)
    ssweep, place_carry, place_data = make_sharded_sweep(
        net, cfg, mesh, feat_major=True
    )
    carry1 = place_carry(jax.vmap(lambda k: net.init_carry(X, y, k))(keys))
    Xs, ys = place_data(X, y)
    out, out_stats = ssweep(carry1, Xs, ys)

    np.testing.assert_allclose(
        np.asarray(ref.residual), np.asarray(out.residual), rtol=2e-4,
        atol=2e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(ref_stats.counts), np.asarray(out_stats.counts)
    )
    for a, b in zip(
        jax.tree.leaves(ref.state.params), jax.tree.leaves(out.state.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5
        )


@pytest.mark.slow
def test_fused_packed_hybrid_sharded_matches_single_device():
    """The production recipe (packed 2-bit genotypes + hybrid schedule +
    mass adaptation) under the full mesh must match the single-device
    run."""
    from rs_bann_tpu.group.grouping import UniformGrouping
    from rs_bann_tpu.io.bed import BedVM
    from rs_bann_tpu.models.data import pack_stacked

    G, n, m, h, C = 8, 64, 8, 4, 2
    bed = BedVM.random(n, G * m, seed=1)
    grouping = UniformGrouping(G, m)
    arch = NetArch.from_width_rules(
        [m] * G, 0, ("fixed", h), ("like_hidden",), activation="identity"
    )
    state, _ = init_net(arch, "ridge_ard", InitCfg(seed=0))
    net = Net("ridge_ard", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(n).astype(np.float32)
    data = pack_stacked(arch, bed, grouping, y)
    cfg = MCMCCfg(
        chain_length=1, burn_in=4, hmc_integration_length=3,
        hmc_step_size_mode="dual_averaging", update_mode="hybrid",
        block_size=2, mass_adaptation=True, num_chains=C, seed=0,
    )
    keys = jax.random.split(jax.random.key(0), C)
    sweep = jax.jit(jax.vmap(net.make_sweep(cfg), in_axes=(0, None, None)))
    carry0 = jax.vmap(
        lambda k: net.init_carry(data.X, data.y, k, mass_adaptation=True)
    )(keys)
    ref, ref_stats = sweep(carry0, data.X, data.y)

    mesh = make_mesh(2, 2, 2)
    ssweep, place_carry, place_data = make_sharded_sweep(
        net, cfg, mesh, packed_n=n
    )
    carry1 = place_carry(
        jax.vmap(
            lambda k: net.init_carry(data.X, data.y, k, mass_adaptation=True)
        )(keys)
    )
    Xs, ys = place_data(data.X, data.y)
    out, out_stats = ssweep(carry1, Xs, ys)

    np.testing.assert_allclose(
        np.asarray(ref.residual), np.asarray(out.residual), rtol=2e-4,
        atol=2e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(ref_stats.counts), np.asarray(out_stats.counts)
    )
    for a, b in zip(
        jax.tree.leaves(ref.state.params), jax.tree.leaves(out.state.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5
        )
