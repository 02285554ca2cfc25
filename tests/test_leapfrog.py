"""Chain arrangements of the compiled sweep: a chain-vmapped sweep (the
arrangement train.py runs, with X unbatched over chains) must reproduce the
per-chain ``lax.map`` arrangement draw-for-draw — same keys, same momenta
and step sizes; only f32 association-order roundoff differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_bann_tpu.models import density as D
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.init import InitCfg, init_net
from rs_bann_tpu.models.net import Net
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg


def _setup_net(model_type="ridge_base", act="tanh", G=4, m=8, h=4, n=256,
               seed=0, depth=1):
    arch = NetArch.uniform(G, m, h, depth, h, activation=act)
    state, _ = init_net(arch, model_type, InitCfg(seed=seed))
    net = Net(model_type, arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(seed)
    Xf = np.zeros((G, arch.m_pad, n), np.float32)
    Xf[:, :m, :] = rng.standard_normal((G, m, n), dtype=np.float32)
    X = D.FeatX(jnp.asarray(Xf))
    y = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    return net, X, y


@pytest.mark.parametrize(
    "model_type,mode,mass,act,depth",
    [
        ("ridge_base", "izmailov", False, "tanh", 1),
        ("ridge_ard", "dual_averaging", True, "tanh", 1),
        ("lasso_base", "izmailov", False, "tanh", 1),
        # the genome-scale production arch: identity depth-0 (2 weight
        # layers — the kernel's empty-hidden-loop edge case)
        ("ridge_ard", "dual_averaging", True, "identity", 0),
    ],
)
def test_chain_vmapped_sweep_matches_lax_map(model_type, mode, mass, act,
                                             depth):
    """The chain vmap must reproduce the per-chain arrangement
    draw-for-draw (same keys -> same momenta/step sizes; only
    association-order roundoff differs)."""
    C = 2
    net, X, y = _setup_net(model_type=model_type, act=act, depth=depth)
    cfg = MCMCCfg(
        chain_length=1, burn_in=4 if mode == "dual_averaging" else 10**9,
        hmc_integration_length=4, hmc_step_size_mode=mode,
        update_mode="parallel", num_chains=C, mass_adaptation=mass, seed=0,
    )
    sweep = net.make_sweep(cfg)
    keys = jax.random.split(jax.random.key(0), C)
    mk_carry = jax.vmap(
        lambda k: net.init_carry(X, y, k, mass_adaptation=mass)
    )

    vmapped = jax.jit(jax.vmap(sweep, in_axes=(0, None, None)))
    ref = jax.jit(
        lambda c, X_, y_: jax.lax.map(lambda ci: sweep(ci, X_, y_), c)
    )

    c_f, c_r = mk_carry(keys), mk_carry(keys)
    for _ in range(3):
        c_f, st_f = vmapped(c_f, X, y)
        c_r, st_r = ref(c_r, X, y)
    np.testing.assert_allclose(
        np.asarray(c_f.residual), np.asarray(c_r.residual), rtol=2e-4,
        atol=2e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(st_f.counts), np.asarray(st_r.counts)
    )
    for a, b in zip(
        jax.tree.leaves(c_f.state.params), jax.tree.leaves(c_r.state.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5
        )


def test_per_chain_block_perm_runs_under_chain_vmap():
    """Hybrid with per-chain block permutations (X[ixs] batched over
    chains) still runs correctly under the chain vmap."""
    net, X, y = _setup_net()
    cfg = MCMCCfg(
        chain_length=1, burn_in=10**9, hmc_integration_length=3,
        update_mode="hybrid", block_size=2, num_chains=2, seed=0,
        hybrid_shared_perm=False,
    )
    sweep = net.make_sweep(cfg)
    keys = jax.random.split(jax.random.key(0), 2)
    carry = jax.vmap(lambda k: net.init_carry(X, y, k))(keys)
    carry, stats = jax.jit(jax.vmap(sweep, in_axes=(0, None, None)))(
        carry, X, y
    )
    assert np.all(np.isfinite(np.asarray(stats.mse_train)))


def _setup_net_packed(model_type="ridge_ard", act="identity", G=4, m=8,
                      h=4, n=700, seed=0, depth=0):
    from rs_bann_tpu.ops.packed_matmul import pack_strided

    arch = NetArch.uniform(G, m, h, depth, h, activation=act)
    state, _ = init_net(arch, model_type, InitCfg(seed=seed))
    net = Net(model_type, arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(G, m, n)).astype(np.float32)
    bytes_g = np.stack([
        pack_strided(np.pad(geno[g], ((0, arch.m_pad - m), (0, 0))))
        for g in range(G)
    ])
    shift = np.zeros((G, arch.m_pad), np.float32)
    scale = np.zeros((G, arch.m_pad), np.float32)
    shift[:, :m] = geno.mean(axis=2)
    sd = geno.std(axis=2)
    scale[:, :m] = np.where(sd > 0, 1.0 / np.maximum(sd, 1e-12), 0.0)
    X = D.PackedX(
        jnp.asarray(bytes_g), jnp.asarray(scale), jnp.asarray(shift), n
    )
    y = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    return net, X, y


@pytest.mark.parametrize(
    "packed,model_type,act,depth,mode,mass",
    [
        (False, "ridge_base", "tanh", 1, "izmailov", False),
        (True, "ridge_ard", "identity", 0, "dual_averaging", True),
        # the genome-scale production recipe: packed + hybrid + ridge_ard
        # identity depth-0 with DA + mass adaptation
        (True, "lasso_ard", "identity", 0, "izmailov", False),
    ],
)
def test_hybrid_chain_vmapped_sweep_matches_lax_map(packed, model_type, act,
                                                    depth, mode, mass):
    """The hybrid schedule under a chain vmap (r5: shared block
    permutation, dense AND packed) must reproduce the per-chain lax.map
    arrangement draw-for-draw."""
    C = 2
    if packed:
        net, X, y = _setup_net_packed(model_type=model_type, act=act,
                                      depth=depth)
    else:
        net, X, y = _setup_net(model_type=model_type, act=act, depth=depth)
    cfg = MCMCCfg(
        chain_length=1, burn_in=4 if mode == "dual_averaging" else 10**9,
        hmc_integration_length=4, hmc_step_size_mode=mode,
        update_mode="hybrid", block_size=2, num_chains=C,
        mass_adaptation=mass, seed=0,
    )
    sweep = net.make_sweep(cfg)
    keys = jax.random.split(jax.random.key(0), C)
    mk_carry = jax.vmap(
        lambda k: net.init_carry(X, y, k, mass_adaptation=mass)
    )

    vmapped = jax.jit(jax.vmap(sweep, in_axes=(0, None, None)))
    ref = jax.jit(
        lambda c, X_, y_: jax.lax.map(lambda ci: sweep(ci, X_, y_), c)
    )

    c_f, c_r = mk_carry(keys), mk_carry(keys)
    for _ in range(3):
        c_f, st_f = vmapped(c_f, X, y)
        c_r, st_r = ref(c_r, X, y)
    np.testing.assert_allclose(
        np.asarray(c_f.residual), np.asarray(c_r.residual), rtol=2e-4,
        atol=2e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(st_f.counts), np.asarray(st_r.counts)
    )
    for a, b in zip(
        jax.tree.leaves(c_f.state.params), jax.tree.leaves(c_r.state.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5
        )


def test_ssm_hybrid_chain_vmapped_matches_lax_map():
    """r5: the per-marker spike-and-slab production recipe runs the
    live-accept path (post-scan prediction rebase + row freezing). The
    chain vmap must reproduce the per-chain lax.map arrangement
    draw-for-draw, including the spike invariant (excluded rows exactly
    zero)."""
    C = 2
    net, X, y = _setup_net_packed(model_type="ridge_ard", act="identity",
                                  depth=0, n=700)
    cfg = MCMCCfg(
        chain_length=1, burn_in=10**9, hmc_integration_length=4,
        update_mode="hybrid", block_size=2, num_chains=C, seed=0,
        ss_markers=True, ssm_pi=0.3, ssm_warmup=0,
    )
    sweep = net.make_sweep(cfg)
    keys = jax.random.split(jax.random.key(0), C)
    mk_carry = jax.vmap(
        lambda k: net.init_carry(X, y, k, ss_markers=True, ssm_pi=0.3)
    )

    vmapped = jax.jit(jax.vmap(sweep, in_axes=(0, None, None)))
    ref = jax.jit(
        lambda c, X_, y_: jax.lax.map(lambda ci: sweep(ci, X_, y_), c)
    )

    c_f, c_r = mk_carry(keys), mk_carry(keys)
    for _ in range(3):
        c_f, st_f = vmapped(c_f, X, y)
        c_r, st_r = ref(c_r, X, y)
    np.testing.assert_allclose(
        np.asarray(c_f.residual), np.asarray(c_r.residual), rtol=2e-4,
        atol=2e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(st_f.counts), np.asarray(st_r.counts)
    )
    np.testing.assert_array_equal(
        np.asarray(c_f.ssm_z), np.asarray(c_r.ssm_z)
    )
    # spike invariant: excluded rows' layer-0 weights are EXACTLY zero
    W0 = np.asarray(c_f.state.params.weights[0])  # [C, G, m_pad, out]
    z = np.asarray(c_f.ssm_z)  # [C, G, m_pad]
    assert np.all(W0[z == 0.0] == 0.0)
    assert np.any(z == 0.0)  # the test exercised actual exclusions
    for a, b in zip(
        jax.tree.leaves(c_f.state.params), jax.tree.leaves(c_r.state.params)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5
        )
