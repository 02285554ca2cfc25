"""Device-mesh sharding of the Gibbs sweep.

The reference is strictly single-device, single-chain (SURVEY.md §2.7). The
rebuild exposes the two parallel axes that exist implicitly in the model:

  * ``chain``  — vectorized MCMC chains: pure data parallelism, no
    communication (each chain owns its full state).
  * ``branch`` — SNP groups within a sweep: embarrassingly parallel in the
    block-parallel update mode except for the shared residual (a length-n
    all-reduce over branch predictions), the error precision, the output
    layer precision, and the output-weight summary statistic (scalar psums).

We lay the stacked state out as ``[C, G, ...]`` and annotate leaves with
``NamedSharding`` over a ``Mesh(("chain", "branch"))``; XLA GSPMD inserts the
collectives (the Σ_g pred_g all-reduce rides the branch axis of the mesh).
Sequential (reference-exact) mode serializes branches by construction, so it
shards only over chains; parallel mode shards both axes.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.net import Net, TrainCarry
from ..samplers.mcmc_cfg import MCMCCfg


def make_mesh(
    n_chain: int, n_branch: int, n_data: int = 1, devices=None
) -> Mesh:
    """Mesh over (chain, branch, data) axes.

    chain: data-parallel MCMC chains (no communication). branch: SNP-group
    shards (residual all-reduce + scalar psums over ICI). data: individuals
    — the reductions over n (rss, backprop sums) become psums; this is the
    axis to map onto DCN for multi-host runs (SURVEY.md §2.7 axis 3).
    """
    devices = devices if devices is not None else jax.devices()
    need = n_chain * n_branch * n_data
    assert need <= len(devices), (
        f"mesh {n_chain}x{n_branch}x{n_data} needs {need} devices, "
        f"have {len(devices)}"
    )
    dev = np.asarray(devices[:need]).reshape(n_chain, n_branch, n_data)
    return Mesh(dev, ("chain", "branch", "data"))


def _carry_specs(
    carry: TrainCarry, chains: bool, shard_branch: bool, shard_data: bool = False
):
    """PartitionSpec pytree matching a TrainCarry.

    Stacked per-branch arrays lead with [C?, G, ...]; scalars replicate;
    the residual vector shards over the data (individuals) axis.
    """
    c = "chain" if chains else None
    b = "branch" if shard_branch else None
    dax = "data" if shard_data else None

    def spec(ndim_after_batch, branch_leading):
        base = [c] if chains else []
        if branch_leading:
            base.append(b)
        base += [None] * ndim_after_batch
        return P(*base)

    params_spec = type(carry.state.params)(
        tuple(spec(w.ndim - (2 if chains else 1), True) for w in carry.state.params.weights),
        tuple(spec(bi.ndim - (2 if chains else 1), True) for bi in carry.state.params.biases),
    )
    prec_spec = type(carry.state.precisions)(
        tuple(spec(w.ndim - (2 if chains else 1), True) for w in carry.state.precisions.weights),
        tuple(spec(bi.ndim - (2 if chains else 1), True) for bi in carry.state.precisions.biases),
        P(c) if chains else P(),
    )
    state_spec = type(carry.state)(
        params_spec,
        prec_spec,
        P(c) if chains else P(),
        P(c) if chains else P(),
    )
    return TrainCarry(
        state=state_spec,
        residual=P(c, dax) if chains else P(dax),
        lpd_local=P(c, b) if chains else P(b),
        lpd_out=P(c) if chains else P(),
        lpd_rss=P(c) if chains else P(),
        counts=P(c, None) if chains else P(None),
        # typed PRNG keys are rank-1 with a leading chain axis
        key=P(c) if chains else P(),
        da_log_eps=P(c, b) if chains else P(b),
        da_log_eps_bar=P(c, b) if chains else P(b),
        da_h_bar=P(c, b) if chains else P(b),
        da_t=P(c) if chains else P(),
        mm_mean=P(c, b, None) if chains else P(b, None),
        mm_m2=P(c, b, None) if chains else P(b, None),
        beta=P(c) if chains else P(),
        tl_avg=P(c, b) if chains else P(b),
        ss_z=P(c, b) if chains else P(b),
        ss_pi=P(c) if chains else P(),
        ss_pip=P(c, b) if chains else P(b),
        ssm_z=P(c, b, None) if chains else P(b, None),
        ssm_pi=P(c) if chains else P(),
        ssm_pip=P(c, b, None) if chains else P(b, None),
    )


def packed_x_specs(shard_branch: bool, shard_data: bool, n: int):
    """PartitionSpec pytree for a PackedX (models/density.py).

    Leaves: ``bytes`` [G, m_pad, B] (B = group-strided packed individuals),
    ``w_scale``/``shift`` [G, m_pad]. The byte payload — the only
    genome-scale-sized array — shards over the branch axis (each device
    holds only its branch shard's genotypes, never a replica) and over the
    data axis along the strided-individuals byte groups; the per-marker
    scale/shift vectors are small and shard on branch only. ``n`` must be
    the PackedX's static individual count (pytree aux data must match).
    """
    from ..models.density import PackedX

    b = "branch" if shard_branch else None
    dax = "data" if shard_data else None
    return PackedX(P(b, None, dax), P(b, None), P(b, None), n)


def make_sharded_sweep(
    net: Net,
    cfg: MCMCCfg,
    mesh: Mesh,
    packed_n: Optional[int] = None,
    feat_major: bool = False,
):
    """Compile the sweep with mesh shardings.

    Returns (sweep_fn, place_carry, place_data):
      sweep_fn(carry, X, y) -> (carry, stats), jitted with shardings;
      place_carry / place_data move host pytrees onto the mesh.

    With num_chains > 1 the carry must have a leading chain axis on every
    leaf (build with vmap of net.init_carry). ``packed_n`` (the individual
    count) switches X to a PackedX (2-bit genotypes) whose byte payload
    shards over the branch axis instead of a dense [G, n, m_pad] array.

    Branch sharding applies to both concurrent update schedules: "parallel"
    (one vmap over all G) and "hybrid" (sequential random blocks, parallel
    within a block — the block gathers become GSPMD collectives).
    """
    chains = cfg.num_chains > 1
    shard_branch = (
        cfg.update_mode in ("parallel", "hybrid") and mesh.shape["branch"] > 1
    )
    shard_data = "data" in mesh.shape and mesh.shape["data"] > 1
    if shard_branch:
        assert net.arch.num_branches % mesh.shape["branch"] == 0, (
            f"num_branches {net.arch.num_branches} must divide evenly over the "
            f"branch mesh axis {mesh.shape['branch']}"
        )

    sweep = net.make_sweep(cfg)
    if chains:
        sweep = jax.vmap(sweep, in_axes=(0, None, None))

    def dummy_carry():
        key = jax.random.key(0)
        n = 4
        import jax.numpy as jnp

        X = jnp.zeros((net.arch.num_branches, n, net.arch.m_pad))
        y = jnp.zeros(n)
        c = net.init_carry(X, y, key)
        if chains:
            c = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (cfg.num_chains,) + a.shape), c
            )
        return c

    specs = _carry_specs(dummy_carry(), chains, shard_branch, shard_data)
    b = "branch" if shard_branch else None
    dax = "data" if shard_data else None
    if packed_n is not None:
        x_spec = packed_x_specs(shard_branch, shard_data, packed_n)
    elif feat_major:
        from ..models.density import FeatX

        # [G, m_pad, n]: branch shard leads, individuals shard the minor axis
        x_spec = FeatX(P(b, None, dax))
    else:
        x_spec = P(b, dax, None)
    y_spec = P(dax)

    def sh(spec_tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), spec_tree,
                            is_leaf=lambda x: isinstance(x, P))

    sweep_jit = jax.jit(
        sweep,
        in_shardings=(sh(specs), sh(x_spec), sh(y_spec)),
        out_shardings=(sh(specs), None),
    )

    def place_carry(carry):
        return jax.device_put(carry, sh(specs))

    def place_data(X, y):
        return jax.device_put(X, sh(x_spec)), jax.device_put(y, sh(y_spec))

    return sweep_jit, place_carry, place_data
