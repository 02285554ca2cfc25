"""Training driver: runs the compiled Gibbs sweep for chain_length iterations,
records statistics, writes posterior model samples and artifact streams.

Mirrors the outer loop of the reference ``Net::train`` (/root/reference/src/
net/net.rs:201-358) and its artifact conventions:
  * ``models/<chain_ix>.npz``   posterior sample store (reference: bincode
    ``models/<ix>.bin``, net.rs:339-342; we use npz pytrees)
  * ``hyperparams``             JSON model hyperparameters (net.rs:149-156)
  * ``trace``                   JSONL, one line per iteration with all branch
                                params/precisions (net.rs:349-352)
  * ``training_stats``          JSON acceptance counts + mse/lpd series
                                (train_stats.rs:83-88)

Extensions over the reference: multiple vectorized chains (a leading vmap
axis; chains write to ``models/chain<k>/``), full reproducibility from a seed,
and a block-parallel update mode.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .models import density as D
from .models.data import StackedData
from .models.init import DEFAULT_INIT_OUTPUT_LAYER_PRECISION
from .models.net import Net, TrainCarry
from .models.params import StackedPrecisions
from .samplers.mcmc_cfg import MCMCCfg

log = logging.getLogger("rs_bann_tpu")


def over_chains(fn, carry, *shared):
    """fn(carry_c, *shared) for every chain c of a chain-batched carry.

    One fixed arrangement: a vmap with the data unbatched, so each sweep dot
    reads X once for all chains (the chain axis joins the dot's free
    dimension).
    """
    return jax.vmap(fn, in_axes=(0,) + (None,) * len(shared))(carry, *shared)


class TrainingStats:
    """train_stats.rs:24-88 equivalent."""

    def __init__(self):
        self.num_samples = 0
        self.num_accepted = 0
        self.num_early_rejected = 0
        self.mse_train = []
        self.mse_test = None
        self.lpd = []
        # parallel tempering: replica-exchange swap proposals between
        # adjacent temperature slots (0 / 0 when tempering is off)
        self.pt_swaps_proposed = 0
        self.pt_swaps_accepted = 0

    def update_counts(self, counts):
        self.num_accepted = int(counts[0])
        self.num_early_rejected = int(counts[2])
        self.num_samples = int(counts.sum())

    def acceptance_rate(self):
        return self.num_accepted / max(self.num_samples, 1)

    def early_rejection_rate(self):
        return self.num_early_rejected / max(self.num_samples, 1)

    def end_rejection_rate(self):
        return (
            self.num_samples - self.num_early_rejected - self.num_accepted
        ) / max(self.num_samples, 1)

    def pt_swap_rate(self):
        return self.pt_swaps_accepted / max(self.pt_swaps_proposed, 1)

    def to_file(self, outdir):
        rec = {
            "num_samples": self.num_samples,
            "num_accepted": self.num_accepted,
            "num_early_rejected": self.num_early_rejected,
            "mse_train": self.mse_train,
            "mse_test": self.mse_test,
            "lpd": self.lpd,
        }
        if self.pt_swaps_proposed:
            rec["pt_swaps_proposed"] = self.pt_swaps_proposed
            rec["pt_swaps_accepted"] = self.pt_swaps_accepted
        with open(os.path.join(outdir, "training_stats"), "w") as f:
            json.dump(rec, f)


def _write_hyperparams(net: Net, cfg: MCMCCfg):
    hp = {
        "branch_hyperparams": [
            {
                "num_params": net.arch.num_params_branch(g),
                "num_markers": net.arch.m[g],
                "layer_widths": net.arch.layer_widths(g),
            }
            for g in range(net.arch.num_branches)
        ],
        "precision_hyperparams": {
            "dense": {"shape": net.hyper.dense_shape, "scale": net.hyper.dense_scale},
            "summary": {
                "shape": net.hyper.summary_shape,
                "scale": net.hyper.summary_scale,
            },
            "output": {
                "shape": net.hyper.output_shape,
                "scale": net.hyper.output_scale,
            },
        },
    }
    with open(cfg.hyperparam_path(), "w") as f:
        json.dump(hp, f)


def _trace_line(net: Net, state) -> dict:
    """One trace record: all branch params + precisions (host side)."""
    arch = net.arch
    rec = []
    for g in range(arch.num_branches):
        ins = arch.layer_in_counts()
        outs = arch.layer_out_counts()
        weights = [
            np.asarray(state.params.weights[l][g])[: ins[l][g], : outs[l][g]]
            .reshape(-1, order="F")
            .tolist()
            for l in range(arch.num_layers)
        ]
        biases = [
            np.asarray(state.params.biases[l][g])[: outs[l][g]].tolist()
            for l in range(arch.num_layers - 1)
        ]
        wprec = [
            np.asarray(state.precisions.weights[l][g]).reshape(-1).tolist()
            for l in range(arch.num_layers)
        ]
        bprec = [
            np.asarray(state.precisions.biases[l][g]).reshape(-1).tolist()
            for l in range(arch.num_layers - 1)
        ]
        rec.append(
            {
                "num_markers": arch.m[g],
                "layer_widths": arch.layer_widths(g),
                "params": {"weights": weights, "biases": biases},
                "precisions": {
                    "weight_precisions": wprec,
                    "bias_precisions": bprec,
                    "error_precision": [float(np.asarray(state.precisions.error))],
                },
            }
        )
    return rec


def _unpad_flat(net: Net, g: int, flat: np.ndarray) -> list:
    """Padded-flat (raveled padded layers, weights then biases) -> reference
    param_vec order (column-major true weights per layer, then biases)."""
    arch = net.arch
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    pieces, ix = [], 0
    for l in range(arch.num_layers):
        ip, op = arch.layer_in_pad(l), arch.layer_out_pad(l)
        w = flat[ix : ix + ip * op].reshape(ip, op)
        pieces.append(w[: ins[l][g], : outs[l][g]].reshape(-1, order="F"))
        ix += ip * op
    for l in range(arch.num_layers - 1):
        op = arch.layer_out_pad(l)
        b = flat[ix : ix + op]
        pieces.append(b[: outs[l][g]])
        ix += op
    return np.concatenate(pieces).tolist()


def _unpad_prec_flat(net: Net, g: int, flat: np.ndarray) -> list:
    """Padded-flat precision vector (w_prec per layer, b_prec, error) ->
    true entries only (ARD layers carry one precision per true input row)."""
    arch = net.arch
    ins = arch.layer_in_counts()
    p = net.state.precisions
    pieces, ix = [], 0
    for l in range(arch.num_layers):
        rows = p.weights[l].shape[1]  # 1 (base) or in_pad (ARD)
        v = flat[ix : ix + rows]
        pieces.append(v[: ins[l][g]] if rows > 1 else v)
        ix += rows
    for l in range(arch.num_layers - 1):
        pieces.append(flat[ix : ix + 1])
        ix += 1
    pieces.append(flat[ix : ix + 1])  # error precision
    return np.concatenate(pieces).tolist()


def _write_traj_lines(f, net: Net, traj) -> None:
    """One JSONL record per branch update, in update order
    (trajectory.rs:4-43 schema: params/ldg/num_ldg series + hamiltonian;
    joint-HMC runs additionally record the precision series)."""
    perm = np.asarray(traj["perm"])
    params = np.asarray(traj["params"])  # [G, L, P]
    ldg = np.asarray(traj["ldg"])
    ham = np.asarray(traj["hamiltonian"])  # [G, L+1]
    num_ldg = np.asarray(traj["num_ldg"]) if "num_ldg" in traj else None
    precs = np.asarray(traj["precisions"]) if "precisions" in traj else None
    for i, g in enumerate(perm):
        rec = {
            "branch_ix": int(g),
            "params": [_unpad_flat(net, g, params[i, t]) for t in range(params.shape[1])],
            "precisions": (
                [_unpad_prec_flat(net, g, precs[i, t]) for t in range(precs.shape[1])]
                if precs is not None
                else []
            ),
            "ldg": [_unpad_flat(net, g, ldg[i, t]) for t in range(ldg.shape[1])],
            "num_ldg": (
                [_unpad_flat(net, g, num_ldg[i, t]) for t in range(num_ldg.shape[1])]
                if num_ldg is not None
                else []
            ),
            "hamiltonian": ham[i].tolist(),
        }
        f.write(json.dumps(rec) + "\n")


def _write_effect_sizes(net: Net, X, model_ix: int, outdir: str, state) -> None:
    """effect_sizes/<model_ix>_<branch_ix> CSV: n rows x m_g cols of
    |d y_hat / d x| input gradients (net.rs:571-587)."""
    es = np.asarray(net.effect_sizes(X, state))  # [G, n, m_pad]
    for g in range(net.arch.num_branches):
        path = os.path.join(outdir, f"{model_ix}_{g}")
        np.savetxt(path, es[g][:, : net.arch.m[g]], delimiter=",", fmt="%.7g")


def tempering_ladder(num_chains: int, max_temperature: float) -> np.ndarray:
    """Geometric inverse-temperature ladder: β_0 = 1 (cold, the true
    posterior) down to β_{C-1} = 1/max_temperature."""
    return (1.0 / max_temperature) ** (
        np.arange(num_chains) / max(num_chains - 1, 1)
    )


def _pt_swap(carry: TrainCarry, parity):
    """One replica-exchange round between adjacent temperature slots.

    ``carry`` is chain-stacked ([C, ...] leaves). Pairs (i, i+1) with
    i ≡ parity (mod 2) propose to exchange their sampler STATES (params,
    precisions, residual, LPD terms); β, RNG keys, counts and the
    step-size/mass adaptation state stay attached to the slot, so slot 0
    is always the cold chain. Acceptance is the standard replica-exchange
    ratio exp((β_i − β_j)(ℓ_j − ℓ_i)) with ℓ the UNTEMPERED Gaussian
    log-likelihood n/2·log(λ_e/2π) − λ_e/2·rss — the prior terms cancel
    because the full states are exchanged.

    Returns (carry, proposed_mask [C-1], accepted_mask [C-1]).
    """
    lam = carry.state.precisions.error  # [C]
    rss = jnp.sum(carry.residual**2, axis=-1)  # [C]
    n = carry.residual.shape[-1]
    ell = 0.5 * n * jnp.log(lam / (2.0 * jnp.pi)) - 0.5 * lam * rss
    betas = carry.beta  # [C]
    C = betas.shape[0]
    i = jnp.arange(C - 1)
    proposed = (i % 2) == parity
    log_ratio = (betas[:-1] - betas[1:]) * (ell[1:] - ell[:-1])
    k_swap = jax.random.fold_in(carry.key[0], 0x5157)
    u = jax.random.uniform(k_swap, (C - 1,))
    accepted = proposed & (jnp.log(u) < log_ratio)
    # permutation of slots: swapped pairs never overlap (parity masking)
    perm = jnp.arange(C)
    take_next = jnp.zeros(C, bool).at[:-1].set(accepted)
    take_prev = jnp.zeros(C, bool).at[1:].set(accepted)
    perm = jnp.where(take_next, perm + 1, jnp.where(take_prev, perm - 1, perm))
    state, residual, lpd_local, lpd_out, lpd_rss = jax.tree.map(
        lambda a: a[perm],
        (carry.state, carry.residual, carry.lpd_local, carry.lpd_out,
         carry.lpd_rss),
    )
    carry = carry._replace(
        state=state, residual=residual, lpd_local=lpd_local,
        lpd_out=lpd_out, lpd_rss=lpd_rss,
    )
    return carry, proposed, accepted


def prepare_state_for_training(net: Net, cfg_fixed_precision: Optional[float]):
    """Inject the GlobalParams init into the state, as the reference's first
    ``update_global_params`` does (architectures.rs:216-236, net.rs:262):
    error precision 2.0, output layer precision 0.05 (or the fixed value)."""
    lam_out = (
        cfg_fixed_precision
        if cfg_fixed_precision is not None
        else DEFAULT_INIT_OUTPUT_LAYER_PRECISION
    )
    if net.model_type == "std_normal":
        lam_out = 1.0
    p = net.state.precisions
    wp = tuple(
        jnp.full_like(p.weights[l], lam_out)
        if l == net.arch.num_layers - 1
        else p.weights[l]
        for l in range(net.arch.num_layers)
    )
    net.state = net.state._replace(
        precisions=StackedPrecisions(wp, p.biases, jnp.asarray(2.0))
    )
    return net


def save_checkpoint(path, carry: TrainCarry, chain_ix: int, stats: "TrainingStats"):
    """Serialize the FULL sampler state — including the PRNG key — so a run
    resumes bit-for-bit. (The reference checkpoints the model but not its
    RNG, so its resumed chains are not reproducible; SURVEY.md §5.)"""
    leaves, treedef = jax.tree.flatten(carry)
    arrays = {}
    for i, leaf in enumerate(leaves):
        a = np.asarray(
            jax.random.key_data(leaf)
            if jnp.issubdtype(getattr(leaf, "dtype", np.float32), jax.dtypes.prng_key)
            else leaf
        )
        arrays[f"leaf{i}"] = a
    key_ixs = [
        i
        for i, leaf in enumerate(leaves)
        if jnp.issubdtype(getattr(leaf, "dtype", np.float32), jax.dtypes.prng_key)
    ]
    arrays["meta_json"] = np.frombuffer(
        json.dumps(
            {
                "chain_ix": chain_ix,
                "key_ixs": key_ixs,
                "num_leaves": len(leaves),
                "stats": {
                    "mse_train": stats.mse_train,
                    "mse_test": stats.mse_test,
                    "lpd": stats.lpd,
                },
            }
        ).encode(),
        dtype=np.uint8,
    )
    np.savez(path, **arrays)


def load_checkpoint(path, carry_like: TrainCarry):
    """Restore (carry, chain_ix, stats_dict) from a checkpoint file."""
    z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    meta = json.loads(bytes(z["meta_json"]).decode())
    _, treedef = jax.tree.flatten(carry_like)
    leaves = []
    for i in range(meta["num_leaves"]):
        a = jnp.asarray(z[f"leaf{i}"])
        if i in meta["key_ixs"]:
            a = jax.random.wrap_key_data(a)
        leaves.append(a)
    return jax.tree.unflatten(treedef, leaves), meta["chain_ix"], meta["stats"]


def train(
    net: Net,
    train_data: StackedData,
    cfg: MCMCCfg,
    test_data: Optional[StackedData] = None,
    report_interval: int = 1,
    verbose: bool = True,
    fixed_param_precision: Optional[float] = None,
    checkpoint_interval: int = 0,
    resume_from: Optional[str] = None,
):
    """Run the MCMC chain(s). Returns (net, TrainingStats).

    ``net.state`` is left at the final iteration of chain 0.
    ``checkpoint_interval`` > 0 writes <outpath>/checkpoint.npz every that
    many iterations; ``resume_from`` restores one and continues exactly.
    """
    os.makedirs(cfg.outpath, exist_ok=True)
    save_models = cfg.chain_length > cfg.burn_in
    if save_models:
        os.makedirs(cfg.models_path(), exist_ok=True)
        if cfg.effect_sizes:
            os.makedirs(cfg.effect_sizes_path(), exist_ok=True)
    _write_hyperparams(net, cfg)
    prepare_state_for_training(net, fixed_param_precision)

    sweep = net.make_sweep(cfg)
    C = cfg.num_chains
    X, y = train_data.X, train_data.y

    gd_sweep = None
    if cfg.gd_warmup > 0 and not (cfg.gradient_descent or cfg.gradient_descent_joint):
        import dataclasses as _dc

        # GD ignores the step-size mode (its line search sets its own rate),
        # but an adaptive mode would make the GD sweeps advance the
        # dual-averaging state and the da_t warmup counter from meaningless
        # GD "acceptances", corrupting the subsequent HMC adaptation — pin a
        # static mode here and reset the counters after the warm start
        gd_cfg = _dc.replace(
            cfg, gradient_descent=True, joint_hmc=False, trajectories=False,
            mass_adaptation=False, tempering=False, spike_slab=False,
            hmc_traj_length_mode="fixed",
            hmc_step_size_mode="izmailov",
            hmc_step_size_factor=min(cfg.hmc_step_size_factor, 1e-3),
            hmc_integration_length=min(cfg.hmc_integration_length, 20),
        )
        gd_sweep = net.make_sweep(gd_cfg)

    if C == 1:
        key = jax.random.key(cfg.seed)
        # jit with state/X/y as ARGUMENTS: closing over the device state
        # would bake it into the program as constants
        carry = jax.jit(
            lambda s, X_, y_, k: net.init_carry(
                X_, y_, k, cfg.hmc_step_size_factor, cfg.mass_adaptation,
                ss_pi=cfg.ss_pi, state=s,
                ss_markers=cfg.ss_markers or cfg.ss_rows,
                ssm_pi=cfg.ssr_pi if cfg.ss_rows else cfg.ssm_pi,
            )
        )(net.state, X, y, key)
    else:
        keys = jax.random.split(jax.random.key(cfg.seed), C)
        betas = (
            jnp.asarray(tempering_ladder(C, cfg.max_temperature), jnp.float32)
            if cfg.tempering
            else jnp.ones(C, jnp.float32)
        )
        # state/X/y flow in as jit ARGUMENTS (closing over device arrays
        # would bake them in as constants -> device readback at lowering)
        carry = jax.jit(
            lambda s, X_, y_, ks, bs: jax.vmap(
                lambda k, b: net.init_carry(
                    X_, y_, k, cfg.hmc_step_size_factor, cfg.mass_adaptation,
                    b, ss_pi=cfg.ss_pi, state=s,
                    ss_markers=cfg.ss_markers or cfg.ss_rows,
                ssm_pi=cfg.ssr_pi if cfg.ss_rows else cfg.ssm_pi,
                )
            )(ks, bs)
        )(net.state, X, y, keys, betas)

    stats = TrainingStats()
    start_ix = 0
    if resume_from is not None:
        carry, start_ix, st = load_checkpoint(resume_from, carry)
        stats.mse_train = st["mse_train"]
        stats.mse_test = st["mse_test"]
        stats.lpd = st["lpd"]
        log.info("resumed from %s at iteration %d", resume_from, start_ix)
    mode = "a" if resume_from is not None else "w"
    trace_f = open(cfg.trace_path(), mode) if cfg.trace else None
    traj_f = open(cfg.trajectories_path(), mode) if cfg.trajectories else None

    tempering = cfg.tempering and C > 1
    # tempered slots target DIFFERENT distributions: every reported
    # statistic and every saved sample comes from the cold slot (chain 0)

    def record(carry, sweep_stats=None):
        if sweep_stats is None:
            if C == 1:
                mse_train = float(jnp.sum(carry.residual**2) / y.shape[0])
                lpd = float(
                    carry.lpd_rss + carry.lpd_out + jnp.sum(carry.lpd_local)
                )
            elif tempering:
                mse_train = float(
                    jnp.sum(carry.residual[0] ** 2) / y.shape[0]
                )
                lpd = float(
                    carry.lpd_rss[0]
                    + carry.lpd_out[0]
                    + jnp.sum(carry.lpd_local[0])
                )
            else:
                mse_train = float(
                    jnp.mean(jnp.sum(carry.residual**2, axis=-1)) / y.shape[0]
                )
                lpd = float(
                    jnp.mean(
                        carry.lpd_rss
                        + carry.lpd_out
                        + jnp.sum(carry.lpd_local, axis=-1)
                    )
                )
        else:
            if tempering:
                mse_train = float(np.asarray(sweep_stats.mse_train)[0])
                lpd = float(np.asarray(sweep_stats.lpd)[0])
            else:
                mse_train = float(jnp.mean(sweep_stats.mse_train))
                lpd = float(jnp.mean(sweep_stats.lpd))
        stats.mse_train.append(mse_train)
        stats.lpd.append(lpd)
        if test_data is not None:
            if C == 1:
                mse_t = float(net.mse(test_data.X, test_data.y, carry.state))
            elif tempering:
                mse_t = float(
                    net.mse(
                        test_data.X, test_data.y,
                        jax.tree.map(lambda a: a[0], carry.state),
                    )
                )
            else:
                mse_t = float(
                    jnp.mean(
                        jax.vmap(lambda s: net.mse(test_data.X, test_data.y, s))(
                            carry.state
                        )
                    )
                )
            if stats.mse_test is None:
                stats.mse_test = []
            stats.mse_test.append(mse_t)

    def save_sample(carry, ix):
        if C == 1:
            net.save(os.path.join(cfg.models_path(), f"{ix}.npz"), carry.state)
        elif tempering:
            net.save(
                os.path.join(cfg.models_path(), f"{ix}.npz"),
                jax.tree.map(lambda a: a[0], carry.state),
            )
        else:
            for c in range(C):
                d = os.path.join(cfg.models_path(), f"chain{c}")
                os.makedirs(d, exist_ok=True)
                net.save(
                    os.path.join(d, f"{ix}.npz"),
                    jax.tree.map(lambda a: a[c], carry.state),
                )

    def emit_trace(carry):
        if trace_f is None:
            return
        st = carry.state if C == 1 else jax.tree.map(lambda a: a[0], carry.state)
        trace_f.write(json.dumps(_trace_line(net, st)) + "\n")

    if gd_sweep is not None and start_ix == 0:
        # MAP warm start: a few line-search GD sweeps before sampling
        # (the reference exposes GD only as a full alternative mode;
        # using it as initialization is an extension)
        if C == 1:
            gd_jit = jax.jit(gd_sweep)
        else:
            gd_jit = jax.jit(lambda c, X_, y_: over_chains(gd_sweep, c, X_, y_))
        for _ in range(cfg.gd_warmup):
            carry, _gd_stats = gd_jit(carry, X, y)
        carry = carry._replace(
            counts=jnp.zeros_like(carry.counts),
            da_t=jnp.zeros_like(carry.da_t),
        )
        log.info("gd warm start: %d sweeps", cfg.gd_warmup)

    if start_ix == 0:
        record(carry)
        emit_trace(carry)
        if cfg.burn_in == 0 and save_models:
            save_sample(carry, 0)

    # ---- batched sweeps: K iterations per compiled call, with per-sweep
    # states and on-device test mse collected through scan — avoids the
    # per-sweep host round trips that dominate wall clock for small models.
    # Trajectory recording keeps K=1 (per-step arrays are memory-heavy).
    state_bytes = sum(
        int(np.prod(l.shape)) * 4 for l in jax.tree.leaves(carry.state)
    )
    if cfg.trajectories:
        K_auto = 1
    elif cfg.sweeps_per_call > 0:
        K_auto = cfg.sweeps_per_call
    else:
        K_auto = max(1, min(16, int(2e9 / max(state_bytes, 1))))
        # large sweep programs: cap the unroll so compile time stays sane
        if state_bytes > 100_000:
            K_auto = min(K_auto, 4)

    has_test = test_data is not None
    if has_test:
        Xt, yt = test_data.X, test_data.y

    # NOTE: data must flow in as jit ARGUMENTS — closing over device arrays
    # bakes them into the executable as constants.
    def one_sweep(c, X_, y_, Xt_, yt_):
        pt = (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
        if C == 1:
            c2, st = sweep(c, X_, y_)
            mse_t = net.mse(Xt_, yt_, c2.state) if has_test else jnp.asarray(0.0)
        else:
            c2, st = over_chains(sweep, c, X_, y_)
            if tempering:
                # replica exchange between adjacent temperature slots,
                # alternating even/odd pairs by sweep parity
                parity = jnp.mod(c2.da_t[0], 2.0).astype(jnp.int32)
                c2, proposed, accepted = _pt_swap(c2, parity)
                pt = (
                    jnp.sum(proposed).astype(jnp.int32),
                    jnp.sum(accepted).astype(jnp.int32),
                )
                mse_t = (
                    net.mse(Xt_, yt_, jax.tree.map(lambda a: a[0], c2.state))
                    if has_test
                    else jnp.asarray(0.0)
                )
            else:
                mse_t = (
                    jnp.mean(over_chains(
                        lambda s, X_t, y_t: net.mse(X_t, y_t, s),
                        c2.state, Xt_, yt_,
                    ))
                    if has_test
                    else jnp.asarray(0.0)
                )
        return c2, st, mse_t, pt

    @functools.lru_cache(maxsize=None)
    def multi_sweep(K):
        def run(c, X_, y_, Xt_, yt_):
            def body(cc, _):
                c2, st, mse_t, pt = one_sweep(cc, X_, y_, Xt_, yt_)
                return c2, (st, mse_t, c2.state, pt)

            return jax.lax.scan(body, c, None, length=K)

        if has_test:
            return jax.jit(run)
        return jax.jit(
            lambda c, X_, y_: run(c, X_, y_, None, None)
        )

    def process_iteration(chain_ix, st_k, mse_t_k, state_k, pt_k=None):
        if tempering:
            mse_train = float(np.asarray(st_k.mse_train)[0])
            lpd = float(np.asarray(st_k.lpd)[0])
        else:
            mse_train = float(np.mean(np.asarray(st_k.mse_train)))
            lpd = float(np.mean(np.asarray(st_k.lpd)))
        if pt_k is not None:
            stats.pt_swaps_proposed += int(pt_k[0])
            stats.pt_swaps_accepted += int(pt_k[1])
        stats.mse_train.append(mse_train)
        stats.lpd.append(lpd)
        if has_test:
            if stats.mse_test is None:
                stats.mse_test = []
            stats.mse_test.append(float(mse_t_k))
        if traj_f is not None and getattr(st_k, "traj", ()) != ():
            tr = st_k.traj
            if C > 1:
                tr = jax.tree.map(lambda a: a[0], tr)
            _write_traj_lines(traj_f, net, tr)
        counts = np.asarray(st_k.counts)
        if C > 1:
            counts = counts.sum(axis=0)
        stats.update_counts(counts)
        if chain_ix >= cfg.burn_in and save_models:
            carry_like = TrainCarry(
                **{**{f: None for f in TrainCarry._fields}, "state": state_k}
            )
            save_sample(carry_like, chain_ix)
            if cfg.effect_sizes:
                sst = state_k if C == 1 else jax.tree.map(lambda a: a[0], state_k)
                _write_effect_sizes(net, X, chain_ix, cfg.effect_sizes_path(), sst)
        if trace_f is not None:
            sst = state_k if C == 1 else jax.tree.map(lambda a: a[0], state_k)
            trace_f.write(json.dumps(_trace_line(net, sst)) + "\n")
        if verbose and chain_ix % report_interval == 0:
            msg = (
                f"i: {chain_ix} \t | acc: {stats.acceptance_rate():.2f} \t | "
                f"early_rej: {stats.early_rejection_rate():.2f} \t | "
                f"end_rej: {stats.end_rejection_rate():.2f} \t | "
                f"mse(trn): {stats.mse_train[-1]:.4f}"
            )
            if stats.mse_test is not None:
                msg += f" \t | mse(tst): {stats.mse_test[-1]:.4f}"
            msg += f" | lpd: {stats.lpd[-1]:.4f}"
            if cfg.spike_slab:
                ni = np.asarray(st_k.n_incl)
                msg += f" | incl: {int(ni if ni.ndim == 0 else ni[0])}"
            if tempering and stats.pt_swaps_proposed:
                msg += f" | pt_swap: {stats.pt_swap_rate():.2f}"
            log.info(msg)

    t0 = time.time()
    chain_ix = start_ix
    # one compiled program per run: shrink K to a divisor of the remaining
    # iterations so the tail batch reuses the same executable (each distinct
    # K is a separate compile)
    remaining = cfg.chain_length - start_ix
    if remaining > 0 and remaining % K_auto != 0:
        K_auto = max(k for k in range(1, K_auto + 1) if remaining % k == 0)
    while chain_ix < cfg.chain_length:
        K = min(K_auto, cfg.chain_length - chain_ix)
        if has_test:
            carry, (st_all, mse_t_all, states_all, pt_all) = multi_sweep(K)(
                carry, X, y, Xt, yt
            )
        else:
            carry, (st_all, mse_t_all, states_all, pt_all) = multi_sweep(K)(
                carry, X, y
            )
        st_all, mse_t_all, states_all, pt_all = jax.device_get(
            (st_all, mse_t_all, states_all, pt_all)
        )
        for k in range(K):
            chain_ix += 1
            process_iteration(
                chain_ix,
                jax.tree.map(lambda a: a[k], st_all),
                mse_t_all[k],
                jax.tree.map(lambda a: a[k], states_all),
                (pt_all[0][k], pt_all[1][k]),
            )
        if checkpoint_interval > 0 and (
            chain_ix % checkpoint_interval < K or chain_ix >= cfg.chain_length
        ):
            save_checkpoint(
                os.path.join(cfg.outpath, "checkpoint.npz"), carry, chain_ix, stats
            )

    elapsed = time.time() - t0
    if verbose:
        lf = cfg.chain_length * cfg.hmc_integration_length * net.arch.num_branches * C
        log.info(
            "Completed training: %.2fs, %.0f leapfrog steps/s", elapsed, lf / elapsed
        )
    if trace_f is not None:
        trace_f.close()
    if traj_f is not None:
        traj_f.close()
    stats.to_file(cfg.outpath)

    if cfg.spike_slab or cfg.ss_markers or cfg.ss_rows:
        # posterior inclusion probabilities (post-burn-in mean of z) from
        # the cold / first chain
        first = lambda a: a if C == 1 else a[0]
        rec = {}
        if cfg.spike_slab:
            rec["pip"] = np.asarray(first(carry.ss_pip)).tolist()
            rec["pi"] = float(np.asarray(first(carry.ss_pi)))
        if cfg.ss_markers or cfg.ss_rows:
            # [G, m_pad] -> true markers only, per branch
            pm = np.asarray(first(carry.ssm_pip))
            rec["pip_markers"] = [
                pm[g, : net.arch.m[g]].tolist()
                for g in range(net.arch.num_branches)
            ]
            rec["pi_markers"] = float(np.asarray(first(carry.ssm_pi)))
        with open(os.path.join(cfg.outpath, "inclusion_probs"), "w") as f:
            json.dump(rec, f)

    net.state = carry.state if C == 1 else jax.tree.map(lambda a: a[0], carry.state)
    return net, stats
