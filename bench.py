"""Benchmark: throughput of the compiled Gibbs sweep on an NVIDIA GPU.

Workloads:
  1. Flagship dense sweep — 64 branches x 64 markers, n=4096, one hidden
     layer of 32, block-parallel update mode, 4 vectorized chains (the
     multi-branch + multi-chain configuration the rs-bann reference cannot
     express: it runs one chain, one branch at a time, host-driven).
     Feature-major (FeatX) layout, X stored in bf16.
  2. Packed genome-scale sweep — 10k SNPs in 100 groups, n=100,000, the
     docs/GENOME_SCALE.md production recipe shape (ridge_ard + identity +
     hybrid + 2-bit packed genotypes decoded inside the Triton kernels).

Headline metric: leapfrog steps/s/card, one step = one per-branch leapfrog
integration step (forward+backward pass + momentum update) = chains x
branches x integration_length x sweeps.

Every timed section ends in jax.block_until_ready, repeats REPEATS times and
reports the median with min/max spread.

FLOP accounting: true matmul FLOPs per leapfrog step from the layer dims
(fwd 2*n*in*out per layer; backward = dW for every layer + the dX chain for
all layers but the input), divided by the card's f32 peak (the sweep's f32
dots run at Precision.HIGHEST) from PEAKS, keyed by device_kind.

ESS: per-parameter effective samples/s over a kept-sample window — one
output weight per branch per chain plus the error precision — reported as
the median and min across parameters, next to the mse-statistic ESS.

vs_baseline: the reference publishes no numbers (BASELINE.md), so we
self-baseline against the reference's algorithm compiled as well as
possible on the same card: one chain, branches updated one at a time in a
sequential scan (net.rs:258-334 semantics, fully jitted — generous to the
reference, whose ArrayFire loop additionally pays per-op dispatch).

Run: python bench.py (one GPU). Prints ONE json line on stdout; diagnostics
go to stderr.
"""

import json
import sys
import time

import numpy as np

REPEATS = 3

# Published dense peaks per card (NVIDIA H100 SXM data sheet, 700 W):
# TFLOP/s by operand type and device-memory TB/s. A device missing here is
# an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
        "hbm_tbps": 3.35,
    },
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def leapfrog_flops(n, widths):
    """True matmul FLOPs of ONE leapfrog step (value_and_grad of the
    potential) for one branch: fwd = sum_l 2*n*in_l*out_l; backward = dW for
    every layer (same cost as fwd) + the dX chain for every layer except
    the input one."""
    dims = list(widths)
    f_fwd = sum(2 * n * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    f_dx0 = 2 * n * dims[0] * dims[1]
    return 3 * f_fwd - f_dx0


def _timed(fn, reps=REPEATS):
    """Median + spread of reps timings of fn() (each fn() must end in
    jax.block_until_ready)."""
    ts = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        ts.append(time.time() - t0)
    return float(np.median(ts)), float(min(ts)), float(max(ts))


def main():
    import jax
    import jax.numpy as jnp

    from rs_bann_tpu.models import density as D
    from rs_bann_tpu.models.arch import NetArch
    from rs_bann_tpu.models.init import InitCfg, init_net
    from rs_bann_tpu.models.net import Net
    from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
    from rs_bann_tpu.train import over_chains
    from rs_bann_tpu.utils.compile_cache import setup_compile_cache
    from rs_bann_tpu.vis import ess

    from chip_smoke import card, require_gpu

    setup_compile_cache()
    dev = require_gpu()[0]
    kind = dev.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add them to PEAKS")
    peak_f32, peak_bf16 = PEAKS[kind]["f32_tflops"], PEAKS[kind]["bf16_tflops"]
    card_name = card()
    log(f"device: {kind} [{card_name}] (f32 peak {peak_f32} TF/s)")

    G, m, n, h, depth, C, L = 64, 64, 4096, 32, 1, 4, 64
    sweeps = 10

    arch = NetArch.uniform(G, m, h, depth, h)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=0))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)

    rng = np.random.default_rng(0)
    # feature-major [G, m_pad, n] (models/density.FeatX), stored bf16: half
    # the bytes of the dominant layer-0 reads; dots accumulate in f32
    Xf = np.zeros((G, arch.m_pad, n), np.float32)
    Xf[:, :m, :] = rng.standard_normal((G, m, n), dtype=np.float32)
    X = D.FeatX(jnp.asarray(Xf, dtype=jnp.bfloat16))
    y = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    cfg = MCMCCfg(
        chain_length=1,
        burn_in=10**9,
        hmc_integration_length=L,
        hmc_step_size_mode="izmailov",
        update_mode="parallel",
        num_chains=C,
        seed=0,
    )
    sweep1 = net.make_sweep(cfg)
    sweep = jax.jit(lambda c, X_, y_: over_chains(sweep1, c, X_, y_))
    keys = jax.random.split(jax.random.key(0), C)
    carry = jax.jit(
        lambda s, X_, y_, ks: jax.vmap(
            lambda k: net.init_carry(X_, y_, k, state=s)
        )(ks)
    )(net.state, X, y, keys)
    jax.block_until_ready(carry)

    log(f"sweep: G={G} m={m} n={n} h={h} d={depth} C={C} L={L} "
        f"[feature-major, bf16 X]")
    t0 = time.time()
    carry, stats = sweep(carry, X, y)
    jax.block_until_ready(stats)
    compile_s = time.time() - t0
    log(f"compile+first sweep: {compile_s:.1f}s")

    state_box = {"carry": carry, "stats": stats}

    def run_sweeps():
        c = state_box["carry"]
        for _ in range(sweeps):
            c, s = sweep(c, X, y)
        jax.block_until_ready(s)
        state_box["carry"], state_box["stats"] = c, s

    dt_med, dt_min, dt_max = _timed(run_sweeps)
    carry, stats = state_box["carry"], state_box["stats"]
    steps = sweeps * C * G * L
    steps_per_s = steps / dt_med
    acc = np.asarray(stats.counts)[:, 0].sum() / (
        (1 + REPEATS * sweeps) * C * G
    )
    log(
        f"{sweeps} sweeps x {REPEATS}: median {dt_med:.3f}s "
        f"[{dt_min:.3f}, {dt_max:.3f}] -> {steps_per_s:,.0f} leapfrog "
        f"steps/s/card (mse={np.asarray(stats.mse_train).mean():.3f}, "
        f"acc={acc:.2f})"
    )

    # ---- achieved FLOP/s vs the card's f32 peak
    widths = [m, h, h, 1]  # m -> hidden -> summary -> output
    f_true = leapfrog_flops(n, widths)
    tflops_true = steps_per_s * f_true / 1e12
    mfu = tflops_true / peak_f32
    log(
        f"model FLOPs/leapfrog-step: {f_true/1e6:.1f} MF; achieved "
        f"{tflops_true:.2f} TF/s = {100*mfu:.1f}% of the {kind} f32 peak"
    )

    # ---- effective samples per second, per PARAMETER (north-star #2):
    # one output weight per (chain, branch) + the shared error precision.
    # Measured under TWO step-size regimes: the izmailov heuristic (the
    # r01/r02-comparable series; acc ~0.3 under the exact live-accept
    # sampler — r2's 0.83 was the biased frozen-residual accept) and
    # dual-averaging-tuned (48 adaptation sweeps targeting 0.65, then a
    # frozen-step window). Sweep cost is identical between modes.
    ess_sweeps = 64

    def measure_ess(sweep_fn, carry0, label):
        c = carry0
        w_series, lam_series, mse_series = [], [], []
        t0 = time.time()
        for _ in range(ess_sweeps):
            c, stats = sweep_fn(c, X, y)
            w_series.append(c.state.params.weights[-1][:, :, 0, 0])  # [C, G]
            lam_series.append(c.state.precisions.error)  # [C]
            mse_series.append(stats.mse_train)
        jax.block_until_ready(stats)
        ess_dt = time.time() - t0
        w_series = np.asarray(jax.device_get(w_series))  # [S, C, G]
        lam_series = np.asarray(jax.device_get(lam_series))  # [S, C]
        mse_series = np.asarray(jax.device_get(mse_series))  # [S, C]
        per_param = []
        for g in range(G):
            per_param.append(sum(ess(w_series[:, c_, g]) for c_ in range(C)))
        per_param.append(sum(ess(lam_series[:, c_]) for c_ in range(C)))
        per_param = np.asarray(per_param)
        out = {
            "per_param_median": round(float(np.median(per_param)) / ess_dt, 1),
            "per_param_min": round(float(per_param.min()) / ess_dt, 1),
            "mse_stat": round(
                sum(ess(mse_series[:, c_]) for c_ in range(C)) / ess_dt, 1
            ),
        }
        log(
            f"ESS/s over {ess_sweeps} sweeps x {C} chains ({label}): "
            f"per-parameter median {out['per_param_median']}, min "
            f"{out['per_param_min']}; mse-statistic {out['mse_stat']}"
        )
        return out, c

    ess_iz, carry = measure_ess(sweep, carry, "izmailov step sizes")

    da_cfg = MCMCCfg(
        chain_length=1,
        burn_in=48,
        hmc_integration_length=L,
        hmc_step_size_mode="dual_averaging",
        target_accept=0.65,  # HMC-optimal; the cfg default (0.8) measured
        # per-param ESS/s 6.6 vs izmailov's 21 on this shape
        update_mode="parallel",
        num_chains=C,
        seed=0,
    )
    da_sweep1 = net.make_sweep(da_cfg)
    da_sweep = jax.jit(lambda c, X_, y_: over_chains(da_sweep1, c, X_, y_))
    da_carry = jax.jit(
        lambda s, X_, y_, ks: jax.vmap(
            lambda k: net.init_carry(X_, y_, k, state=s)
        )(ks)
    )(net.state, X, y, keys)
    for _ in range(48):  # adaptation window (da_t counts up to burn_in)
        da_carry, da_stats = da_sweep(da_carry, X, y)
    jax.block_until_ready(da_stats)
    acc0 = np.asarray(da_stats.counts)[:, 0].sum()
    ess_da, da_carry = measure_ess(
        da_sweep, da_carry, "dual-averaging-tuned, frozen"
    )
    ess_da["acceptance"] = round(
        float(
            (np.asarray(
                jax.device_get(
                    da_sweep(da_carry, X, y)[1].counts
                )
            )[:, 0].sum() - acc0)
            / ((ess_sweeps + 1) * C * G)
        ),
        2,
    )

    # ---- self-baseline: the reference's algorithm (sequential random-scan
    # Gibbs, one chain), fully compiled on the same card
    base_cfg = MCMCCfg(
        chain_length=1,
        burn_in=10**9,
        hmc_integration_length=L,
        hmc_step_size_mode="izmailov",
        update_mode="sequential",
        num_chains=1,
        seed=0,
    )
    base_sweep = jax.jit(net.make_sweep(base_cfg))
    base_carry = jax.jit(
        lambda s, X_, y_, k: net.init_carry(X_, y_, k, state=s)
    )(net.state, X, y, jax.random.key(2))
    t0 = time.time()
    base_carry, base_stats = base_sweep(base_carry, X, y)
    jax.block_until_ready(base_stats)
    log(f"baseline compile+first sweep: {time.time() - t0:.1f}s")
    base_sweeps = 3
    base_box = {"c": base_carry}

    def run_base():
        c = base_box["c"]
        for _ in range(base_sweeps):
            c, s = base_sweep(c, X, y)
        jax.block_until_ready(s)
        base_box["c"] = c

    b_med, b_min, b_max = _timed(run_base)
    base_steps_per_s = base_sweeps * G * L / b_med
    log(
        f"sequential single-chain baseline (reference algorithm, compiled): "
        f"{base_steps_per_s:,.0f} steps/s (median of {REPEATS}x{base_sweeps} "
        f"sweeps, [{b_min:.2f}, {b_max:.2f}]s)"
    )

    # ---- baseline ESS/s (VERDICT r3 #2): effective samples/s of the
    # reference algorithm on the same card, so the headline speedup can be
    # stated in effective samples, not just raw leapfrog steps. Same
    # per-parameter series as measure_ess, one chain.
    def measure_base_ess(sweep_fn, carry0, label):
        c = carry0
        w_series, lam_series, mse_series = [], [], []
        t0 = time.time()
        for _ in range(ess_sweeps):
            c, st = sweep_fn(c, X, y)
            w_series.append(c.state.params.weights[-1][:, 0, 0])  # [G]
            lam_series.append(c.state.precisions.error)
            mse_series.append(st.mse_train)
        jax.block_until_ready(st)
        dt = time.time() - t0
        w_series = np.asarray(jax.device_get(w_series))  # [S, G]
        lam_series = np.asarray(jax.device_get(lam_series))  # [S]
        mse_series = np.asarray(jax.device_get(mse_series))  # [S]
        per_param = np.asarray(
            [ess(w_series[:, g]) for g in range(G)] + [ess(lam_series)]
        )
        out = {
            "per_param_median": round(float(np.median(per_param)) / dt, 1),
            "per_param_min": round(float(per_param.min()) / dt, 1),
            "mse_stat": round(ess(mse_series) / dt, 1),
        }
        log(
            f"baseline ESS/s over {ess_sweeps} sweeps ({label}): per-param "
            f"median {out['per_param_median']}, min {out['per_param_min']}; "
            f"mse-statistic {out['mse_stat']}"
        )
        return out, c

    base_ess_iz, base_carry = measure_base_ess(
        base_sweep, base_carry, "izmailov"
    )
    import dataclasses as _dc

    base_da_cfg = _dc.replace(
        base_cfg, burn_in=48, hmc_step_size_mode="dual_averaging",
        target_accept=0.65,
    )
    base_da_sweep = jax.jit(net.make_sweep(base_da_cfg))
    base_da_carry = jax.jit(
        lambda s, X_, y_, k: net.init_carry(X_, y_, k, state=s)
    )(net.state, X, y, jax.random.key(2))
    for _ in range(48):
        base_da_carry, bst = base_da_sweep(base_da_carry, X, y)
    jax.block_until_ready(bst)
    base_ess_da, _ = measure_base_ess(
        base_da_sweep, base_da_carry, "dual-averaging-tuned, frozen"
    )

    # ---- packed genome-scale entry (docs/GENOME_SCALE.md shape)
    from rs_bann_tpu.io.bed import BedVM
    from rs_bann_tpu.group.grouping import UniformGrouping
    from rs_bann_tpu.models.data import pack_stacked

    pG, pm_, pn, pL = 100, 100, 100_000, 30
    log(f"packed genome-scale: G={pG} m={pm_} n={pn} ridge_ard identity hybrid L={pL}")
    bed = BedVM.random(pn, pG * pm_, seed=1)
    grouping = UniformGrouping(pG, pm_)
    parch = NetArch.from_width_rules(
        [pm_] * pG, 0, ("fixed", 10), ("like_hidden",), activation="identity"
    )
    pstate, _ = init_net(parch, "ridge_ard", InitCfg(seed=0))
    pnet = Net("ridge_ard", parch, D.Hyperparameters(), pstate)
    pdata = pack_stacked(parch, bed, grouping, rng.standard_normal(pn).astype(np.float32))
    x_gb = sum(a.nbytes for a in jax.tree.leaves(pdata.X)) / 1e9
    pcfg = MCMCCfg(
        chain_length=1, burn_in=10**9, hmc_integration_length=pL,
        hmc_step_size_mode="dual_averaging", update_mode="hybrid",
        mass_adaptation=True, seed=0,
    )
    psweep = jax.jit(pnet.make_sweep(pcfg))
    pcarry = jax.jit(
        lambda s, X_, y_, k: pnet.init_carry(X_, y_, k, mass_adaptation=True,
                                             state=s)
    )(pnet.state, pdata.X, pdata.y, jax.random.key(0))
    t0 = time.time()
    pcarry, pstats = psweep(pcarry, pdata.X, pdata.y)
    jax.block_until_ready(pstats)
    p_compile = time.time() - t0
    log(f"packed compile+first sweep: {p_compile:.1f}s (X: {x_gb:.2f} GB)")
    p_sweeps = 3
    p_box = {"c": pcarry}

    def run_packed():
        c = p_box["c"]
        for _ in range(p_sweeps):
            c, s = psweep(c, pdata.X, pdata.y)
        jax.block_until_ready(s)
        p_box["c"] = c

    p_med, p_min, p_max = _timed(run_packed)
    p_steps_per_s = p_sweeps * pG * pL / p_med
    log(
        f"packed: {p_steps_per_s:,.0f} leapfrog steps/s "
        f"({p_med/p_sweeps*1e3:.0f} ms/sweep median, "
        f"[{p_min/p_sweeps*1e3:.0f}, {p_max/p_sweeps*1e3:.0f}])"
    )

    print(
        json.dumps(
            {
                "metric": "hmc_leapfrog_steps_per_s_per_card",
                "value": round(steps_per_s, 1),
                "unit": "leapfrog steps/s (fwd+bwd per branch) on G=64,m=64,n=4096,h=32,d=1,C=4 [feature-major]",
                "device": {"platform": dev.platform, "kind": kind,
                           "count": len(jax.devices())},
                "card": card_name,
                "vs_baseline": round(steps_per_s / base_steps_per_s, 2),
                "repeats": REPEATS,
                "spread_s": [round(dt_min, 3), round(dt_med, 3), round(dt_max, 3)],
                "compile_s": round(compile_s, 1),
                "tflops_true": round(tflops_true, 2),
                # layer 0 runs in bf16 (bf16 X), deeper layers in f32
                "mfu_vs_f32_peak": round(mfu, 4),
                "mfu_vs_bf16_peak": round(tflops_true / peak_bf16, 4),
                "ess_per_s": ess_iz,
                "ess_per_s_tuned": ess_da,
                "baseline_ess_per_s": base_ess_iz,
                "baseline_ess_per_s_tuned": base_ess_da,
                # the headline effective-sample speedup: flagship ESS/s over
                # the compiled reference algorithm's ESS/s, per step-size
                # regime
                "vs_baseline_ess": round(
                    ess_iz["per_param_median"]
                    / max(base_ess_iz["per_param_median"], 1e-9), 2
                ),
                "vs_baseline_ess_tuned": round(
                    ess_da["per_param_median"]
                    / max(base_ess_da["per_param_median"], 1e-9), 2
                ),
                "packed": {
                    "shape": f"G={pG},m={pm_},n={pn},ridge_ard,identity,hybrid,L={pL}",
                    "leapfrog_steps_per_s": round(p_steps_per_s, 1),
                    "ms_per_sweep": round(p_med / p_sweeps * 1e3, 1),
                    "ms_per_sweep_spread": [
                        round(p_min / p_sweeps * 1e3, 1),
                        round(p_max / p_sweeps * 1e3, 1),
                    ],
                    "compile_s": round(p_compile, 1),
                    "x_gb": round(x_gb, 2),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
