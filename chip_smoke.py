"""Smoke test of the Gibbs sweep on an NVIDIA GPU, through the entry points a
user calls.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # only the sharded sweep on a 4-card mesh,
                                  # compared with the same keys on one card

Phases (one process, in order; any failure ends the run with a non-zero
exit):

  1. device check: JAX must run on a GPU (no CPU fallback);
  2. the dense flagship through the CLI (simulate-xy -> train-new ->
     predict): 64 branches x 64 markers, n=4096, ridge_base tanh, depth 1,
     h=32, feature-major, parallel, 4 chains, integration length 64;
  3. the genome-scale production recipe (docs/GENOME_SCALE.md) through the
     CLI: 10k SNPs in 100 groups, n=100,000, ridge_ard identity depth 0,
     2-bit packed, hybrid, dual averaging, mass adaptation, per-marker
     spike-and-slab, integration length 30;
  4. kernel parity: the Triton kernels as compiled for the card against the
     plain reference at Precision.HIGHEST, at n=100,000 and n=460,800;
  5. timings: ms/sweep of both cells, and each kernel against the plain
     version XLA compiles, each line naming the card and its power limit.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from rs_bann_tpu.utils.compile_cache import setup_compile_cache

# parity bound: f32 accumulation, relative to the max-abs reference output
RTOL = 1e-5
# sharded vs single-card sweep: per-device partial sums change the order
SHARD_RTOL, SHARD_ATOL = 2e-4, 2e-5
# the two cells at full width (tests pass smaller shapes)
FLAGSHIP = dict(G=64, m=64, n=4096, h=32, C=4, L=64)
GENOME = dict(G=100, m=100, n=100_000, k=10, L=30)


def card() -> str:
    """`name, power.limit` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def require_gpu(count: int = 1):
    """JAX's devices; raises unless there are `count` NVIDIA GPUs."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX found {devices[0].platform}"
        )
    if len(devices) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devices)}")
    return devices


def check(ok: bool, *what):
    """A failed check ends the run (unlike assert, also under -O)."""
    if not ok:
        raise AssertionError(what)


def cli(*argv) -> list[str]:
    """Run rs_bann_tpu.cli.main in process; its stdout lines."""
    from rs_bann_tpu.cli.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main([str(a) for a in argv])
    return out.getvalue().strip().splitlines()


def check_run(run: Path, models: Path, sim: Path, packed: bool, tag: str):
    """Finite mse, acceptance in (0, 1], predictions written and finite."""
    st = json.loads((run / "training_stats").read_text())
    acc = st["num_accepted"] / max(st["num_samples"], 1)
    mse, mse_t = st["mse_train"][-1], st["mse_test"][-1]
    check(np.isfinite(mse) and np.isfinite(mse_t), tag, mse, mse_t)
    check(0.0 < acc <= 1.0, tag, acc)
    extra = ["--packed-genotypes"] if packed else []
    rows = cli("predict", sim / "test", sim / "train.groups", "-m", models,
               *extra)
    pred_file = run / "predictions.csv"
    pred_file.write_text("\n".join(rows) + "\n")
    preds = np.loadtxt(pred_file, delimiter=",", ndmin=2)
    n_models = len(list(models.glob("*.npz")))
    check(preds.shape[0] == n_models > 0, tag, preds.shape, n_models)
    check(np.all(np.isfinite(preds)), tag)
    print(f"{tag}: mse(train) {mse:.4f}, mse(test) {mse_t:.4f}, "
          f"acceptance {acc:.3f}, {preds.shape[0]} x {preds.shape[1]} "
          f"predictions in {pred_file.name}", flush=True)


def phase_cli_flagship(work: Path, s=FLAGSHIP):
    t0 = time.perf_counter()
    sim = Path(cli("simulate-xy", "ridge_base", "tanh", s["m"], s["G"], s["n"],
                   s["h"], 1, 0.6, "--seed", 1, "-o", work / "flagship")[-1])
    run = Path(cli(
        "train-new", sim / "train", sim / "train.phen", sim / "train.groups",
        "ridge_base", "tanh", 1, 4, s["L"],
        "--fixed-hidden-layer-width", s["h"],
        "--fixed-summary-layer-width", s["h"],
        "--feat-major", "--update-mode", "parallel", "--num-chains", s["C"],
        "--burn-in", 1, "--seed", 0,
        "--bfile-test", sim / "test", "--p-test", sim / "test.phen",
        "-o", work / "flagship_run",
    )[-1])
    check_run(run, run / "models" / "chain0", sim, False,
              "dense flagship via CLI")
    print(f"dense flagship via CLI: {time.perf_counter() - t0:.1f} s "
          "wall (simulate + compile + 4 sweeps + predict)", flush=True)


def phase_cli_genome(work: Path, s=GENOME):
    t0 = time.perf_counter()
    sim = Path(cli("simulate-xy", "linear", "identity", s["m"], s["G"],
                   s["n"], s["k"], 0, 0.6,
                   "--num-effective", s["G"] * s["m"] // 20, "--seed", 2,
                   "-o", work / "genome")[-1])
    run = Path(cli(
        "train-new", sim / "train", sim / "train.phen", sim / "train.groups",
        "ridge_ard", "identity", 0, 4, s["L"],
        "--fixed-summary-layer-width", s["k"],
        "--step-size-mode", "dual_averaging", "--update-mode", "hybrid",
        "--mass-adaptation", "--ss-markers", "--ssm-fixed-pi",
        "--ssm-pi", 0.1, "--ssm-warmup", 1, "--packed-genotypes",
        "--burn-in", 2, "--seed", 0,
        "--bfile-test", sim / "test", "--p-test", sim / "test.phen",
        "-o", work / "genome_run",
    )[-1])
    check_run(run, run / "models", sim, True, "genome recipe via CLI")
    print(f"genome recipe via CLI: {time.perf_counter() - t0:.1f} s wall "
          "(simulate + compile + 4 sweeps + predict)", flush=True)


def _rel(out, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))


def phase_kernel_parity():
    """Each kernel at the packed cell's padded widths (m_pad=104, k=16)."""
    from rs_bann_tpu.ops import packed_matmul as P

    rng = np.random.default_rng(0)
    m, k = 104, 16
    for n in (100_000, 460_800):
        by = jnp.asarray(P.pack_strided(rng.integers(0, 3, size=(m, n))))
        a = jnp.asarray(rng.normal(0, 0.1, (m, k)).astype(np.float32))
        off = jnp.asarray(rng.normal(0, 0.1, k).astype(np.float32))
        g = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
        for act in P.FUSED_ACTIVATIONS:
            out = jax.jit(lambda *x: P._linear_fwd_kernel(*x, n, act))(
                by, a, off)
            ref = jax.jit(lambda *x: P._linear_ref(*x, n, act))(by, a, off)
            da, doff = jax.jit(lambda *x: P._linear_bwd_kernel(*x, n, act))(
                by, g, ref)
            rda, rdoff = jax.jit(lambda *x: P._linear_bwd_ref(*x, n, act))(
                by, g, ref)
            errs = (_rel(out, ref), _rel(da, rda), _rel(doff, rdoff))
            print(f"kernel parity n={n} m={m} k={k} {act}: fwd {errs[0]:.2e} "
                  f"bwd {errs[1]:.2e} d_off {errs[2]:.2e} "
                  f"(bound {RTOL:.0e} of max-abs, reference at HIGHEST)",
                  flush=True)
            check(max(errs) < RTOL, n, act, errs)


def _ms(fn, *args, reps=10) -> float:
    """Median wall ms of fn(*args) to block_until_ready (after warm-up)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


@contextlib.contextmanager
def plain_xla():
    """Trace packed_linear with XLA's plain version instead of the kernels
    (for the comparison only; functions traced inside keep it)."""
    from rs_bann_tpu.ops import packed_matmul as P

    saved = P._on_cuda
    P._on_cuda = lambda kernel_fn, ref_fn, *args: ref_fn(*args)
    try:
        yield
    finally:
        P._on_cuda = saved


def flagship_cell(s=FLAGSHIP, seed=0):
    """The dense flagship: (net, cfg, X, y)."""
    from rs_bann_tpu.models import density as D
    from rs_bann_tpu.models.arch import NetArch
    from rs_bann_tpu.models.init import InitCfg, init_net
    from rs_bann_tpu.models.net import Net
    from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg

    G, m, n, h = s["G"], s["m"], s["n"], s["h"]
    arch = NetArch.uniform(G, m, h, 1, h)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=seed))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(seed)
    Xf = np.zeros((G, arch.m_pad, n), np.float32)
    Xf[:, :m] = rng.standard_normal((G, m, n), dtype=np.float32)
    cfg = MCMCCfg(chain_length=1, burn_in=10**9,
                  hmc_integration_length=s["L"], update_mode="parallel",
                  num_chains=s["C"], seed=seed)
    y = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    return net, cfg, D.FeatX(jnp.asarray(Xf)), y


def genome_cell(s=GENOME, seed=0):
    """The packed genome-scale recipe, one chain: (net, cfg, X, y)."""
    from rs_bann_tpu.group.grouping import UniformGrouping
    from rs_bann_tpu.io.bed import BedVM
    from rs_bann_tpu.models import density as D
    from rs_bann_tpu.models.arch import NetArch
    from rs_bann_tpu.models.data import pack_stacked
    from rs_bann_tpu.models.init import InitCfg, init_net
    from rs_bann_tpu.models.net import Net
    from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg

    G, m, n = s["G"], s["m"], s["n"]
    arch = NetArch.from_width_rules([m] * G, 0, ("fixed", s["k"]),
                                    ("like_hidden",), activation="identity")
    state, _ = init_net(arch, "ridge_ard", InitCfg(seed=seed))
    net = Net("ridge_ard", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(seed)
    data = pack_stacked(arch, BedVM.random(n, G * m, seed=seed + 1),
                        UniformGrouping(G, m),
                        rng.standard_normal(n).astype(np.float32))
    cfg = MCMCCfg(chain_length=1, burn_in=10**9,
                  hmc_integration_length=s["L"],
                  hmc_step_size_mode="dual_averaging", update_mode="hybrid",
                  mass_adaptation=True, ss_markers=True, ssm_pi=0.1,
                  seed=seed)
    return net, cfg, data.X, data.y


def _init(net, cfg, X, y, C):
    kw = dict(mass_adaptation=cfg.mass_adaptation,
              ss_markers=cfg.ss_markers, ssm_pi=cfg.ssm_pi)
    init = lambda k: net.init_carry(X, y, k, state=net.state, **kw)
    if C == 1:
        return jax.jit(init)(jax.random.key(cfg.seed))
    keys = jax.random.split(jax.random.key(cfg.seed), C)
    return jax.jit(jax.vmap(init))(keys)


def ms_per_sweep(net, cfg, X, y, sweeps=5) -> float:
    """Median ms of one compiled sweep, chains vmapped as train.py runs
    them."""
    from rs_bann_tpu.train import over_chains

    sweep = net.make_sweep(cfg)
    C = cfg.num_chains
    run = jax.jit(sweep if C == 1 else
                  (lambda c, X_, y_: over_chains(sweep, c, X_, y_)))
    box = {"c": _init(net, cfg, X, y, C)}

    def step(X_, y_):
        box["c"], stats = run(box["c"], X_, y_)
        return stats

    return _ms(step, X, y, reps=sweeps)


def phase_timings(card_name: str):
    from rs_bann_tpu.ops import packed_matmul as P

    tag = f"[{card_name}]"
    net, cfg, X, y = flagship_cell()
    print(f"timing {tag} dense flagship G=64 m=64 n=4096 h=32 C=4 L=64: "
          f"{ms_per_sweep(net, cfg, X, y):.1f} ms/sweep", flush=True)
    net, cfg, X, y = genome_cell()
    kern = ms_per_sweep(net, cfg, X, y)
    with plain_xla():
        plain = ms_per_sweep(net, cfg, X, y)
    print(f"timing {tag} genome recipe G=100 m=100 n=100000 k=10 L=30: "
          f"{kern:.1f} ms/sweep with the Triton kernels, {plain:.1f} "
          "ms/sweep with XLA's plain version", flush=True)

    rng = np.random.default_rng(1)
    B, m, k = 10, 104, 16  # one hybrid block of branches, padded widths
    for n in (100_000, 460_800):
        by = jnp.asarray(np.stack(
            [P.pack_strided(rng.integers(0, 3, size=(m, n)))] * B))
        a = jnp.asarray(rng.normal(0, 0.1, (B, m, k)).astype(np.float32))
        off = jnp.zeros((B, k), jnp.float32)
        g = jnp.asarray(rng.standard_normal((B, n, k)).astype(np.float32))
        pairs = {
            "forward": ((lambda b, a_, o: P._linear_fwd_kernel(b, a_, o, n,
                                                               "identity")),
                        (lambda b, a_, o: P._linear_ref(b, a_, o, n,
                                                        "identity")),
                        (by, a, off)),
            "backward": ((lambda b, g_, r: P._linear_bwd_kernel(b, g_, r, n,
                                                                "identity")),
                         (lambda b, g_, r: P._linear_bwd_ref(b, g_, r, n,
                                                             "identity")),
                         (by, g, g)),
        }
        for name, (kf, rf, args) in pairs.items():
            tk = _ms(jax.jit(jax.vmap(kf)), *args)
            tr = _ms(jax.jit(jax.vmap(rf)), *args)
            print(f"timing {tag} packed {name} B={B} m={m} k={k} n={n}: "
                  f"kernel {tk:.3f} ms, XLA plain {tr:.3f} ms", flush=True)


def _assert_same_sweep(ref, out):
    np.testing.assert_allclose(np.asarray(ref.residual),
                               np.asarray(out.residual),
                               rtol=SHARD_RTOL, atol=SHARD_ATOL)
    for a, b in zip(jax.tree.leaves(ref.state.params),
                    jax.tree.leaves(out.state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=SHARD_RTOL, atol=SHARD_ATOL)


def phase_four(card_name: str, flagship=FLAGSHIP, genome=GENOME):
    """Both cells on a 4-device mesh against the same keys on one device."""
    from rs_bann_tpu.parallel.sharding import make_mesh, make_sharded_sweep
    from rs_bann_tpu.train import over_chains

    cells = [
        ("dense flagship, mesh chain=2 x branch=2", flagship_cell(flagship),
         (2, 2, 1), {"feat_major": True}),
        ("genome recipe, mesh branch=4", genome_cell(genome), (1, 4, 1),
         {"packed_n": genome["n"]}),
    ]
    for name, (net, cfg, X, y), shape, kw in cells:
        C = cfg.num_chains
        sweep = net.make_sweep(cfg)
        single = jax.jit(sweep if C == 1 else
                         (lambda c, X_, y_: over_chains(sweep, c, X_, y_)))
        ref, _ = single(_init(net, cfg, X, y, C), X, y)
        ssweep, place_carry, place_data = make_sharded_sweep(
            net, cfg, make_mesh(*shape), **kw)
        Xs, ys = place_data(X, y)
        t0 = time.perf_counter()
        out, stats = ssweep(place_carry(_init(net, cfg, X, y, C)), Xs, ys)
        jax.block_until_ready(out)
        first = time.perf_counter() - t0
        _assert_same_sweep(ref, out)
        box = {"c": out}

        def step(X_, y_):
            box["c"], st = ssweep(box["c"], X_, y_)
            return st

        print(f"four devices [{card_name}] {name}: sharded == single device "
              f"(rtol {SHARD_RTOL:g}, atol {SHARD_ATOL:g}); first sweep "
              f"{first:.1f} s, then {_ms(step, Xs, ys, reps=5):.1f} ms/sweep",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded sweep on a 4-card mesh")
    args = ap.parse_args(argv)

    setup_compile_cache()
    devices = require_gpu(4 if args.four else 1)
    card_name = card()
    print(card_name, flush=True)
    if args.four:
        phase_four(card_name)
    else:
        with tempfile.TemporaryDirectory() as work:
            phase_cli_flagship(Path(work))
            phase_cli_genome(Path(work))
        phase_kernel_parity()
        phase_timings(card_name)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    sys.exit(main())
