"""Self-baselining: run the reference's canonical sim_train_pred workloads
and record accuracy + throughput (BASELINE.md: the reference publishes no
numbers, so these runs ARE the comparison target for future rounds).

Writes BASELINE_SELF.json at the repo root:
  per (h2, chain_length): test r² of the posterior-mean prediction, the
  Daetwyler expected-r² ceiling, acceptance rates, wall-clock, leapfrog
  steps/s.

Usage: python scripts/self_baseline.py [--quick] [--out PATH]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="h2=0.8 only")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parent.parent / "BASELINE_SELF.json"))
    ap.add_argument("--step-size-mode", default="izmailov")
    ap.add_argument("--update-mode", default="sequential")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rs_bann_tpu.models import density as D
    from rs_bann_tpu.models.arch import NetArch
    from rs_bann_tpu.models.init import InitCfg, init_net
    from rs_bann_tpu.models.net import Net
    from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
    from rs_bann_tpu.sim import simulate_xy
    from rs_bann_tpu.train import train
    from rs_bann_tpu.vis import expected_r2, posterior_predictions
    import tempfile

    h2s = [0.8] if args.quick else [0.25, 0.5, 0.8, 0.95]
    # canonical chain lengths (sim_train_pred.sh) under the reference's
    # izmailov scheme, plus this framework's adaptive configuration
    configs = [("izmailov", 10), ("izmailov", 100), ("dual_averaging", 1000)]
    if args.quick:
        configs = configs[:2]
    m, b, n, w, d, il = 20, 1, 1000, 10, 0, 300

    results = {
        "workload": "sim_train_pred.sh: lasso-base b=1 m=20 n=1000 w=10 d=0 il=300 gamma(3,1)",
        "backend": jax.default_backend(),
        "update_mode": args.update_mode,
        "runs": [],
    }

    for h2 in h2s:
        with tempfile.TemporaryDirectory() as td:
            sim = simulate_xy(
                td, "lasso_base", "tanh", m, b, n, w, d, heritability=h2,
                init_gamma_shape=3.0, init_gamma_scale=1.0, seed=11,
            )
            dtr = sim.gen_train.to_stacked(sim.arch, sim.y_train)
            dte = sim.gen_test.to_stacked(sim.arch, sim.y_test)
            for mode, cl in configs:
                arch = NetArch.from_width_rules(
                    sim.gen_train.num_markers_per_group(), d,
                    ("fixed", w), ("like_hidden",),
                )
                state, _ = init_net(arch, "lasso_base", InitCfg(seed=1))
                net = Net("lasso_base", arch, D.Hyperparameters(), state)
                cfg = MCMCCfg(
                    chain_length=cl, burn_in=cl // 2,
                    hmc_integration_length=il,
                    hmc_step_size_mode=mode,
                    update_mode=args.update_mode,
                    outpath=f"{td}/run_cl{cl}", seed=3,
                )
                t0 = time.time()
                net, stats = train(net, dtr, cfg, test_data=dte, verbose=False)
                wall = time.time() - t0
                preds = posterior_predictions(f"{td}/run_cl{cl}/models", dte.X)
                pm = preds.mean(axis=0)
                r2 = float(np.corrcoef(pm, np.asarray(dte.y))[0, 1] ** 2)
                rec = {
                    "h2": h2,
                    "step_size_mode": mode,
                    "chain_length": cl,
                    "test_r2_posterior_mean": round(r2, 4),
                    # reliability k/(k+1); achievable phenotype r2 is h2 x this
                    "reliability_daetwyler": round(float(expected_r2(m, n, h2)), 4),
                    "achievable_r2": round(h2 * float(expected_r2(m, n, h2)), 4),
                    "mse_test_final": round(stats.mse_test[-1], 4),
                    "acceptance_rate": round(stats.acceptance_rate(), 3),
                    "early_rejection_rate": round(stats.early_rejection_rate(), 3),
                    "wall_s": round(wall, 2),
                    "leapfrog_steps_per_s": round(cl * il * b / wall, 1),
                }
                results["runs"].append(rec)
                print(json.dumps(rec), flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
