"""rs-bann-tpu: a compiled Bayesian neural network engine for genomic prediction.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the
``medical-genomics-group/rs-bann`` reference (Rust + ArrayFire): grouped sparse
branch networks (one small MLP per SNP group, summed at the output) trained with
blocked Gibbs-within-MCMC — per-branch HMC over weights/biases plus conjugate
Gibbs draws for all precision hyperparameters.

Design (accelerator-first, not a port):
  * All branches live in stacked, padded pytrees ``[G, ...]`` with masks;
    the per-branch object graph of the reference collapses into pure arrays.
  * The Gibbs-over-branches sweep is a single jitted ``lax.scan`` (sequential,
    reference-exact semantics) or a block-parallel vmapped update for scaling.
  * HMC leapfrog integration is a ``lax.scan`` with masked early termination.
  * Gradients come from ``jax.grad`` of the log posterior density; the
    reference's hand-written backprop becomes a numerical cross-check.
  * Chains are a vmapped batch axis; branches and chains shard over a
    ``jax.sharding.Mesh`` with XLA collectives for the shared residual.
  * Genotypes stay 2-bit packed (PLINK .bed bytes) in device memory; a
    Pallas kernel fuses the decode into the layer-0 matmul for genome-scale
    inputs.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: from rs_bann_tpu import Net, NetArch, ..."""
    lazy = {
        "Net": ("rs_bann_tpu.models.net", "Net"),
        "NetArch": ("rs_bann_tpu.models.arch", "NetArch"),
        "MCMCCfg": ("rs_bann_tpu.samplers.mcmc_cfg", "MCMCCfg"),
        "Hyperparameters": ("rs_bann_tpu.models.density", "Hyperparameters"),
        "InitCfg": ("rs_bann_tpu.models.init", "InitCfg"),
        "init_net": ("rs_bann_tpu.models.init", "init_net"),
        # NOTE: "train" is the submodule; the function is
        # rs_bann_tpu.train.train (a lazy attr here would be shadowed)
        "simulate_xy": ("rs_bann_tpu.sim", "simulate_xy"),
        "simulate_y": ("rs_bann_tpu.sim", "simulate_y"),
        "BedVM": ("rs_bann_tpu.io.bed", "BedVM"),
        "Phenotypes": ("rs_bann_tpu.io.phen", "Phenotypes"),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'rs_bann_tpu' has no attribute {name!r}")
