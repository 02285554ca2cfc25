"""Conjugate Gibbs updates for precision hyperparameters.

Compiled equivalents of the reference's src/net/gibbs_steps.rs:9-129: all
draws are ``jax.random.gamma`` with batched shape/scale arrays, so per-row ARD
updates across a whole layer (and across branches/chains under vmap) are a
single vectorized draw instead of the reference's host-loop of rand_distr
samples (ridge_ard.rs:271-301).

Parameterization: Gamma(shape k, scale θ); ``jax.random.gamma(key, k) * θ``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _gamma(key, shape, scale):
    """Independent Gamma(shape, scale) draws, one per element of the
    broadcast of (shape, scale)."""
    out_shape = jnp.broadcast_shapes(jnp.shape(shape), jnp.shape(scale))
    shape_b = jnp.broadcast_to(jnp.asarray(shape, jnp.float32), out_shape)
    return jax.random.gamma(key, shape_b) * scale


def inverse_gaussian(key, mu, lam):
    """Independent InverseGaussian(mean μ, shape λ) draws, elementwise over
    the broadcast of (μ, λ).

    Michael–Schucany–Haas (1976) transform: y = ν² with ν ~ N(0,1),
    x = μ + μ²y/(2λ) − μ/(2λ)·√(4μλy + μ²y²), accept x with probability
    μ/(μ+x), else return μ²/x. Used for the Bayesian-lasso scale-mixture
    augmentation (Park & Casella 2008): for w ~ Laplace(rate λ_r), the
    auxiliary per-element precision is 1/s | w ~ InvGauss(λ_r/|w|, λ_r²).
    """
    shape = jnp.broadcast_shapes(jnp.shape(mu), jnp.shape(lam))
    mu = jnp.broadcast_to(jnp.asarray(mu, jnp.float32), shape)
    lam = jnp.broadcast_to(jnp.asarray(lam, jnp.float32), shape)
    # cap μ: for μ ≳ 1e18 (rate / |w| with |w| at the 1e-12 floor),
    # μ·y·(4λ+μ·y) overflows f32 to inf, x → −inf → the 1e-30 floor, and the
    # accept test then returns the floor itself (a huge slab VARIANCE) where
    # the correct draw is in the large-precision reciprocal branch. Draws at
    # μ = 1e12 are astronomically large precisions already (callers clip to
    # 1e12), so the cap is distributionally inert where it binds.
    mu = jnp.minimum(mu, 1e12)
    k_n, k_u = jax.random.split(key)
    y = jax.random.normal(k_n, shape) ** 2
    muy = mu * y
    x = mu + mu * (muy - jnp.sqrt(muy * (4.0 * lam + muy))) / (2.0 * lam)
    # x can round to <= 0 in f32 for extreme μ/λ; the reciprocal branch
    # below (μ²/x) is then selected by u > μ/(μ+x) with x→0 ⇒ p(accept)→1…
    # guard with a tiny floor instead
    x = jnp.maximum(x, 1e-30)
    u = jax.random.uniform(k_u, shape)
    return jnp.where(u <= mu / (mu + x), x, mu * mu / x)


def ridge_precision_posterior(key, prior_shape, prior_scale, sum_of_squares, n):
    """λ | w ~ Gamma(k + n/2, 2s / (2 + s·Σw²)) — gibbs_steps.rs:76-94.

    Broadcasts over array-shaped ``sum_of_squares`` / ``n`` with independent
    per-element draws (the reference loops host draws, ridge_ard.rs:280-291).
    """
    shape = prior_shape + n / 2.0
    scale = 2.0 * prior_scale / (2.0 + prior_scale * sum_of_squares)
    return _gamma(key, shape, scale)


def lasso_precision_posterior(key, prior_shape, prior_scale, sum_of_abs, n):
    """λ | w ~ Gamma(k + n, s / (1 + s·Σ|w|)) — gibbs_steps.rs:25-39."""
    shape = prior_shape + n
    scale = prior_scale / (1.0 + prior_scale * sum_of_abs)
    return _gamma(key, shape, scale)


def ridge_single_precision_posterior(key, prior_shape, prior_scale, value):
    """Scalar-parameter case (gibbs_steps.rs:9-23), used for the output bias
    prior precision (net.rs:56-67)."""
    return ridge_precision_posterior(key, prior_shape, prior_scale, value * value, 1.0)


def error_precision_posterior(key, hyper, residual, beta=None):
    """λ_e | r ~ ridge posterior on the residual vector.

    The reference uses the *output layer* hyperparams for the error precision
    prior (branch_sampler.rs:190-202).

    ``beta`` (inverse temperature, parallel tempering): the conditional under
    the tempered likelihood L^β is Gamma(k + β·n/2, 2s/(2 + s·β·rss)) —
    exactly the β=1 posterior with (rss, n) scaled by β.
    """
    rss = jnp.sum(residual * residual)
    n = jnp.asarray(residual.shape[-1], jnp.float32)
    if beta is not None:
        rss, n = beta * rss, beta * n
    return ridge_precision_posterior(key, hyper.output_shape, hyper.output_scale, rss, n)


def sample_output_bias(key, residual_plus_bias, error_precision, bias_precision):
    """Normal posterior draw of the global intercept (net.rs:47-53).

    ``residual_plus_bias`` is the residual with the current bias added back.
    """
    n = jnp.asarray(residual_plus_bias.shape[-1], jnp.float32)
    denom = n * error_precision + bias_precision
    mean = error_precision / denom * jnp.sum(residual_plus_bias)
    std = jnp.sqrt(1.0 / denom)
    return mean + std * jax.random.normal(key, ())
