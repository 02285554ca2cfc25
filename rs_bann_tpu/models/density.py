"""Per-branch forward pass and log posterior densities for all prior families.

This is the mathematical core: the compiled equivalents of the reference's
``BranchSampler`` density methods and the five branch impls
(/root/reference/src/net/branch/{branch_sampler,ridge_base,ridge_ard,
lasso_base,lasso_ard,std_normal_branch}.rs).

Everything operates on a *single branch slice* — pytrees of per-layer arrays
without the leading G axis — so the same functions serve:
  * the sequential Gibbs scan (slice branch g out of the stacked state),
  * the block-parallel update (vmap over G),
  * multi-chain sampling (vmap over chains).

Gradients are obtained with ``jax.grad`` of these densities; the reference's
hand-derived backprop (branch_sampler.rs:813-875) plus prior-term gradients
(ridge: −λ∘W, lasso: −λ∘sign(W) with sign(0)=0 — matching ``jnp.sign``) agree
with autodiff, which the tests verify against the reference's golden values.
Lasso L1 terms are written ``w·sign(w)`` (``_abs0``) rather than ``jnp.abs``:
``jax.grad(jnp.abs)(0.0) = 1``, which would put a phantom prior force on
exactly-zero weights — padded entries and spike-and-slab-excluded rows — and
leak them off zero through the leapfrog; ``grad(w·sign(w)) = sign(w)`` is 0
at 0, the reference's af_helpers.rs:53-58 subgradient convention.

Prior families ("model types"):
  ridge_base   one Gamma-precision per layer, Normal weights
  ridge_ard    one precision per input row in all but the output layer
  lasso_base   one precision per layer, Laplace weights
  lasso_ard    per-row Laplace rates
  std_normal   fixed unit precisions (no Gibbs)

The output layer is always Base-style, with a precision *shared across all
branches* (reference params.rs:395-465): its conditional posterior sees the
summary statistic (sum of squares / abs) of ALL branches' output weights.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import activations as _A
from ..ops.activations import activation
from .arch import NetArch
from . import params as P
from .params import StackedParams, StackedPrecisions

MODEL_TYPES = ("ridge_base", "ridge_ard", "lasso_base", "lasso_ard", "std_normal")


def is_ard(model_type: str) -> bool:
    return model_type.endswith("_ard")


def is_lasso(model_type: str) -> bool:
    return model_type.startswith("lasso")


def _abs0(w: jax.Array) -> jax.Array:
    """|w| with autodiff gradient sign(w), sign(0) = 0 (see module doc).

    Use in every L1 term a leapfrog gradient flows through; ``jnp.abs`` is
    fine for value-only summary statistics.
    """
    return w * jnp.sign(w)


def summary_stat(model_type: str, w: jax.Array) -> jax.Array:
    """Branch-type specific regularization sum over output weights.

    Ridge/StdNormal: sum of squares; Lasso: sum of abs
    (ridge_base.rs:36-42, lasso_base.rs:37-43).
    """
    if is_lasso(model_type):
        return jnp.sum(jnp.abs(w))
    return jnp.sum(w * w)


class Hyperparameters(NamedTuple):
    """Gamma (shape, scale) precision prior hyperparameters per layer group.

    Mirrors ``NetworkPrecisionHyperparameters`` (params.rs:133-188): dense
    layers, the summary layer (index L-2), the output layer (index L-1).
    """

    dense_shape: float = 0.001
    dense_scale: float = 1000.0
    summary_shape: float = 0.001
    summary_scale: float = 1000.0
    output_shape: float = 0.001
    output_scale: float = 1000.0

    def layer(self, l: int, num_layers: int) -> Tuple[float, float]:
        if l == num_layers - 1:
            return self.output_shape, self.output_scale
        if l == num_layers - 2:
            return self.summary_shape, self.summary_scale
        return self.dense_shape, self.dense_scale


class BranchStatics(NamedTuple):
    """Per-branch true counts / masks, stacked [G, ...]; slice with tree.map."""

    w_counts: Tuple[jax.Array, ...]  # [G] true weights per layer
    b_counts: Tuple[jax.Array, ...]  # [G] true biases per layer
    row_masks: Tuple[jax.Array, ...]  # [G, in_pad, 1] true input-row masks
    out_counts: Tuple[jax.Array, ...]  # [G] true output width per layer
    n_params: jax.Array  # [G] true params per branch


def branch_statics(arch: NetArch) -> BranchStatics:
    """Static per-branch counts/masks as HOST (numpy) leaves — compile-time
    constants embedded at lowering without a device readback (see
    params.weight_masks)."""
    ins = arch.layer_in_counts()
    row_masks = []
    for l in range(arch.num_layers):
        ip = arch.layer_in_pad(l)
        rm = (np.arange(ip)[None, :] < np.asarray(ins[l])[:, None]).astype(np.float32)
        row_masks.append(rm[:, :, None])
    return BranchStatics(
        w_counts=P.weight_counts(arch),
        b_counts=P.bias_counts(arch),
        row_masks=tuple(row_masks),
        out_counts=tuple(
            np.asarray(c, np.float32) for c in arch.layer_out_counts()
        ),
        n_params=P.param_counts(arch),
    )


def slice_branch(tree, g):
    """Take branch g out of a stacked pytree (works under jit/scan)."""
    return jax.tree.map(lambda a: a[g], tree)


# ------------------------------------------------------------------ forward


@jax.tree_util.register_pytree_node_class
class PackedX:
    """2-bit packed, device-resident branch genotypes.

    ``bytes``   uint8 [..., m_pad, bytes_per_col] PLINK bed columns
    ``w_scale`` [..., m_pad] = 1/σ per marker (0 for padded / zero-variance)
    ``shift``   [..., m_pad] = μ per marker (raw column means)
    ``n``       static number of individuals

    Standardization folds into layer-0 weights:
      X_std @ W = decode(bytes) @ (w_scale[:,None]·W) − μ @ (w_scale[:,None]·W)
    so the Pallas kernels (ops/packed_matmul.py) fuse decode+matmul and the
    dense standardized matrix never materializes.
    """

    def __init__(self, bytes_, w_scale, shift, n: int):
        self.bytes = bytes_
        self.w_scale = w_scale
        self.shift = shift
        self.n = int(n)

    def tree_flatten(self):
        return (self.bytes, self.w_scale, self.shift), self.n

    @classmethod
    def tree_unflatten(cls, n, children):
        return cls(*children, n)

    def __getitem__(self, g):
        return PackedX(self.bytes[g], self.w_scale[g], self.shift[g], self.n)


@jax.tree_util.register_pytree_node_class
class FeatX:
    """Feature-major dense branch genotypes: ``xT`` [..., m_pad, n].

    Every layer runs feature-major, with the large n axis minor:

        z [h, n] = W᾿ [h, m] @ x [m, n]      (W᾿ = Wᵀ, formed per step —
                                              weights stay [in, out])

    and the width-1 output neuron is an elementwise product and a
    reduction over features instead of a one-column matmul.

    ``forward`` on a FeatX returns *feature-major* pre/activations
    ([width, n]) for all but the LAST entry, which is the standard [n, 1]
    output column — callers of intermediate activations must transpose
    (see ``summary_acts``).
    """

    def __init__(self, xT):
        self.xT = xT

    def tree_flatten(self):
        return (self.xT,), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    def __getitem__(self, g):
        return FeatX(self.xT[g])

    @property
    def n(self) -> int:
        return self.xT.shape[-1]

    def to_dense(self):
        """Standard sample-major [..., n, m_pad] view (analysis paths)."""
        return jnp.swapaxes(self.xT, -1, -2)


def x_slice(x, g):
    """Branch g's input out of stacked [G, ...] data (dense or packed)."""
    return x[g]


# Matmul precision of the sweep's dots. None = f32 operands at
# Precision.HIGHEST (full f32 products on the GPU, not TF32), for parity with
# the NumPy oracle; these dots are skinny (k <= 32) and memory-bound, so the
# f32 rate costs little. "bfloat16" = bf16 operands with f32 accumulation:
# half the operand traffic at the cost of input rounding — the Metropolis
# correction keeps the sampler exact regardless (the proposal just changes
# slightly).
_COMPUTE_DTYPE = None
_HIGHEST = jax.lax.Precision.HIGHEST


def set_compute_dtype(dtype):
    """Set matmul input dtype globally: None (f32) or "bfloat16"."""
    global _COMPUTE_DTYPE
    assert dtype in (None, "bfloat16"), dtype
    _COMPUTE_DTYPE = dtype


def _bf16_pair(a, b):
    """Resolve a dtype mismatch: ONLY the intended bf16-stored-X vs f32-
    weights pair downcasts (X was rounded to bf16 when stored, so a bf16 dot
    loses only the weights' low bits); any other mismatch is a caller bug."""
    if jnp.bfloat16 not in (a.dtype, b.dtype) or not (
        jnp.issubdtype(a.dtype, jnp.floating)
        and jnp.issubdtype(b.dtype, jnp.floating)
    ):
        raise TypeError(
            f"matmul dtype mismatch {a.dtype} vs {b.dtype}: only the "
            "bf16-stored-X vs f32-weights pair is supported"
        )
    return a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)


def _precision(a):
    """HIGHEST for f32 operands; bf16 operands need no precision flag."""
    return _HIGHEST if a.dtype == jnp.float32 else None


def matmul(a, b):
    """a @ b with optional bf16 inputs and always-f32 accumulation."""
    if _COMPUTE_DTYPE is not None:
        a = a.astype(_COMPUTE_DTYPE)
        b = b.astype(_COMPUTE_DTYPE)
    elif a.dtype != b.dtype:
        a, b = _bf16_pair(a, b)
    return jax.lax.dot_general(
        a, b, (((a.ndim - 1,), (0,)), ((), ())), precision=_precision(a),
        preferred_element_type=jnp.float32,
    )


def matmul_fm(w, a):
    """Feature-major layer: [out, n] = w[in, out]ᵀ @ a[in, n].

    The explicit transpose keeps weights in their canonical [in, out]
    orientation everywhere else while the dot (and the autodiff cotangent
    dWᵀ = g @ aᵀ) keeps n minor — see FeatX. Optional bf16 inputs, f32
    accumulation, same contract as ``matmul``.
    """
    wt = w.T
    if _COMPUTE_DTYPE is not None:
        wt = wt.astype(_COMPUTE_DTYPE)
        a = a.astype(_COMPUTE_DTYPE)
    elif wt.dtype != a.dtype:
        wt, a = _bf16_pair(wt, a)
    return jax.lax.dot_general(
        wt, a, (((1,), (0,)), ((), ())), precision=_precision(a),
        preferred_element_type=jnp.float32,
    )


def _layer0(weights0, bias0, x):
    if isinstance(x, PackedX):
        from ..ops.packed_matmul import packed_matmul

        w0p = x.w_scale[:, None] * weights0
        z = packed_matmul(x.bytes, w0p, x.n) - jnp.dot(
            x.shift, w0p, precision=_HIGHEST
        )[None, :]
        return z + bias0[None, :]
    return matmul(x, weights0) + bias0[None, :]


def forward(act_name: str, weights, biases, x):
    """Forward pass of one branch.

    x: [n, m_pad] dense standardized, or a PackedX; returns
    (pre_activations, activations) like the reference's ``forward_feed``
    (branch_sampler.rs:743-758): activations has one entry per layer, the
    last being the scalar output column [n, 1]. On the packed path with a
    fusable activation, layer 0 runs as one fused op (decode + matmul +
    offset + activation) and pre_activations[0] is None — no caller
    consumes pre_activations; it exists for reference-parity inspection.
    """
    from ..ops.packed_matmul import FUSED_ACTIVATIONS, packed_linear

    h = activation(act_name)
    pre = []
    acts = []
    num_layers = len(weights)
    canon = _A.canonical(act_name)
    if isinstance(x, FeatX):
        a = x.xT  # [m_pad, n]
        for l in range(num_layers - 1):
            z = matmul_fm(weights[l], a) + biases[l][:, None]
            pre.append(z)
            a = h(z)
            acts.append(a)
        # width-1 output as an elementwise product and a reduction over
        # features; returned in the standard [n, 1] orientation for callers
        out = jnp.sum(weights[-1][:, 0][:, None] * a, axis=0)  # [n]
        acts.append(out[:, None])
        return pre, acts
    if isinstance(x, PackedX) and canon in FUSED_ACTIVATIONS:
        w0p = x.w_scale[:, None] * weights[0]
        off = biases[0] - jnp.dot(x.shift, w0p, precision=_HIGHEST)
        a = packed_linear(x.bytes, w0p, off, x.n, canon)
        pre.append(None)
        acts.append(a)
    else:
        z = _layer0(weights[0], biases[0], x)
        pre.append(z)
        a = h(z)
        acts.append(a)
    for l in range(1, num_layers - 1):
        z = matmul(a, weights[l]) + biases[l][None, :]
        pre.append(z)
        a = h(z)
        acts.append(a)
    out = matmul(a, weights[-1])
    acts.append(out)
    return pre, acts


def predict(act_name: str, weights, biases, x) -> jax.Array:
    """Branch prediction [n] (output column squeezed)."""
    _, acts = forward(act_name, weights, biases, x)
    return acts[-1][:, 0]


def summary_acts(act_name: str, weights, biases, x) -> jax.Array:
    """Summary-layer activations in the STANDARD [n, s_pad] orientation,
    regardless of the input layout (FeatX forward keeps intermediates
    feature-major; spike-and-slab consumers want sample-major)."""
    A = forward(act_name, weights, biases, x)[1][-2]
    if isinstance(x, FeatX):
        return A.T
    return A


def branch_rss(act_name: str, weights, biases, x, y) -> jax.Array:
    r = predict(act_name, weights, biases, x) - y
    return jnp.sum(r * r)


# --------------------------------------------------- marginal log densities


def log_density_wrt_weights(model_type: str, weights, w_precisions) -> jax.Array:
    """Prior term of the marginal (precision-conditional) log density.

    ridge_base.rs:159-173 / ridge_ard.rs:171-194 / lasso_base.rs:160-173 /
    lasso_ard.rs / std_normal_branch.rs. Padded entries are exactly zero so
    unmasked sums are exact.
    """
    ld = 0.0
    for w, lam in zip(weights, w_precisions):
        if model_type == "std_normal":
            ld = ld - 0.5 * jnp.sum(w * w)
        elif is_lasso(model_type):
            ld = ld - jnp.sum(lam * _abs0(w))
        else:
            ld = ld - 0.5 * jnp.sum(lam * w * w)
    return ld


def log_density_wrt_biases(model_type: str, biases) -> jax.Array:
    """Marginal mode: biases are unregularized (branch_sampler.rs:104-112)
    except for std_normal, whose log_density override includes unit-precision
    bias terms (std_normal_branch.rs:150-162)."""
    if model_type != "std_normal":
        return jnp.asarray(0.0)
    ld = 0.0
    for b in biases:
        ld = ld - 0.5 * jnp.sum(b * b)
    return ld


def log_density(
    model_type: str, weights, biases, w_precisions, error_precision, rss
) -> jax.Array:
    """-U(q): branch_sampler.rs:72-78."""
    return (
        log_density_wrt_weights(model_type, weights, w_precisions)
        + log_density_wrt_biases(model_type, biases)
        - error_precision * rss / 2.0
    )


def potential_fn(model_type: str, act_name: str):
    """Returns f(weights, biases, w_precisions, error_precision, x, y) -> -U.

    ``jax.grad`` of this w.r.t. (weights, biases) reproduces the reference's
    analytic gradient (backprop + prior terms, branch_sampler.rs:380-391).
    """

    def f(weights, biases, w_precisions, error_precision, x, y):
        rss = branch_rss(act_name, weights, biases, x, y)
        return log_density(model_type, weights, biases, w_precisions, error_precision, rss)

    return f


# ------------------------------------------------------ joint log densities


def _joint_local_weights(
    model_type: str,
    weights,
    w_precisions,
    hyper: Hyperparameters,
    statics_g,
) -> jax.Array:
    """Local (non-output) weight+precision terms of the joint density.

    ridge_base.rs:117-136, ridge_ard.rs:119-148, lasso_base.rs:119-138,
    lasso_ard.rs.
    """
    L = len(weights)
    ld = 0.0
    for l in range(L - 1):
        shape, scale = hyper.layer(l, L)
        w, lam = weights[l], w_precisions[l]
        if is_ard(model_type):
            rm = statics_g.row_masks[l]  # [in_pad, 1]
            ncols = statics_g.out_counts[l]
            if is_lasso(model_type):
                row_l1 = jnp.sum(_abs0(w), axis=1, keepdims=True)
                ld = ld - jnp.sum(rm * (row_l1 + 1.0 / scale) * lam)
                ld = ld + (shape + ncols - 1.0) * jnp.sum(rm * jnp.log(lam))
            else:
                row_ssq = jnp.sum(w * w, axis=1, keepdims=True)
                ld = ld - jnp.sum(rm * (row_ssq / 2.0 + 1.0 / scale) * lam)
                ld = ld + (shape + (ncols - 2.0) / 2.0) * jnp.sum(rm * jnp.log(lam))
        else:
            nvar = statics_g.w_counts[l]
            lam0 = lam.reshape(())
            if is_lasso(model_type):
                ld = ld - (jnp.sum(_abs0(w)) + 1.0 / scale) * lam0
                ld = ld + (shape + nvar - 1.0) * jnp.log(lam0)
            else:
                ld = ld - (jnp.sum(w * w) / 2.0 + 1.0 / scale) * lam0
                ld = ld + (shape + (nvar - 2.0) / 2.0) * jnp.log(lam0)
    return ld


def _joint_output_weights(
    model_type: str,
    weights,
    w_precisions,
    hyper: Hyperparameters,
    reg_sum_others: jax.Array,
    n_out_global: jax.Array,
) -> jax.Array:
    """Output weight + shared precision term (ridge_base.rs:138-157 etc.).

    ``reg_sum_others`` is the summary stat of all OTHER branches' output
    weights; ``n_out_global`` the global output-weight count.
    """
    L = len(weights)
    shape, scale = hyper.layer(L - 1, L)
    lam = w_precisions[-1].reshape(())
    own = summary_stat(model_type, weights[-1])
    tot = own + reg_sum_others
    if is_lasso(model_type):
        return -(tot + 1.0 / scale) * lam + (shape + n_out_global - 1.0) * jnp.log(lam)
    return -(tot / 2.0 + 1.0 / scale) * lam + (
        shape + (n_out_global - 2.0) / 2.0
    ) * jnp.log(lam)


def _joint_biases(biases, b_precisions, hyper: Hyperparameters, statics_g) -> jax.Array:
    """l2-regularized bias + precision terms (branch_sampler.rs:259-279)."""
    L = len(biases) + 1
    ld = 0.0
    for l in range(L - 1):
        shape, scale = hyper.layer(l, L)
        lam = b_precisions[l].reshape(())
        nvar = statics_g.b_counts[l]
        ld = ld - lam * (jnp.sum(biases[l] ** 2) / 2.0 + 1.0 / scale)
        ld = ld + (shape + (nvar - 2.0) / 2.0) * jnp.log(lam)
    return ld


def joint_rss_term(
    error_precision, rss, hyper: Hyperparameters, num_individuals
) -> jax.Array:
    """RSS + error precision term (branch_sampler.rs:240-257): uses the
    *output layer* hyperparams for the error precision prior."""
    return (hyper.output_shape + (num_individuals - 2.0) / 2.0) * jnp.log(
        error_precision
    ) - error_precision * (rss / 2.0 + 1.0 / hyper.output_scale)


def log_density_joint(
    model_type: str,
    weights,
    biases,
    w_precisions,
    b_precisions,
    error_precision,
    rss,
    hyper: Hyperparameters,
    statics_g,
    reg_sum_others,
    n_out_global,
    num_individuals,
) -> jax.Array:
    """Full joint -U over params AND precisions (branch_sampler.rs:292-305)."""
    return (
        _joint_local_weights(model_type, weights, w_precisions, hyper, statics_g)
        + _joint_output_weights(
            model_type, weights, w_precisions, hyper, reg_sum_others, n_out_global
        )
        + _joint_biases(biases, b_precisions, hyper, statics_g)
        + joint_rss_term(error_precision, rss, hyper, num_individuals)
    )


def joint_local_term(
    model_type, weights, biases, w_precisions, b_precisions, hyper, statics_g
) -> jax.Array:
    """Per-branch local LPD contribution (log_posterior_density.rs:27-50)."""
    return _joint_local_weights(
        model_type, weights, w_precisions, hyper, statics_g
    ) + _joint_biases(biases, b_precisions, hyper, statics_g)


def joint_output_term(
    model_type, weights, w_precisions, hyper, reg_sum_others, n_out_global
) -> jax.Array:
    return _joint_output_weights(
        model_type, weights, w_precisions, hyper, reg_sum_others, n_out_global
    )


def joint_potential_fn(model_type: str, act_name: str):
    """Joint-HMC potential: differentiable in params AND precisions.

    f(weights, biases, w_prec, b_prec, err_prec, x, y, hyper, statics_g,
      reg_sum_others, n_out_global) -> -U
    """

    def f(
        weights,
        biases,
        w_precisions,
        b_precisions,
        error_precision,
        x,
        y,
        hyper,
        statics_g,
        reg_sum_others,
        n_out_global,
    ):
        rss = branch_rss(act_name, weights, biases, x, y)
        return log_density_joint(
            model_type,
            weights,
            biases,
            w_precisions,
            b_precisions,
            error_precision,
            rss,
            hyper,
            statics_g,
            reg_sum_others,
            n_out_global,
            jnp.asarray(y.shape[0], jnp.float32),
        )

    return f


# ------------------------------------------------------------ effect sizes


def effect_sizes(act_name: str, weights, biases, x) -> jax.Array:
    """d y_hat / d x (standardized genotype scale), per individual: [n, m_pad].

    Equivalent to the reference's input-gradient backprop
    (branch_sampler.rs:787-811). Dense path: jacobian-vector algebra — the
    output is scalar per individual, so grad of the summed outputs w.r.t. x
    gives exactly the per-row input gradients. Packed path: the same
    backward chain written out explicitly (the input gradient needs only
    the forward ACTIVATIONS and the weights, never a gradient through the
    2-bit decode), with h' reconstructed from pre-activations where the
    forward kept them and from the activation outputs on the fused layer-0
    Pallas path (exact for the fusable activations).
    """
    if isinstance(x, FeatX):  # analysis path: densify, reuse the dense chain
        x = x.to_dense()
    if not isinstance(x, PackedX):

        def total_out(xx):
            return jnp.sum(predict(act_name, weights, biases, xx))

        return jax.grad(total_out)(x)

    from ..ops.packed_matmul import _act_prime_from_out

    h = activation(act_name)
    canon = _A.canonical(act_name)
    pre, acts = forward(act_name, weights, biases, x)
    num_layers = len(weights)
    # error = d y_hat / d a_{L-2} = w_out broadcast over rows
    err = jnp.broadcast_to(
        weights[-1][:, 0][None, :], (acts[-1].shape[0], weights[-1].shape[0])
    )
    for l in range(num_layers - 2, -1, -1):
        if pre[l] is not None:
            hp = jax.vmap(jax.vmap(jax.grad(h)))(pre[l])
        else:  # fused layer 0: reconstruct h' from the output
            hp = _act_prime_from_out(canon, acts[l])
        delta = hp * err
        err = delta @ weights[l].T
    return err
