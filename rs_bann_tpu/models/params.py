"""Stacked parameter / precision pytrees.

Replaces the reference's host/device mirrored ``BranchParams(Host)`` /
``BranchPrecisions(Host)`` pair (/root/reference/src/net/params.rs:191-796)
with a single pytree of device arrays covering *all* branches:

  * ``weights[l]``:  [G, in_pad(l), out_pad(l)]
  * ``biases[l]``:   [G, out_pad(l)]                (no bias on output layer)
  * weight precisions per layer, broadcastable against the weights:
      - Base priors: [G, 1, 1] (one precision per layer)
      - ARD priors:  [G, in_pad(l), 1] (one per input row) for local layers,
        [G, 1, 1] for the output layer (always Base-style and shared globally;
        reference ridge_ard.rs:188-194)
  * ``bias_precisions[l]``: [G, 1]
  * ``error_precision``: scalar — global across branches, mirroring
    ``GlobalParams.error_precision`` (params.rs:14-18).

Padding invariant: padded weight/bias entries are exactly 0 and have zero
momentum in HMC, so they stay 0 through leapfrog integration. Reductions over
weights (sum of squares / l1 norms) are then exact without masks; only counts
(Gibbs shapes, joint-density degrees of freedom) use the true per-branch
counts from ``NetArch``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .arch import NetArch


class StackedParams(NamedTuple):
    weights: Tuple[jax.Array, ...]  # per layer [G, in_pad, out_pad]
    biases: Tuple[jax.Array, ...]  # per layer [G, out_pad], len = num_layers-1


class StackedPrecisions(NamedTuple):
    weights: Tuple[jax.Array, ...]  # per layer [G,1,1] or [G,in_pad,1]
    biases: Tuple[jax.Array, ...]  # per layer [G,1]
    error: jax.Array  # scalar


class NetState(NamedTuple):
    """Full mutable sampler state of the net (one chain)."""

    params: StackedParams
    precisions: StackedPrecisions
    output_bias: jax.Array  # scalar
    output_bias_precision: jax.Array  # scalar (lambda of the bias prior)


# ----------------------------------------------------------------- masks


def weight_masks(arch: NetArch) -> Tuple[np.ndarray, ...]:
    """Per-layer [G, in_pad, out_pad] {0,1} masks of real weights.

    HOST (numpy) arrays by design: these are compile-time constants of the
    sweep program. Converting them to device arrays eagerly would force a
    device->host readback at every jit lowering; numpy constants embed
    directly from host memory. Convert with
    jnp.asarray INSIDE traced code where tracer indexing is needed."""
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    masks = []
    for l in range(arch.num_layers):
        ip, op = arch.layer_in_pad(l), arch.layer_out_pad(l)
        im = np.arange(ip)[None, :] < ins[l][:, None]  # [G, in_pad]
        om = np.arange(op)[None, :] < outs[l][:, None]  # [G, out_pad]
        masks.append(np.asarray(im[:, :, None] & om[:, None, :], np.float32))
    return tuple(masks)


def bias_masks(arch: NetArch) -> Tuple[jax.Array, ...]:
    outs = arch.layer_out_counts()
    masks = []
    for l in range(arch.num_layers - 1):
        op = arch.layer_out_pad(l)
        om = np.arange(op)[None, :] < outs[l][:, None]
        masks.append(np.asarray(om, np.float32))
    return tuple(masks)


def marker_mask(arch: NetArch) -> jax.Array:
    """[G, m_pad] mask of real markers."""
    mm = np.arange(arch.m_pad)[None, :] < np.asarray(arch.m)[:, None]
    return np.asarray(mm, np.float32)


# ------------------------------------------------------- per-branch counts


def weight_counts(arch: NetArch) -> Tuple[jax.Array, ...]:
    """Per-layer [G] true number of weights."""
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    return tuple(np.asarray(ins[l] * outs[l], np.float32) for l in range(arch.num_layers))


def bias_counts(arch: NetArch) -> Tuple[jax.Array, ...]:
    outs = arch.layer_out_counts()
    return tuple(np.asarray(outs[l], np.float32) for l in range(arch.num_layers - 1))


def param_counts(arch: NetArch) -> jax.Array:
    """[G] true number of params (weights+biases) per branch."""
    return np.asarray(
        [arch.num_params_branch(g) for g in range(arch.num_branches)], np.float32
    )


# ------------------------------------------------------------ construction


def zeros_params(arch: NetArch, dtype=jnp.float32) -> StackedParams:
    G = arch.num_branches
    ws = tuple(
        jnp.zeros((G, arch.layer_in_pad(l), arch.layer_out_pad(l)), dtype)
        for l in range(arch.num_layers)
    )
    bs = tuple(
        jnp.zeros((G, arch.layer_out_pad(l)), dtype) for l in range(arch.num_layers - 1)
    )
    return StackedParams(ws, bs)


def ones_precisions(arch: NetArch, ard: bool, dtype=jnp.float32) -> StackedPrecisions:
    G = arch.num_branches
    ws = []
    for l in range(arch.num_layers):
        if ard and l < arch.num_layers - 1:
            ws.append(jnp.ones((G, arch.layer_in_pad(l), 1), dtype))
        else:
            ws.append(jnp.ones((G, 1, 1), dtype))
    bs = tuple(jnp.ones((G, 1), dtype) for _ in range(arch.num_layers - 1))
    return StackedPrecisions(tuple(ws), bs, jnp.asarray(2.0, dtype))


# ------------------------------------------------- reference param_vec order


def branch_param_vec(arch: NetArch, params: StackedParams, g: int) -> np.ndarray:
    """Flatten branch g's true params in the reference order.

    Order: all weight layers (column-major within a layer, i.e. ArrayFire's
    layout: for an in x out matrix, elements run down each column first), then
    all bias layers (params.rs:700-726).
    """
    pieces = []
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    for l in range(arch.num_layers):
        w = np.asarray(params.weights[l][g])[: ins[l][g], : outs[l][g]]
        pieces.append(w.reshape(-1, order="F"))
    for l in range(arch.num_layers - 1):
        b = np.asarray(params.biases[l][g])[: outs[l][g]]
        pieces.append(b.reshape(-1))
    return np.concatenate(pieces).astype(np.float32)


def load_branch_param_vec(
    arch: NetArch, params: StackedParams, g: int, vec: np.ndarray
) -> StackedParams:
    """Inverse of :func:`branch_param_vec` (host-side; returns new pytree)."""
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    ws = [np.asarray(w) for w in params.weights]
    bs = [np.asarray(b) for b in params.biases]
    ix = 0
    for l in range(arch.num_layers):
        i, o = int(ins[l][g]), int(outs[l][g])
        ws[l] = ws[l].copy()
        ws[l][g, :i, :o] = vec[ix : ix + i * o].reshape(i, o, order="F")
        ix += i * o
    for l in range(arch.num_layers - 1):
        o = int(outs[l][g])
        bs[l] = bs[l].copy()
        bs[l][g, :o] = vec[ix : ix + o]
        ix += o
    return StackedParams(
        tuple(jnp.asarray(w) for w in ws), tuple(jnp.asarray(b) for b in bs)
    )
