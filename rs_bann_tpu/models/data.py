"""Device-resident training data.

The reference re-decodes and re-uploads each branch's standardized genotype
submatrix from host RAM on every single branch update
(reference src/io/bed.rs:325-355, net.rs:265). Here the data stays
resident in device memory across the whole run in one of two forms:

  * ``StackedData``: materialized standardized X as [G, n, m_pad] f32 —
    best for small/medium problems (the entire sweep reads it in place).
  * packed form (see ops/packed_matmul.py): the 2-bit PLINK bed bytes stay
    compressed in device memory and are decoded inside the layer-0 matmul —
    16x less memory for genome-scale inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from .arch import NetArch


class StackedData(NamedTuple):
    X: object  # [G, n, m_pad] standardized dense array, or a stacked PackedX
    y: jnp.ndarray  # [n]


def pack_stacked(arch: NetArch, bed, grouping, y) -> StackedData:
    """Build the 2-bit packed stacked form: X is a PackedX whose leaves have a
    leading branch axis. 16x less HBM than the dense form; requires the fused
    decode path (ops/packed_matmul.py)."""
    from ..ops.packed_matmul import GBYTES, GROUP, pack_strided
    from .density import PackedX

    n = bed.num_individuals
    G = arch.num_branches
    B = -(-n // GROUP) * GBYTES  # group-strided bytes per marker
    by = np.empty((G, arch.m_pad, B), np.uint8)
    scale = np.zeros((G, arch.m_pad), np.float32)
    shift = np.zeros((G, arch.m_pad), np.float32)
    raw = np.zeros((arch.m_pad, n), np.float32)
    for g in range(G):
        ixs = np.asarray(grouping.group(g))
        raw[:] = 0.0
        raw[: arch.m[g]] = bed.get_cols(ixs)
        by[g] = pack_strided(raw)
        std = bed.col_stds[ixs]
        scale[g, : arch.m[g]] = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
        shift[g, : arch.m[g]] = bed.col_means[ixs]
    X = PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), n)
    return StackedData(X, jnp.asarray(np.asarray(y, np.float32)))


def stack_standardized(
    arch: NetArch,
    columns: Sequence[np.ndarray],  # per-branch [n, m_g] raw (or standardized)
    y: np.ndarray,
    standardize: bool = True,
    dtype=np.float32,
    feature_major: bool = False,
) -> StackedData:
    """Pad per-branch matrices into [G, n, m_pad]; optionally standardize
    columns to mean 0 / std 1 (population std, matching io/bed.rs:231-242).

    ``dtype``: storage dtype of X. bfloat16 halves the memory traffic of
    the dominant layer-0 reads; matmuls accumulate in f32 either way.

    ``feature_major``: store X transposed as a FeatX ([G, m_pad, n]), with
    the large n axis minor in every sweep matmul (see models/density.FeatX).
    """
    n = columns[0].shape[0]
    G = arch.num_branches
    if feature_major:
        X = np.zeros((G, arch.m_pad, n), np.float32)
    else:
        X = np.zeros((G, n, arch.m_pad), np.float32)
    for g, xg in enumerate(columns):
        xg = np.asarray(xg, np.float32)
        assert xg.shape == (n, arch.m[g]), (xg.shape, n, arch.m[g])
        if standardize:
            mean = xg.mean(axis=0)
            std = xg.std(axis=0)  # population std (ddof=0), like the reference
            xg = (xg - mean) / np.where(std > 0, std, 1.0)
        if feature_major:
            X[g, : arch.m[g], :] = xg.T
        else:
            X[g, :, : arch.m[g]] = xg
    Xj = jnp.asarray(X)
    if dtype is not None and np.dtype(dtype) != np.float32:
        Xj = Xj.astype(dtype)
    if feature_major:
        from .density import FeatX

        return StackedData(FeatX(Xj), jnp.asarray(np.asarray(y, np.float32)))
    return StackedData(Xj, jnp.asarray(np.asarray(y, np.float32)))
