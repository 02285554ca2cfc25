"""Grouped genotypes: BedVM + MarkerGrouping -> per-branch matrices.

Rebuild of /root/reference/src/data/{genotypes,data}.rs. The reference decodes
and uploads each group's standardized submatrix on every access
(genotypes.rs:44-48); here ``to_stacked`` materializes the padded stacked
device tensor once, and ``to_packed`` keeps the 2-bit bytes for the fused
decode path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..group.grouping import MarkerGrouping
from ..models.arch import NetArch
from ..models.data import StackedData
from .bed import BedVM
from .phen import Phenotypes


class CompressedGenotypes:
    def __init__(self, bed: BedVM, groups: MarkerGrouping):
        self.bed = bed
        self.groups = groups

    @property
    def num_individuals(self) -> int:
        return self.bed.num_individuals

    @property
    def num_groups(self) -> int:
        return self.groups.num_groups

    def num_markers_per_group(self):
        return self.groups.group_sizes()

    def x_group(self, ix: int) -> np.ndarray:
        """[n, m_g] standardized (genotypes.rs:44-48)."""
        return self.bed.get_submatrix_standardized(self.groups.group(ix))

    def to_file(self, stem):
        self.bed.to_file(stem)
        self.groups.to_file(stem)

    def to_stacked(self, arch: NetArch, y: Optional[np.ndarray] = None) -> StackedData:
        """Materialize the [G, n, m_pad] standardized tensor."""
        import jax.numpy as jnp

        n = self.num_individuals
        X = np.zeros((arch.num_branches, n, arch.m_pad), np.float32)
        for g in range(self.num_groups):
            X[g, :, : arch.m[g]] = self.x_group(g)
        if y is None:
            y = np.zeros(n, np.float32)
        return StackedData(jnp.asarray(X), jnp.asarray(np.asarray(y, np.float32)))

    def to_packed(self, arch: NetArch, y: Optional[np.ndarray] = None) -> StackedData:
        """2-bit packed device form for the fused decode path (16x less
        HBM than to_stacked; the only form that fits UKB-scale n)."""
        from ..models.data import pack_stacked

        if y is None:
            y = np.zeros(self.num_individuals, np.float32)
        return pack_stacked(arch, self.bed, self.groups, y)

    def to_feature_major(
        self, arch: NetArch, y: Optional[np.ndarray] = None, dtype=np.float32
    ) -> StackedData:
        """Feature-major dense FeatX [G, m_pad, n]: the large n axis is
        minor in every sweep matmul (models/density.FeatX).

        ``dtype``: X storage dtype. bfloat16 halves the dominant layer-0
        memory traffic at the cost of rounding X; accumulation stays f32
        (see models/density.matmul)."""
        import jax.numpy as jnp

        from ..models.density import FeatX

        n = self.num_individuals
        X = np.zeros((arch.num_branches, arch.m_pad, n), np.float32)
        for g in range(self.num_groups):
            X[g, : arch.m[g], :] = self.x_group(g).T
        if y is None:
            y = np.zeros(n, np.float32)
        return StackedData(
            FeatX(jnp.asarray(X, dtype=dtype)),
            jnp.asarray(np.asarray(y, np.float32)),
        )


class Data:
    """Genotypes + phenotypes pair (data/data.rs:7-48)."""

    def __init__(self, gen: CompressedGenotypes, phen: Phenotypes):
        assert gen.num_individuals == phen.y.shape[0], (
            gen.num_individuals,
            phen.y.shape,
        )
        self.gen = gen
        self.phen = phen

    @property
    def num_individuals(self):
        return self.gen.num_individuals

    @property
    def num_branches(self):
        return self.gen.num_groups

    def num_markers_per_branch(self):
        return self.gen.num_markers_per_group()

    def y(self):
        return self.phen.y

    def to_stacked(self, arch: NetArch) -> StackedData:
        return self.gen.to_stacked(arch, self.phen.y)
