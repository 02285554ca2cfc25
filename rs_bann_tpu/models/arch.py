"""Static network architecture description.

Mirrors the semantics of the reference's ``BlockNetCfg`` / ``BranchCfg`` layer
bookkeeping (/root/reference/src/net/architectures.rs:31-236,
/root/reference/src/net/branch/branch_cfg_builder.rs:104-297) but as a single
static, hashable description of *all* branches at once, with padded device
shapes.

Layer convention (same as the reference):
  * A branch with ``depth`` hidden layers has ``num_layers = depth + 2``
    weight layers: ``depth`` dense hidden layers, one summary layer and one
    output layer of width 1.
  * Per-branch layer widths: ``[h]*depth + [s, 1]``.
  * Every layer except the output layer has a bias row; the output neuron is a
    pure dot product (reference ``forward_feed``,
    branch_sampler.rs:743-782).

Branches are ragged (different m_g, h_g, s_g). Every branch is padded to
the max across branches (rounded up to a multiple of 8) and the true counts
are carried; masks are derived on the fly.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Sequence

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class NetArch:
    """Static (trace-time) architecture of a block net.

    All fields are python ints / tuples so the object is hashable and can be
    closed over by jitted functions without retracing surprises.
    """

    m: tuple  # true number of markers per branch, len G
    h: tuple  # true hidden layer width per branch, len G
    s: tuple  # true summary layer width per branch, len G
    depth: int  # number of hidden layers (excluding summary layer)
    activation: str = "tanh"
    pad_multiple: int = 8  # padded widths are multiples of this

    # ------------------------------------------------------------------ sizes
    @property
    def num_branches(self) -> int:
        return len(self.m)

    @property
    def num_layers(self) -> int:
        return self.depth + 2

    @cached_property
    def m_pad(self) -> int:
        return _round_up(max(self.m), self.pad_multiple)

    @cached_property
    def h_pad(self) -> int:
        return _round_up(max(self.h), self.pad_multiple) if self.depth > 0 else 0

    @cached_property
    def s_pad(self) -> int:
        return _round_up(max(self.s), self.pad_multiple)

    # ------------------------------------------------------------- per layer
    def layer_in_pad(self, l: int) -> int:
        """Padded input width of weight layer l."""
        if l == 0:
            return self.m_pad
        if l < self.depth:
            return self.h_pad
        if l == self.depth:  # summary layer
            return self.m_pad if self.depth == 0 else self.h_pad
        return self.s_pad  # output layer

    def layer_out_pad(self, l: int) -> int:
        """Padded output width of weight layer l."""
        if l < self.depth:
            return self.h_pad
        if l == self.depth:
            return self.s_pad
        return 1

    def layer_in_counts(self) -> list:
        """Per-layer [G] arrays of true input widths."""
        out = []
        for l in range(self.num_layers):
            if l == 0:
                out.append(np.asarray(self.m, np.int32))
            elif l <= self.depth:
                out.append(np.asarray(self.h, np.int32))
            else:
                out.append(np.asarray(self.s, np.int32))
        return out

    def layer_out_counts(self) -> list:
        """Per-layer [G] arrays of true output widths."""
        out = []
        for l in range(self.num_layers):
            if l < self.depth:
                out.append(np.asarray(self.h, np.int32))
            elif l == self.depth:
                out.append(np.asarray(self.s, np.int32))
            else:
                out.append(np.ones(self.num_branches, np.int32))
        return out

    def layer_widths(self, g: int) -> list:
        """Reference-style layer_widths vector for branch g."""
        return [self.h[g]] * self.depth + [self.s[g], 1]

    # --------------------------------------------------------------- counts
    def num_weights_per_layer(self, g: int) -> list:
        dims = [self.m[g]] + self.layer_widths(g)
        return [dims[i] * dims[i + 1] for i in range(self.num_layers)]

    def num_params_branch(self, g: int) -> int:
        """Weights + biases of branch g (biases on all but output layer)."""
        widths = self.layer_widths(g)
        n = sum(self.num_weights_per_layer(g))
        n += sum(widths[:-1])
        return n

    def num_params(self) -> int:
        return sum(self.num_params_branch(g) for g in range(self.num_branches))

    @cached_property
    def total_output_weights(self) -> int:
        """Global number of output-layer weights (= sum of summary widths)."""
        return int(sum(self.s))

    # ------------------------------------------------------------- builders
    @staticmethod
    def from_width_rules(
        num_markers_per_branch: Sequence[int],
        depth: int,
        hidden_rule,
        summary_rule,
        activation: str = "tanh",
        pad_multiple: int = 8,
    ) -> "NetArch":
        """Apply the reference's width rules (architectures.rs:93-122).

        ``hidden_rule``/``summary_rule`` are ``("fixed", w)``,
        ``("fraction_of_input", f)`` / ``("like_hidden",)``,
        ``("fraction_of_hidden", f)``.
        """
        ms, hs, ss = [], [], []
        for m in num_markers_per_branch:
            kind = hidden_rule[0]
            if kind == "fixed":
                h = int(hidden_rule[1])
            elif kind == "fraction_of_input":
                h = max(int(m * hidden_rule[1]), 1)
            else:
                raise ValueError(f"unknown hidden rule {hidden_rule}")
            skind = summary_rule[0]
            if skind == "fixed":
                s = int(summary_rule[1])
                assert s != 0, "summary layer width must be > 0"
            elif skind == "like_hidden":
                s = h
            elif skind == "fraction_of_hidden":
                s = max(int(h * summary_rule[1]), 1)
            else:
                raise ValueError(f"unknown summary rule {summary_rule}")
            ms.append(int(m))
            hs.append(h)
            ss.append(s)
        return NetArch(
            m=tuple(ms),
            h=tuple(hs),
            s=tuple(ss),
            depth=depth,
            activation=activation,
            pad_multiple=pad_multiple,
        )

    @staticmethod
    def uniform(
        num_branches: int,
        num_markers_per_branch: int,
        hidden_layer_width: int,
        depth: int,
        summary_layer_width=None,
        activation: str = "tanh",
        pad_multiple: int = 8,
    ) -> "NetArch":
        s = summary_layer_width if summary_layer_width is not None else hidden_layer_width
        return NetArch(
            m=(num_markers_per_branch,) * num_branches,
            h=(hidden_layer_width,) * num_branches,
            s=(s,) * num_branches,
            depth=depth,
            activation=activation,
            pad_multiple=pad_multiple,
        )
