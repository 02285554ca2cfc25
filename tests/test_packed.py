"""Packed (2-bit HBM-resident) genotype path vs the dense standardized path:
forward, gradients, and full training sweeps must agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_bann_tpu.io.bed import BedVM
from rs_bann_tpu.group.grouping import UniformGrouping
from rs_bann_tpu.models import density as D
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import pack_stacked
from rs_bann_tpu.models.init import InitCfg, init_net
from rs_bann_tpu.models.net import Net
from rs_bann_tpu.ops import packed_matmul as P
from rs_bann_tpu.ops.packed_matmul import (
    FUSED_ACTIVATIONS,
    _act_apply,
    _act_prime_from_out,
    _linear_bwd_kernel,
    _linear_fwd_kernel,
    _packed_matmul_ref,
    pack_strided,
    packed_linear,
    unpack_bytes,
    unpack_strided,
)
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Route packed_linear's dispatch to the Triton kernels in interpret mode
    (on the CPU the program itself runs the plain reference)."""
    monkeypatch.setattr(
        P, "_on_cuda",
        lambda kernel_fn, ref_fn, *args: kernel_fn(*args, interpret=True),
    )


def _setup(n=50, G=2, m=6, seed=0):
    bed = BedVM.random(n, G * m, seed=seed)
    grouping = UniformGrouping(G, m)
    arch = NetArch.uniform(G, m, 4, 0, 4)
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n).astype(np.float32)
    from rs_bann_tpu.io.genotypes import CompressedGenotypes

    gen = CompressedGenotypes(bed, grouping)
    dense = gen.to_stacked(arch, y)
    packed = pack_stacked(arch, bed, grouping, y)
    return arch, dense, packed


def test_unpack_matches_bed_decode():
    bed = BedVM.random(23, 5, seed=1)
    dec = np.asarray(unpack_bytes(jnp.asarray(bed.data), 23))
    np.testing.assert_array_equal(dec, bed.data_f32().T)


def test_strided_pack_round_trip():
    rng = np.random.default_rng(0)
    for n in (512, 513, 700, 1024, 37):
        vals = rng.integers(0, 3, size=(5, n)).astype(np.float32)
        by = pack_strided(vals)
        assert by.shape[1] % 128 == 0
        np.testing.assert_array_equal(
            np.asarray(unpack_strided(jnp.asarray(by), n)), vals
        )


def test_packed_forward_matches_dense():
    arch, dense, packed = _setup()
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=3))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    a = np.asarray(net.predict(dense.X))
    b = np.asarray(net.predict(packed.X))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_packed_gradient_matches_dense():
    arch, dense, packed = _setup()
    state, _ = init_net(arch, "lasso_base", InitCfg(seed=3))
    pot = D.potential_fn("lasso_base", "tanh")
    w = tuple(w[0] for w in state.params.weights)
    b = tuple(b[0] for b in state.params.biases)
    lam = tuple(a[0] for a in state.precisions.weights)
    g_dense = jax.grad(pot, argnums=(0, 1))(
        w, b, lam, jnp.asarray(1.0), dense.X[0], dense.y
    )
    g_packed = jax.grad(pot, argnums=(0, 1))(
        w, b, lam, jnp.asarray(1.0), packed.X[0], dense.y
    )
    for a_, b_ in zip(jax.tree.leaves(g_dense), jax.tree.leaves(g_packed)):
        np.testing.assert_allclose(np.asarray(a_), np.asarray(b_), rtol=2e-3, atol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("update_mode", ["sequential", "parallel"])
def test_packed_sweep_matches_dense(update_mode):
    """Same seed, packed vs dense input: identical sampler trajectory."""
    arch, dense, packed = _setup(n=40)
    outs = []
    for data in (dense, packed):
        state, _ = init_net(arch, "ridge_base", InitCfg(seed=1))
        net = Net("ridge_base", arch, D.Hyperparameters(), state)
        cfg = MCMCCfg(
            chain_length=3, burn_in=10**9, hmc_integration_length=10,
            update_mode=update_mode, seed=7,
        )
        sweep = jax.jit(net.make_sweep(cfg))
        carry = net.init_carry(data.X, data.y, jax.random.key(7))
        for _ in range(3):
            carry, stats = sweep(carry, data.X, data.y)
        outs.append(np.asarray(carry.residual))
    np.testing.assert_allclose(outs[0], outs[1], rtol=5e-3, atol=5e-4)


def _bwd_ref(by, g, res, n, act):
    dz = g * _act_prime_from_out(act, res)
    da = jax.lax.dot_general(
        unpack_strided(by, n), dz, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    return np.asarray(da), np.asarray(jnp.sum(dz, axis=0))


def _rel(out, ref):
    return float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))


def test_pallas_kernels_interpret_mode():
    """The Triton kernels, run in interpreter mode on CPU, match the plain
    reference (identity epilogue: the plain decode-matmul and its VJP)."""
    rng = np.random.default_rng(0)
    m, n, k = 16, 600, 8
    vals = rng.integers(0, 3, size=(m, n)).astype(np.float32)
    by = jnp.asarray(pack_strided(vals))
    a = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    zero = jnp.zeros((k,), jnp.float32)
    ref = np.asarray(_packed_matmul_ref(by, a, n))
    out = _linear_fwd_kernel(by, a, zero, n, "identity", interpret=True)
    assert _rel(out, ref) < 1e-5

    g = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    ref_b, _ = _bwd_ref(by, g, g, n, "identity")
    out_b, _ = _linear_bwd_kernel(by, g, g, n, "identity", interpret=True)
    assert _rel(out_b, ref_b) < 1e-5


@pytest.mark.parametrize("act", FUSED_ACTIVATIONS)
def test_pallas_fused_kernel_interpret_mode(act):
    """Fused decode+matmul+offset+activation kernel matches the jnp ref."""
    rng = np.random.default_rng(3)
    m, n, k = 16, 600, 8
    vals = rng.integers(0, 3, size=(m, n)).astype(np.float32)
    by = jnp.asarray(pack_strided(vals))
    a = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    off = jnp.asarray(rng.standard_normal(k).astype(np.float32))
    ref = np.asarray(_act_apply(act, _packed_matmul_ref(by, a, n) + off[None, :]))
    out = np.asarray(_linear_fwd_kernel(by, a, off, n, act, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", FUSED_ACTIVATIONS)
def test_pallas_bwd_fused_kernel_interpret_mode(act):
    """Backward kernel with in-kernel h'(out) matches the jnp formula."""
    rng = np.random.default_rng(7)
    m, n, k = 16, 600, 8
    vals = rng.integers(0, 3, size=(m, n)).astype(np.float32)
    by = jnp.asarray(pack_strided(vals))
    g = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    res = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    ref, ref_off = _bwd_ref(by, g, res, n, act)
    out, d_off = _linear_bwd_kernel(by, g, res, n, act, interpret=True)
    assert _rel(out, ref) < 1e-5
    assert _rel(d_off, ref_off) < 1e-5


@pytest.mark.parametrize(
    "m,n,k",
    [
        (8, 512, 3),  # one group exactly, k far below the dot width 16
        (40, 37, 1),  # n below one group, ragged marker tile
        (104, 1500, 10),  # the genome recipe's m_pad and k; n % 512 != 0
        (200, 4700, 16),  # two backward marker blocks, two chunks
        (256, 700, 33),  # widest m_pad tested; k padded to 64
        (16, 513, 16),  # one individual past a group boundary
        (64, 8192, 32),  # exactly two backward chunks, no ragged tail
    ],
)
def test_kernel_shapes_and_padding(m, n, k):
    """Every padding path of the wrappers: marker rows not a multiple of the
    decode tile, n not a multiple of the 512-individual group or of the
    backward chunk, k padded up to a power of two >= 16."""
    rng = np.random.default_rng(m + n + k)
    vals = rng.integers(0, 3, size=(m, n)).astype(np.float32)
    by = jnp.asarray(pack_strided(vals))
    a = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    off = jnp.asarray(rng.standard_normal(k).astype(np.float32))
    out = _linear_fwd_kernel(by, a, off, n, "identity", interpret=True)
    assert out.shape == (n, k)
    ref = np.asarray(_packed_matmul_ref(by, a, n) + off)
    assert _rel(out, ref) < 1e-5
    g = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    res = jnp.tanh(out)
    da, d_off = _linear_bwd_kernel(by, g, res, n, "tanh", interpret=True)
    assert da.shape == (m, k) and d_off.shape == (k,)
    ref_da, ref_off = _bwd_ref(by, g, res, n, "tanh")
    assert _rel(da, ref_da) < 1e-5
    assert _rel(d_off, ref_off) < 1e-5


def test_kernels_vmap_over_branches():
    """The sweep vmaps the kernels over a block's branches (an extra grid
    axis); each branch must equal its own unbatched call."""
    rng = np.random.default_rng(11)
    G, m, n, k = 3, 24, 900, 8
    vals = rng.integers(0, 3, size=(G, m, n)).astype(np.float32)
    by = jnp.asarray(np.stack([pack_strided(v) for v in vals]))
    a = jnp.asarray(rng.standard_normal((G, m, k)).astype(np.float32))
    off = jnp.asarray(rng.standard_normal((G, k)).astype(np.float32))
    out = jax.vmap(
        lambda b, a_, o: _linear_fwd_kernel(b, a_, o, n, "relu", interpret=True)
    )(by, a, off)
    da, d_off = jax.vmap(
        lambda b, g_, r: _linear_bwd_kernel(b, g_, r, n, "relu", interpret=True)
    )(by, out, out)
    for g in range(G):
        o1 = _linear_fwd_kernel(by[g], a[g], off[g], n, "relu", interpret=True)
        np.testing.assert_array_equal(np.asarray(out[g]), np.asarray(o1))
        d1, do1 = _linear_bwd_kernel(by[g], o1, o1, n, "relu", interpret=True)
        np.testing.assert_array_equal(np.asarray(da[g]), np.asarray(d1))
        np.testing.assert_array_equal(np.asarray(d_off[g]), np.asarray(do1))


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_dispatch_kernel_on_gpu_reference_elsewhere(platform):
    """packed_linear and its VJP lower to the Triton kernels for an NVIDIA
    GPU and to the plain XLA reference for any other platform."""
    m, n, k = 104, 3000, 10
    by = jnp.zeros((2, m, -(-n // 512) * 128), jnp.uint8)

    def loss(a, off):
        out = jax.vmap(
            lambda b, a_, o: packed_linear(b, a_, o, n, "tanh")
        )(by, a, off)
        return jnp.sum(out * out)

    f = jax.jit(jax.grad(loss, argnums=(0, 1)))
    hlo = f.trace(
        jnp.zeros((2, m, k)), jnp.zeros((2, k))
    ).lower(lowering_platforms=(platform,)).as_text()
    kernels = [name in hlo for name in ("packed_linear_fwd", "packed_linear_bwd")]
    assert kernels == ([True, True] if platform == "cuda" else [False, False])


@pytest.mark.parametrize("act", ["tanh", "relu", "leaky_relu", "silu", "identity"])
@pytest.mark.parametrize("widths,n", [((24, 16, 8, 1), 384), ((16, 8, 1), 300)])
def test_branch_value_and_grad_matches_dense(interpret_kernels, act, widths, n):
    """A full branch value-and-grad (the leapfrog's potential) on 2-bit
    packed genotypes, through packed_linear with the Triton kernels in
    interpret mode, against dense autodiff on the standardized matrix."""
    rng = np.random.default_rng(0)
    m = widths[0]
    geno = rng.integers(0, 3, size=(m, n)).astype(np.float32)
    mu, sd = geno.mean(axis=1), geno.std(axis=1)
    scale = np.where(sd > 0, 1.0 / np.maximum(sd, 1e-12), 0.0).astype(np.float32)
    x_dense = jnp.asarray(((geno - mu[:, None]) * scale[:, None]).T)
    x_packed = D.PackedX(
        jnp.asarray(pack_strided(geno)), jnp.asarray(scale),
        jnp.asarray(mu.astype(np.float32)), n,
    )
    ws = tuple(
        jnp.asarray(rng.standard_normal((widths[i], widths[i + 1])) * 0.3,
                    jnp.float32)
        for i in range(len(widths) - 1)
    )
    bs = tuple(
        jnp.asarray(rng.standard_normal((widths[i + 1],)) * 0.1, jnp.float32)
        for i in range(len(widths) - 2)
    )
    lam = tuple(jnp.ones_like(w) for w in ws)
    y = jnp.asarray(rng.standard_normal(n), jnp.float32)
    vg = jax.value_and_grad(D.potential_fn("ridge_base", act), argnums=(0, 1))
    v_d, (gw_d, gb_d) = vg(ws, bs, lam, jnp.float32(1.3), x_dense, y)
    v_p, (gw_p, gb_p) = vg(ws, bs, lam, jnp.float32(1.3), x_packed, y)
    np.testing.assert_allclose(v_p, v_d, rtol=1e-5)
    for a_, b_ in zip(gw_p + gb_p, gw_d + gb_d):
        np.testing.assert_allclose(a_, b_, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_kernels_compiled_on_card(gpu):
    """The kernels as compiled for the card, at the genome recipe's width,
    against the plain reference (chip_smoke.py runs the same check)."""
    rng = np.random.default_rng(0)
    m, n, k = 104, 100_000, 16
    by = jnp.asarray(pack_strided(rng.integers(0, 3, size=(m, n))))
    a = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    off = jnp.asarray(rng.standard_normal(k).astype(np.float32))
    out = jax.jit(lambda *x: _linear_fwd_kernel(*x, n, "identity"))(by, a, off)
    ref = np.asarray(_packed_matmul_ref(by, a, n) + off)
    assert _rel(out, ref) < 1e-5
    g = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    res = jnp.tanh(out)
    da, d_off = jax.jit(lambda *x: _linear_bwd_kernel(*x, n, "tanh"))(by, g, res)
    ref_da, ref_off = _bwd_ref(by, g, res, n, "tanh")
    assert _rel(da, ref_da) < 1e-5 and _rel(d_off, ref_off) < 1e-5


def test_split3_pieces_sum_exactly():
    """The three bf16 pieces of each f32 kernel operand sum back to it
    exactly, so dots against exact bf16 genotypes lose nothing."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(
        rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
        jnp.float32,
    )
    lo, mid, hi = P._split3(x)
    back = (hi.astype(jnp.float32) + mid.astype(jnp.float32)) + lo.astype(
        jnp.float32
    )
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_decode_part_is_strided_layout():
    """Bit pair q of byte column j holds individual q*128 + j of its group,
    decoded by the 2-bit lookup exactly as unpack_strided does."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 3, size=(5, 1024)).astype(np.float32)
    by = jnp.asarray(pack_strided(vals)).astype(jnp.int32)
    for g in range(2):
        tile = by[:, g * 128:(g + 1) * 128]
        for q in range(4):
            part = np.asarray(P._decode_part(tile, q).astype(jnp.float32))
            cols = g * 512 + q * 128 + np.arange(128)
            np.testing.assert_array_equal(part, vals[:, cols])


@pytest.mark.parametrize("act", FUSED_ACTIVATIONS)
def test_packed_linear_gradient_through_kernels(interpret_kernels, act):
    """packed_linear's custom VJP with both Triton kernels (interpret mode)
    matches autodiff of the unfused math."""
    rng = np.random.default_rng(6)
    m, n, k = 12, 700, 5
    vals = rng.integers(0, 3, size=(m, n)).astype(np.float32)
    by = jnp.asarray(pack_strided(vals))
    a = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32) * 0.3)
    off = jnp.asarray(rng.standard_normal(k).astype(np.float32))
    ct = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))

    def fused(a_, off_):
        return jnp.vdot(packed_linear(by, a_, off_, n, act), ct)

    def unfused(a_, off_):
        dec = unpack_strided(by, n)
        z = jax.lax.dot_general(
            dec, a_, (((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        ) + off_[None, :]
        return jnp.vdot(_act_apply(act, z), ct)

    ga, go = jax.grad(fused, argnums=(0, 1))(a, off)
    ra, ro = jax.grad(unfused, argnums=(0, 1))(a, off)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(ra), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(go), np.asarray(ro), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", FUSED_ACTIVATIONS)
def test_packed_linear_gradient(act):
    """Custom VJP of the fused op matches autodiff of the unfused math
    (the plain reference path the CPU dispatches to)."""
    rng = np.random.default_rng(5)
    m, n, k = 12, 70, 4
    vals = rng.integers(0, 3, size=(m, n)).astype(np.float32)
    by = jnp.asarray(pack_strided(vals))
    a = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    off = jnp.asarray(rng.standard_normal(k).astype(np.float32))
    ct = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))

    def fused(a_, off_):
        return jnp.vdot(packed_linear(by, a_, off_, n, act), ct)

    def unfused(a_, off_):
        dec = unpack_strided(by, n)
        z = jax.lax.dot_general(dec, a_, (((0,), (0,)), ((), ()))) + off_[None, :]
        return jnp.vdot(_act_apply(act, z), ct)

    ga, go = jax.grad(fused, argnums=(0, 1))(a, off)
    ra, ro = jax.grad(unfused, argnums=(0, 1))(a, off)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(ra), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(go), np.asarray(ro), rtol=1e-4, atol=1e-5)


def test_packed_analysis_matches_dense():
    """effect_sizes / branch_r2s / activations / gradients agree between the
    dense and 2-bit packed genotype forms (VERDICT r1 #6: the analysis
    surface must not force the dense materialization at genome scale)."""
    from rs_bann_tpu.io.bed import BedVM
    from rs_bann_tpu.group.grouping import UniformGrouping
    from rs_bann_tpu.models import density as D
    from rs_bann_tpu.models.arch import NetArch
    from rs_bann_tpu.models.data import pack_stacked
    from rs_bann_tpu.models.init import InitCfg, init_net
    from rs_bann_tpu.models.net import Net

    G, m, n, h = 3, 10, 64, 4
    bed = BedVM.random(n, G * m, seed=3)
    grouping = UniformGrouping(G, m)
    arch = NetArch.uniform(G, m, h, 1, h)
    state, _ = init_net(arch, "ridge_base", InitCfg(seed=2))
    net = Net("ridge_base", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(n).astype(np.float32)

    from rs_bann_tpu.io.genotypes import CompressedGenotypes

    gen = CompressedGenotypes(bed, grouping)
    dense = gen.to_stacked(arch, y)
    packed = pack_stacked(arch, bed, grouping, y)

    es_d = np.asarray(net.effect_sizes(dense.X))
    es_p = np.asarray(net.effect_sizes(packed.X))
    np.testing.assert_allclose(es_p, es_d, rtol=1e-4, atol=1e-5)

    r2_d = np.asarray(net.branch_r2s(dense.X, dense.y))
    r2_p = np.asarray(net.branch_r2s(packed.X, packed.y))
    np.testing.assert_allclose(r2_p, r2_d, rtol=1e-4, atol=1e-5)

    pes_d = net.population_effect_sizes(dense.X)
    pes_p = net.population_effect_sizes(packed.X)
    np.testing.assert_allclose(pes_p, pes_d, rtol=1e-4, atol=1e-5)

    acts_d = net.activations(dense.X)
    acts_p = net.activations(packed.X)
    for g in range(G):
        for l in range(arch.num_layers):
            np.testing.assert_allclose(
                acts_p[g][l], acts_d[g][l], rtol=1e-4, atol=1e-5
            )

    gr_d = net.gradients(dense.X, dense.y)
    gr_p = net.gradients(packed.X, packed.y)
    for g in range(G):
        for a, b in zip(gr_d[g][0], gr_p[g][0]):
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
