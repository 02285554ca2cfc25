"""Fused 2-bit genotype decode + matmul (Pallas kernels through Triton).

The reference decodes bed bytes on the host and uploads a dense standardized
f32 submatrix per branch update (/root/reference/src/io/bed.rs:325-355). Here
the 2-bit codes stay packed in device memory — 16x less memory and 16x less
traffic than f32, which is what makes genome-scale inputs (460k x 10k ≈
1.15 GB packed vs 18 GB dense) resident — and each kernel block decodes its
tile of bytes in registers right before the tensor-core dot. The decoded
[m, n] f32 block is never written to device memory.

Layout: PLINK's byte order interleaves 4 consecutive individuals per byte.
The host repacks into a *group-strided* layout: individuals are grouped in
blocks of 512; within a group, byte j holds individuals (j, j+128, j+256,
j+384) in bit pairs (0, 2, 4, 6). Decoding bit pair q of a [rows, 128]-byte
tile gives the genotypes of 128 consecutive individuals, so each of the four
parts feeds one dot whose rows are a contiguous block of the output.

Standardization never appears in the kernel: for standardized X_std with
column means μ and stds σ,

    X_std @ W = decode(bytes) @ (W / σ[:,None]) − (μ/σ) @ W

so the caller folds 1/σ into the weights and the rank-1 correction into a
per-feature offset (models/density.py PackedX). The same decode with the
transposed contraction is the custom-VJP backward:

    d/dW [decode(bytes) @ W] = decode(bytes) contracted with the cotangent

2-bit decode (io/bed.rs lookup semantics): code 00→2, 01→0 (missing,
impute-beforehand contract), 10→1, 11→0.

Precision: decoded genotypes {0, 1, 2} are exact in bf16, so each kernel dot
splits its f32 operand into three bf16 pieces (8 + 8 + 8 mantissa bits) and
runs three bf16 tensor-core dots with f32 accumulation: every product is
exact and the result matches an f32 (``Precision.HIGHEST``) dot up to f32
summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

GROUP = 512  # individuals per strided group
GBYTES = GROUP // 4  # bytes per group

# genotype value -> 2-bit code and back (io/bed.rs:16)
_VALUE_TO_CODE = np.array([0b11, 0b10, 0b00], np.uint8)


def _decode_codes(codes):
    """2-bit code -> genotype value, branchless: v = (c==0)*2 + (c==2)."""
    return (codes == 0).astype(jnp.float32) * 2.0 + (codes == 2).astype(jnp.float32)


def unpack_bytes(bytes_mb: jax.Array, n: int) -> jax.Array:
    """Standard PLINK byte order: [m, B] uint8 -> [m, n] f32 genotypes."""
    b = bytes_mb.astype(jnp.int32)
    parts = [(b >> (2 * i)) & 0b11 for i in range(4)]
    codes = jnp.stack(parts, axis=-1).reshape(b.shape[0], b.shape[1] * 4)
    return _decode_codes(codes)[:, :n]


# ------------------------------------------------------- strided layout


def pack_strided(vals: np.ndarray) -> np.ndarray:
    """[m, n] genotypes {0,1,2} -> group-strided packed [m, ceil(n/512)*128].

    Within each 512-individual group, byte j carries individuals
    (j, j+128, j+256, j+384) in bit pairs (0, 2, 4, 6). Missing tail
    individuals get code 01 (decodes to 0).
    """
    m, n = vals.shape
    ngroups = -(-n // GROUP)
    codes = np.full((m, ngroups * GROUP), 0b01, np.uint8)
    codes[:, :n] = _VALUE_TO_CODE[vals.astype(np.int64)]
    codes = codes.reshape(m, ngroups, 4, GBYTES)  # [m, g, quarter, j]
    out = (
        codes[:, :, 0, :]
        | (codes[:, :, 1, :] << 2)
        | (codes[:, :, 2, :] << 4)
        | (codes[:, :, 3, :] << 6)
    )
    return np.ascontiguousarray(out.reshape(m, ngroups * GBYTES))


def unpack_strided(bytes_mb: jax.Array, n: int) -> jax.Array:
    """Group-strided packed [m, B] -> [m, n] f32 genotypes."""
    m, B = bytes_mb.shape
    ngroups = B // GBYTES
    b = bytes_mb.astype(jnp.int32).reshape(m, ngroups, GBYTES)
    parts = [(b >> (2 * i)) & 0b11 for i in range(4)]
    codes = jnp.concatenate(parts, axis=-1)  # [m, g, 512]
    return _decode_codes(codes).reshape(m, ngroups * GROUP)[:, :n]


# ------------------------------------------------------- plain reference

_HIGHEST = jax.lax.Precision.HIGHEST


def _packed_matmul_ref(bytes_mb, a, n):
    """Z[n, k] = decode(bytes)[m, :n] as [n, m] @ A[m, k]."""
    dec = unpack_strided(bytes_mb, n)  # [m, n]
    return jax.lax.dot_general(
        dec, a, (((0,), (0,)), ((), ())), precision=_HIGHEST,
        preferred_element_type=jnp.float32,
    )


# Activations whose derivative is recoverable from the *output* value alone.
# These fuse into the kernel epilogue with only the activation saved as the
# VJP residual (silu needs the pre-activation, so it is not fused).
FUSED_ACTIVATIONS = ("identity", "relu", "leaky_relu", "tanh")


def _act_apply(act, z):
    if act == "identity":
        return z
    if act == "relu":
        return z * (z > 0)
    if act == "leaky_relu":
        return z * (z > 0) + 0.01 * z * (z < 0)
    if act == "tanh":
        return jnp.tanh(z)
    raise ValueError(f"activation not fusable: {act}")


def _act_prime_from_out(act, out):
    """h'(z) reconstructed from a = h(z); exact for the fused activations
    (at a==0 the subgradient 0 is used, matching jax.grad of x*(x>0) etc.)."""
    if act == "identity":
        return jnp.ones_like(out)
    if act == "relu":
        return (out > 0).astype(out.dtype)
    if act == "leaky_relu":
        return jnp.where(out > 0, 1.0, jnp.where(out < 0, 0.01, 0.0)).astype(out.dtype)
    if act == "tanh":
        return 1.0 - out * out
    raise ValueError(f"activation not fusable: {act}")


def _linear_ref(bytes_mb, a, off, n, act):
    return _act_apply(act, _packed_matmul_ref(bytes_mb, a, n) + off[None, :])


def _linear_bwd_ref(bytes_mb, g, out, n, act):
    """(da, d_off) of packed_linear for cotangent g at output out."""
    dz = g * _act_prime_from_out(act, out)
    da = jax.lax.dot_general(
        unpack_strided(bytes_mb, n), dz, (((1,), (0,)), ((), ())),
        precision=_HIGHEST, preferred_element_type=jnp.float32,
    )
    return da, jnp.sum(dz, axis=0)


# ---------------------------------------------------------- triton kernels
#
# Forward: one block per 512-individual group owns its [512, k] output tile
# and loops over the marker axis in BM-row tiles, so every output element is
# written once. Backward: the reduction runs over individuals, so one block
# per (chunk of CHUNK groups, MB marker rows) loops over its groups and
# writes a [MB, k] partial that XLA sums afterwards (no atomics: seeded runs
# stay reproducible); the chunks give the card enough blocks to fill its SMs
# at biobank n. CHUNK and the warp count were chosen on an H100 at the
# genome recipe's shapes (PERF.md).

_BM = 32  # marker rows per decode tile (tensor-core dot depth >= 16)
_MB = 128  # marker rows per backward block (wider branches add blocks)
_CHUNK = 4  # strided groups (x512 individuals) per backward block
_NUM_WARPS = 4


def _cdiv(a, b):
    return -(-a // b)


def _kpad(k):
    """Feature width inside the kernel: a power of two >= 16 (dot width)."""
    return max(16, 1 << (int(k) - 1).bit_length())


def _decode_part(b, q):
    """Bit pair q of an int32 byte tile -> genotypes as bf16 (exact).

    Value map {00->2, 01->0, 10->1, 11->0} as a 2-bit lookup packed into the
    constant 18 = 0b01_00_00_10: v = (18 >> 2c) & 3.
    """
    c = (b >> (2 * q)) & 0b11
    return ((18 >> (c + c)) & 0b11).astype(jnp.float32).astype(jnp.bfloat16)


def _split3(x):
    """f32 -> three bf16 pieces, smallest first, summing to x (24 bits)."""
    hi = x.astype(jnp.bfloat16)
    r = x - hi.astype(jnp.float32)
    mid = r.astype(jnp.bfloat16)
    lo = (r - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return lo, mid, hi


def _dot3(dec, pieces, trans_a=False):
    """dec @ (sum of pieces) with f32 accumulation; exact products."""
    from jax.experimental import pallas as pl

    acc = None
    for p in pieces:
        d = pl.dot(dec, p, trans_a=trans_a)
        acc = d if acc is None else acc + d
    return acc


def _fwd_kernel(bytes_ref, a_ref, off_ref, out_ref, *, m, k, n, act):
    """out[512 rows of group gi, :k] = act(dec(bytes)ᵀ @ a + off)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    gi = pl.program_id(0)
    kp = a_ref.shape[1]

    def body(j, accs):
        rows = j * _BM + jnp.arange(_BM)
        b = plgpu.load(
            bytes_ref.at[pl.ds(j * _BM, _BM), pl.ds(gi * GBYTES, GBYTES)],
            mask=(rows < m)[:, None], other=0,
        ).astype(jnp.int32)
        pieces = _split3(a_ref[pl.ds(j * _BM, _BM), :])
        return tuple(
            acc + _dot3(_decode_part(b, q), pieces, trans_a=True)
            for q, acc in enumerate(accs)
        )

    zero = jnp.zeros((GBYTES, kp), jnp.float32)
    accs = jax.lax.fori_loop(0, _cdiv(m, _BM), body, (zero,) * 4)
    off = off_ref[...][None, :]
    cols = jnp.arange(kp) < k
    for q in range(4):
        r0 = gi * GROUP + q * GBYTES
        rows = r0 + jnp.arange(GBYTES)
        plgpu.store(
            out_ref.at[pl.ds(r0, GBYTES), pl.ds(0, kp)],
            _act_apply(act, accs[q] + off),
            mask=(rows < n)[:, None] & cols[None, :],
        )


def _bwd_kernel(bytes_ref, g_ref, res_ref, da_ref, doff_ref, *, m, k, n, act,
                ngroups, n_mtiles):
    """Partials over chunk ci of CHUNK groups: da = dec @ dz, d_off = Σ dz,
    with dz = g ⊙ act'(res) formed in registers."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    ci, mb = pl.program_id(0), pl.program_id(1)
    kp = da_ref.shape[2]
    m0 = mb * n_mtiles * _BM
    cols = jnp.arange(kp) < k
    g_last = jnp.minimum((ci + 1) * _CHUNK, ngroups)

    def body(gi, carry):
        accs, dsum = carry
        dzs = []
        for q in range(4):
            r0 = gi * GROUP + q * GBYTES
            mask = ((r0 + jnp.arange(GBYTES)) < n)[:, None] & cols[None, :]
            idx = (pl.ds(r0, GBYTES), pl.ds(0, kp))
            dz = plgpu.load(g_ref.at[idx], mask=mask, other=0.0)
            if act != "identity":
                res = plgpu.load(res_ref.at[idx], mask=mask, other=0.0)
                dz = dz * _act_prime_from_out(act, res)
            dsum = dsum + jnp.sum(dz, axis=0)
            dzs.append(_split3(dz))
        new = []
        for t in range(n_mtiles):
            r0 = m0 + t * _BM
            rows = r0 + jnp.arange(_BM)
            b = plgpu.load(
                bytes_ref.at[pl.ds(r0, _BM), pl.ds(gi * GBYTES, GBYTES)],
                mask=(rows < m)[:, None], other=0,
            ).astype(jnp.int32)
            acc = accs[t]
            for q in range(4):
                acc = acc + _dot3(_decode_part(b, q), dzs[q])
            new.append(acc)
        return tuple(new), dsum

    zero = jnp.zeros((_BM, kp), jnp.float32)
    accs, dsum = jax.lax.fori_loop(
        ci * _CHUNK, g_last, body,
        ((zero,) * n_mtiles, jnp.zeros((kp,), jnp.float32)),
    )
    for t in range(n_mtiles):
        da_ref[ci, pl.ds(m0 + t * _BM, _BM), :] = accs[t]

    @pl.when(mb == 0)
    def _():
        doff_ref[ci, :] = dsum


def _linear_fwd_kernel(bytes_mb, a, off, n, act, interpret=False):
    """out[n, k] = act(decode(bytes)[:, :n]ᵀ @ a + off) — Triton kernel."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    m, B = bytes_mb.shape
    k = a.shape[1]
    assert B % GBYTES == 0 and n <= B * 4
    kp, mt = _kpad(k), _cdiv(m, _BM) * _BM
    a_p = jnp.zeros((mt, kp), jnp.float32).at[:m, :k].set(a)
    off_p = jnp.zeros((kp,), jnp.float32).at[:k].set(off)
    return pl.pallas_call(
        functools.partial(_fwd_kernel, m=m, k=k, n=n, act=act),
        out_shape=jax.ShapeDtypeStruct((n, k), jnp.float32),
        grid=(_cdiv(n, GROUP),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="packed_linear_fwd",
    )(bytes_mb, a_p, off_p)


def _linear_bwd_kernel(bytes_mb, g, res, n, act, interpret=False):
    """(da[m, k], d_off[k]) for cotangent g [n, k] at output res — Triton
    kernel writing per-chunk partials, summed here."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    m, B = bytes_mb.shape
    k = g.shape[1]
    ngroups = _cdiv(n, GROUP)
    nchunks = _cdiv(ngroups, _CHUNK)
    kp, mt = _kpad(k), _cdiv(m, _BM) * _BM
    mb_rows = min(mt, _MB)
    n_mblocks = _cdiv(mt, mb_rows)
    da_p, doff_p = pl.pallas_call(
        functools.partial(
            _bwd_kernel, m=m, k=k, n=n, act=act, ngroups=ngroups,
            n_mtiles=mb_rows // _BM,
        ),
        out_shape=(
            jax.ShapeDtypeStruct((nchunks, n_mblocks * mb_rows, kp),
                                 jnp.float32),
            jax.ShapeDtypeStruct((nchunks, kp), jnp.float32),
        ),
        grid=(nchunks, n_mblocks),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="packed_linear_bwd",
    )(bytes_mb, g, res)
    return jnp.sum(da_p, axis=0)[:m, :k], jnp.sum(doff_p, axis=0)[:k]


# --------------------------------------------------------------- dispatch


def _on_cuda(kernel_fn, ref_fn, *args):
    """The Triton kernel where the computation lowers for an NVIDIA GPU, the
    plain reference on every other platform (decided at lowering)."""
    return jax.lax.platform_dependent(*args, cuda=kernel_fn, default=ref_fn)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def packed_linear(bytes_mb, a, off, n, act):
    """out[n, k] = act(decode_strided(bytes_mb)[:, :n]ᵀ @ a + off[None, :]).

    The fused layer-0 op: 2-bit decode, matmul, per-feature offset (bias
    plus the rank-1 standardization correction folded in by the caller,
    models/density.py), and activation in one kernel — the pre-activation
    never touches device memory. ``act`` must be in FUSED_ACTIVATIONS (its
    derivative is reconstructed from the output in the backward pass).
    ``bytes_mb`` must be in the group-strided layout (pack_strided);
    individuals beyond n decode to 0 (missing code). Differentiable in ``a``
    and ``off``.
    """
    assert act in FUSED_ACTIVATIONS, act
    return _on_cuda(
        functools.partial(_linear_fwd_kernel, n=n, act=act),
        functools.partial(_linear_ref, n=n, act=act),
        bytes_mb, a, off,
    )


def _pl_fwd(bytes_mb, a, off, n, act):
    out = packed_linear(bytes_mb, a, off, n, act)
    return out, (bytes_mb, out)


def _pl_bwd(n, act, res, g):
    bytes_mb, out = res
    da, d_off = _on_cuda(
        functools.partial(_linear_bwd_kernel, n=n, act=act),
        functools.partial(_linear_bwd_ref, n=n, act=act),
        bytes_mb, g, out,
    )
    return None, da, d_off


packed_linear.defvjp(_pl_fwd, _pl_bwd)


def packed_matmul(bytes_mb, a, n):
    """Z[n, k] = decode_strided(bytes_mb)[m, :n] (as [n, m]) @ a[m, k].

    Differentiable in ``a`` only (the identity case of packed_linear).
    """
    return packed_linear(bytes_mb, a, jnp.zeros((a.shape[1],), a.dtype), n,
                         "identity")
