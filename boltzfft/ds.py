"""Double-single ("ds") arithmetic: ~2x-precision floats from hardware pairs.

The 64^3 configuration's *method* error is 3.1e-12 — three decades below the
f32 floor.  This module reaches it from float32 arithmetic alone: every value
is an unevaluated sum
``hi + lo`` of two hardware floats with ``|lo| <= ulp(hi)/2``, giving ~2x the
hardware mantissa (f32 pairs ~ 48-49 bits ~ 1e-14 relative).  All primitives
are the classical error-free transformations (Dekker 1971, Knuth TAOCP 4.2.2;
the same algebra as CUDA's ``double-single`` and the QD library's
``dd_real``), expressed as branch-free jnp elementwise ops so they vectorize
and compose under jit/vmap/scan.

Used by :mod:`boltzfft.ds_operator` for the compensated collision pipeline
(``CollisionConfig`` companion path) — a float32-pair counterpart of the
reference's native-f64 FFTW backend (``FFTWBoltzmannOperator.cpp``).

Correctness requirement: IEEE-correct rounding of +,-,* at the working dtype.
XLA does not reassociate user arithmetic; an FMA fusion of ``a*b - p`` only
*improves* ``two_prod``'s residual.  The test suite checks the invariants
numerically, and ``chip_smoke.py`` checks the pipeline's digits on the GPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class DS(NamedTuple):
    """A double-single array: value = hi + lo (element-wise, non-overlapping)."""

    hi: jnp.ndarray
    lo: jnp.ndarray


class CDS(NamedTuple):
    """A complex double-single array."""

    re: DS
    im: DS


# ---------------------------------------------------------------------------
# error-free transformations (elementwise, broadcasting)
# ---------------------------------------------------------------------------


_NEXP_BITS = {np.dtype(np.float32): 8, np.dtype(np.float64): 11}


def _opaque(x):
    """Pin a rounded intermediate to its storage format.

    The error-free transformations below are *numerically* meaningful only if
    ``s = fl(a + b)`` / ``p = fl(a * b)`` denote single correctly-rounded
    values used consistently by every consumer.  XLA:CPU breaks this two
    ways: fusions duplicate cheap producers into consumers and LLVM then
    FMA-contracts ``a*b +- c`` differently per duplicate (observed: the
    compensation terms of ``quick_two_sum`` stop matching the materialized
    sum, collapsing the pipeline back to ~2^-24).  ``lax.reduce_precision``
    to the dtype's own (exp, mant) layout is an explicit rounding op the
    compiler must honor on every copy — semantically an identity, but it
    pins each EFT intermediate to one IEEE value.  (A plain
    ``optimization_barrier`` is NOT sufficient: it vanishes during fusion and
    duplication proceeds; measured in the ds test suite.)
    """
    x = jnp.asarray(x)
    return jax.lax.reduce_precision(
        x, _NEXP_BITS[x.dtype], np.finfo(x.dtype).nmant
    )


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth/Moller, 6 flops)."""
    s = _opaque(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """two_sum assuming |a| >= |b| (3 flops)."""
    s = _opaque(a + b)
    e = b - (s - a)
    return s, e


def _split_factor(dtype) -> float:
    # 2^ceil(p/2) + 1 for a p-bit mantissa (Dekker splitting constant)
    p = np.finfo(dtype).nmant + 1  # 24 for f32, 53 for f64
    return float(2 ** ((p + 1) // 2) + 1)


def split(a):
    """a == h + l with h, l each holding ~half the mantissa bits."""
    c = _opaque(jnp.asarray(a) * _split_factor(jnp.asarray(a).dtype))
    h = _opaque(c - (c - a))
    return h, a - h


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker, ~17 flops; an XLA FMA
    rewrite of the leading ``ah*bh - p`` term only tightens the residual)."""
    p = _opaque(a * b)
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# ds arithmetic
# ---------------------------------------------------------------------------


def from_float(a) -> DS:
    """Promote a hardware float array (exact: lo = 0)."""
    a = jnp.asarray(a)
    return DS(a, jnp.zeros_like(a))


def from_f64(a: np.ndarray, dtype=np.float32) -> DS:
    """Split a host float64 array into a ds pair of ``dtype`` (hi = round(a),
    lo = round(a - hi)); relative representation error ~2^-2p."""
    a = np.asarray(a, np.float64)
    hi = a.astype(dtype)
    lo = (a - hi.astype(np.float64)).astype(dtype)
    return DS(jnp.asarray(hi), jnp.asarray(lo))


def to_f64(x: DS) -> np.ndarray:
    """Exact host reconstruction (f64 holds an f32 pair exactly)."""
    return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)


def zeros(shape, dtype=jnp.float32) -> DS:
    z = jnp.zeros(shape, dtype)
    return DS(z, z)


def neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def add(x: DS, y: DS) -> DS:
    """IEEE-style ds add (11 flops, error O(2^-2p))."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    s, e = quick_two_sum(s, e)
    return DS(s, e)


def sub(x: DS, y: DS) -> DS:
    return add(x, neg(y))


def mul(x: DS, y: DS) -> DS:
    """ds multiply (~25 flops; drops only the lo*lo term, O(2^-2p))."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    p, e = quick_two_sum(p, e)
    return DS(p, e)


def mul_f(x: DS, a) -> DS:
    """ds times a plain hardware float (exact split of the single product)."""
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    p, e = quick_two_sum(p, e)
    return DS(p, e)


# ---------------------------------------------------------------------------
# complex ds
# ---------------------------------------------------------------------------


def cds_from_f64(a: np.ndarray, dtype=np.float32) -> CDS:
    return CDS(from_f64(a.real, dtype), from_f64(a.imag, dtype))


def cds_from_real(x: DS) -> CDS:
    z = DS(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))
    return CDS(x, z)


def cds_to_c128(x: CDS) -> np.ndarray:
    return to_f64(x.re) + 1j * to_f64(x.im)


def czeros(shape, dtype=jnp.float32) -> CDS:
    return CDS(zeros(shape, dtype), zeros(shape, dtype))


def cadd(x: CDS, y: CDS) -> CDS:
    return CDS(add(x.re, y.re), add(x.im, y.im))


def cmul(x: CDS, y: CDS) -> CDS:
    return CDS(
        sub(mul(x.re, y.re), mul(x.im, y.im)),
        add(mul(x.re, y.im), mul(x.im, y.re)),
    )


def cconj(x: CDS) -> CDS:
    return CDS(x.re, neg(x.im))


def cmul_both(a: CDS, f: CDS) -> tuple:
    """``(a * f, conj(a) * f)`` sharing the four component products.

    The collision pipeline needs both ``alpha1 * f_hat`` and
    ``conj(alpha1) * f_hat`` (``FFTWBoltzmannOperator.cpp:204-225``); the
    naive pair costs 8 ds multiplies, this costs 4 (the products
    ``ar*fr, ai*fi, ar*fi, ai*fr`` are shared — only the add/sub
    combinations differ).
    """
    rr = mul(a.re, f.re)
    ii = mul(a.im, f.im)
    ri = mul(a.re, f.im)
    ir = mul(a.im, f.re)
    t1 = CDS(sub(rr, ii), add(ri, ir))
    t2 = CDS(add(rr, ii), sub(ri, ir))
    return t1, t2


def cmul_ds(x: CDS, w: DS) -> CDS:
    """Complex ds times real ds."""
    return CDS(mul(x.re, w), mul(x.im, w))


# ---------------------------------------------------------------------------
# linear algebra: last-axis contraction and 3-D tensor transforms
# ---------------------------------------------------------------------------


def _index_last(x: DS, k, n_keep=1):
    hi = jax.lax.dynamic_slice_in_dim(x.hi, k, n_keep, axis=-1)
    lo = jax.lax.dynamic_slice_in_dim(x.lo, k, n_keep, axis=-1)
    return DS(hi, lo)


def _row(m: DS, k):
    hi = jax.lax.dynamic_slice_in_dim(m.hi, k, 1, axis=0)[0]
    lo = jax.lax.dynamic_slice_in_dim(m.lo, k, 1, axis=0)[0]
    return DS(hi, lo)


def contract_last(
    x: CDS, m: CDS, block: int = 1,
    real_in: bool = False, real_out: bool = False,
) -> CDS:
    """``out[..., l] = sum_k x[..., k] * m[k, l]`` in full ds arithmetic.

    The contraction runs as a ``fori_loop`` of rank-1 updates (elementwise
    work — the compensated accumulation cannot ride the matrix units, whose f32
    accumulator is exactly the precision being escaped).  ``block`` rank-1
    updates are unrolled per loop iteration, fusing into one accumulator pass
    (divides the dominant HBM read-modify-write cost by ``block``) at the
    price of a much larger loop body: XLA:CPU compile time explodes past
    block≈4 on the full pipeline (measured 20 s -> >900 s at block=8), so the
    default stays 1; the update order — hence the bits — is identical for
    every block.

    ``real_in`` skips the imaginary input plane (treated as exactly zero);
    ``real_out`` skips computing the imaginary output (returned as zeros).
    Both are exact structure exploits — the collision pipeline's shifted
    convolution factors are real for real ``f`` (Hermitian spectra), the
    same fact the rfft impl rides.
    """
    n = m.re.hi.shape[0]
    out_shape = x.re.hi.shape[:-1] + (m.re.hi.shape[1],)
    acc0 = czeros(out_shape, x.re.hi.dtype)

    def update(k, acc):
        xr = _index_last(x.re, k)  # (..., 1)
        mr, mi = _row(m.re, k), _row(m.im, k)  # (M,)
        if real_in:
            re = mul(xr, mr)
            im = None if real_out else mul(xr, mi)
        else:
            xi = _index_last(x.im, k)
            re = sub(mul(xr, mr), mul(xi, mi))
            im = None if real_out else add(mul(xr, mi), mul(xi, mr))
        return CDS(
            add(acc.re, re),
            acc.im if im is None else add(acc.im, im),
        )

    b = max(1, min(block, n))

    def body(j, acc):
        k0 = j * b
        for t in range(b):  # unrolled: one fused accumulator pass
            acc = update(k0 + t, acc)
        return acc

    acc = jax.lax.fori_loop(0, n // b, body, acc0)
    for k in range(n - n % b, n):  # remainder
        acc = update(k, acc)
    return acc


def _swap_last2(x: CDS) -> CDS:
    f = lambda a: jnp.swapaxes(a, -1, -2)
    return CDS(DS(f(x.re.hi), f(x.re.lo)), DS(f(x.im.hi), f(x.im.lo)))


def _roll_axis(x: CDS, src: int, dst: int) -> CDS:
    f = lambda a: jnp.moveaxis(a, src, dst)
    return CDS(DS(f(x.re.hi), f(x.re.lo)), DS(f(x.im.hi), f(x.im.lo)))


def _per_axis(m):
    """Normalize a transform-matrix argument to an (mx, my, mz) triple —
    a single shared CDS matrix (cubic grids) or a per-axis plain tuple
    (anisotropic).  CDS is itself a NamedTuple, so test the type, not
    ``isinstance(m, tuple)``."""
    return (m, m, m) if isinstance(m, CDS) else tuple(m)


def transform3(
    x: CDS, m, block: int = 1,
    real_in: bool = False, real_out: bool = False,
) -> CDS:
    """Separable 3-D transform of the trailing (Nx, Ny, Nz) axes with the
    (N_axis, N_axis) ds matrix/matrices ``m`` (shared or per-axis tuple) —
    the ds analog of ``operator._dft3``.

    ``real_in``: the input's imaginary planes are exactly zero (skips half
    the first contraction); ``real_out``: only the real output is needed
    (skips half the last contraction)."""
    mx, my, mz = _per_axis(m)
    # z (last) axis
    x = contract_last(x, mz, block=block, real_in=real_in)
    # y axis
    x = _swap_last2(contract_last(_swap_last2(x), my, block=block))
    # x axis
    x = _roll_axis(
        contract_last(_roll_axis(x, -3, -1), mx, block=block, real_out=real_out),
        -1, -3,
    )
    return x
