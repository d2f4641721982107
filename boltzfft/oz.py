"""Ozaki-scheme sliced contraction: ds-accuracy matrix products in bfloat16.

The compensated (double-single) pipeline's cost is its contraction — ds
rank-1 updates cost ~300 flops per output element per contraction step
because a float32 matrix product's accumulator is exactly the precision being
escaped (:mod:`boltzfft.ds`).  This module turns the contraction back into
matrix products without giving up the ~49-bit accuracy, using the Ozaki
splitting idea
(error-free matrix multiplication via mantissa slicing, Ozaki et al. 2012;
the same scheme used to get f64-class GEMM out of f16 tensor cores):

* every ds value is split into ``w``-bit mantissa chunks aligned to a
  per-row power-of-two scale.  Each chunk is an integer multiple of a shared
  unit, bounded by ``2^w`` — hence **exactly representable in bfloat16**
  (8 mantissa bits) and fed to a bf16 matrix unit at full rate;
* a chunk-pair product is an integer of at most ``2w`` bits times a shared
  power-of-two unit; summing ``K`` of them grows it by ``log2 K`` bits.  With
  ``w = 7`` and ``K <= 128`` every slice-pair dot product fits a 24-bit f32
  accumulator **without rounding** — the products are exact;
* the few slice-pair results (those with slice-index sum ``i + j <= cmax``)
  are recombined smallest-scale-last with compensated (two_sum) adds —
  O(output) work instead of the old O(output * K).

Truncation error is ``~2^-w(cmax+2)`` relative to the row magnitude, i.e.
ds-class (~2^-49) at the default ``w=7, cmax=7``, while the arithmetic runs
as ``O(cmax^2/2)`` bf16 matrix products.  It answers "the reference links
cuTensor but never uses it" (``CUDABoltzmannOperator.cu:180-188``) one step
further: the tensor-core contraction at beyond-hardware precision.  Exactness
needs every product accumulated in float32: the contractions here ask for
``preferred_element_type=float32`` and HIGHEST precision.

Used by :func:`boltzfft.ds_operator.collide_ds` via ``contract="oz"``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import ds
from .ds import CDS, DS, two_sum, quick_two_sum, _opaque

DEFAULT_W = 7  # chunk width (bits); 7 keeps depth-128 dots + 8-term level sums exact
DEFAULT_SLICES_X = 7  # 49 bits — all of an f32 ds pair
DEFAULT_SLICES_M = 8  # 56 bits — covers a full f64 table entry
DEFAULT_CMAX = 7  # keep slice pairs with i + j <= cmax


class CSlicedMatrix(NamedTuple):
    """A (K, L) complex matrix as bf16 mantissa slices (host-split from f64).

    ``re``/``im``: (nslices, K, L) bfloat16; slice ``j`` holds the ``w``-bit
    mantissa chunk at scale ``sigma * 2^{-w(j+1)}`` (true values — the slices
    sum to the matrix).  The chunk width ``w`` is NOT carried here (it would
    become a traced pytree leaf under jit); all splitters/contractors share
    ``DEFAULT_W`` unless explicitly overridden.
    """

    re: jnp.ndarray
    im: jnp.ndarray


def _host_slices(m: np.ndarray, nslices: int, w: int) -> np.ndarray:
    """Split a real f64 matrix into w-bit chunks of a global pow-2 scale."""
    m = np.asarray(m, np.float64)
    amax = float(np.max(np.abs(m))) if m.size else 0.0
    sigma = 2.0 ** np.ceil(np.log2(amax)) if amax > 0 else 1.0
    r = m.copy()
    out = np.empty((nslices,) + m.shape, np.float32)
    for j in range(nslices):
        u = sigma * 2.0 ** (-w * (j + 1))
        c = np.round(r / u) * u  # multiple of u, |c/u| <= 2^w: bf16-exact
        out[j] = c
        r -= c
    return out


def slice_matrix(
    m: np.ndarray, nslices: int = DEFAULT_SLICES_M, w: int = DEFAULT_W
) -> CSlicedMatrix:
    """Host-split a complex (or real) f64 matrix for :func:`contract_last_oz`."""
    m = np.asarray(m)
    return CSlicedMatrix(
        re=jnp.asarray(_host_slices(m.real, nslices, w), jnp.bfloat16),
        im=jnp.asarray(_host_slices(m.imag, nslices, w), jnp.bfloat16),
    )


def slice_matrix_nodes(
    m: np.ndarray, nslices: int = DEFAULT_SLICES_M, w: int = DEFAULT_W
) -> CSlicedMatrix:
    """Host-split a batch of per-node matrices ``(..., K, L)``.

    Returns slices with the slice axis INSIDE the batch axes —
    ``re/im: (..., nslices, K, L)`` — so the leading node axes stay leading
    (scannable / sub-batch sliceable).  One global power-of-two scale across
    the batch (the phase-folded matrices all share the base matrix's
    magnitude, so per-node scales would buy < 1 bit of the 56-bit depth)."""
    m = np.asarray(m)
    sl = lambda comp: np.moveaxis(_host_slices(comp, nslices, w), 0, -3)
    return CSlicedMatrix(
        re=jnp.asarray(sl(m.real), jnp.bfloat16),
        im=jnp.asarray(sl(m.imag), jnp.bfloat16),
    )


def _pow2_ceil(a: jnp.ndarray) -> jnp.ndarray:
    """Smallest power of two >= a (elementwise, a >= 0), via exponent bits.

    Exponent is clamped into the normal range so the extraction constants
    derived from it stay normal: an all-zero row yields all-zero slices
    through the clamp (the chunks round to zero), not NaNs.
    """
    bits = jax.lax.bitcast_convert_type(a.astype(jnp.float32), jnp.int32)
    exp = (bits >> 23) & 0xFF
    exp = jnp.clip(exp + 1, 64, 254)
    return jax.lax.bitcast_convert_type(exp << 23, jnp.float32)


def slice_ds_last(
    x: DS, nslices: int = DEFAULT_SLICES_X, w: int = DEFAULT_W
) -> jnp.ndarray:
    """Split a ds array into bf16 chunks, scaled per row of the LAST axis.

    Returns (nslices, *x.shape) bfloat16 true-value chunks; chunk ``i`` is an
    integer multiple of ``sigma_row * 2^{-w(i+1)}`` bounded by ``2^w`` times
    that unit.  Extraction is the classical shift trick (add/subtract a
    mid-binade constant whose ulp is the chunk unit) with every rounded
    intermediate pinned via ``lax.reduce_precision`` — the same discipline as
    :mod:`boltzfft.ds`, without which XLA's fusion duplication voids the
    error-free algebra.  The residual after ``nslices`` chunks is
    ``<= sigma * 2^{-w*nslices}`` — for the default 7x7 bits that is every
    bit an f32 pair carries.
    """
    hi = x.hi.astype(jnp.float32)
    lo = x.lo.astype(jnp.float32)
    sigma = _pow2_ceil(jnp.max(jnp.abs(hi), axis=-1, keepdims=True))
    out = []
    r_hi, r_lo = hi, lo
    for i in range(nslices):
        # mid-binade constant: ulp(m_i) = sigma * 2^{-w(i+1)} = the chunk unit
        m_i = (1.5 * 2.0 ** (23 - w * (i + 1))) * sigma
        c = _opaque(_opaque(r_hi + m_i) - m_i)
        out.append(c.astype(jnp.bfloat16))
        r_hi = _opaque(r_hi - c)  # exact (Sterbenz-range subtraction)
        r_hi, r_lo = two_sum(r_hi, r_lo)  # fold low-word bits into range
    return jnp.stack(out)


def _level_dots(xs: jnp.ndarray, ms: jnp.ndarray, cmax: int) -> list:
    """Per-level exact dot sums: level d = sum_{i+j=d} xs[i] @ ms[j].

    Each pair dot is exact in the f32 accumulator (see module docstring);
    same-level results share a power-of-two unit and their (<= 8-term) sum
    stays under 24 bits, so the plain f32 adds here are exact too.
    """
    levels = []
    for d in range(cmax + 1):
        acc = None
        for i in range(min(d, xs.shape[0] - 1), -1, -1):
            j = d - i
            if j >= ms.shape[0]:
                continue
            p = jnp.einsum(
                "...k,kl->...l",
                xs[i],
                ms[j],
                preferred_element_type=jnp.float32,
            )
            acc = p if acc is None else _opaque(acc + p)
        if acc is not None:
            levels.append(acc)
    return levels


def _add_float(x: DS, a: jnp.ndarray) -> DS:
    """ds += plain float (9 flops)."""
    s, e = two_sum(x.hi, a)
    s, e = quick_two_sum(s, e + x.lo)
    return DS(s, e)


def _fold_levels(a: list, b: list, sign_b: float) -> DS:
    """Compensated sum ``sum(a) + sign_b * sum(b)`` of exact f32 level
    arrays, folded largest-scale-first (level d is ~2^-w of level d-1)."""
    acc = None
    for d in range(max(len(a), len(b))):
        for arr, sgn in ((a, 1.0), (b, sign_b)):
            if d < len(arr):
                t = arr[d] if sgn > 0 else -arr[d]
                acc = DS(t, jnp.zeros_like(t)) if acc is None else _add_float(acc, t)
    return acc


def contract_last_oz(
    x: CDS, m: CSlicedMatrix, cmax: int = DEFAULT_CMAX, w: int = DEFAULT_W,
    real_in: bool = False, real_out: bool = False,
    fold_tail: Optional[int] = None,
) -> CDS:
    """``out[..., l] = sum_k x[..., k] * m[k, l]`` — ds accuracy from bf16
    matrix products.

    Drop-in replacement for :func:`boltzfft.ds.contract_last` with the matrix
    pre-split by :func:`slice_matrix`.  ``4 * (cmax+1)(cmax+2)/2`` bf16
    matmuls + O(output) compensated recombination.  ``real_in`` treats the
    imaginary input plane as exactly zero (half the slicing + dots);
    ``real_out`` skips the imaginary output (returned as zeros).
    """
    xr = slice_ds_last(x.re, w=w)
    rr = _level_dots(xr, m.re, cmax)
    ri = None if real_out else _level_dots(xr, m.im, cmax)
    if real_in:
        ii, ir = [], []
    else:
        xi = slice_ds_last(x.im, w=w)
        ii = _level_dots(xi, m.im, cmax)
        ir = [] if real_out else _level_dots(xi, m.re, cmax)
    if fold_tail is not None:
        # collapse levels >= fold_tail with plain f32 adds before the
        # compensated fold: level d is ~2^-wd of level 0, so the pre-sum
        # rounding is bounded by ~2^{-24-w*fold_tail} of the level-0 scale
        def collapse(levels):
            ft = max(1, fold_tail)
            if levels is None or len(levels) <= ft + 1:
                return levels
            tail = levels[ft]
            for t in levels[ft + 1:]:
                tail = _opaque(tail + t)
            return levels[:ft] + [tail]

        rr, ri, ii, ir = (collapse(v) for v in (rr, ri, ii, ir))
    re = _fold_levels(rr, ii, -1.0)
    if real_out:
        z = ds.DS(jnp.zeros_like(re.hi), jnp.zeros_like(re.lo))
        return CDS(re, z)
    return CDS(re, _fold_levels(ri, ir, +1.0))


_SPLIT_F32 = float(2 ** 12 + 1)  # Dekker split constant for f32


def _k_mul(ah, al, bh, bl, opq):
    """ds multiply on (hi, lo) planes (ds.mul algebra; ``opq`` pins the
    rounded intermediates)."""
    p = opq(ah * bh)
    c = opq(ah * _SPLIT_F32)
    h1 = opq(c - (c - ah))
    l1 = ah - h1
    c = opq(bh * _SPLIT_F32)
    h2 = opq(c - (c - bh))
    l2 = bh - h2
    e = ((h1 * h2 - p) + h1 * l2 + l1 * h2) + l1 * l2
    e = e + (ah * bl + al * bh)
    sHi = opq(p + e)
    return sHi, e - (sHi - p)


def _k_ds_add(ah, al, bh, bl, opq):
    """ds add on (hi, lo) planes (ds.add algebra)."""
    s0, e = _k_two_sum(ah, bh, opq)
    e = e + (al + bl)
    s1 = opq(s0 + e)
    return s1, e - (s1 - s0)


def _k_ds_sub(ah, al, bh, bl, opq):
    return _k_ds_add(ah, al, -bh, -bl, opq)


def _phase_sigma(a_hi):
    """Rowwise strictly-greater scale, ``2^(floor(log2 max|row|) + 1)`` via
    exp2/log2 (the device's exp2 may round it a few ulps off the power of
    two; the chunk extraction only needs its binade).  Matches _pow2_ceil's
    exponent+1 semantics up to that rounding — a ds-noise-level
    difference."""
    a = jnp.max(jnp.abs(a_hi), axis=-1, keepdims=True)
    return jnp.where(
        a > 0.0, jnp.exp2(jnp.floor(jnp.log2(jnp.maximum(a, 1e-38))) + 1.0), 1.0
    )


def _k_phase_cmul(xr, xi, ph, conj, opq):
    """t = phase * x (or conj(phase) * x) in full ds arithmetic.

    ``xr``/``xi`` are (hi, lo) pairs of the input component planes; ``ph`` is
    ((pr_hi, pr_lo), (pi_hi, pi_lo)) broadcastable against them."""
    (prh, prl), (pih, pil) = ph
    if conj:
        pih, pil = -pih, -pil
    rr = _k_mul(prh, prl, xr[0], xr[1], opq)
    ii = _k_mul(pih, pil, xi[0], xi[1], opq)
    ri = _k_mul(prh, prl, xi[0], xi[1], opq)
    ir = _k_mul(pih, pil, xr[0], xr[1], opq)
    tre = _k_ds_sub(rr[0], rr[1], ii[0], ii[1], opq)
    tim = _k_ds_add(ri[0], ri[1], ir[0], ir[1], opq)
    return tre, tim


def _k_two_sum(a, b, opq):
    s = opq(a + b)
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def merge_ok(k: int, sx: int = DEFAULT_SLICES_X, sm=None,
             cmax: int = DEFAULT_CMAX, w: int = DEFAULT_W) -> bool:
    """Whether the K-merged complex contraction stays exact at depth ``k``.

    The merged level-``d`` product accumulates ``2k * pairs(d)`` nonzero
    products of two w-bit integers in one f32 accumulator; exactness needs
    every partial sum <= 2^24, i.e. ``2k * max_pairs * 2^(2w) <= 2^24``.
    At the default w=7: ``2k * max_pairs <= 1024`` — true for the ds
    pipeline's K <= 73 at cmax=6 (all 64^3-and-below grids; the z-half
    stage merges up to Nz=144)."""
    if sm is None:
        sm = DEFAULT_SLICES_M
    pairs = min(cmax + 1, min(sx, cmax + 1), sm)
    return 2 * k * pairs * (1 << (2 * w)) <= (1 << 24)


def _oz_contract_v2_jnp(
    sig_r, sig_i, xrh, xrl, xih, xil, m_re, m_im, *, w, sx, sm, ell, cmax,
    real_in=False, real_out=False, fold_tail=None,
):
    """Row-block Ozaki contraction on flattened ds planes.

    Slices each row into ``sx`` chunks at the given power-of-two row scales,
    forms the exact level sums with float32 dots at HIGHEST precision (exact
    for the chunk values by construction), and folds them with pinned
    compensated adds.  Returns the four output planes ``(reh, rel, imh, iml)``.
    """
    rows = xrh.shape[0]

    def slices(hi, lo, sig):
        out = []
        r_hi, r_lo = hi, lo
        for i in range(sx):
            m_i = (1.5 * 2.0 ** (23 - w * (i + 1))) * sig
            c = _opaque(_opaque(r_hi + m_i) - m_i)
            out.append(c)
            r_hi = _opaque(r_hi - c)
            r_hi, r_lo = two_sum(r_hi, r_lo)
        return jnp.stack(out)  # (sx, rows, K) f32 (bf16-exact values)

    cr = slices(xrh, xrl, sig_r)
    ci = None if real_in else slices(xih, xil, sig_i)
    m_re32 = m_re.astype(jnp.float32)  # (sm, K, ell)
    m_im32 = m_im.astype(jnp.float32)

    reh = rel = jnp.zeros((rows, ell), jnp.float32)
    imh = iml = jnp.zeros((rows, ell), jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    groups = [(cr, m_re32, 1.0, "re")]
    if not real_in:
        groups.append((ci, m_im32, -1.0, "re"))
    if not real_out:
        groups.append((cr, m_im32, 1.0, "im"))
        if not real_in:
            groups.append((ci, m_re32, 1.0, "im"))
    n_fold = min(cmax + 1, sx + sm - 1)
    ft = n_fold if fold_tail is None else max(1, min(fold_tail, n_fold))
    for chunks, mat, sgn, which in groups:
        tail = None
        for d in range(n_fold):
            acc = None
            for i in range(min(d, sx - 1), -1, -1):
                j = d - i
                if j >= sm:
                    continue
                t = jnp.dot(
                    chunks[i], mat[j],
                    precision=hp, preferred_element_type=jnp.float32,
                )
                acc = t if acc is None else _opaque(acc + t)
            if acc is None:
                continue
            if d >= ft:
                tail = acc if tail is None else _opaque(tail + acc)
                continue
            if sgn < 0:
                acc = -acc
            if which == "re":
                s, e = two_sum(reh, acc)
                reh, rel = quick_two_sum(s, e + rel)
            else:
                s, e = two_sum(imh, acc)
                imh, iml = quick_two_sum(s, e + iml)
        if tail is not None:
            if sgn < 0:
                tail = -tail
            if which == "re":
                s, e = two_sum(reh, tail)
                reh, rel = quick_two_sum(s, e + rel)
            else:
                s, e = two_sum(imh, tail)
                imh, iml = quick_two_sum(s, e + iml)
    return reh, rel, imh, iml


def _oz_contract_merged_jnp(
    sig, xrh, xrl, xih, xil, m_re, m_im, *, w, sx, sm, ell, cmax,
    real_out=False, fold_tail=None,
):
    """The K-MERGED form of :func:`_oz_contract_v2_jnp`.

    Both components are sliced with the shared per-row scale ``sig``; each
    level value is the full complex combination ``sum_i cr_i@A[d-i] +
    ci_i@B[d-i]`` with ``(A, B) = (M_re, -M_im)`` for the real output and
    ``(M_im, M_re)`` for the imaginary one.  Every level value is an exact
    integer sum under :func:`merge_ok`, so the plain f32 adds here are exact
    in any order."""
    rows = xrh.shape[0]

    def slices(hi, lo):
        out = []
        r_hi, r_lo = hi, lo
        for i in range(sx):
            m_i = (1.5 * 2.0 ** (23 - w * (i + 1))) * sig
            c = _opaque(_opaque(r_hi + m_i) - m_i)
            out.append(c)
            r_hi = _opaque(r_hi - c)
            r_hi, r_lo = two_sum(r_hi, r_lo)
        return jnp.stack(out)  # (sx, rows, K) f32 (bf16-exact values)

    cr = slices(xrh, xrl)
    ci = slices(xih, xil)
    m_re32 = m_re.astype(jnp.float32)  # (sm, K, ell)
    m_im32 = m_im.astype(jnp.float32)

    reh = rel = jnp.zeros((rows, ell), jnp.float32)
    imh = iml = jnp.zeros((rows, ell), jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    groups = [(m_re32, -m_im32, "re")]
    if not real_out:
        groups.append((m_im32, m_re32, "im"))
    n_fold = min(cmax + 1, sx + sm - 1)
    ft = n_fold if fold_tail is None else max(1, min(fold_tail, n_fold))
    for mat_a, mat_b, which in groups:
        tail = None
        for d in range(n_fold):
            acc = None
            for i in range(min(d, sx - 1), -1, -1):
                j = d - i
                if j >= sm:
                    continue
                t = _opaque(
                    jnp.dot(cr[i], mat_a[j], precision=hp,
                            preferred_element_type=jnp.float32)
                    + jnp.dot(ci[i], mat_b[j], precision=hp,
                              preferred_element_type=jnp.float32)
                )
                acc = t if acc is None else _opaque(acc + t)
            if acc is None:
                continue
            if d >= ft:
                tail = acc if tail is None else _opaque(tail + acc)
                continue
            if which == "re":
                s, e = two_sum(reh, acc)
                reh, rel = quick_two_sum(s, e + rel)
            else:
                s, e = two_sum(imh, acc)
                imh, iml = quick_two_sum(s, e + iml)
        if tail is not None:
            if which == "re":
                s, e = two_sum(reh, tail)
                reh, rel = quick_two_sum(s, e + rel)
            else:
                s, e = two_sum(imh, tail)
                imh, iml = quick_two_sum(s, e + iml)
    return reh, rel, imh, iml


def _phased_contract(x, m, phase, conj, repeat, *, cmax, w, fold_tail=None):
    """``sum_k (phase[node, k] * x[..., k]) * m[k, l]`` — the ds phase
    multiply applied per node before the contraction.  ``repeat``: the
    input ``x`` is shared by all ``C`` nodes and the output gains a leading
    node axis."""
    shape = x.re.hi.shape
    k = shape[-1]
    sm, _, ell = m.re.shape
    c = phase.re.hi.shape[0]  # nodes
    rows_in = int(np.prod(shape[:-1]))
    rows_per_node = rows_in if repeat else rows_in // c
    out_lead = (c,) + shape[:-1] if repeat else shape[:-1]

    flat = lambda a: a.reshape(-1, k).astype(jnp.float32)
    xrh, xrl = flat(x.re.hi), flat(x.re.lo)
    xih, xil = flat(x.im.hi), flat(x.im.lo)
    rep = (lambda a: jnp.tile(a, (c, 1))) if repeat else (lambda a: a)
    pex = lambda a: jnp.repeat(
        a.astype(jnp.float32), rows_per_node, axis=0
    )  # (rows_out, K)
    ph = (
        (pex(phase.re.hi), pex(phase.re.lo)),
        (pex(phase.im.hi), pex(phase.im.lo)),
    )
    tre, tim = _k_phase_cmul(
        (rep(xrh), rep(xrl)), (rep(xih), rep(xil)), ph, conj, _opaque
    )
    out = _oz_contract_v2_jnp(
        _phase_sigma(tre[0]), _phase_sigma(tim[0]),
        tre[0], tre[1], tim[0], tim[1], m.re, m.im,
        w=w, sx=DEFAULT_SLICES_X, sm=sm, ell=ell, cmax=cmax,
        fold_tail=fold_tail,
    )
    reh, rel, imh, iml = (a.reshape(out_lead + (ell,)) for a in out)
    return CDS(DS(reh, rel), DS(imh, iml))


def contract_last_oz_nodemat(
    x: CDS,
    m: CSlicedMatrix,
    cmax: int = DEFAULT_CMAX,
    w: int = DEFAULT_W,
    repeat: bool = False,
    fold_tail: Optional[int] = None,
    real_out: bool = False,
    merged: Optional[bool] = None,
) -> CDS:
    """Per-node-matrix contraction: ``out[c, ..., l] = sum_k x[(c,) ..., k]
    * m[c, k, l]``.

    ``m`` carries a leading node axis (``slice_matrix_nodes`` layout,
    ``(C, sm, K, L)``).  With ``repeat=True`` the input ``x`` is one shared
    ``(..., K)`` operand contracted against every node's matrix; otherwise
    ``x`` has the matching leading ``(C, ...)`` axis.  This is how the ds
    pipeline applies the per-node alpha phases: ``diag(alpha_axis) @ Vinv``
    is folded into the matrix on the host (static tables), so the
    contraction runs NO phase arithmetic at all.

    ``merged`` (None = off): run the K-MERGED complex contraction — both
    components sliced with a shared per-row scale and contracted against
    K-concatenated matrices, so each Ozaki level needs ONE product + ONE
    compensated fold per output component instead of two.  Exactness of the
    single-accumulator level products is gated by :func:`merge_ok`; raises
    if it fails.  The level VALUES equal the unmerged ones as real numbers
    only when the shared scale equals the per-component scale — otherwise
    chunks split differently and results agree to the ds noise floor
    (~2^-49 relative), not bitwise.
    """
    c, sm = m.re.shape[0], m.re.shape[-3]
    ell = m.re.shape[-1]
    shape = x.re.hi.shape
    k = shape[-1]
    if merged and not merge_ok(k, sm=sm, cmax=cmax, w=w):
        raise ValueError(
            f"merged contraction is not exact at K={k} (merge_ok: "
            f"2K*pairs*2^(2w) must stay <= 2^24)"
        )
    if repeat:
        rows_pn = int(np.prod(shape[:-1]))
        out_lead = (c,) + shape[:-1]
    else:
        if shape[0] != c:
            raise ValueError(f"leading axis {shape[0]} != node count {c}")
        rows_pn = int(np.prod(shape[1:-1]))
        out_lead = shape[:-1]

    flat = lambda a: a.reshape(-1, k).astype(jnp.float32)
    xrh, xrl = flat(x.re.hi), flat(x.re.lo)
    xih, xil = flat(x.im.hi), flat(x.im.lo)
    sig_r = _phase_sigma(xrh)
    sig_i = _phase_sigma(xih)
    outs = []
    for ci in range(c):
        if repeat:
            args = (sig_r, sig_i, xrh, xrl, xih, xil)
        else:
            sel = slice(ci * rows_pn, (ci + 1) * rows_pn)
            args = tuple(a[sel] for a in (sig_r, sig_i, xrh, xrl, xih, xil))
        if merged:
            outs.append(
                _oz_contract_merged_jnp(
                    jnp.maximum(args[0], args[1]), *args[2:],
                    m.re[ci], m.im[ci],
                    w=w, sx=DEFAULT_SLICES_X, sm=sm, ell=ell, cmax=cmax,
                    real_out=real_out, fold_tail=fold_tail,
                )
            )
            continue
        outs.append(
            _oz_contract_v2_jnp(
                *args, m.re[ci], m.im[ci],
                w=w, sx=DEFAULT_SLICES_X, sm=sm, ell=ell, cmax=cmax,
                real_out=real_out, fold_tail=fold_tail,
            )
        )
    reh, rel, imh, iml = (
        jnp.concatenate([o[i] for o in outs], axis=0).reshape(
            out_lead + (ell,)
        )
        for i in range(4)
    )
    return CDS(DS(reh, rel), DS(imh, iml))


def transform3_oz_nodemat(
    x: CDS,
    mats,
    cmax: int = DEFAULT_CMAX,
    repeat: bool = True,
    fold_tail: Optional[int] = None,
    w: int = DEFAULT_W,
    merged: Optional[bool] = None,
) -> CDS:
    """``IFFT3(alpha_c . x)`` for a block of nodes with the separable
    per-axis phases FOLDED INTO per-node transform matrices.

    ``mats`` is an ``(mx, my, mz)`` triple of :func:`slice_matrix_nodes`
    tables of shape ``(C, sm, N_axis, N_axis)`` holding
    ``diag(alpha_axis[c]) @ Vinv_axis`` (built on the host — the phases are
    static quadrature tables, so this costs nothing at eval time).  With
    ``repeat=True`` (default) ``x`` is the shared ``(Nx, Ny, Nz)`` spectrum;
    returns ``(C, Nx, Ny, Nz)``.  Same role as :func:`transform3_oz_phased`,
    with no phase arithmetic at eval time.
    """
    mx, my, mz = mats
    ck = partial(contract_last_oz_nodemat, cmax=cmax, fold_tail=fold_tail, w=w)
    # merged applies per axis: each stage's K must pass the merge_ok
    # exactness bound independently (anisotropic grids differ per axis)
    mok = lambda mm: bool(merged) and merge_ok(
        mm.re.shape[-2], sm=mm.re.shape[-3], cmax=cmax, w=w
    )
    x = ck(x, mz, repeat=repeat, merged=mok(mz))  # z: (C,Nx,Ny,Nz)
    x = ds._swap_last2(ck(ds._swap_last2(x), my, merged=mok(my)))  # y
    x = ds._roll_axis(
        ck(ds._roll_axis(x, -3, -1), mx, merged=mok(mx)), -1, -3
    )  # x
    return x


def transform3_oz_phased(
    f_hat: CDS,
    m,
    phases,
    conj: bool = False,
    cmax: int = DEFAULT_CMAX,
    w: int = DEFAULT_W,
    fold_tail: Optional[int] = None,
) -> CDS:
    """``IFFT3(alpha_b . f_hat)`` for a block of nodes with the separable
    per-axis phases fused into each axis contraction.

    ``f_hat`` is the shared ``(Nx, Ny, Nz)`` spectrum; ``phases`` is an
    ``(px, py, pz)`` triple of CDS tables of shape ``(C, N_axis)``;
    ``conj=True`` evaluates the conj-phase (g2) stream.  Returns
    ``(C, Nx, Ny, Nz)``.  This removes the materialized ``alpha``/
    ``alpha*f_hat`` intermediates as full-grid arrays.
    """
    mx, my, mz = (m, m, m) if isinstance(m, CSlicedMatrix) else tuple(m)
    px, py, pz = phases
    ck = partial(_phased_contract, cmax=cmax, w=w, fold_tail=fold_tail)
    # z axis: shared input, repeated per node
    x = ck(f_hat, mz, pz, conj, True)  # (C, Nx, Ny, Nz)
    # y axis
    x = ds._swap_last2(ck(ds._swap_last2(x), my, py, conj, False))
    # x axis
    x = ds._roll_axis(
        ck(ds._roll_axis(x, -3, -1), mx, px, conj, False), -1, -3
    )
    return x


def transform3_oz(
    x: CDS,
    m,
    cmax: int = DEFAULT_CMAX,
    real_in: bool = False,
    real_out: bool = False,
    fold_tail: Optional[int] = None,
    w: int = DEFAULT_W,
) -> CDS:
    """Separable 3-D transform of the trailing (Nx, Ny, Nz) axes with the
    sliced matrix/matrices ``m`` (one :class:`CSlicedMatrix` shared by all
    axes, or a per-axis (mx, my, mz) tuple) — the matrix-product analog of
    :func:`boltzfft.ds.transform3`."""
    # CSlicedMatrix is itself a NamedTuple — test the type, not tuple-ness
    mx, my, mz = (m, m, m) if isinstance(m, CSlicedMatrix) else tuple(m)
    c = partial(contract_last_oz, fold_tail=fold_tail, w=w)
    x = c(x, mz, cmax, real_in=real_in)  # z
    x = ds._swap_last2(c(ds._swap_last2(x), my, cmax))  # y
    x = ds._roll_axis(
        c(ds._roll_axis(x, -3, -1), mx, cmax, real_out=real_out), -1, -3
    )  # x
    return x
