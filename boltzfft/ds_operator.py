"""Compensated (double-single) collision pipeline: f64-class digits from
pairs of float32 values.

This module evaluates the *entire* pipeline — forward transform, per-node
shifted convolutions, Hadamard, gain reduction, loss term, assembly
(reference algorithm: ``FFTWBoltzmannOperator.cpp:147-334``) — in
double-single arithmetic (:mod:`boltzfft.ds`): every value is an f32 pair
carrying ~49 mantissa bits, every table is split from host float64, and the
input distribution may be supplied as an f64-split pair, so no f32
quantization floor remains.  At 64^3/Ns=12 it reproduces the reference's
f64 BKW digits (L-inf 3.0686e-12, ``BASELINE.md``).

Design notes (why this is not just "the dft impl in ds"):

* All tables (DFT matrices, per-axis phases, beta1 rows, beta2, weights) are
  computed in host float64 and split exactly — no device trig, no table
  rounding.
* Two contraction engines: ``"vpu"`` runs compensated rank-1 updates (a
  float32 matrix product would round the pair back to 2^-24), ``"oz"`` runs
  exact Ozaki-sliced bfloat16 matrix products (:mod:`boltzfft.oz`).
* beta1 depends only on the radial node, so the ns spherical nodes of one
  radial group share one forward transform (exact by linearity), and the
  group loop is a ``lax.scan`` whose xs are the per-group table slices.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import ds
from . import modes as _modes
from . import oz
from . import quadrature as _quad
from .ds import CDS, DS
from . import weights as _weights
from .device import pipeline_choice
from .weights import CollisionConfig, sincc


class DsPrecomp(NamedTuple):
    """Double-single tables, grouped by radial quadrature node.

    Leading axis of the per-node tables is the radial index (scanned); the
    second axis is the spherical-design member within the group.
    """

    ax: CDS  # (n_gl, ns, N) alpha phase factors, x axis
    ay: CDS  # (n_gl, ns, N)
    az: CDS  # (n_gl, ns, N)
    gain_w: DS  # (n_gl, ns) quadrature weight w_gl * w_sph * rho^(gamma+2)
    beta1: DS  # (n_gl, Nx, Ny, Nz) radial gain kernel rows
    beta2: DS  # (Nx, Ny, Nz) loss multiplier
    vfwd: CDS  # (N, N) forward DFT matrix — or per-axis (mx, my, mz) tuple
    vinv: CDS  # (N, N) 1/N-normalized inverse DFT matrix (or tuple)
    vfwd_sl: oz.CSlicedMatrix  # bf16 mantissa slices for contract="oz" (or tuple)
    vinv_sl: oz.CSlicedMatrix
    # Phase-folded per-node inverse matrices for the oz engine (None when
    # built with node_mats=False): (mx, my, mz) tuples of slice_matrix_nodes
    # tables (n_gl, ns, sm, N_axis, N_axis) holding diag(alpha_axis) @ Vinv
    # (pm1: the g1 stream) and diag(conj(alpha_axis)) @ Vinv (pm2: g2).  The
    # phases are static quadrature tables, so folding them into the matrices
    # on the host removes the ds phase multiply from the contraction.
    pm1: Optional[tuple] = None
    pm2: Optional[tuple] = None
    # Half-spectrum g-stream tables (``g_stream="half"``, even grids only;
    # math oracle: tests/test_half_spectrum.py).  The per-node z-axis HALF
    # matrices (n_gl, ns, sm, Nz/2, Nz) compute the main Nyquist-free block
    # as ``Re(sum_{k<Nz/2} t_k * wt_k * alpha_z(k) * exp(2i pi k jz/Nz)/Nz)``
    # with weights (1, 2, 2, ...) — a real_out contraction at HALF the
    # z depth.  ``nyq_coef`` holds the exact host-f64 Nyquist-block
    # coefficients: planes ``nu_a / n_a``, lines ``nu_b nu_c / (n_b n_c)``
    # (indexed by the free axis), point ``nu_x nu_y nu_z / (nx ny nz)`` —
    # each CDS (n_gl, ns); the g2 stream conjugates them in-trace.
    # (The UNWEIGHTED stream-1 table is not stored: stream 1 always
    # contracts with the weight-folded ``pmz_half1w`` below.)
    pmz_half2: Optional[oz.CSlicedMatrix] = None
    nyq_coef: Optional[tuple] = None
    # Stream-1 WEIGHT-FOLDED half tables: the stream-1 half matrix times the per-node
    # quadrature weight ``gain_w`` and the matching scaled Nyquist
    # coefficients, both exact host-f64 products.  The half path contracts
    # stream 1 with these so the Hadamard sum skips the per-node ds weight
    # multiply entirely (hadamard_wsum_half(w=None)).
    pmz_half1w: Optional[oz.CSlicedMatrix] = None
    nyq_coef_w: Optional[tuple] = None
    # Hermitian-downstream tables (half path): the group sum ``s`` is REAL,
    # so ``FFT(s)`` — and by linearity the whole gain spectrum, and the loss
    # spectrum ``beta2*f_hat`` — is exactly Hermitian: everything after the
    # Hadamard runs on the half-z spectrum (kz < Nz/2) plus one Nyquist
    # plane.  ``vfwd_zh_sl`` is the forward z matrix restricted to those
    # output columns ((Nz, Nz/2)); ``vinv_zh_sl`` the SHARED inverse half-z
    # matrix ``wt_k * exp(+2i pi k jz/Nz)/Nz`` with Hermitian pair weights
    # wt = (1, 2, 2, ...) — a real_out contraction reconstructing the real
    # field from half depth (same math as the per-node pmz_half tables).
    vfwd_zh_sl: Optional[oz.CSlicedMatrix] = None
    vinv_zh_sl: Optional[oz.CSlicedMatrix] = None


def build_ds_precomp(
    cfg: CollisionConfig, dtype=np.float32, node_mats: bool = True
) -> DsPrecomp:
    """All host math in float64, split exactly into ds pairs of ``dtype``.

    Anisotropic grids (``nvy``/``nvz`` != ``nv``, mirroring the reference
    operator's ``Nvx, Nvy, Nvz`` constructor, ``FFTWBoltzmannOperator.hpp:32``)
    get per-axis mode tables and per-axis DFT matrices; the ``vfwd``/``vinv``
    fields then hold (mx, my, mz) tuples instead of one shared matrix.

    ``node_mats=True`` additionally builds the phase-folded per-node inverse
    matrices (``pm1``/``pm2``) the oz engine contracts with — ~2 * 3 * sm *
    B * N^2 bf16 of device tables (302 MB at 64^3/Ns=12; skip for the vpu
    engine on memory-tight configs with ``node_mats=False``)."""
    nx, ny, nz = cfg.grid_shape
    length = cfg.domain_length

    gl = _quad.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
    sph = _weights.spherical_quadrature(cfg)  # antipodally reduced if enabled
    rho = gl.nodes  # (n_gl,)
    sigma = sph.points  # (ns_eff, 3)

    modes = [
        _modes.fft_modes(n).astype(np.float64) for n in (nx, ny, nz)
    ]  # full c2c mode order, per axis
    coef = -np.pi / (2.0 * length)
    # phase[r, s, l] = coef * rho_r * sigma_s[axis] * l
    def axis_phase_c128(axis):
        ph = (
            coef * rho[:, None, None] * sigma[None, :, axis, None]
            * modes[axis][None, None, :]
        )
        return np.exp(1j * ph)

    def axis_phase(axis):
        return ds.cds_from_f64(axis_phase_c128(axis), dtype)

    gain_w = (
        (gl.weights * rho ** (cfg.gamma + 2.0))[:, None] * sph.weights[None, :]
    )  # (n_gl, ns)

    norm_l = _modes.mode_norm_grid(*modes)  # (Nx, Ny, Nz)
    eps64 = float(np.finfo(np.float64).eps)
    beta1 = (4.0 * np.pi * cfg.b_gamma) * sincc(
        (np.pi / (2.0 * length)) * rho[:, None, None, None] * norm_l[None], eps64
    )  # (n_gl, Nx, Ny, Nz)

    radial_w = gl.weights * rho ** (cfg.gamma + 2.0)
    arg = (np.pi / length) * rho[:, None] * norm_l.reshape(1, -1)
    beta2 = (
        16.0 * np.pi**2 * cfg.b_gamma * (radial_w @ sincc(arg, eps64))
    ).reshape(norm_l.shape)

    def dft_pair(n):
        m = np.arange(n)
        ph = 2.0 * np.pi * np.outer(m, m) / n
        return np.exp(-1j * ph), np.exp(1j * ph) / n

    slw, slm, _ = _pipeline_slicing(cfg)
    pairs = [dft_pair(n) for n in (nx, ny, nz)]
    if cfg.is_isotropic:
        vfwd64, vinv64 = pairs[0]
        vfwd = ds.cds_from_f64(vfwd64, dtype)
        vinv = ds.cds_from_f64(vinv64, dtype)
        vfwd_sl = oz.slice_matrix(vfwd64, slm, slw)
        vinv_sl = oz.slice_matrix(vinv64, slm, slw)
    else:
        vfwd = tuple(ds.cds_from_f64(p[0], dtype) for p in pairs)
        vinv = tuple(ds.cds_from_f64(p[1], dtype) for p in pairs)
        vfwd_sl = tuple(oz.slice_matrix(p[0], slm, slw) for p in pairs)
        vinv_sl = tuple(oz.slice_matrix(p[1], slm, slw) for p in pairs)
    pm1 = pm2 = None
    if node_mats:
        # diag(alpha_axis[r, s]) @ Vinv_axis, host f64, sliced per node — the
        # oz engine contracts with these instead of multiplying phases
        def folded(axis):
            p = axis_phase_c128(axis)[..., :, None]  # (n_gl, ns, N, 1)
            vinv64 = pairs[axis][1]
            return (
                oz.slice_matrix_nodes(p * vinv64[None, None], slm, slw),
                oz.slice_matrix_nodes(np.conj(p) * vinv64[None, None], slm, slw),
            )

        fx, fy, fz = folded(0), folded(1), folded(2)
        pm1 = (fx[0], fy[0], fz[0])
        pm2 = (fx[1], fy[1], fz[1])
    pmz_half2 = pmz_half1w = nyq_coef = nyq_coef_w = None
    vfwd_zh_sl = vinv_zh_sl = None
    if node_mats and nx % 2 == ny % 2 == nz % 2 == 0:
        # half-spectrum g-stream tables (see the DsPrecomp field comment +
        # tests/test_half_spectrum.py for the validated math)
        nzh = nz // 2
        pz = axis_phase_c128(2)[..., :nzh, None]  # (n_gl, ns, nzh, 1)
        ejz = np.exp(
            2j * np.pi * np.outer(np.arange(nzh), np.arange(nz)) / nz
        ) / nz
        wt = np.ones((nzh, 1))
        wt[1:] = 2.0
        mzh = wt[None, None] * ejz[None, None]
        pmz_half2 = oz.slice_matrix_nodes(np.conj(pz) * mzh, slm, slw)
        # stream-1 weight fold: one exact host-f64 product replaces the
        # Hadamard sum's per-node ds weight multiply
        gw4 = gain_w[:, :, None, None]
        pmz_half1w = oz.slice_matrix_nodes(pz * mzh * gw4, slm, slw)
        # Hermitian-downstream shared z matrices (see the field comment):
        # forward restricted to kz < Nz/2; inverse = the pair-weighted
        # half-depth real_out matrix (the shared core of the pmz tables)
        vfwd_zh_sl = oz.slice_matrix(pairs[2][0][:, :nzh], slm, slw)
        vinv_zh_sl = oz.slice_matrix((wt * ejz), slm, slw)
        nus = [
            axis_phase_c128(a)[..., n // 2]
            for a, n in zip(range(3), (nx, ny, nz))
        ]  # per-node Nyquist phase values nu_a, (n_gl, ns) complex
        csplit = lambda z: ds.cds_from_f64(z, dtype)
        raw_coef = (
            nus[0] / nx,
            nus[1] / ny,
            nus[2] / nz,
            nus[1] * nus[2] / (ny * nz),  # line with free axis x
            nus[0] * nus[2] / (nx * nz),  # free axis y
            nus[0] * nus[1] / (nx * ny),  # free axis z
            nus[0] * nus[1] * nus[2] / (nx * ny * nz),
        )
        nyq_coef = tuple(csplit(c) for c in raw_coef)
        nyq_coef_w = tuple(csplit(c * gain_w) for c in raw_coef)
    return DsPrecomp(
        ax=axis_phase(0),
        ay=axis_phase(1),
        az=axis_phase(2),
        gain_w=ds.from_f64(gain_w, dtype),
        beta1=ds.from_f64(beta1, dtype),
        beta2=ds.from_f64(beta2, dtype),
        vfwd=vfwd,
        vinv=vinv,
        vfwd_sl=vfwd_sl,
        vinv_sl=vinv_sl,
        pm1=pm1,
        pm2=pm2,
        pmz_half2=pmz_half2,
        nyq_coef=nyq_coef,
        pmz_half1w=pmz_half1w,
        nyq_coef_w=nyq_coef_w,
        vfwd_zh_sl=vfwd_zh_sl,
        vinv_zh_sl=vinv_zh_sl,
    )


def _cindex(x, idx):
    """Apply a numpy-style index to every leaf of a DS/CDS pytree."""
    return jax.tree.map(lambda a: a[idx], x)


#: Ozaki slice-pair retention for the ds pipeline at the w=7 chunk width
#: (see _pipeline_slicing for the measured retention/width ladder).
DS_PIPELINE_CMAX = 6

#: Fold-tail pre-summing for the pipeline: None = exact all-ds fold.
#: Measured: a fold_tail=4 f32 tail pre-sum rounds at ~2^-47 of the output
#: scale (a few ulps at the tail level on elements below the row scale) —
#: too close to the 2^-49 ds floor for the digit-parity claim, and at
#: w=8/cmax=5 it saves only 1 of 6 folds.  Kept as an opt-in knob on the
#: oz contraction API.
DS_PIPELINE_FOLD_TAIL = None

#: Default for collide_ds(oz_merge=None): K-merged contractions in the
#: per-node transform stages (stages gated per-K by oz.merge_ok) — half the
#: compensated-fold work, BKW digits unchanged (the merged pipeline matches
#: the vpu engine, tests/test_half_spectrum.py).
DS_PIPELINE_MERGE = True


def _pipeline_slicing(cfg: CollisionConfig):
    """Ozaki slicing parameters for the ds pipeline: ``(w, nslices_m,
    default_cmax)``.

    ``w=8`` chunks (full bf16 mantissa) at ``cmax=5`` drop levels whose pair
    values are ``~2^{-w(cmax+1)-2}`` each (7 pairs ~ 2^-47 of scale), which
    moves the 64^3 BKW L-inf print in its last digits; digit-safe retention
    at w=8 is cmax=6, the same slice-pair work as w=7/cmax=6.  w=7/cmax=6's
    dropped level 7 is ``8 * 2^-51 ~ 2^-48``, just under the printed digits.
    """
    return 7, 8, 6


def _cconj(c: CDS) -> CDS:
    """Exact complex conjugate of a CDS (negated imaginary planes)."""
    return CDS(c.re, DS(-c.im.hi, -c.im.lo))


def _nyq_corrections(cfg, pre, f_hat, ck, conj: bool, coef=None):
    """Coefficient-folded Nyquist-block correction fields for ALL nodes of
    one g stream (batched: a handful of kernel launches per eval).

    Exact block evaluation (tests/test_half_spectrum.py): for each axis
    subset at Nyquist, the block's inverse transform factors into a ±1
    parity pattern along the Nyquist axes and a reduced transform of the
    (masked) plane/line/corner data over the rest.  Returns the THREE
    plane CDS fields (leading (n_gl, ns)) with the line/point blocks
    pre-folded in and every exact host-f64 coefficient applied — see the
    fold note below.

    ``coef`` overrides the coefficient tuple (default ``pre.nyq_coef``);
    the pipeline passes the weight-folded ``pre.nyq_coef_w`` for stream 1.
    """
    nx, ny, nz = cfg.grid_shape
    hx, hy, hz = nx // 2, ny // 2, nz // 2
    kx, ky, kz = (
        jnp.asarray(np.arange(n) != h, jnp.float32)
        for n, h in ((nx, hx), (ny, hy), (nz, hz))
    )
    vs = pre.vinv_sl
    # CSlicedMatrix is itself a NamedTuple — test the type, not tuple-ness
    vx, vy, vz = (
        (vs, vs, vs) if isinstance(vs, oz.CSlicedMatrix) else tuple(vs)
    )
    ph = (pre.ax, pre.ay, pre.az)
    if coef is None:
        coef = pre.nyq_coef
    if conj:
        ph = tuple(_cconj(p) for p in ph)
        coef = tuple(_cconj(c) for c in coef)
    ax, ay, az = ph
    sl_all = slice(None)

    def t2(u, m_last, m_second):
        """Inverse transform of the last two axes with shared matrices."""
        u = ck(u, m_last)
        return ds._swap_last2(ck(ds._swap_last2(u), m_second))

    def plane(take, mask, p_b, p_c, m_last, m_second, cf):
        data = jax.tree.map(lambda a: a[take] * mask, f_hat)
        u = ds.cmul(_cindex(p_b, (sl_all, sl_all, sl_all, None)), data)
        u = ds.cmul(_cindex(p_c, (sl_all, sl_all, None, sl_all)), u)
        t = t2(u, m_last, m_second)
        return ds.cmul(_cindex(cf, (sl_all, sl_all, None, None)), t)

    px = plane((hx,), ky[:, None] * kz[None, :], ay, az, vz, vy, coef[0])
    py = plane(
        (sl_all, hy), kx[:, None] * kz[None, :], ax, az, vz, vx, coef[1]
    )
    pz = plane(
        (sl_all, sl_all, hz), kx[:, None] * ky[None, :], ax, ay, vy, vx,
        coef[2],
    )

    def line(take, mask, p_a, m_a, cf):
        data = jax.tree.map(lambda a: a[take] * mask, f_hat)
        u = ds.cmul(p_a, jax.tree.map(lambda a: a[None, None, :], data))
        t = ck(u, m_a)
        return ds.cmul(_cindex(cf, (sl_all, sl_all, None)), t)

    lx = line((sl_all, hy, hz), kx, ax, vx, coef[3])
    ly = line((hx, sl_all, hz), ky, ay, vy, coef[4])
    lz = line((hx, hy, sl_all), kz, az, vz, coef[5])
    corner = jax.tree.map(lambda a: a[hx, hy, hz], f_hat)
    pt = ds.cmul(coef[6], corner)

    # Fold the line and point terms into the plane fields (shared parity
    # patterns; every multiply is by exact ±1, every add compensated —
    # tiny (B, N^2) work done once per eval).  The per-sub-batch assembly
    # then needs only THREE broadcast terms:
    #   g = r_main + sx(jx).px'(jy,jz) + sy(jy).py'(jx,jz) + sz(jz).pz(jx,jy)
    syv = jnp.asarray((-1.0) ** np.arange(ny), jnp.float32)
    szv = jnp.asarray((-1.0) ** np.arange(nz), jnp.float32)
    expand = lambda t, idx, pat: jax.tree.map(lambda a: a[idx] * pat, t)
    b = (sl_all, sl_all)
    # ly: sx.(sz(jz) Ly(jy)) ; lz: sx.(sy(jy) Lz(jz)) ; pt: sx.(sy sz pt)
    px = ds.cadd(px, expand(ly, b + (sl_all, None), szv[None, None, None, :]))
    px = ds.cadd(px, expand(lz, b + (None, sl_all), syv[None, None, :, None]))
    px = ds.cadd(
        px, expand(pt, b + (None, None), (syv[:, None] * szv[None, :])[None, None])
    )
    # lx: sy.(sz(jz) Lx(jx))
    py = ds.cadd(py, expand(lx, b + (sl_all, None), szv[None, None, None, :]))
    return (px, py, pz)


def _g_main_half(fhs, m_y, m_x, m_zh, cmax, w, ftail, merged=False):
    """The main (Nyquist-free) block of one g stream for a node sub-batch:
    y/x complex contractions on the half-z spectrum, then the real_out
    half-depth z contraction.  Returns the exactly-real main field as a DS.

    ``fhs`` is the shared masked spectrum pre-swapped to (Nx, Nz/2, Ny);
    ``m_zh`` the per-node half matrices (DsPrecomp.pmz_half*).  ``merged``
    requests the K-merged contraction (half the compensated-fold work) per
    stage where :func:`boltzfft.oz.merge_ok` holds."""
    ck = partial(oz.contract_last_oz_nodemat, cmax=cmax, w=w, fold_tail=ftail)
    mok = lambda mm: merged and oz.merge_ok(
        mm.re.shape[-2], sm=mm.re.shape[-3], cmax=cmax, w=w
    )
    t = ck(fhs, m_y, repeat=True, merged=mok(m_y))
    t = jax.tree.map(lambda a: a.transpose(0, 3, 2, 1), t)  # (C, Ny, Nzh, Nx)
    t = ck(t, m_x, merged=mok(m_x))
    t = jax.tree.map(lambda a: a.transpose(0, 3, 1, 2), t)  # (C, Nx, Ny, Nzh)
    return ck(t, m_zh, real_out=True, merged=mok(m_zh)).re  # (C,Nx,Ny,Nz)


def _rev_v(a):
    """Physical velocity reversal ``v -> -v`` on the last three axes.

    The grid is CELL-centered (``v_j = -L + dv*(j + 1/2)``, grid.py), so
    ``v_j + v_{N-1-j} = 0`` and the reversal is the pure index flip
    ``j -> N-1-j`` — NOT the DFT-index map ``j -> (N-j) mod N`` (that one
    is the reversal of a node-centered grid; using it here leaves an O(1)
    defect on physically-even states, measured rel ~4 on a raw BKW input
    before this was fixed)."""
    return jnp.flip(a, (-3, -2, -1))


def _g1_from_g2(r2: DS, w: DS) -> DS:
    """Stream-1 weighted main block from stream 2's: ``g1(v) = g2(-v)``,
    exact ONLY for centrally-symmetric f (``f(v) = f(-v)``; see the
    ``g1_reversal`` note in :func:`collide_ds` — this is an opt-in
    symmetry optimization, not a general identity).  Folds the per-node
    quadrature weight as one ds multiply (supersedes the pmz_half1w host
    fold on this path; same 2^-49 error class)."""
    rev = DS(_rev_v(r2.hi), _rev_v(r2.lo))
    wb = DS(w.hi[:, None, None, None], w.lo[:, None, None, None])
    return ds.mul(rev, wb)


def _ds_sum_last(x: DS) -> DS:
    """Compensated pairwise sum of a DS over its last axis (every add is a
    ds add; the tree order is fixed, so the result is deterministic)."""
    cur = x
    n = cur.hi.shape[-1]
    while n > 1:
        m = n // 2
        a = jax.tree.map(lambda t: t[..., :m], cur)
        b = jax.tree.map(lambda t: t[..., m : 2 * m], cur)
        s = ds.add(a, b)
        if n % 2:
            tail = jax.tree.map(lambda t: t[..., 2 * m :], cur)
            s = jax.tree.map(
                lambda u, v: jnp.concatenate((u, v), axis=-1), s, tail
            )
            n = m + 1
        else:
            n = m
        cur = s
    return jax.tree.map(lambda t: t[..., 0], cur)


def _fwd_herm_half(s: DS, ck, m_xy, m_zh, szv):
    """Forward transform of a REAL field onto the Hermitian half-z spectrum.

    Returns ``(main, q)``: the main block (kz < Nz/2 — bit-identical to
    those columns of the full transform: same dot rows, fewer output
    columns) and the REAL z-Nyquist line sum ``q = sum_z s*(-1)^z`` whose
    2-D forward transform is the Nyquist plane (batched across radial
    groups by the caller — per-group 2-D transforms are tiny
    launch-overhead-bound kernels).  Exact: for real s the spectrum is
    Hermitian, so the discarded half is the conjugate mirror of the kept
    one (index convention ``F[(N-k)%N] = conj(F[k])``) and carries no
    information."""
    mx, my = m_xy
    u = ck(ds.cds_from_real(s), m_zh, real_in=True)  # (..., Nx, Ny, Nzh)
    u = ds._swap_last2(ck(ds._swap_last2(u), my))
    u = ds._roll_axis(ck(ds._roll_axis(u, -3, -1), mx), -1, -3)
    q = _ds_sum_last(DS(s.hi * szv, s.lo * szv))  # (..., Nx, Ny) real
    return u, q


def _fwd2_batched(q: DS, ck, m_xy) -> CDS:
    """Batched 2-D forward transform of real fields (the Nyquist planes of
    every radial group in one launch set)."""
    mx, my = m_xy
    p = ck(ds.cds_from_real(q), my, real_in=True)
    return ds._swap_last2(ck(ds._swap_last2(p), mx))


def _cds_sum_first(x: CDS) -> CDS:
    """Compensated pairwise sum of a CDS over its FIRST axis (fixed tree
    order — deterministic)."""
    cur = x
    n = cur.re.hi.shape[0]
    while n > 1:
        m = n // 2
        a = jax.tree.map(lambda t: t[:m], cur)
        b = jax.tree.map(lambda t: t[m : 2 * m], cur)
        s = ds.cadd(a, b)
        if n % 2:
            tail = jax.tree.map(lambda t: t[2 * m :], cur)
            s = jax.tree.map(
                lambda u, v: jnp.concatenate((u, v), axis=0), s, tail
            )
            n = m + 1
        else:
            n = m
        cur = s
    return jax.tree.map(lambda t: t[0], cur)


def _inv_herm_half(u: CDS, p: CDS, ck, m_xy, m_zh, nz: int, szv) -> DS:
    """``Re(IFFT3(.))`` of a Hermitian spectrum given as half-z main block +
    z-Nyquist plane: y/x inverses at half depth, then the pair-weighted
    half-depth real_out z contraction (``DsPrecomp.vinv_zh_sl``); the plane
    inverts in 2-D and enters as ``Re(.)*(-1)^z/Nz`` (exact: after the x/y
    inverses of a Hermitian spectrum the kz=0 and Nyquist slabs are real,
    and ``(-1)^z`` is real, so the projection commutes)."""
    mx, my = m_xy
    u = ds._swap_last2(ck(ds._swap_last2(u), my))
    u = ds._roll_axis(ck(ds._roll_axis(u, -3, -1), mx), -1, -3)
    main = ck(u, m_zh, real_out=True).re  # (..., Nx, Ny, Nz) real
    p = ck(p, my)
    pr = ds._swap_last2(ck(ds._swap_last2(p), mx, real_out=True)).re
    # z-axis inverse normalization: 1/Nz as an exactly-split ds constant
    # (a bare f32 scalar rounds at 2^-24 for non-power-of-two Nz)
    pr = ds.mul(pr, ds.from_f64(np.float64(1.0) / nz))
    corr = DS(pr.hi[..., None] * szv, pr.lo[..., None] * szv)
    return ds.add(main, corr)


def _assemble_g_half(r_main: DS, corr, signs) -> CDS:
    """Dense complex g from the real main block + Nyquist corrections.

    ``corr`` holds the three plane fields with the line/point terms
    pre-folded in (:func:`_nyq_corrections`), so the dense assembly is
    three broadcast ds adds per component (the ±1 parity multiplies are
    exact)."""
    px, py, pz = corr
    sx, sy, sz = signs
    terms = (
        (px, (slice(None), None, slice(None), slice(None)),
         sx[None, :, None, None]),
        (py, (slice(None), slice(None), None, slice(None)),
         sy[None, None, :, None]),
        (pz, (slice(None), slice(None), slice(None), None),
         sz[None, None, None, :]),
    )
    g_re, g_im = r_main, None
    for field, idx, pat in terms:
        tre = DS(field.re.hi[idx] * pat, field.re.lo[idx] * pat)
        tim = DS(field.im.hi[idx] * pat, field.im.lo[idx] * pat)
        g_re = ds.add(g_re, tre)
        g_im = tim if g_im is None else ds.add(g_im, tim)
    return CDS(g_re, g_im)


def _hadamard_wsum(g1: CDS, g2: CDS, w: Optional[DS]) -> CDS:
    """``sum_j w[j] * (g1[j] . g2[j])`` over the leading node axis — the
    pipeline's Hadamard product and weighted group sum (reference:
    ``FFTWBoltzmannOperator.cpp:233-273``) in compensated arithmetic, in a
    fixed node order.  ``w=None`` sums the plain products (the
    weight-folded half-spectrum path)."""
    h = ds.cmul(g1, g2)
    s = None
    for j in range(h.re.hi.shape[0]):
        term = _cindex(h, j)
        if w is not None:
            term = ds.cmul_ds(term, _cindex(w, j))
        s = term if s is None else ds.cadd(s, term)
    return s


def _hadamard_wsum_half(r1: DS, c1, r2: DS, c2, signs, groups: int = 1) -> DS:
    """``Re(sum_j g1[j] . g2[j])`` where each g is given FACTORED as a real
    main block plus three plane corrections (the half-spectrum form; the
    per-node weight is pre-folded into stream 1's tables).

    Returns only the real part — EXACT, not an approximation: the pipeline
    consumes this through ``Re(IFFT(beta1 * FFT(.)))`` per radial group,
    beta1 is real and ``l -> -l`` symmetric (it depends on ``|l|`` with
    Nyquist mapping to itself), and the anti-Hermitian part of ``FFT(s)`` —
    exactly ``FFT(i Im s)`` — yields a purely imaginary IFFT that the final
    real projection annihilates.  (This is NOT the rejected g-realness
    shortcut: the epsilon streams still enter ``Re(h) = R1 R2 - E1 E2``
    exactly.)

    ``groups > 1``: the node axis covers ``groups`` radial groups
    back-to-back (group-major) and the result is the ``(groups,) + grid``
    stack of per-group sums."""
    c = r1.hi.shape[0]
    ns_pg = c // groups
    outs = []
    for g in range(groups):
        sel = slice(g * ns_pg, (g + 1) * ns_pg)
        tk = lambda t: jax.tree.map(lambda a: a[sel], t)
        g1 = _assemble_g_half(tk(r1), tk(c1), signs)
        g2 = _assemble_g_half(tk(r2), tk(c2), signs)
        outs.append(_hadamard_wsum(g1, g2, None).re)
    if groups == 1:
        return outs[0]
    return jax.tree.map(lambda *a: jnp.stack(a), *outs)


def collide_ds(
    cfg: CollisionConfig, pre: DsPrecomp, f: DS, sub_batch: int = 2,
    contract: str = "vpu",
    gain_reduce: Optional[Callable[[CDS], CDS]] = None,
    oz_cmax: Optional[int] = None,
    g_stream: str = "full",
    herm_downstream: bool = True,
    group_batch: int = 1,
    oz_merge: Optional[bool] = None,
    g1_reversal: bool = False,
) -> DS:
    """Q(f, f) in double-single arithmetic.  Pure and jittable.

    ``f`` is a ds pair (use :func:`boltzfft.ds.from_f64` to split a host
    float64 distribution, or :func:`boltzfft.ds.from_float` to promote a
    device f32 array).  Returns Q as a ds pair; reconstruct with
    :func:`boltzfft.ds.to_f64`.

    ``sub_batch`` bounds how many of a radial group's ``ns`` nodes are in
    flight at once (peak live state is ~6 complex-ds ``(sub_batch, N^3)``
    tensors; at 64^3 each node costs ~8 MB per tensor) — probe per config
    with :func:`boltzfft.autotune_ds`.

    ``contract`` picks the transform engine: ``"vpu"`` = compensated rank-1
    updates (bit-exact ds reference), ``"oz"`` = Ozaki-scheme sliced bf16
    matrix products (:mod:`boltzfft.oz`) — same ~49-bit accuracy class.
    :func:`boltzfft.device.pipeline_choice` names the default per backend.

    ``gain_reduce`` (sharding hook): applied to the gain spectrum between
    the radial-group scan and the final inverse — the radial-sharded
    operator passes the compensated cross-device fold here.

    ``oz_cmax`` (oz engine): Ozaki slice-pair retention level — the ds
    pipeline's accuracy dial.  ``None`` defers to ``cfg.oz_cmax``, then to
    the digit-exact default from :func:`_pipeline_slicing` (cmax=6 at w=7).
    Lower levels drop slice pairs and lose the last reference digits.  The
    ``vpu`` engine ignores it.

    ``g_stream`` (oz engine, even grids): ``"half"`` evaluates the per-node
    inverse streams via the exact half-spectrum Nyquist-block decomposition
    (tests/test_half_spectrum.py) — the main block is a real-output
    transform at half the z depth (~5/12 of the full complex MACs), plus
    exact plane/line/point corrections.  ``"full"`` keeps the direct complex
    streams.  Not an approximation: results agree with the full streams to
    the ds noise floor on ANY input (Nyquist-rich included), and with the
    f64 reference digits at the BKW oracle.

    ``herm_downstream`` (half path): the group sums are real, so everything
    downstream of the Hadamard — forward transforms, beta1 accumulator,
    final inverses — runs on the exactly-Hermitian half-z spectrum plus one
    Nyquist plane.  Exact either way (white-noise vpu parity ~2e-14).

    ``group_batch`` (half path): how many radial groups ride each batch of
    contractions — the g-main/Hadamard stages treat nodes independently, so
    batching groups multiplies the row count without changing the math (the
    per-group forward + beta1 accumulation order is unchanged; gb>1 takes a
    group's whole node batch at once, so within-group Hadamard partial sums
    reassociate at the ds noise floor vs small ``sub_batch``).  Must divide
    the radial group count.

    ``oz_merge`` (oz engine): run the K-MERGED complex contraction in the
    per-node transform stages — both components ride one double-height
    Ozaki product so the compensated fold runs half the level lists
    (:func:`boltzfft.oz.merge_ok` gates exactness per stage; stages whose K
    fails the bound keep the unmerged contraction).  Results agree with
    unmerged to the ds noise floor (shared per-row slicing scale), not
    bitwise.  None = :data:`DS_PIPELINE_MERGE`.

    ``g1_reversal`` (half path, OPT-IN): derive stream 1's main block from
    stream 2's by physical velocity reversal (``j -> N-1-j`` on the
    cell-centered grid, :func:`_rev_v`) instead of computing it.  The
    identity ``g1(v) = g2(-v)`` requires a centrally-symmetric
    distribution ``f(v) = f(-v)`` (even physical spectrum) — it is NOT
    true for general real f (measured rel ~0.5 on noise input, <3e-14 on
    raw BKW — ``tests/test_half_spectrum.py::TestG1Reversal``).
    BKW/Maxwellian relaxation states are exactly even, so this halves the
    dominant per-node transform work for isotropic-relaxation runs.  Never
    auto-enabled, because the operator must stay correct for arbitrary f.
    """
    ns = cfg.ns_eff
    sb = min(ns, sub_batch) if sub_batch else ns
    slw, _, cmax_def = _pipeline_slicing(cfg)
    if oz_cmax is None:  # per-call kwarg > cfg.oz_cmax > digit-exact default
        oz_cmax = cfg.oz_cmax
    cmax = cmax_def if oz_cmax is None else oz_cmax
    ftail = DS_PIPELINE_FOLD_TAIL
    mg = DS_PIPELINE_MERGE if oz_merge is None else bool(oz_merge)
    if contract == "oz":
        tf_fwd = partial(
            oz.transform3_oz, m=pre.vfwd_sl, cmax=cmax, w=slw,
            fold_tail=ftail,
        )
        tf_inv = partial(
            oz.transform3_oz, m=pre.vinv_sl, cmax=cmax, w=slw,
            fold_tail=ftail,
        )
    elif contract == "vpu":
        tf_fwd = partial(ds.transform3, m=pre.vfwd)
        tf_inv = partial(ds.transform3, m=pre.vinv)
    else:
        raise ValueError(f"unknown ds contract engine: {contract!r}")
    f_hat = tf_fwd(ds.cds_from_real(f), real_in=True)

    # Exact structure exploits only (parity with the complex f64 reference
    # must hold to ~1e-12 for ANY input, resolved or not):
    # * f_hat's transform input is literally real (real_in exact);
    # * alpha1*f_hat and conj(alpha1)*f_hat share their four component
    #   products (ds.cmul_both, exact algebra);
    # * the final inverses take Re(IFFT(.)) exactly as the reference does
    #   (FFTWBoltzmannOperator.cpp:314-330), so real_out there computes the
    #   same projection without the imaginary output plane.
    # Realness of g1/g2 fails at the unpaired Nyquist mode (alpha1(-N/2)
    # has no +N/2 partner), so it is NOT exploited as an approximation (the
    # rfft impl's documented shortcut stays out of this accuracy
    # instrument).  g_stream="half" instead uses the EXACT route: the
    # Nyquist-block decomposition whose main block is provably real and
    # whose plane/line/point corrections reproduce the complex Nyquist
    # terms the Hadamard needs (tests/test_half_spectrum.py).
    # The oz engine folds the separable per-axis phases into the transform
    # (per-node matrices, or a phase multiply per axis contraction), so the
    # alpha / alpha*f_hat intermediates are never materialized; the vpu
    # reference engine keeps the explicit a1/cmul_both formulation.
    phased = contract == "oz"
    nodemat = phased and pre.pm1 is not None
    half = g_stream == "half" and nodemat and pre.pmz_half1w is not None
    if g_stream == "half" and not half:
        raise ValueError(
            "g_stream='half' needs the oz engine with node_mats tables "
            "on an all-even grid (build_ds_precomp default; precomps built "
            "before the weight-folded tables existed must be rebuilt)"
        )
    if group_batch > 1 and not half:
        raise ValueError(
            "group_batch > 1 applies to the half-spectrum path only "
            "(oz engine with g_stream='half'); it would be silently "
            "ignored here"
        )
    if g1_reversal and not half:
        raise ValueError(
            "g1_reversal applies to the half-spectrum path only (oz "
            "engine with g_stream='half'); it would be silently ignored "
            "here"
        )
    rev1 = bool(g1_reversal) and half  # opt-in: exact only for even f
    gb = group_batch if half else 1
    if half:
        nxg, nyg, nzg = cfg.grid_shape
        hx, hy = nxg // 2, nyg // 2
        kxm = jnp.asarray(np.arange(nxg) != hx, jnp.float32)
        kym = jnp.asarray(np.arange(nyg) != hy, jnp.float32)
        fmask = kxm[:, None, None] * kym[None, :, None]
        # main-block spectrum: half z extent, x/y Nyquist rows zeroed
        # (exact ±/0 multiplies), pre-swapped once for the y-first
        # contraction order
        f_main = jax.tree.map(lambda a: a[..., : nzg // 2] * fmask, f_hat)
        fhs = ds._swap_last2(f_main)  # (Nx, Nz/2, Ny)
        ckc = partial(oz.contract_last_oz, cmax=cmax, w=slw, fold_tail=ftail)
        # stream 1 carries the per-node quadrature weight (host-folded into
        # its z-half matrices and Nyquist coefficients), so the Hadamard
        # sums plain products (w=None)
        corr1 = _nyq_corrections(
            cfg, pre, f_hat, ckc, conj=False, coef=pre.nyq_coef_w
        )
        corr2 = _nyq_corrections(cfg, pre, f_hat, ckc, conj=True)
        signs = tuple(
            jnp.asarray((-1.0) ** np.arange(n), jnp.float32)
            for n in (nxg, nyg, nzg)
        )
        # Hermitian downstream: the group sums are real, so the gain/loss
        # spectra are exactly Hermitian — forward transforms, the beta1
        # accumulator, and the final inverses can run on the half-z
        # spectrum plus one Nyquist plane (see _fwd_herm_half).
        herm = herm_downstream and pre.vfwd_zh_sl is not None
        nzh = nzg // 2
        _xy = lambda m: (m, m) if isinstance(m, oz.CSlicedMatrix) else (
            m[0], m[1]
        )
        fwd_xy, inv_xy = _xy(pre.vfwd_sl), _xy(pre.vinv_sl)
        if herm:
            beta1h = jax.tree.map(lambda a: a[..., :nzh], pre.beta1)
            beta1p = jax.tree.map(lambda a: a[..., nzh], pre.beta1)

    def group(acc, xs):
        if half and rev1:
            # g1-reversal mode: stream-1 tables never enter the scan; the
            # group weights ride in for the ds fold
            b1h = b1 = xs[0]
            _, mxy2, mzh2g, c1g, c2g, gwn = xs
            mxy1 = mzh1g = None
        elif half:
            # first element: beta1 restricted to the half-z block (herm
            # downstream) or the full beta1 rows
            b1h = b1 = xs[0]
            _, mxy1, mxy2, mzh1g, mzh2g, c1g, c2g = xs
        elif nodemat:
            gw, b1, pm1, pm2 = xs  # per-radial-group table slices
        else:
            ax, ay, az, gw, b1 = xs
        s = None
        # group-batched half path: all gb*ns nodes at once (sub_batch is
        # moot — batching is the point)
        sub_starts = range(0, ns, sb) if gb == 1 else (0,)
        for j0 in sub_starts:
            sl = (
                slice(j0, min(j0 + sb, ns)) if gb == 1 else slice(None)
            )
            if half:
                # exact half-spectrum streams: real main block + Nyquist
                # corrections (tests/test_half_spectrum.py).  Both streams
                # ride ONE set of contractions: per-node rows are
                # independent, so concatenating the g1/g2 table slices on
                # the node axis is bit-identical.
                take = lambda t: jax.tree.map(lambda a: a[sl], t)
                if rev1:
                    # one stream of main-block transforms; g1(v) = g2(-v)
                    # exactly for centrally symmetric f
                    r2 = _g_main_half(
                        fhs, take(mxy2[1]), take(mxy2[0]), take(mzh2g),
                        cmax, slw, ftail, merged=mg,
                    )
                    r1 = _g1_from_g2(r2, take(gwn))
                else:
                    cat = lambda a, b: jax.tree.map(
                        lambda x, y: jnp.concatenate((x, y)), a, b
                    )
                    r12 = _g_main_half(
                        fhs,
                        cat(take(mxy1[1]), take(mxy2[1])),
                        cat(take(mxy1[0]), take(mxy2[0])),
                        cat(take(mzh1g), take(mzh2g)),
                        cmax, slw, ftail, merged=mg,
                    )
                    c = r12.hi.shape[0] // 2
                    r1 = jax.tree.map(lambda a: a[:c], r12)
                    r2 = jax.tree.map(lambda a: a[c:], r12)
                part = _hadamard_wsum_half(
                    r1, take(c1g), r2, take(c2g), signs, groups=gb,
                )
                # part is Re(sum w h) only — Im(h) provably never reaches
                # Q (see _hadamard_wsum_half), so the group sum stays a
                # REAL field and the forward transform below runs real_in
                # (gb > 1: part is the (gb,) stack of per-group sums)
                s = part if s is None else ds.add(s, part)
                continue
            elif nodemat:
                # phase-folded per-node matrices: no phase arithmetic
                m1 = tuple(jax.tree.map(lambda a: a[sl], m) for m in pm1)
                m2 = tuple(jax.tree.map(lambda a: a[sl], m) for m in pm2)
                g1 = oz.transform3_oz_nodemat(
                    f_hat, m1, cmax=cmax, w=slw, fold_tail=ftail, merged=mg,
                )
                g2 = oz.transform3_oz_nodemat(
                    f_hat, m2, cmax=cmax, w=slw, fold_tail=ftail, merged=mg,
                )
            elif phased:
                ph = (_cindex(ax, sl), _cindex(ay, sl), _cindex(az, sl))
                g1 = oz.transform3_oz_phased(
                    f_hat, pre.vinv_sl, ph, conj=False,
                    cmax=cmax, w=slw, fold_tail=ftail,
                )
                g2 = oz.transform3_oz_phased(
                    f_hat, pre.vinv_sl, ph, conj=True,
                    cmax=cmax, w=slw, fold_tail=ftail,
                )
            else:
                # a1[s, x, y, z] = ax[s, x] * ay[s, y] * az[s, z]
                a_yz = ds.cmul(
                    _cindex(ay, (sl, slice(None), None)),
                    _cindex(az, (sl, None, slice(None))),
                )  # (sb, N, N)
                a1 = ds.cmul(
                    _cindex(ax, (sl, slice(None), None, None)),
                    _cindex(a_yz, (slice(None), None, slice(None), slice(None))),
                )  # (sb, N, N, N)
                t1, t2 = ds.cmul_both(a1, f_hat)
                g1 = tf_inv(t1)
                g2 = tf_inv(t2)
            # weighted group sum BEFORE the forward transform (beta1 is
            # shared within the radial group; hoisting is exact by linearity)
            part = _hadamard_wsum(g1, g2, _cindex(gw, sl))
            s = part if s is None else ds.cadd(s, part)
        if half and herm:
            hm, q = _fwd_herm_half(
                s, ckc, fwd_xy, pre.vfwd_zh_sl, signs[2]
            )
            # the plane transform is batched across groups after the scan;
            # q rides out as a scan output
            if gb > 1:
                # per-group beta1 accumulation, in the same global group
                # order as gb=1 (sequential compensated adds)
                for g in range(gb):
                    tk = lambda t, _g=g: jax.tree.map(lambda a: a[_g], t)
                    acc = ds.cadd(acc, ds.cmul_ds(tk(hm), tk(b1h)))
                return acc, q
            return ds.cadd(acc, ds.cmul_ds(hm, b1h)), q
        if half:
            h_hat = tf_fwd(ds.cds_from_real(s), real_in=True)
            if gb > 1:
                for g in range(gb):
                    tk = lambda t, _g=g: jax.tree.map(lambda a: a[_g], t)
                    acc = ds.cadd(acc, ds.cmul_ds(tk(h_hat), tk(b1)))
                return acc, None
        else:
            h_hat = tf_fwd(s)
        return ds.cadd(acc, ds.cmul_ds(h_hat, b1)), None

    if half:
        nxg, nyg, nzg = cfg.grid_shape
        acc0 = (
            ds.czeros((nxg, nyg, nzg // 2), f.hi.dtype)
            if herm else ds.czeros(cfg.grid_shape, f.hi.dtype)
        )
        if rev1:
            # stream-1 tables (pm1, pmz_half1w) stay out of the scan
            # entirely — no per-step slicing DMA for dead operands
            xs = (
                beta1h if herm else pre.beta1,
                (pre.pm2[0], pre.pm2[1]), pre.pmz_half2, corr1, corr2,
                pre.gain_w,
            )
        else:
            xs = (
                beta1h if herm else pre.beta1,
                (pre.pm1[0], pre.pm1[1]), (pre.pm2[0], pre.pm2[1]),
                pre.pmz_half1w, pre.pmz_half2, corr1, corr2,
            )
        if gb > 1:
            # fold `gb` radial groups into each scan step: spatial-field
            # entries (beta1) gain a (gb,) axis, node-carrying tables
            # (per-node matrices, correction planes) merge the group axis
            # into their node axis (group-major — the kernel's per-group
            # sum windows and the downstream accumulation order match the
            # gb=1 sequence exactly)
            n_gl = xs[0].hi.shape[0]
            if n_gl % gb:
                raise ValueError(
                    f"group_batch={gb} must divide the radial group "
                    f"count {n_gl}"
                )
            grp = lambda t: jax.tree.map(
                lambda a: a.reshape((n_gl // gb, gb) + a.shape[1:]), t
            )
            nod = lambda t: jax.tree.map(
                lambda a: a.reshape(
                    (n_gl // gb, gb * a.shape[1]) + a.shape[2:]
                ),
                t,
            )
            xs = (grp(xs[0]),) + tuple(nod(t) for t in xs[1:])
    elif nodemat:
        acc0 = ds.czeros(cfg.grid_shape, f.hi.dtype)
        xs = (pre.gain_w, pre.beta1, pre.pm1, pre.pm2)
    else:
        acc0 = ds.czeros(cfg.grid_shape, f.hi.dtype)
        xs = (pre.ax, pre.ay, pre.az, pre.gain_w, pre.beta1)
    q_gain_hat, qs = jax.lax.scan(group, acc0, xs)

    if half and herm:
        # Hermitian finale: the loss spectrum beta2*f_hat is Hermitian too
        # (f real), so it rides the same half-z main + Nyquist-plane
        # inverse, stacked with the gain on a leading axis (one launch set).
        # The per-group Nyquist line sums q transform in ONE batched 2-D
        # launch set, then beta1-weight and fold (compensated, fixed order).
        am = q_gain_hat
        if gb > 1:
            # per-step q stacks are (n_gl/gb, gb, Nx, Ny) — flatten back to
            # the per-group order the beta1p table carries
            qs = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), qs)
        ap = _cds_sum_first(
            ds.cmul_ds(_fwd2_batched(qs, ckc, fwd_xy), beta1p)
        )
        if gain_reduce is not None:
            am, ap = gain_reduce(am), gain_reduce(ap)
        b2h = jax.tree.map(lambda a: a[..., :nzh], pre.beta2)
        b2p = jax.tree.map(lambda a: a[..., nzh], pre.beta2)
        fh = jax.tree.map(lambda a: a[..., :nzh], f_hat)
        fp = jax.tree.map(lambda a: a[..., nzh], f_hat)
        stk = lambda a, b: jax.tree.map(
            lambda x, y: jnp.stack((x, y)), a, b
        )
        inv = _inv_herm_half(
            stk(am, ds.cmul_ds(fh, b2h)), stk(ap, ds.cmul_ds(fp, b2p)),
            ckc, inv_xy, pre.vinv_zh_sl, nzg, signs[2],
        )
        q_gain = jax.tree.map(lambda a: a[0], inv)
        loss = jax.tree.map(lambda a: a[1], inv)
        return ds.sub(q_gain, ds.mul(loss, f))

    if gain_reduce is not None:
        q_gain_hat = gain_reduce(q_gain_hat)

    # one stacked launch for both final inverses (gain + loss share the
    # transform; rows are independent, so stacking is bit-identical)
    both = jax.tree.map(
        lambda a, b: jnp.stack((a, b)),
        q_gain_hat, ds.cmul_ds(f_hat, pre.beta2),
    )
    inv = tf_inv(both, real_out=True).re
    q_gain = jax.tree.map(lambda a: a[0], inv)
    loss = jax.tree.map(lambda a: a[1], inv)
    return ds.sub(q_gain, ds.mul(loss, f))


def make_ds_collision_operator(
    cfg: CollisionConfig, jit: bool = True, dtype=np.float32,
    sub_batch: int = 2, contract: Optional[str] = None,
    oz_cmax: Optional[int] = None, g_stream: str = "full",
    group_batch: int = 1, oz_merge: Optional[bool] = None,
    g1_reversal: bool = False,
) -> Tuple[Callable[[DS, DsPrecomp], DS], DsPrecomp]:
    """Build the compensated operator: ``(collide_fn, ds_precomp)``.

    Same factory shape as :func:`boltzfft.make_collision_operator`;
    ``collide_fn(f_ds, pre) -> Q_ds`` with ds pairs on both ends.
    ``contract=None`` takes the backend's engine from
    :func:`boltzfft.device.pipeline_choice`; ``oz_cmax`` is the Ozaki
    retention level, ``g_stream`` the inverse-stream formulation,
    ``group_batch`` the radial-group batching, ``oz_merge`` the K-merged
    contraction toggle, and ``g1_reversal`` the opt-in even-symmetry
    stream reuse (see :func:`collide_ds`).
    """
    pre = build_ds_precomp(cfg, dtype)
    fn = partial(
        collide_ds, cfg, sub_batch=sub_batch,
        contract=contract or pipeline_choice().ds_contract, oz_cmax=oz_cmax,
        g_stream=g_stream, group_batch=group_batch, oz_merge=oz_merge,
        g1_reversal=g1_reversal,
    )

    def collide_fn(f, precomp):
        if not isinstance(f, DS):
            f = ds.from_float(jnp.asarray(f, dtype))
        return fn(precomp, f)

    if jit:
        collide_fn = jax.jit(collide_fn)
    return collide_fn, pre


# ---------------------------------------------------------------------------
# multi-chip ds: radial-axis sharding with a COMPENSATED cross-device fold
# ---------------------------------------------------------------------------


def _pad_radial(pre: DsPrecomp, n_groups: int) -> DsPrecomp:
    """Pad the leading radial axis to ``n_groups`` with zero-weight groups.

    Padded groups carry ``gain_w = 0`` so they contribute exactly nothing to
    the gain sum (their phase/beta1 entries are zeros — finite, unused)."""
    have = pre.gain_w.hi.shape[0]
    if n_groups == have:
        return pre

    def pad(a):
        width = [(0, n_groups - have)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, width)

    padded = jax.tree.map(
        pad,
        (pre.ax, pre.ay, pre.az, pre.gain_w, pre.beta1, pre.pm1, pre.pm2,
         pre.pmz_half2, pre.nyq_coef,
         pre.pmz_half1w, pre.nyq_coef_w),
    )
    return pre._replace(
        ax=padded[0], ay=padded[1], az=padded[2],
        gain_w=padded[3], beta1=padded[4], pm1=padded[5], pm2=padded[6],
        pmz_half2=padded[7], nyq_coef=padded[8],
        pmz_half1w=padded[9], nyq_coef_w=padded[10],
    )


def _ds_precomp_specs(radial_axis: Optional[str]):
    """shard_map PartitionSpec prefix-tree for a DsPrecomp: per-radial-group
    tables sharded on their leading axis, shared tables replicated."""
    from jax.sharding import PartitionSpec as P

    shard = P(radial_axis)
    rep = P()
    return DsPrecomp(
        ax=shard, ay=shard, az=shard, gain_w=shard, beta1=shard,
        beta2=rep, vfwd=rep, vinv=rep, vfwd_sl=rep, vinv_sl=rep,
        pm1=shard, pm2=shard,
        pmz_half2=shard, nyq_coef=shard,
        pmz_half1w=shard, nyq_coef_w=shard,
        vfwd_zh_sl=rep, vinv_zh_sl=rep,
    )


def make_sharded_ds_collision_operator(
    cfg: CollisionConfig,
    mesh,
    radial_axis: Optional[str] = "node",
    ensemble_axis: Optional[str] = None,
    jit: bool = True,
    dtype=np.float32,
    sub_batch: int = 2,
    contract: Optional[str] = None,
    oz_cmax: Optional[int] = None,
    g_stream: str = "full",
    herm_downstream: bool = True,
    group_batch: int = 1,
    oz_merge: Optional[bool] = None,
    g1_reversal: bool = False,
) -> Tuple[Callable[[DS, DsPrecomp], DS], DsPrecomp]:
    """f64-class collision evals sharded over a device mesh.

    The radial quadrature groups spread over ``radial_axis`` (the analog of
    :func:`boltzfft.make_sharded_collision_operator`'s node sharding; the ds
    scan is over radial groups, so that is the natural shard unit).  The
    cross-device gain reduction CANNOT be a plain ``psum`` — the f32
    collective would round the compensated pairs back to 2^-24 — so each
    device ``all_gather``s the partial gain spectra and folds them with ds
    adds in a fixed order: deterministic, ~49-bit, identical on every device.

    ``ensemble_axis`` additionally shards a leading ensemble dimension of
    ``f`` (no communication).  Returns ``(collide_fn, precomp)`` with the
    precomp's radial tables padded to shard evenly; place them with
    :func:`place_ds`.

    ``herm_downstream``/``group_batch``/``oz_merge`` forward to
    :func:`collide_ds` per shard (``group_batch`` must divide the
    SHARD-LOCAL radial group count).
    """
    from jax.sharding import PartitionSpec as P

    if radial_axis is None and ensemble_axis is None:
        raise ValueError("need at least one of radial_axis/ensemble_axis")
    n_shards = mesh.shape[radial_axis] if radial_axis else 1
    pre = build_ds_precomp(cfg, dtype)
    n_gl = pre.gain_w.hi.shape[0]
    pre = _pad_radial(pre, -(-n_gl // n_shards) * n_shards)
    engine = contract or pipeline_choice().ds_contract

    def folded_gather(q: CDS) -> CDS:
        parts = jax.tree.map(
            lambda a: jax.lax.all_gather(a, radial_axis, axis=0), q
        )
        acc = jax.tree.map(lambda a: a[0], parts)
        for i in range(1, n_shards):
            acc = ds.cadd(acc, jax.tree.map(lambda a: a[i], parts))
        return acc

    reducer = folded_gather if (radial_axis and n_shards > 1) else None

    def body(f, p):
        one = lambda fi: collide_ds(
            cfg, p, fi, sub_batch=sub_batch, contract=engine,
            gain_reduce=reducer, oz_cmax=oz_cmax, g_stream=g_stream,
            herm_downstream=herm_downstream, group_batch=group_batch,
            oz_merge=oz_merge, g1_reversal=g1_reversal,
        )
        if ensemble_axis is not None:
            return jax.vmap(one)(f)
        return one(f)

    f_spec = P(ensemble_axis) if ensemble_axis is not None else P()
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(f_spec, _ds_precomp_specs(radial_axis)),
        out_specs=f_spec,
        check_vma=False,
    )

    def collide_fn(f, precomp):
        if not isinstance(f, DS):
            f = ds.from_float(jnp.asarray(f, dtype))
        return sharded(f, precomp)

    if jit:
        collide_fn = jax.jit(collide_fn)
    return collide_fn, pre


def place_ds(pre: DsPrecomp, mesh, radial_axis: Optional[str] = "node") -> DsPrecomp:
    """Device-put DsPrecomp leaves with their intended shardings."""
    from jax.sharding import NamedSharding

    specs = _ds_precomp_specs(radial_axis)

    def put(leaf_tree, spec):
        return jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, spec)), leaf_tree
        )

    return DsPrecomp(*(put(getattr(pre, f), getattr(specs, f)) for f in pre._fields))
