"""Math validation for the exact half-spectrum g-stream decomposition.

The ds-oz pipeline's dominant cost (measured 82% at 64^3, see
docs/PERFORMANCE.md) is the per-node inverse transforms
``g = IFFT3(alpha . f_hat)``.  For REAL input f the spectrum
``alpha . f_hat`` is Hermitian *except on the Nyquist hyperplanes* (the
mode ``-N/2`` has no ``+N/2`` partner, so ``alpha(-l) = conj(alpha(l))``
fails there — the reason the naive g-realness shortcut was rejected in
round 3, ``ds_operator.py``).  The exact fix validated here: partition the
mode set per axis into non-Nyquist indices ``K'`` and the Nyquist index,
giving 8 blocks by which axes sit at Nyquist:

    g = MAIN   (3-D block over K'^3, exactly real -> half-spectrum
                transform with halved z extent and doubled interior
                weights)
      + 3 PLANE terms  (one axis at Nyquist: ``nu_a (-1)^{j_a} (x)`` a
                2-D reduced transform of that Nyquist plane, exactly real)
      + 3 LINE terms   (two axes at Nyquist: 1-D reduced transforms)
      + 1 POINT term   (the all-Nyquist corner, a real scalar).

Every reduced transform is real because each block's data is Hermitian on
its own reduced index set (closed under negation once Nyquist is removed)
and the phases satisfy ``alpha(-k) = conj(alpha(k))`` on ``K'``.  No
approximation anywhere — this is an exact regrouping of the full complex
sum, turning ~7/12 of the transform MACs real-output-redundant.

Reference for the direct form: ``FFTWBoltzmannOperator.cpp:204-230``
(alpha build + batched inverse transforms).
"""

from __future__ import annotations

import numpy as np
import pytest

from boltzfft import modes as _modes


def _axis_phase(n: int, rho_sigma: float, length: float) -> np.ndarray:
    """Production-form separable phase: exp(i * coef * rho*sigma_axis * l)
    (build_ds_precomp's axis_phase_c128, one node)."""
    coef = -np.pi / (2.0 * length)
    return np.exp(1j * coef * rho_sigma * _modes.fft_modes(n))


def _rng_real_f(shape, seed=0):
    rng = np.random.default_rng(seed)
    # adversarial: full-scale white noise — every Nyquist mode populated
    # (smooth BKW-like inputs underweight the correction terms)
    return rng.standard_normal(shape)


def _decomposed_g(f, ax, ay, az):
    """The 8-block decomposition, assembled exactly as the pipeline will:
    half-spectrum main + plane/line/point corrections."""
    nx, ny, nz = f.shape
    F = np.fft.fftn(f)
    hx, hy, hz = nx // 2, ny // 2, nz // 2  # Nyquist indices
    nux, nuy, nuz = ax[hx], ay[hy], az[hz]

    kx = np.arange(nx) != hx  # K' masks
    ky = np.arange(ny) != hy
    kz = np.arange(nz) != hz

    # ---- MAIN: K'^3 block via the halved-z real form --------------------
    S0 = (ax[:, None, None] * ay[None, :, None] * az[None, None, :]) * F
    S0 = S0 * kx[:, None, None] * ky[None, :, None] * kz[None, None, :]
    # complex 2-D inverse over x,y; then the weighted half-z sum
    T = np.fft.ifft2(S0, axes=(0, 1))  # (nx, ny, nz) spatial x,y
    jz = np.arange(nz)
    r_main = np.zeros(f.shape)
    for k in range(hz):  # kz in 0..N/2-1 (z-Nyquist excluded from main)
        w = 1.0 if k == 0 else 2.0
        e = np.exp(2j * np.pi * jz * k / nz) / nz
        r_main += w * np.real(T[:, :, k][:, :, None] * e[None, None, :])

    # ---- PLANES ----------------------------------------------------------
    def plane_term(axis):
        if axis == 2:  # z-Nyquist plane, reduced over (x, y)
            data = (ax[:, None] * ay[None, :]) * F[:, :, hz]
            data = data * kx[:, None] * ky[None, :]
            red = np.fft.ifft2(data)  # (nx, ny)
            assert np.max(np.abs(red.imag)) < 1e-13 * max(
                1.0, np.max(np.abs(red))
            ), "reduced plane transform must be exactly real"
            pat = (-1.0) ** jz / nz
            return nuz * red.real[:, :, None] * pat[None, None, :]
        if axis == 0:  # x-Nyquist plane, reduced over (y, z)
            data = (ay[:, None] * az[None, :]) * F[hx, :, :]
            data = data * ky[:, None] * kz[None, :]
            red = np.fft.ifft2(data)
            pat = (-1.0) ** np.arange(nx) / nx
            return nux * pat[:, None, None] * red.real[None, :, :]
        data = (ax[:, None] * az[None, :]) * F[:, hy, :]  # y plane
        data = data * kx[:, None] * kz[None, :]
        red = np.fft.ifft2(data)
        pat = (-1.0) ** np.arange(ny) / ny
        return nuy * red.real[:, None, :] * pat[None, :, None]

    # ---- LINES -----------------------------------------------------------
    jx, jy = np.arange(nx), np.arange(ny)

    def line_term(free_axis):
        if free_axis == 2:  # x,y at Nyquist; 1-D reduced over z
            data = az * F[hx, hy, :] * kz
            red = np.fft.ifft(data)
            pat = np.outer((-1.0) ** jx, (-1.0) ** jy) / (nx * ny)
            return nux * nuy * pat[:, :, None] * red.real[None, None, :]
        if free_axis == 0:
            data = ax * F[:, hy, hz] * kx
            red = np.fft.ifft(data)
            pat = np.outer((-1.0) ** jy, (-1.0) ** jz) / (ny * nz)
            return nuy * nuz * red.real[:, None, None] * pat[None, :, :]
        data = ay * F[hx, :, hz] * ky
        red = np.fft.ifft(data)
        pat = np.outer((-1.0) ** jx, (-1.0) ** jz) / (nx * nz)
        return nux * nuz * red.real[None, :, None] * pat[:, None, :]

    corr = sum(plane_term(a) for a in range(3))
    corr = corr + sum(line_term(a) for a in range(3))
    # ---- POINT -----------------------------------------------------------
    corner = F[hx, hy, hz]
    assert abs(corner.imag) < 1e-12 * max(1.0, abs(corner))
    pat = (
        np.multiply.outer(np.outer((-1.0) ** jx, (-1.0) ** jy), (-1.0) ** jz)
        / (nx * ny * nz)
    )
    corr = corr + (nux * nuy * nuz) * corner.real * pat
    return r_main + corr


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 16, 16), (8, 16, 12)])
@pytest.mark.parametrize("seed", [0, 3])
def test_half_spectrum_decomposition_exact(shape, seed):
    """main + planes + lines + point == IFFT3(alpha . fftn(f)) to f64 eps,
    on white noise (all Nyquist modes hot), both alpha streams."""
    f = _rng_real_f(shape, seed)
    length = 7.0
    rs = 1.37  # rho * sigma_axis products, one per axis
    ax = _axis_phase(shape[0], rs * 0.61, length)
    ay = _axis_phase(shape[1], rs * -0.34, length)
    az = _axis_phase(shape[2], rs * 0.94, length)
    for conj in (False, True):  # g1 and g2 streams
        a1, a2, a3 = (
            (np.conj(ax), np.conj(ay), np.conj(az)) if conj else (ax, ay, az)
        )
        g_direct = np.fft.ifftn(
            (a1[:, None, None] * a2[None, :, None] * a3[None, None, :])
            * np.fft.fftn(f)
        )
        g_dec = _decomposed_g(f, a1, a2, a3)
        scale = np.max(np.abs(g_direct))
        # the decomposition reproduces BOTH parts of the complex g: the
        # real part (main + Re-coefficient corrections) and the imaginary
        # part (Im-coefficient corrections -- the Nyquist 'junk' the
        # Hadamard h = g1 . g2 needs for bit-parity with the reference)
        assert np.max(np.abs(g_dec.real - g_direct.real)) < 5e-15 * scale
        assert np.max(np.abs(g_dec.imag - g_direct.imag)) < 5e-15 * scale


def test_half_z_matrix_form():
    """The main block's z stage as the (N/2, N) real-out matrix the
    contraction uses: out = Re(t @ M) with M[k, jz] = wt_k * alpha_z(k) *
    exp(2i pi jz k / N) / N — equals the loop form above."""
    n = 16
    rng = np.random.default_rng(7)
    t = rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
    # impose the Hermitian pair structure the pipeline guarantees:
    # t(-k) = conj(t(k)), t(0) real, Nyquist entry irrelevant (excluded)
    t[:, 0] = t[:, 0].real
    for k in range(1, n // 2):
        t[:, n - k] = np.conj(t[:, k])
    az = _axis_phase(n, 0.83, 7.0)
    full = np.zeros((5, n))
    for k in list(range(0, n // 2)) + list(range(n // 2 + 1, n)):
        e = np.exp(2j * np.pi * np.arange(n) * k / n) / n
        full += np.real(az[k] * t[:, k][:, None] * e[None, :])
    wt = np.ones(n // 2)
    wt[1:] = 2.0
    M = (
        wt[:, None]
        * az[: n // 2, None]
        * np.exp(2j * np.pi * np.outer(np.arange(n // 2), np.arange(n)) / n)
        / n
    )
    half = np.real(t[:, : n // 2] @ M)
    np.testing.assert_allclose(half, full, rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# pipeline integration: collide_ds(g_stream="half")
# ---------------------------------------------------------------------------

import jax  # noqa: E402  (conftest pins the CPU x64 backend)
import jax.numpy as jnp  # noqa: E402

import boltzfft as bz  # noqa: E402
from boltzfft import ds  # noqa: E402
from boltzfft.ds_operator import build_ds_precomp, collide_ds  # noqa: E402


def _noise_f(cfg, seed=0):
    """Nyquist-rich adversarial input (white noise, positive)."""
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal(cfg.grid_shape)) + 0.1


class TestHalfStreamPipeline:
    def test_half_matches_vpu_on_nyquist_rich_input(self):
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=2, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu", sub_batch=6))
        q_half = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       sub_batch=6)
        )
        rel = np.max(np.abs(q_half - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel < 1e-12, rel  # measured ~1.4e-14 (ds noise floor)

    def test_herm_downstream_off_matches_vpu(self):
        # the full-spectrum downstream (herm_downstream=False — the >32^3
        # default) must match too; the True variant is covered by the
        # nv=6 tests above via the auto rule (on for grids <= 32/axis,
        # which also exercises the non-power-of-two 1/Nz ds constant and
        # the odd Nz/2=3 line-sum tree)
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=2, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg, seed=3))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        q = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       herm_downstream=False)
        )
        rel = np.max(np.abs(q - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel < 1e-12, rel

    @pytest.mark.slow
    def test_half_matches_f64_reference(self):
        # the same bar as the round-3 Nyquist regression test: an
        # under-resolved input with O(1) Nyquist content must match the
        # complex f64 reference to ds accuracy
        rng = np.random.RandomState(7)
        cfg64 = bz.CollisionConfig(nv=6, ns=6, n_radial=3, impl="c2c",
                                   dtype="float64")
        coll, pre64 = bz.make_collision_operator(cfg64)
        g = cfg64.velocity_grid
        f64 = np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float64)
        f64 = f64 * (1.0 + 0.3 * rng.rand(*f64.shape))
        q_ref = np.asarray(coll(f64, pre64), np.float64)
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=3, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        q = ds.to_f64(
            collide_ds(cfg, pre, ds.from_f64(f64), contract="oz",
                       g_stream="half", sub_batch=6)
        )
        rel = np.max(np.abs(q - q_ref)) / np.max(np.abs(q_ref))
        assert rel < 1e-12, rel

    @pytest.mark.slow
    def test_half_anisotropic(self):
        cfg = bz.CollisionConfig(nv=6, nvy=8, nvz=10, ns=6, n_radial=2,
                                 impl="c2c", dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg, seed=3))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu", sub_batch=6))
        q_half = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       sub_batch=6)
        )
        rel = np.max(np.abs(q_half - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel < 1e-12, rel

    def _group_batch_parity(self, herm, gbs):
        # radial-group launch batching (group_batch>1) must be a pure
        # layout change: per-group Hadamard sums, forward transforms, and
        # the beta1 accumulation order are the gb=1 sequence exactly, so
        # parity here is BIT-level against gb=1.
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg, seed=5))
        kw = dict(contract="oz", g_stream="half", herm_downstream=herm,
                  sub_batch=6)
        q1 = ds.to_f64(collide_ds(cfg, pre, f, group_batch=1, **kw))
        for gb in gbs:
            qb = ds.to_f64(collide_ds(cfg, pre, f, group_batch=gb, **kw))
            rel = np.max(np.abs(qb - q1)) / np.max(np.abs(q1))
            assert rel < 1e-13, (gb, rel)  # same-op-order: ~0 expected

    def test_group_batch_matches_vpu(self):
        # default tier: one gb=2 program (the production small-grid shape:
        # herm downstream, multi-group batches, mid-scan restarts)
        # against the cheap-to-compile vpu reference; the strict gb=1
        # bit-parity sweep lives in the slow tier
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg, seed=5))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        qb = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       herm_downstream=True, group_batch=2)
        )
        rel = np.max(np.abs(qb - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel < 1e-12, rel

    @pytest.mark.slow
    def test_group_batch_full_sweep(self):
        self._group_batch_parity(herm=True, gbs=(2, 4))
        self._group_batch_parity(herm=False, gbs=(2, 4))

    def test_group_batch_requires_half_path(self):
        # the knob must not be silently ignored on non-half engines
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg))
        with pytest.raises(ValueError, match="half"):
            collide_ds(cfg, pre, f, contract="vpu", group_batch=2)

    def test_group_batch_must_divide(self):
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg))
        with pytest.raises(ValueError, match="divide"):
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       group_batch=3)

    def test_half_requires_tables(self):
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=2, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg, node_mats=False)
        f = ds.from_f64(_noise_f(cfg))
        with pytest.raises(ValueError, match="half"):
            collide_ds(cfg, pre, f, contract="oz", g_stream="half")


class TestMergedContraction:
    """K-merged complex contraction (oz_merge / contract_last_oz_nodemat
    merged=True): both CDS components ride one double-height Ozaki dot so
    the compensated fold runs half the level lists.  Exactness of the
    single-accumulator level dots is gated by oz.merge_ok; results agree
    with the unmerged engine to the ds noise floor (shared per-row slicing
    scale), not bitwise."""

    def test_merged_pipeline_matches_vpu(self):
        from boltzfft import oz

        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=2, impl="c2c",
                                 dtype="float32")
        assert oz.merge_ok(6)  # the gate is live at this size
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg, seed=11))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        for gs in ("full", "half"):
            q = ds.to_f64(
                collide_ds(cfg, pre, f, contract="oz", g_stream=gs,
                           oz_merge=True)
            )
            rel = np.max(np.abs(q - q_vpu)) / np.max(np.abs(q_vpu))
            assert rel < 1e-12, (gs, rel)

    def test_merged_stage_exact_on_mismatched_scales(self):
        # shared per-row scale: the smaller component is sliced against the
        # larger one's sigma — still ds-floor-exact even at 10^6 magnitude
        # mismatch between re and im
        from boltzfft import oz

        rng = np.random.default_rng(2)
        re = rng.standard_normal((8, 16)) * 1e3
        im = rng.standard_normal((8, 16)) * 1e-3
        x = oz.CDS(ds.from_f64(re), ds.from_f64(im))
        m64 = rng.standard_normal((2, 16, 12)) + 1j * rng.standard_normal(
            (2, 16, 12)
        )
        m = oz.slice_matrix_nodes(m64)
        out = oz.contract_last_oz_nodemat(
            x, m, repeat=True, merged=True
        )
        val = (
            np.asarray(out.re.hi, np.float64) + np.asarray(out.re.lo, np.float64)
        ) + 1j * (
            np.asarray(out.im.hi, np.float64) + np.asarray(out.im.lo, np.float64)
        )
        exact = np.einsum("rk,ckl->crl", re + 1j * im, m64)
        rel = np.max(np.abs(val - exact)) / np.max(np.abs(exact))
        assert rel < 1e-13, rel

    def test_merged_real_out_matches_unmerged(self):
        from boltzfft import oz

        rng = np.random.default_rng(3)
        re = rng.standard_normal((16, 8))
        im = rng.standard_normal((16, 8))
        x = oz.CDS(ds.from_f64(re), ds.from_f64(im))
        m64 = rng.standard_normal((2, 8, 16)) + 1j * rng.standard_normal(
            (2, 8, 16)
        )
        m = oz.slice_matrix_nodes(m64)
        a = oz.contract_last_oz_nodemat(
            x, m, repeat=True, real_out=True
        )
        b = oz.contract_last_oz_nodemat(
            x, m, repeat=True, real_out=True, merged=True
        )
        va = np.asarray(a.re.hi, np.float64) + np.asarray(a.re.lo, np.float64)
        vb = np.asarray(b.re.hi, np.float64) + np.asarray(b.re.lo, np.float64)
        rel = np.max(np.abs(va - vb)) / np.max(np.abs(va))
        assert rel < 1e-13, rel

    def test_merged_raises_beyond_exactness_bound(self):
        # at K=128 the merged level dot would overflow the exact-f32
        # accumulation budget (merge_ok false) — explicit merged=True must
        # raise, and the pipeline's auto gate must stay unmerged silently
        from boltzfft import oz

        assert not oz.merge_ok(128)
        rng = np.random.default_rng(4)
        x = oz.CDS(
            ds.from_f64(rng.standard_normal((8, 128))),
            ds.from_f64(rng.standard_normal((8, 128))),
        )
        m = oz.slice_matrix_nodes(
            rng.standard_normal((1, 128, 8))
            + 1j * rng.standard_normal((1, 128, 8))
        )
        with pytest.raises(ValueError, match="merge"):
            oz.contract_last_oz_nodemat(
                x, m, repeat=True, merged=True
            )


def _even_f(cfg, seed=0):
    """Centrally-symmetric positive input: ``f(v) = f(-v)``.  The grid is
    cell-centered (``v_j + v_{N-1-j} = 0``, grid.py), so physical reversal
    is the pure index flip ``j -> N-1-j`` — NOT ``j -> (N-j) mod N``
    (node-centered convention; BKW states are flip-even but have an O(1)
    defect under the mod-N map)."""
    f = _noise_f(cfg, seed)
    return 0.5 * (f + f[::-1, ::-1, ::-1])


class TestG1Reversal:
    """Opt-in even-symmetry stream reuse: g1(v) = g2(-v) holds IFF f is
    centrally symmetric, ``f(v) = f(-v)`` (e.g. BKW/Maxwellian states).
    The stream phase tables are exact conjugates (``pm1 = conj(pm2)``,
    ds_operator.py build_ds_precomp), so for even f stream 1's main block
    is the physical flip (``j -> N-1-j``, cell-centered grid) of stream
    2's.  For general f the identity is FALSE (measured rel ~0.5 on
    noise) — collide_ds ``g1_reversal`` is therefore strictly opt-in,
    default OFF."""

    def test_g1_equals_reversed_g2_oracle(self):
        # end-to-end table identity through the REAL forward (the earlier
        # oracle fed a raw array as the spectrum, which validated the map
        # for an input class no physical state belongs to — raw BKW then
        # failed at rel ~4; this one uses the pipeline's own f_hat)
        from boltzfft.ds_operator import (
            DS_PIPELINE_FOLD_TAIL, _g_main_half, _pipeline_slicing,
        )

        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        slw, _, cmax = _pipeline_slicing(cfg)
        g = cfg.velocity_grid
        fm = np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float64)
        fh = ds.transform3(ds.cds_from_real(ds.from_f64(fm)), m=pre.vfwd,
                           real_in=True)
        nx, ny, nz = cfg.grid_shape
        nzh = nz // 2
        kxm = jnp.asarray(np.arange(nx) != nx // 2, jnp.float32)
        kym = jnp.asarray(np.arange(ny) != ny // 2, jnp.float32)
        fmask = kxm[:, None, None] * kym[None, :, None]
        fhs = ds._swap_last2(
            jax.tree.map(lambda a: a[..., :nzh] * fmask, fh)
        )
        take0 = lambda t: jax.tree.map(lambda a: a[0, :2], t)
        ft = DS_PIPELINE_FOLD_TAIL
        r1w = _g_main_half(fhs, take0(pre.pm1[1]), take0(pre.pm1[0]),
                           take0(pre.pmz_half1w), cmax, slw, ft, merged=True)
        r2 = _g_main_half(fhs, take0(pre.pm2[1]), take0(pre.pm2[0]),
                          take0(pre.pmz_half2), cmax, slw, ft, merged=True)
        w = (np.asarray(pre.gain_w.hi[0, :2], np.float64)
             + np.asarray(pre.gain_w.lo[0, :2], np.float64))
        v1 = np.asarray(r1w.hi, np.float64) + np.asarray(r1w.lo, np.float64)
        v2 = (np.asarray(r2.hi, np.float64)
              + np.asarray(r2.lo, np.float64)) * w[:, None, None, None]
        rev = lambda a: a[:, ::-1, ::-1, ::-1]  # physical flip, see _rev_v
        rel = np.max(np.abs(v1 - rev(v2))) / np.max(np.abs(v1))
        assert rel < 1e-12, rel

    def test_reversal_pipeline_matches_vpu_on_bkw(self):
        # the production use case: a RAW BKW state (not symmetrized by
        # hand) through the full pipeline with the reversal on
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        fm = np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5),
                        np.float64)
        f = ds.from_f64(fm)
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        q = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       g1_reversal=True)
        )
        rel = np.max(np.abs(q - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel < 1e-12, rel

    def test_reversal_pipeline_matches_vpu_on_even_f(self):
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_even_f(cfg, seed=18))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        for kw in ({}, {"group_batch": 2}, {"herm_downstream": False}):
            q = ds.to_f64(
                collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                           g1_reversal=True, **kw)
            )
            rel = np.max(np.abs(q - q_vpu)) / np.max(np.abs(q_vpu))
            assert rel < 1e-12, (kw, rel)

    def test_reversal_wrong_for_general_f(self):
        # the identity is false off the even-symmetry manifold — the knob
        # must stay opt-in; this guards against ever auto-enabling it
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg, seed=18))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        q_def = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half")
        )
        rel_def = np.max(np.abs(q_def - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel_def < 1e-12, rel_def  # default (no reversal) is exact
        q_rev = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       g1_reversal=True)
        )
        rel_rev = np.max(np.abs(q_rev - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel_rev > 1e-3, rel_rev  # and reversal on noise is NOT

    def test_reversal_anisotropic(self):
        cfg = bz.CollisionConfig(nv=6, nvy=8, nvz=10, ns=6, n_radial=4,
                                 impl="c2c", dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_even_f(cfg, seed=19))
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        q = ds.to_f64(
            collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       g1_reversal=True)
        )
        rel = np.max(np.abs(q - q_vpu)) / np.max(np.abs(q_vpu))
        assert rel < 1e-12, rel

    def test_reversal_requires_half_path(self):
        cfg = bz.CollisionConfig(nv=6, ns=6, n_radial=4, impl="c2c",
                                 dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(_noise_f(cfg))
        with pytest.raises(ValueError, match="half"):
            collide_ds(cfg, pre, f, contract="vpu", g1_reversal=True)
