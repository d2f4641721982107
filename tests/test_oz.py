"""Tests for the Ozaki-scheme sliced bf16 contraction (boltzfft.oz).

Validates the three exactness layers the scheme stands on (chunk
reconstruction, matrix splitting, exact level sums) and the end results:
ds-class contraction accuracy and full collision-pipeline parity with the
bit-exact VPU ds path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import boltzfft as bz
from boltzfft import ds, oz
from boltzfft.ds_operator import build_ds_precomp, collide_ds


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20260817)


class TestSlicing:
    def test_ds_slice_reconstruction(self, rng):
        # wide per-row dynamic range; reconstruction must capture every bit
        # the f32 pair holds, relative to the row scale
        x64 = rng.standard_normal((6, 40)) * 10.0 ** rng.uniform(-9, 6, (6, 1))
        x = ds.from_f64(x64)
        sl = oz.slice_ds_last(x)
        rec = np.sum(np.asarray(sl, np.float64), axis=0)
        err = np.abs(rec - ds.to_f64(x))
        row_scale = np.max(np.abs(x64), axis=-1, keepdims=True)
        assert np.max(err / row_scale) < 2.0 ** -48

    def test_zero_row_is_safe(self):
        x = ds.from_f64(np.zeros((2, 8)))
        sl = oz.slice_ds_last(x)
        assert np.all(np.asarray(sl, np.float64) == 0.0)

    def test_phase_sigma_bounds_rows(self, rng):
        # the per-row scale of the row-block contractions: strictly above
        # every |entry| of the row (so chunk 0 fits w bits), within a factor
        # of a power of two of the row max
        a = rng.standard_normal((16, 32)) * 10.0 ** rng.uniform(-8, 5, (16, 1))
        sig = np.asarray(oz._phase_sigma(jnp.asarray(a, jnp.float32)))
        amax = np.max(np.abs(np.asarray(a, np.float32)), axis=-1,
                      keepdims=True)
        assert np.all(sig > amax) and np.all(sig <= 4.0 * amax)

    def test_chunks_are_bf16_exact(self, rng):
        # each chunk must be exactly representable in bfloat16: the f64 sum
        # of the bf16 slices equals the f64 sum of f32-cast slices
        x64 = rng.standard_normal((4, 16)) * 10.0 ** rng.uniform(-3, 3, (4, 1))
        sl = oz.slice_ds_last(ds.from_f64(x64))
        as_f32 = np.asarray(sl.astype(jnp.float32), np.float64)
        as_bf = np.asarray(sl, np.float64)
        assert np.array_equal(as_f32, as_bf)

    def test_matrix_slices_reconstruct_f64(self):
        n = 16
        m = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
        msl = oz.slice_matrix(m)
        rec = np.sum(np.asarray(msl.re, np.float64), axis=0) + 1j * np.sum(
            np.asarray(msl.im, np.float64), axis=0
        )
        # 8 slices x 7 bits = 56 bits relative to the GLOBAL scale (=1 here);
        # entries tiny vs the scale keep bits below the slice grid, so the
        # bound is scale-relative, not elementwise-exact
        assert np.max(np.abs(rec - m)) < 2.0 ** -55


class TestContraction:
    def test_matches_f64_einsum(self, rng):
        x64 = (
            rng.standard_normal((3, 7, 32)) * 10.0 ** rng.uniform(-5, 4, (3, 7, 1))
            + 1j * rng.standard_normal((3, 7, 32)) * 10.0 ** rng.uniform(-5, 4, (3, 7, 1))
        )
        m64 = np.exp(1j * rng.uniform(0, 2 * np.pi, (32, 24))) / 32
        out = oz.contract_last_oz(ds.cds_from_f64(x64), oz.slice_matrix(m64))
        got = ds.to_f64(out.re) + 1j * ds.to_f64(out.im)
        ref = x64 @ m64
        rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
        assert rel < 1e-14  # ds-class; plain f32 is ~1e-7 here

    def test_jit_and_grad_free_purity(self, rng):
        x64 = rng.standard_normal((4, 16)) + 1j * rng.standard_normal((4, 16))
        m64 = np.exp(1j * rng.uniform(0, 2 * np.pi, (16, 16)))
        x = ds.cds_from_f64(x64)
        msl = oz.slice_matrix(m64)
        eager = oz.contract_last_oz(x, msl)
        jitted = jax.jit(lambda a, m: oz.contract_last_oz(a, m))(x, msl)
        # jit must not perturb the compensated arithmetic (reduce_precision
        # pinning holds under fusion)
        np.testing.assert_array_equal(np.asarray(eager.re.hi), np.asarray(jitted.re.hi))
        np.testing.assert_array_equal(np.asarray(eager.re.lo), np.asarray(jitted.re.lo))

    def test_nodemat_matches_staged(self, rng):
        # the per-node-matrix row contraction (one node, shared x) and the
        # staged contraction compute the same compensated product
        x64 = (
            rng.standard_normal((16, 32)) * 10.0 ** rng.uniform(-5, 4, (16, 1))
            + 1j * rng.standard_normal((16, 32)) * 10.0 ** rng.uniform(-5, 4, (16, 1))
        )
        m64 = np.exp(1j * rng.uniform(0, 2 * np.pi, (32, 32))) / 32
        x = ds.cds_from_f64(x64)
        a = oz.contract_last_oz(x, oz.slice_matrix(m64))
        b = oz.contract_last_oz_nodemat(
            x, oz.slice_matrix_nodes(m64[None]), repeat=True)
        ga = ds.to_f64(a.re) + 1j * ds.to_f64(a.im)
        gb = ds.to_f64(b.re)[0] + 1j * ds.to_f64(b.im)[0]
        ref = x64 @ m64
        scale = np.max(np.abs(ref))
        assert np.max(np.abs(ga - gb)) / scale < 1e-14
        assert np.max(np.abs(gb - ref)) / scale < 1e-14

    def test_transform3_matches_fft(self, rng):
        n = 8
        x64 = rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
        m = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
        out = oz.transform3_oz(ds.cds_from_f64(x64), oz.slice_matrix(m))
        got = ds.to_f64(out.re) + 1j * ds.to_f64(out.im)
        ref = np.fft.fftn(x64)
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-14


class TestPipeline:
    @pytest.mark.slow
    def test_collide_oz_matches_vpu(self):
        # slow tier: the staged-oz engine is covered per-contraction in
        # TestContraction and end-to-end by TestAnisotropicDs
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c", dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64))
        q_vpu = ds.to_f64(jax.jit(lambda p, x: collide_ds(cfg, p, x, contract="vpu"))(pre, f))
        q_oz = ds.to_f64(jax.jit(lambda p, x: collide_ds(cfg, p, x, contract="oz"))(pre, f))
        scale = np.max(np.abs(q_vpu))
        assert np.max(np.abs(q_vpu - q_oz)) / scale < 1e-12

    def test_oz_cmax_default_parity(self):
        """The pipeline-default retention (cmax=6) keeps ds-class parity
        with the vpu bit-reference."""
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="c2c", dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(
            np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
        )
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        q = ds.to_f64(collide_ds(cfg, pre, f, contract="oz", oz_cmax=6))
        assert np.max(np.abs(q - q_vpu)) / np.max(np.abs(q_vpu)) < 1e-12

    @pytest.mark.slow
    def test_oz_cmax_ladder(self):
        """oz_cmax trades slice-pair FLOPs for truncation: retention is
        monotone (cmax=7 at least as close to the vpu bit-reference as
        cmax=4).  Slow tier: each cmax level is a separate full-pipeline
        compile (~50 s total single-core); the default tier keeps the
        cmax=6 parity check above."""
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="c2c", dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(
            np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
        )
        q_vpu = ds.to_f64(collide_ds(cfg, pre, f, contract="vpu"))
        scale = np.max(np.abs(q_vpu))
        errs = {}
        for cmax in (4, 7):
            q = ds.to_f64(collide_ds(cfg, pre, f, contract="oz", oz_cmax=cmax))
            errs[cmax] = np.max(np.abs(q - q_vpu)) / scale
        assert errs[7] <= errs[4] + 1e-15

    def test_bad_contract_raises(self):
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c", dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64))
        with pytest.raises(ValueError, match="contract"):
            collide_ds(cfg, pre, f, contract="nope")

    def test_default_contract_backend(self):
        # the CPU's ds engine is the bit-exact vpu reference
        assert bz.pipeline_choice().ds_contract == "vpu"
        cfg = bz.CollisionConfig(nv=4, ns=6, n_radial=2, impl="c2c",
                                 dtype="float32")
        coll, pre = bz.make_ds_collision_operator(cfg, jit=False)
        f = ds.from_f64(np.asarray(
            bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64))
        np.testing.assert_array_equal(
            ds.to_f64(coll(f, pre)),
            ds.to_f64(collide_ds(cfg, pre, f, contract="vpu")))


class TestPhasedTransform:
    """transform3_oz_phased: the separable per-node phase fused into each
    axis contraction must match the explicit phase-multiply-then-transform
    formulation (which itself matches f64)."""

    @pytest.mark.parametrize("conj", [False, True])
    def test_matches_explicit_phase(self, rng, conj):
        n, c = 8, 3
        x64 = rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
        m = np.exp(2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
        # unit-magnitude per-axis phases, as the collision alphas are
        ph64 = [np.exp(1j * rng.uniform(-np.pi, np.pi, (c, n))) for _ in range(3)]
        msl = oz.slice_matrix(m)
        x = ds.cds_from_f64(x64)
        phases = tuple(ds.cds_from_f64(p) for p in ph64)

        got = oz.transform3_oz_phased(x, msl, phases, conj=conj)
        g = ds.to_f64(got.re) + 1j * ds.to_f64(got.im)

        # explicit f64 reference: a1 = outer(px, py, pz); transform(a1 * x)
        pcx, pcy, pcz = (np.conj(p) for p in ph64) if conj else ph64
        a1 = pcx[:, :, None, None] * pcy[:, None, :, None] * pcz[:, None, None, :]
        t = a1 * x64[None]
        ref = np.einsum("sxyz,ax,by,cz->sabc", t, m, m, m)
        assert g.shape == (c, n, n, n)
        assert np.max(np.abs(g - ref)) / np.max(np.abs(ref)) < 1e-13

    def test_anisotropic_axes(self, rng):
        nx, ny, nz, c = 4, 6, 8, 2
        x64 = rng.standard_normal((nx, ny, nz)) + 1j * rng.standard_normal(
            (nx, ny, nz)
        )
        ms = [
            np.exp(2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
            for n in (nx, ny, nz)
        ]
        ph64 = [
            np.exp(1j * rng.uniform(-np.pi, np.pi, (c, n))) for n in (nx, ny, nz)
        ]
        got = oz.transform3_oz_phased(
            ds.cds_from_f64(x64),
            tuple(oz.slice_matrix(m) for m in ms),
            tuple(ds.cds_from_f64(p) for p in ph64),
        )
        g = ds.to_f64(got.re) + 1j * ds.to_f64(got.im)
        a1 = (
            ph64[0][:, :, None, None]
            * ph64[1][:, None, :, None]
            * ph64[2][:, None, None, :]
        )
        ref = np.einsum(
            "sxyz,ax,by,cz->sabc", a1 * x64[None], ms[0], ms[1], ms[2]
        )
        assert g.shape == (c, nx, ny, nz)
        assert np.max(np.abs(g - ref)) / np.max(np.abs(ref)) < 1e-13


class TestNodeMatTransform:
    """transform3_oz_nodemat: phase-folded per-node matrices (the pipeline's
    production formulation) must match the explicit f64 phase-then-transform
    reference, including anisotropic axes and both chunk widths."""

    @pytest.mark.parametrize("w,slm", [(7, 8), (8, 7)])
    def test_matches_explicit_phase(self, rng, w, slm):
        n, c = 8, 3
        x64 = rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
        m = np.exp(2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n) / n
        ph64 = [np.exp(1j * rng.uniform(-np.pi, np.pi, (c, n))) for _ in range(3)]
        mats = tuple(
            oz.slice_matrix_nodes(p[..., :, None] * m[None], slm, w)
            for p in ph64
        )
        got = oz.transform3_oz_nodemat(ds.cds_from_f64(x64), mats, w=w)
        g = ds.to_f64(got.re) + 1j * ds.to_f64(got.im)
        a1 = (
            ph64[0][:, :, None, None]
            * ph64[1][:, None, :, None]
            * ph64[2][:, None, None, :]
        )
        ref = np.einsum("sxyz,ax,by,cz->sabc", a1 * x64[None], m, m, m)
        assert g.shape == (c, n, n, n)
        assert np.max(np.abs(g - ref)) / np.max(np.abs(ref)) < 1e-13

    def test_fold_tail_stays_ds_class(self, rng):
        # the f32 tail pre-sum must stay below the ds noise floor
        n, c = 8, 2
        x64 = rng.standard_normal((c, n, n, n)) * 10.0 ** rng.uniform(
            -4, 3, (c, n, n, n)
        ) + 1j * rng.standard_normal((c, n, n, n))
        m64 = np.stack(
            [np.exp(1j * rng.uniform(0, 2 * np.pi, (n, n))) / n for _ in range(c)]
        )
        x = ds.cds_from_f64(x64)
        msl = oz.slice_matrix_nodes(m64)
        full = oz.contract_last_oz_nodemat(x, msl)
        tail = oz.contract_last_oz_nodemat(x, msl, fold_tail=4)
        gf = ds.to_f64(full.re) + 1j * ds.to_f64(full.im)
        gt = ds.to_f64(tail.re) + 1j * ds.to_f64(tail.im)
        ref = np.einsum("c...k,ckl->c...l", x64, m64)
        scale = np.max(np.abs(ref))
        # the f32 tail pre-sum rounds at a few ulps of the tail level —
        # measured ~2^-47 of the global scale on wide-dynamic-range rows
        # (which is why the PIPELINE keeps the exact all-ds fold;
        # ds_operator.DS_PIPELINE_FOLD_TAIL)
        assert np.max(np.abs(gt - gf)) / scale < 2.0 ** -45
        assert np.max(np.abs(gt - ref)) / scale < 1e-13


class TestAnisotropicDs:
    @pytest.mark.slow
    def test_matches_c2c_f64(self):
        # slow tier: full-pipeline ds-vs-f64 parity on an anisotropic grid
        # through both engines; default tier covers the engines at the
        # contraction/transform level (TestContraction) and the pipeline via
        # test_ds.py
        # per-axis DFT matrices + mode tables (reference ctor parity,
        # FFTWBoltzmannOperator.hpp:32) through both ds engines
        cfg64 = bz.CollisionConfig(nv=4, nvy=6, nvz=8, ns=6, n_radial=3,
                                   impl="c2c", dtype="float64")
        coll, pre64 = bz.make_collision_operator(cfg64)
        f64 = np.asarray(bz.bkw_f(cfg64.velocity_grid.r_squared(), 6.5), np.float64)
        q_ref = np.asarray(coll(f64, pre64), np.float64)

        cfg = bz.CollisionConfig(nv=4, nvy=6, nvz=8, ns=6, n_radial=3,
                                 impl="c2c", dtype="float32")
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(f64)
        scale = np.max(np.abs(q_ref))
        for engine in ("vpu", "oz"):
            q = ds.to_f64(collide_ds(cfg, pre, f, contract=engine))
            assert q.shape == (4, 6, 8)
            assert np.max(np.abs(q - q_ref)) / scale < 1e-12, engine
