"""Collision-operator correctness: BKW oracle, cross-implementation parity,
direct-sum parity, chunking invariance, conservation, determinism, dtypes.

Mirrors the reference's validation strategy (SURVEY.md section 5) as a proper
pytest suite: the BKW analytic solution is the accuracy oracle
(``maxwell_bkw_fftw.cpp:144-166``), plus checks the reference never had.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import boltzfft as bz

from reference_direct import direct_collision


def _bkw_setup(cfg, t=6.5):
    g = cfg.velocity_grid
    rsq = g.r_squared()
    return g, bz.bkw_f(rsq, t), bz.bkw_dfdt(rsq, t)


class TestBKWOracle:
    """Computed Q(f_bkw, f_bkw) vs analytic df/dt."""

    @pytest.mark.parametrize("impl", ["rfft", "c2c", "dft"])
    def test_nv16(self, impl):
        cfg = bz.CollisionConfig(nv=16, ns=6, impl=impl)
        coll, pre = bz.make_collision_operator(cfg)
        g, f, q_exact = _bkw_setup(cfg)
        err = bz.error_norms(np.asarray(coll(f, pre)), q_exact, g.dv)
        # calibrated: Linf = 5.549e-4 at this resolution
        assert err["Linf"] < 6e-4

    def test_nv32_reference_parity(self):
        # The headline accuracy config: must match the FFTW f64 reference
        # numbers (Results/maxwell_bkw_fftw_atomics.txt:19-21) to ~1e-12.
        cfg = bz.CollisionConfig(nv=32, ns=12, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg)
        g, f, q_exact = _bkw_setup(cfg)
        err = bz.error_norms(np.asarray(coll(f, pre)), q_exact, g.dv)
        np.testing.assert_allclose(err["L1"], 1.5403e-03, rtol=1e-4)
        np.testing.assert_allclose(err["L2"], 1.0119e-04, rtol=1e-4)
        np.testing.assert_allclose(err["Linf"], 4.2512e-05, rtol=1e-4)

    @pytest.mark.slow
    def test_nv64_reference_parity(self):
        # The high-resolution accuracy anchor: spectral convergence to the
        # f64 floor (Results/maxwell_bkw_fftw_atomics.txt:195-197). Opt-in:
        # ~minutes of CPU; run with `pytest -m slow`.
        cfg = bz.CollisionConfig(nv=64, ns=12, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg)
        g, f, q_exact = _bkw_setup(cfg)
        err = bz.error_norms(np.asarray(coll(f, pre)), q_exact, g.dv)
        np.testing.assert_allclose(err["L1"], 8.9149e-11, rtol=1e-3)
        np.testing.assert_allclose(err["L2"], 8.3092e-12, rtol=1e-3)
        np.testing.assert_allclose(err["Linf"], 3.0685e-12, rtol=1e-3)


class TestCrossImplementationParity:
    @pytest.mark.parametrize(
        "impl,tol", [("rfft", 1e-13), ("dft", 1e-12)]
    )
    def test_matches_c2c(self, impl, tol):
        # rfft agrees up to the (spectrally negligible) Nyquist content of f;
        # dft is an exact reformulation up to summation order.
        cfg_r = bz.CollisionConfig(nv=16, ns=12, impl=impl)
        cfg_c = bz.CollisionConfig(nv=16, ns=12, impl="c2c")
        coll_r, pre_r = bz.make_collision_operator(cfg_r)
        coll_c, pre_c = bz.make_collision_operator(cfg_c)
        _, f, _ = _bkw_setup(cfg_r)
        qr = np.asarray(coll_r(f, pre_r))
        qc = np.asarray(coll_c(f, pre_c))
        scale = np.abs(qc).max()
        np.testing.assert_allclose(qr, qc, atol=tol * scale)

    def test_direct_sum_parity(self):
        # Independent node-by-node NumPy implementation as oracle.
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=6, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg)
        _, f, _ = _bkw_setup(cfg)
        gl = bz.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
        sph = bz.spherical_design(cfg.ns)
        q_direct = direct_collision(
            np.asarray(f),
            gl.nodes,
            gl.weights,
            sph.points,
            sph.weights,
            cfg.domain_length,
            cfg.gamma,
            cfg.b_gamma,
        )
        q = np.asarray(coll(f, pre))
        scale = np.abs(q_direct).max()
        np.testing.assert_allclose(q, q_direct, atol=1e-13 * scale)

    def test_direct_sum_parity_vhs(self):
        # Non-Maxwell VHS kernel (hard spheres: gamma=1).
        cfg = bz.CollisionConfig(
            nv=8, ns=6, n_radial=6, gamma=1.0, b_gamma=1.0 / (4 * np.pi), impl="rfft"
        )
        coll, pre = bz.make_collision_operator(cfg)
        _, f, _ = _bkw_setup(cfg)
        gl = bz.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
        sph = bz.spherical_design(cfg.ns)
        q_direct = direct_collision(
            np.asarray(f), gl.nodes, gl.weights, sph.points, sph.weights,
            cfg.domain_length, cfg.gamma, cfg.b_gamma,
        )
        q = np.asarray(coll(f, pre))
        scale = np.abs(q_direct).max()
        np.testing.assert_allclose(q, q_direct, atol=1e-13 * scale)


class TestDftPrecision:
    """The dft pipeline's einsum precision: both settings agree with the
    f64 c2c reference at float32 class on the CPU (on a GPU "default" may
    run in TF32 — chip_smoke.py measures that)."""

    @pytest.mark.parametrize("prec", ["default", "highest"])
    def test_f32_dft_matches_f64_c2c(self, prec):
        cfg = bz.CollisionConfig(nv=16, ns=6, impl="dft", dtype="float32",
                                 dft_precision=prec)
        cfg_c = bz.CollisionConfig(nv=16, ns=6, impl="c2c")
        coll, pre = bz.make_collision_operator(cfg)
        coll_c, pre_c = bz.make_collision_operator(cfg_c)
        _, f, _ = _bkw_setup(cfg)
        q = np.asarray(coll(f.astype(np.float32), pre), np.float64)
        qc = np.asarray(coll_c(f, pre_c))
        # float32 class at 16^3 (measured ~2e-5 relative); TF32 products
        # would land near 1e-3
        assert np.abs(q - qc).max() <= 1e-4 * np.abs(qc).max()

    def test_bad_precision_rejected(self):
        with pytest.raises(ValueError, match="dft_precision"):
            bz.CollisionConfig(nv=8, ns=6, impl="dft", dft_precision="tf32")

    @pytest.mark.parametrize("impl", ["fused", "auto"])
    def test_removed_impls_rejected(self, impl):
        with pytest.raises(ValueError, match="impl must be"):
            bz.CollisionConfig(nv=8, ns=6, impl=impl)


class TestChunking:
    @pytest.mark.parametrize("chunk", [1, 5, 7, 12, 36, None])
    @pytest.mark.parametrize("impl", ["rfft", "dft", "c2c"])
    def test_chunked_matches_unchunked(self, chunk, impl):
        # Chunk size (incl. a non-divisor forcing padding) must not change Q.
        cfg_full = bz.CollisionConfig(nv=16, ns=6, impl=impl, node_chunk=None)
        cfg = bz.CollisionConfig(nv=16, ns=6, impl=impl, node_chunk=chunk)
        coll_f, pre_f = bz.make_collision_operator(cfg_full)
        coll_c, pre_c = bz.make_collision_operator(cfg)
        _, f, _ = _bkw_setup(cfg)
        q_full = np.asarray(coll_f(f, pre_f))
        q_chunk = np.asarray(coll_c(f, pre_c))
        scale = np.abs(q_full).max()
        np.testing.assert_allclose(q_chunk, q_full, atol=1e-13 * scale)

    def test_unpadded_precomp_keeps_chunking(self):
        # A hand-built Precomp whose node count the configured chunk doesn't
        # divide must round the chunk down to a divisor (bounding memory),
        # not silently collapse to one whole-batch chunk.
        from boltzfft.operator import gain_spectrum

        cfg = bz.CollisionConfig(nv=16, ns=6, node_chunk=7)  # B=48, 48%7!=0
        cfg_1 = bz.CollisionConfig(nv=16, ns=6, node_chunk=None)
        pre = bz.build_precomp(cfg_1)  # unpadded: 16*3 antipodal-reduced nodes
        assert pre.rho.shape[0] == cfg.n_nodes == 48
        _, f, _ = _bkw_setup(cfg)
        import jax.numpy as jnp

        fh = jnp.fft.rfftn(jnp.asarray(f))
        q7 = np.asarray(gain_spectrum(cfg, pre, fh))
        q1 = np.asarray(gain_spectrum(cfg_1, pre, fh))
        np.testing.assert_allclose(q7, q1, atol=1e-13 * np.abs(q1).max())


class TestPhysics:
    def test_reflection_equivariance(self):
        """Q commutes with velocity-axis reflections up to spectral
        truncation: the cell-centered grid and the symmetric spherical design
        are reflection-invariant, but the FFT mode set {-N/2..N/2-1} has an
        unpaired Nyquist mode, so Q(f∘R) - Q(f)∘R is O(truncation), not
        roundoff.  Measured: 1.2e-4 / 3.6e-5 / 6.9e-6 at nv = 16/24/32 —
        assert the spectral decay and the nv=32 smallness."""
        v_err = {}
        for nv in (16, 32):
            cfg = bz.CollisionConfig(nv=nv, ns=12, n_radial=nv // 2,
                                     impl="rfft")
            coll, pre = bz.make_collision_operator(cfg)
            g = cfg.velocity_grid
            v = np.asarray(g.v)
            bump = np.exp(-((v[:, None, None] - 1.0) ** 2
                            + (v[None, :, None] + 0.5) ** 2
                            + v[None, None, :] ** 2) / 4.0)
            f = np.asarray(bz.bkw_f(g.r_squared(), 6.5)) * (1.0 + 0.3 * bump)
            q = np.asarray(coll(jnp.asarray(f), pre))
            worst = 0.0
            for axis in range(3):
                qr = np.asarray(coll(jnp.asarray(np.flip(f, axis=axis)), pre))
                worst = max(worst, np.abs(qr - np.flip(q, axis=axis)).max())
            v_err[nv] = worst / np.abs(q).max()
        assert v_err[32] < 1e-3
        assert v_err[32] < 0.05 * v_err[16]  # spectral, not O(dv^p) decay

    def test_conservation(self):
        # Mass, momentum and energy moments of Q vanish to spectral accuracy.
        cfg = bz.CollisionConfig(nv=32, ns=12, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg)
        g, f, _ = _bkw_setup(cfg)
        q = np.asarray(coll(f, pre))
        m = bz.moments(q, np.asarray(g.v), g.dv)
        # The fast spectral method conserves moments to quadrature accuracy
        # (method error here is Linf ~ 4e-5); momentum vanishes by symmetry.
        assert abs(float(m.mass)) < 1e-5
        assert np.abs(np.asarray(m.momentum)).max() < 1e-10
        assert abs(float(m.energy)) < 1e-3

    def test_maxwellian_equilibrium(self):
        # Q(M, M) = 0 for a Maxwellian (up to quadrature error).
        cfg = bz.CollisionConfig(nv=32, ns=12, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg)
        g = cfg.velocity_grid
        f = bz.maxwellian(g.r_squared())
        q = np.asarray(coll(f, pre))
        assert np.abs(q).max() < 5e-5


class TestDeterminism:
    def test_bitwise_reproducible(self):
        # The deterministic einsum reduction makes repeated evals bit-identical
        # — the property the reference's atomics break (SURVEY.md section 5).
        cfg = bz.CollisionConfig(nv=16, ns=12, impl="rfft", node_chunk=24)
        coll, pre = bz.make_collision_operator(cfg)
        _, f, _ = _bkw_setup(cfg)
        q1 = np.asarray(coll(f, pre))
        q2 = np.asarray(coll(f, pre))
        assert np.array_equal(q1, q2)


class TestDtypes:
    def test_float32_accuracy(self):
        # f32 path: roundoff ~1e-7 relative, far below the 16^3 method error.
        cfg = bz.CollisionConfig(nv=16, ns=6, impl="rfft", dtype="float32")
        coll, pre = bz.make_collision_operator(cfg)
        g, f, q_exact = _bkw_setup(cfg)
        q = np.asarray(coll(f.astype(np.float32), pre))
        assert q.dtype == np.float32
        err = bz.error_norms(q, q_exact, g.dv)
        assert err["Linf"] < 7e-4

    def test_differentiable(self):
        # The operator is a pure composition of FFTs and elementwise ops, so
        # it is differentiable end to end — the adjoint comes for free (a
        # capability the reference cannot offer). Check the JVP/VJP against a
        # finite difference of a scalar functional.
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        _, f, _ = _bkw_setup(cfg)
        f = jnp.asarray(f)

        loss = lambda x: jnp.sum(coll(x, pre) ** 2)
        g = jax.grad(loss)(f)
        assert np.all(np.isfinite(np.asarray(g)))

        rng = np.random.RandomState(0)
        d = jnp.asarray(rng.randn(*f.shape)) * 1e-6
        fd = float(loss(f + d)) - float(loss(f - d))
        analytic = 2.0 * float(jnp.vdot(g, d))
        np.testing.assert_allclose(analytic, fd, rtol=1e-4)

    @pytest.mark.parametrize("impl", ["rfft", "dft"])
    def test_grad_matches_c2c_vjp(self, impl):
        # every staged pipeline differentiates end to end; its gradient
        # agrees with the reference-faithful c2c pipeline's VJP — for rfft
        # on the Nyquist-free subspace, where the two operators coincide
        # (irfftn symmetrizes the Nyquist planes; see operator.py)
        kw = dict(nv=8, ns=6, n_radial=4, dtype="float64")
        coll, pre = bz.make_collision_operator(
            bz.CollisionConfig(impl=impl, **kw), jit=False)
        coll_c, pre_c = bz.make_collision_operator(
            bz.CollisionConfig(impl="c2c", **kw), jit=False)
        _, f, _ = _bkw_setup(bz.CollisionConfig(**kw))
        f = jnp.asarray(f)
        rng = np.random.RandomState(1)
        ct = jnp.asarray(rng.randn(*f.shape))
        _, vjp = jax.vjp(lambda x: coll(x, pre), f)
        _, vjp_c = jax.vjp(lambda x: coll_c(x, pre_c), f)
        (g,), (g_c,) = vjp(ct), vjp_c(ct)
        if impl == "rfft":
            keep = np.ones(f.shape, bool)
            for ax, n in enumerate(f.shape):
                idx = [slice(None)] * 3
                idx[ax] = n // 2
                keep[tuple(idx)] = False
            band = lambda a: np.fft.ifftn(np.fft.fftn(np.asarray(a)) * keep).real
            g, g_c = band(g), band(g_c)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(g_c),
            atol=1e-12 * float(jnp.abs(g_c).max()),
        )

    def test_jit_and_grad_compatible(self):
        # The operator is a pure function: vmap and jit compose.
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        _, f, _ = _bkw_setup(cfg)
        f = jnp.asarray(f)
        batch = jnp.stack([f, 0.5 * f])
        q_batch = jax.jit(jax.vmap(lambda x: coll(x, pre)))(batch)
        assert q_batch.shape == (2, 8, 8, 8)
        q0 = coll(f, pre)
        np.testing.assert_allclose(
            np.asarray(q_batch[0]), np.asarray(q0), atol=1e-12 * float(jnp.abs(q0).max())
        )
        # Q(af, af) = a^2 Q(f, f) — bilinearity of the collision operator.
        np.testing.assert_allclose(
            np.asarray(q_batch[1]), 0.25 * np.asarray(q0),
            atol=1e-12 * float(jnp.abs(q0).max()),
        )


class TestAntipodalReduction:
    """The antipodal-pair quadrature reduction (exact; see
    quadrature.antipodal_reduce) against the full-design evaluation."""

    @pytest.mark.parametrize("impl", ["c2c", "rfft", "dft"])
    def test_half_design_matches_full(self, impl):
        cfg_h = bz.CollisionConfig(nv=16, ns=12, impl=impl)
        cfg_f = bz.CollisionConfig(nv=16, ns=12, impl=impl, antipodal=False)
        assert cfg_h.n_nodes == cfg_f.n_nodes // 2
        coll_h, pre_h = bz.make_collision_operator(cfg_h)
        coll_f, pre_f = bz.make_collision_operator(cfg_f)
        _, f, _ = _bkw_setup(cfg_h)
        qh = np.asarray(coll_h(f, pre_h))
        qf = np.asarray(coll_f(f, pre_f))
        # identical contributions, only summation order differs
        np.testing.assert_allclose(qh, qf, atol=1e-14 * np.abs(qf).max())

    def test_full_design_direct_sum_parity(self):
        # antipodal=False falls back to the reference's full node loop and
        # still matches the independent direct-sum oracle.
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=6, impl="rfft",
                                 antipodal=False)
        coll, pre = bz.make_collision_operator(cfg)
        _, f, _ = _bkw_setup(cfg)
        gl = bz.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
        sph = bz.spherical_design(cfg.ns)
        q_direct = direct_collision(
            np.asarray(f), gl.nodes, gl.weights, sph.points, sph.weights,
            cfg.domain_length, cfg.gamma, cfg.b_gamma,
        )
        q = np.asarray(coll(f, pre))
        np.testing.assert_allclose(
            q, q_direct, atol=1e-13 * np.abs(q_direct).max()
        )


class TestVmap:
    @pytest.mark.parametrize("impl", ["rfft", "c2c", "dft"])
    def test_vmap_matches_loop(self, impl):
        # a batch of distributions through vmap equals one call per member
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl=impl)
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        _, f, _ = _bkw_setup(cfg)
        rng = np.random.RandomState(2)
        batch = jnp.asarray(
            np.stack([f * (1.0 + 0.1 * rng.rand(*f.shape)) for _ in range(3)])
        )
        qv = np.asarray(jax.jit(jax.vmap(lambda x: coll(x, pre)))(batch))
        for i in range(3):
            qi = np.asarray(coll(batch[i], pre))
            np.testing.assert_allclose(
                qv[i], qi, atol=1e-13 * np.abs(qi).max())


class TestMassConservationAnisotropic:
    """The k=0 gain/loss mismatch on anisotropic states.

    The loss kernel's sigma integral is exact (4*pi*sincc closed form,
    ``FFTWBoltzmannOperator.cpp:104-117``) while the gain uses the
    Ns-point spherical design, so mass(Q) on anisotropic (bulk-shifted)
    states carries the design's quadrature error — Nv-INDEPENDENT, and
    vanishing spectrally with Ns (measured f64: 6.9e-3 at Ns=6, 4.7e-5
    at 12, 9.6e-7 at 32 on the two-beam state).  Isotropic BKW states
    never see this; the Taylor-Green driver defaults to Ns=12 for it.
    """

    def _two_beam(self, cfg):
        from boltzfft.bkw import maxwellian

        g = cfg.velocity_grid
        vsq = lambda u: (
            (np.asarray(g.vx)[:, None, None] - u) ** 2
            + np.asarray(g.vy)[None, :, None] ** 2
            + np.asarray(g.vz)[None, None, :] ** 2
        )
        f = 0.5 * (
            np.asarray(maxwellian(vsq(0.8), 1.0, 3.0))
            + np.asarray(maxwellian(vsq(-0.8), 1.0, 3.0))
        )
        return jnp.asarray(f, cfg.real_dtype)

    def test_mass_error_vanishes_with_ns(self):
        drifts = {}
        for ns in (6, 32):
            cfg = bz.CollisionConfig(nv=16, ns=ns, impl="rfft",
                                     dtype="float64", n_radial=16)
            fn, pre = bz.make_collision_operator(cfg)
            q = fn(self._two_beam(cfg), pre)
            drifts[ns] = abs(float(jnp.sum(q)) * cfg.velocity_grid.cell_volume)
        assert drifts[6] > 1e-3  # the coarse design's real error
        assert drifts[32] < 1e-5  # spectral convergence in the design order
        assert drifts[32] < drifts[6] / 100.0

    def test_mass_error_nv_independent(self):
        vals = []
        for nv in (12, 16):
            cfg = bz.CollisionConfig(nv=nv, ns=6, impl="rfft",
                                     dtype="float64", n_radial=12)
            fn, pre = bz.make_collision_operator(cfg)
            q = fn(self._two_beam(cfg), pre)
            vals.append(float(jnp.sum(q)) * cfg.velocity_grid.cell_volume)
        # refining the velocity grid must NOT fix it (same design error)
        assert abs(vals[0] - vals[1]) < 0.3 * abs(vals[0])
