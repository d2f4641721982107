"""Anisotropic velocity grids (Nvx != Nvy != Nvz).

The reference operator is constructed with separate per-axis resolutions
(``FFTWBoltzmannOperator.hpp:32``) although its drivers only run cubic grids;
these tests exercise the per-axis mode-table plumbing against the independent
direct-sum oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import boltzfft as bz
from tests.reference_direct import direct_collision


class TestConfig:
    def test_dft_accepts_anisotropic(self):
        cfg = bz.CollisionConfig(nv=8, nvz=10, ns=6, impl="dft")
        pre = bz.build_precomp(cfg)
        assert pre.dft_fwd_z is not None
        assert pre.dft_fwd_z.shape == (2, 10, 10)

    def test_odd_axis_rejected(self):
        with pytest.raises(ValueError, match="nvy"):
            bz.CollisionConfig(nv=8, nvy=7, ns=6)

    def test_ds_supports_anisotropic(self):
        # round-2: per-axis DFT matrices (parity tests in test_oz.py)
        cfg = bz.CollisionConfig(nv=8, nvy=10, ns=6, impl="c2c")
        pre = bz.build_ds_precomp(cfg)
        assert isinstance(pre.vfwd, tuple) and len(pre.vfwd) == 3
        assert pre.vfwd[1].re.hi.shape == (10, 10)

    def test_grid_properties(self):
        g = bz.VelocityGrid(nv=8, length=2.0, nvy=16, nvz=4)
        assert g.shape == (8, 16, 4)
        assert not g.is_isotropic
        assert g.dvs == (0.5, 0.25, 1.0)
        assert g.cell_volume == pytest.approx(0.125)
        with pytest.raises(ValueError, match="anisotropic"):
            g.dv
        assert g.r_squared().shape == (8, 16, 4)

    def test_explicit_cubic_matches_default(self):
        cfg_a = bz.CollisionConfig(nv=8, ns=6, n_radial=4, impl="rfft")
        cfg_b = bz.CollisionConfig(nv=8, nvy=8, nvz=8, ns=6, n_radial=4,
                                   impl="rfft")
        ca, pa = bz.make_collision_operator(cfg_a)
        cb, pb = bz.make_collision_operator(cfg_b)
        f = np.asarray(bz.bkw_f(cfg_a.velocity_grid.r_squared(), 6.5))
        np.testing.assert_array_equal(
            np.asarray(ca(jnp.asarray(f), pa)), np.asarray(cb(jnp.asarray(f), pb))
        )


class TestMoments:
    def test_anisotropic_moments_match_cubic_values(self):
        # A Maxwellian's moments are resolution-independent once resolved:
        # compare the anisotropic-grid moments to the analytic values.
        from boltzfft.bkw import maxwellian

        g = bz.VelocityGrid(nv=32, length=8.0, nvy=24, nvz=16)
        m = jnp.asarray(maxwellian(g.r_squared(), density=1.0, temperature=1.0))
        mom = bz.moments(
            m, (jnp.asarray(g.vx), jnp.asarray(g.vy), jnp.asarray(g.vz)),
            cell_volume=g.cell_volume,
        )
        assert float(mom.mass) == pytest.approx(1.0, rel=1e-6)
        assert float(jnp.abs(mom.momentum).max()) < 1e-10
        assert float(mom.temperature) == pytest.approx(1.0, rel=1e-5)

    def test_anisotropic_requires_cell_volume(self):
        g = bz.VelocityGrid(nv=8, length=2.0, nvy=16)
        f = jnp.zeros(g.shape)
        with pytest.raises(ValueError, match="cell_volume"):
            bz.moments(f, (jnp.asarray(g.vx), jnp.asarray(g.vy),
                           jnp.asarray(g.vz)), dv=0.1)


class TestParity:
    @pytest.mark.parametrize("impl", ["rfft", "c2c", "dft"])
    def test_direct_sum_parity(self, impl):
        """Anisotropic operator vs the independent O(B) NumPy oracle."""
        self._direct_parity(impl, (8, 12, 10))

    @pytest.mark.parametrize("impl", ["rfft", "dft"])
    @pytest.mark.parametrize("shape", [(12, 6, 8), (6, 10, 12)])
    def test_direct_sum_parity_more_shapes(self, impl, shape):
        self._direct_parity(impl, shape)

    def _direct_parity(self, impl, shape):
        nv, nvy, nvz = shape
        cfg = bz.CollisionConfig(
            nv=nv, nvy=nvy, nvz=nvz, ns=6, n_radial=4, impl=impl,
            dtype="float64",
        )
        g = cfg.velocity_grid
        f = np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float64)

        from boltzfft import quadrature as quad

        gl = quad.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
        sph = quad.spherical_design(cfg.ns)
        q_direct = direct_collision(
            f, gl.nodes, gl.weights, sph.points, sph.weights,
            cfg.domain_length, gamma=cfg.gamma, b_gamma=cfg.b_gamma,
        )

        coll, pre = bz.make_collision_operator(cfg)
        q = np.asarray(coll(jnp.asarray(f), pre))
        scale = np.abs(q_direct).max()
        np.testing.assert_allclose(q, q_direct, atol=1e-12 * scale)

    def test_node_chunking_invariant(self):
        cfg_full = bz.CollisionConfig(nv=8, nvy=12, nvz=10, ns=6, n_radial=4,
                                      impl="rfft", dtype="float64")
        cfg_chunk = bz.CollisionConfig(nv=8, nvy=12, nvz=10, ns=6, n_radial=4,
                                       impl="rfft", dtype="float64",
                                       node_chunk=5)
        cf, pf = bz.make_collision_operator(cfg_full)
        cc, pc = bz.make_collision_operator(cfg_chunk)
        f = jnp.asarray(bz.bkw_f(cfg_full.velocity_grid.r_squared(), 6.5))
        qf = np.asarray(cf(f, pf))
        qc = np.asarray(cc(f, pc))
        np.testing.assert_allclose(qc, qf, atol=1e-13 * np.abs(qf).max())

    def test_bkw_accuracy_tracks_coarsest_axis(self):
        """Mixed (32, 16, 16) error is dominated by the coarse axes: far
        worse than 32^3, same decade as 16^3 (slightly above it is expected —
        anisotropic truncation adds cross terms)."""
        errs = {}
        for shape in [(16, None, None), (32, None, None), (32, 16, 16)]:
            nv, nvy, nvz = shape
            cfg = bz.CollisionConfig(nv=nv, nvy=nvy, nvz=nvz, ns=12,
                                     n_radial=16, impl="rfft", dtype="float64")
            g = cfg.velocity_grid
            coll, pre = bz.make_collision_operator(cfg)
            f = jnp.asarray(bz.bkw_f(g.r_squared(), 6.5))
            q = np.asarray(coll(f, pre))
            q_exact = np.asarray(bz.bkw_dfdt(g.r_squared(), 6.5))
            errs[shape] = np.abs(q - q_exact).max()
        assert errs[(32, None, None)] < 0.1 * errs[(32, 16, 16)]
        assert errs[(32, 16, 16)] <= 2.0 * errs[(16, None, None)]


class TestAnisotropicFusedDft:
    """Per-axis transform matrices in the dft einsum path (the reference
    ctor generality, ``FFTWBoltzmannOperator.hpp:32``)."""

    def _parity(self, nv, nvy, nvz, impl, tol=1e-12, **kw):
        cfg = bz.CollisionConfig(nv=nv, nvy=nvy, nvz=nvz, ns=6, impl=impl, **kw)
        cfg_c = bz.CollisionConfig(nv=nv, nvy=nvy, nvz=nvz, ns=6, impl="c2c")
        coll, pre = bz.make_collision_operator(cfg)
        coll_c, pre_c = bz.make_collision_operator(cfg_c)
        g = cfg.velocity_grid
        f = bz.bkw_f(g.r_squared(), 6.5)
        q = np.asarray(coll(f, pre))
        qc = np.asarray(coll_c(f, pre_c))
        np.testing.assert_allclose(q, qc, atol=tol * np.abs(qc).max())

    def test_dft_matches_c2c(self):
        self._parity(8, 12, 16, "dft")
