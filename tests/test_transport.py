"""Tests for the space-inhomogeneous 1D×3V solver (transport + collisions).

The reference has no spatial transport (SURVEY.md section 0); these tests
validate the Strang-split solver built on top of the collision operator:
conservation of the advection stencil, equivalence with the homogeneous
operator for x-uniform data, and cell-sharded (ensemble-axis) parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import boltzfft as bz
from boltzfft import transport


def small_cfg(**kw):
    kw.setdefault("nv", 8)
    kw.setdefault("ns", 6)
    kw.setdefault("n_radial", 4)
    kw.setdefault("impl", "rfft")
    return bz.CollisionConfig(**kw)


class TestAdvection:
    def test_constant_in_x_is_fixed_point(self):
        cfg = small_cfg()
        g = cfg.velocity_grid
        f_one = jnp.asarray(bz.bkw_f(g.r_squared(), 6.5))
        f = jnp.broadcast_to(f_one, (8, *f_one.shape))
        out = transport.advect_upwind(f, jnp.asarray(g.v), dx=0.1, dt=0.01)
        np.testing.assert_allclose(np.asarray(out), np.asarray(f), rtol=0, atol=1e-15)

    def test_mass_conserved_per_velocity_point(self):
        # Periodic conservative flux: the x-sum at every velocity point is
        # exactly preserved, hence all velocity moments of the total are too.
        cfg = small_cfg()
        g = cfg.velocity_grid
        rng = np.random.default_rng(0)
        f = jnp.asarray(rng.random((8, cfg.nv, cfg.nv, cfg.nv)))
        out = transport.advect_upwind(f, jnp.asarray(g.v), dx=0.05, dt=0.004)
        np.testing.assert_allclose(
            np.asarray(out.sum(axis=0)), np.asarray(f.sum(axis=0)), rtol=1e-13
        )

    def test_exact_shift_at_unit_cfl(self):
        # With dt = dx / v for a single positive velocity, first-order upwind
        # is the exact shift operator.
        v = jnp.asarray([2.0])
        dx = 0.25
        dt = dx / 2.0
        f = jnp.asarray(np.random.default_rng(1).random((8, 1, 1, 1)))
        out = transport.advect_upwind(f, v, dx=dx, dt=dt)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(jnp.roll(f, 1, axis=0)), rtol=1e-14
        )

    def test_cfl_dt(self):
        assert transport.cfl_dt(4.0, 0.1, safety=0.8) == pytest.approx(0.02)


class TestStep:
    def test_uniform_cells_match_homogeneous_rk2(self):
        """x-uniform data: advection is a no-op, so the split step must equal
        the plain homogeneous RK2 midpoint update cell-by-cell."""
        cfg = small_cfg()
        g = cfg.velocity_grid
        collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
        f_one = jnp.asarray(bz.bkw_f(g.r_squared(), 6.5), cfg.real_dtype)
        nx, dt, kn = 4, 0.05, 0.7
        f = jnp.broadcast_to(f_one, (nx, *f_one.shape))

        step = transport.make_inhomogeneous_step(
            cfg, collide_fn, dx=0.1, dt=dt, knudsen=kn
        )
        out = np.asarray(step(f, pre))

        k1 = collide_fn(f_one, pre)
        f_mid = f_one + (0.5 * dt / kn) * k1
        k2 = collide_fn(f_mid, pre)
        expected = np.asarray(f_one + (dt / kn) * k2)
        scale = np.abs(expected).max()
        for i in range(nx):
            np.testing.assert_allclose(out[i], expected, atol=1e-13 * scale)

    def test_collisionless_step_conserves_exactly(self):
        # In the free-streaming limit the split step reduces to two upwind
        # half-steps plus Q ~ 0; all velocity moments of the x-total are
        # preserved to roundoff (the stencil is conservative by construction).
        cfg = small_cfg()
        g = cfg.velocity_grid
        collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
        nx = 8
        f = transport.sod_initial_condition(cfg, nx)
        dx = 1.0 / nx
        dt = transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), dx)
        step = jax.jit(
            transport.make_inhomogeneous_step(
                cfg, collide_fn, dx=dx, dt=dt, knudsen=1e30
            )
        )
        v = jnp.asarray(g.v, cfg.real_dtype)
        m0 = jax.tree.map(np.asarray, bz.moments(f.sum(axis=0), v, g.dv))
        for _ in range(3):
            f = step(f, pre)
        m1 = jax.tree.map(np.asarray, bz.moments(f.sum(axis=0), v, g.dv))
        assert m1.mass == pytest.approx(m0.mass, rel=1e-12)
        np.testing.assert_allclose(m1.momentum, m0.momentum, atol=1e-12 * m0.mass)
        assert m1.energy == pytest.approx(m0.energy, rel=1e-10)

    def test_collisional_step_conserves_to_quadrature_accuracy(self):
        # The fast spectral operator conserves moments only to quadrature
        # accuracy (see TestPhysics.test_conservation); nv=24 is the first
        # resolution where the T=0.8 Maxwellian stops aliasing (measured
        # mass-moment of Q: 8e-2 at nv=8, 6e-2 at nv=16, 4e-4 at nv=24).
        cfg = small_cfg(nv=24, n_radial=12)
        g = cfg.velocity_grid
        collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
        nx = 4
        f = transport.sod_initial_condition(cfg, nx)
        dx = 1.0 / nx
        dt = transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), dx)
        step = jax.jit(
            transport.make_inhomogeneous_step(
                cfg, collide_fn, dx=dx, dt=dt, knudsen=0.5
            )
        )
        v = jnp.asarray(g.v, cfg.real_dtype)
        m0 = jax.tree.map(np.asarray, bz.moments(f.sum(axis=0), v, g.dv))
        for _ in range(2):
            f = step(f, pre)
        m1 = jax.tree.map(np.asarray, bz.moments(f.sum(axis=0), v, g.dv))
        assert m1.mass == pytest.approx(m0.mass, rel=3e-4)
        np.testing.assert_allclose(m1.momentum, m0.momentum, atol=1e-9 * m0.mass)
        assert m1.energy == pytest.approx(m0.energy, rel=1e-3)

    def test_sharded_cells_match_vmap(self):
        """Cells sharded over the ensemble mesh axis == per-cell vmap."""
        cfg = small_cfg(dtype="float32")
        g = cfg.velocity_grid
        nx = 8
        f = transport.sod_initial_condition(cfg, nx)
        dx = 1.0 / nx
        dt = 0.5 * transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), dx)

        collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
        step_ref = transport.make_inhomogeneous_step(
            cfg, collide_fn, dx=dx, dt=dt, knudsen=1.0
        )
        q_ref = np.asarray(step_ref(f, pre))

        mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, 4)])
        sh_fn, sh_pre = bz.make_sharded_collision_operator(
            cfg, mesh, node_axis=None, ensemble_axis=bz.ENSEMBLE_AXIS, jit=False
        )
        step_sh = transport.make_inhomogeneous_step(
            cfg, sh_fn, dx=dx, dt=dt, knudsen=1.0, vmap_cells=False
        )
        q_sh = np.asarray(jax.jit(step_sh)(f, sh_pre))
        scale = np.abs(q_ref).max()
        np.testing.assert_allclose(q_sh, q_ref, atol=2e-6 * scale)


class TestSodCLI:
    def test_smoke(self, capsys):
        from boltzfft.cli import sod_1d3v

        rc = sod_1d3v.main(
            ["--Nv", "8", "--Ns", "6", "--nx", "8", "--steps", "2",
             "--n-radial", "4"]
        )
        assert rc == 0
        out = capsys.readouterr().out
        assert "rel drift" in out
        assert "density profile" in out


class TestMuscl:
    """Second-order MUSCL/minmod advection (round-3: replaces first-order
    upwind as the production transport scheme)."""

    def _advect_error(self, nx, scheme_fn, norm="l1"):
        # advect a smooth periodic profile one full period and compare with
        # the exact (identical) solution
        v = jnp.asarray([1.0])
        dx = 1.0 / nx
        dt = 0.4 * dx  # fixed CFL so dt refines with dx
        steps = int(round(1.0 / dt))
        x = (np.arange(nx) + 0.5) * dx
        f0 = jnp.asarray(
            (1.0 + 0.5 * np.sin(2 * np.pi * x))[:, None, None, None]
        )

        def run(f):
            return jax.lax.fori_loop(
                0, steps, lambda i, y: scheme_fn(y, v, dx, dt), f
            )

        f1 = np.asarray(jax.jit(run)(f0))[:, 0, 0, 0]
        # the profile returns to its initial position after steps*dt ~ 1.0;
        # account for the (tiny) rounding of steps via an exact shift
        t_end = steps * dt
        exact = 1.0 + 0.5 * np.sin(2 * np.pi * (x - t_end))
        d = np.abs(f1 - exact)
        return d.mean() if norm == "l1" else d.max()

    def test_order_of_convergence(self):
        # measured: L1 orders 2.04 (32->64) and 2.21 (64->128) with the MC
        # limiter; L-inf sits lower (~1.5) because the limiter clips at the
        # two sine extrema — the standard TVD behavior
        e1 = self._advect_error(32, transport.advect_muscl)
        e2 = self._advect_error(64, transport.advect_muscl)
        order = np.log2(e1 / e2)
        assert order > 1.8, (e1, e2, order)

    def test_beats_upwind(self):
        em = self._advect_error(64, transport.advect_muscl)
        eu = self._advect_error(64, transport.advect_upwind)
        # measured: 1.2e-3 vs 5.5e-2 (L1, one period at nx=64)
        assert em < eu / 10.0, (em, eu)

    def test_mass_conserved(self):
        rng = np.random.RandomState(0)
        f = jnp.asarray(rng.rand(16, 4, 1, 1))
        v = jnp.asarray([-1.0, -0.3, 0.4, 1.2])
        f1 = transport.advect_muscl(f, v, 0.1, 0.03)
        np.testing.assert_allclose(
            np.asarray(f1.sum(axis=0)), np.asarray(f.sum(axis=0)), rtol=1e-13
        )

    def test_tvd_no_new_extrema(self):
        # square wave stays within [0, 1]: the limiter suppresses the
        # oscillations an unlimited second-order scheme would produce
        f = jnp.asarray(
            np.where((np.arange(64) > 16) & (np.arange(64) < 48), 1.0, 0.0)
        )[:, None, None, None]
        v = jnp.asarray([1.0])
        for _ in range(40):
            f = transport.advect_muscl(f, v, 1.0 / 64, 0.5 / 64)
        f = np.asarray(f)
        assert f.min() > -1e-12 and f.max() < 1.0 + 1e-12

    def test_step_scheme_flag(self):
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        with pytest.raises(ValueError, match="scheme"):
            transport.make_inhomogeneous_step(
                cfg, coll, dx=0.1, dt=0.01, scheme="weno9"
            )


class TestStep2D:
    """The 2D×3V Strang solver (round-3 stretch: multi-dimensional
    production story on the cells-as-ensemble mapping)."""

    def _cfg(self):
        return bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")

    def test_uniform_y_matches_1d(self):
        # y-uniform data: the Ay half-steps are exact no-ops (zero slopes
        # and zero flux differences), so the 2D step must equal the 1D step
        # broadcast over the y cells, bitwise.
        cfg = self._cfg()
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        f1d = transport.sod_initial_condition(cfg, 4)  # (4, 8, 8, 8)
        f2d = jnp.broadcast_to(f1d[:, None], (4, 3) + f1d.shape[1:])
        dx = 0.25
        dt = 0.01
        step1 = transport.make_inhomogeneous_step(
            cfg, coll, dx=dx, dt=dt, knudsen=0.5
        )
        step2 = transport.make_inhomogeneous_step_2d(
            cfg, coll, dx=dx, dy=0.5, dt=dt, knudsen=0.5
        )
        out1 = np.asarray(jax.jit(step1)(f1d, pre))
        out2 = np.asarray(jax.jit(step2)(f2d, pre))
        for j in range(3):
            np.testing.assert_array_equal(out2[:, j], out1)

    def test_mass_conserved_2d(self):
        cfg = self._cfg()
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        rng = np.random.RandomState(3)
        base = np.asarray(transport.sod_initial_condition(cfg, 1))[0]
        f = jnp.asarray(
            base[None, None] * (1.0 + 0.2 * rng.rand(3, 2, 1, 1, 1))
        )
        step = transport.make_inhomogeneous_step_2d(
            cfg, coll, dx=0.3, dy=0.2, dt=0.01, knudsen=1.0
        )
        out = jax.jit(step)(f, pre)
        tot0 = float(jnp.sum(f))
        tot1 = float(jnp.sum(out))
        # advection conserves exactly (telescoping); the collision substep
        # conserves only to quadrature accuracy, which is coarse at
        # nv=8/n_radial=2 (measured drift 3e-5)
        assert abs(tot1 - tot0) / tot0 < 2e-4
        # collisionless limit: advection-only conservation at roundoff
        step_free = transport.make_inhomogeneous_step_2d(
            cfg, coll, dx=0.3, dy=0.2, dt=0.01, knudsen=1e30
        )
        tot2 = float(jnp.sum(jax.jit(step_free)(f, pre)))
        assert abs(tot2 - tot0) / tot0 < 1e-13

    def test_axis1_advection_matches_axis0_transposed(self):
        rng = np.random.RandomState(0)
        f = jnp.asarray(rng.rand(5, 7, 4, 1, 1))
        v = jnp.asarray(rng.randn(4))
        from boltzfft.transport import _advect_muscl_axis

        a0 = _advect_muscl_axis(
            jnp.swapaxes(f, 0, 1), v.reshape(1, 1, -1, 1, 1), 0.1, 0.02, 0
        )
        a1 = _advect_muscl_axis(f, v.reshape(1, 1, -1, 1, 1), 0.1, 0.02, 1)
        np.testing.assert_array_equal(np.asarray(jnp.swapaxes(a0, 0, 1)),
                                      np.asarray(a1))

    def test_bad_scheme(self):
        cfg = self._cfg()
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        with pytest.raises(ValueError, match="scheme"):
            transport.make_inhomogeneous_step_2d(
                cfg, coll, dx=0.1, dy=0.1, dt=0.01, scheme="nope"
            )


class TestStep3D:
    """The 3D×3V Strang solver — the full kinetic phase space (round-4:
    completes the 1D/2D/3D dimensional ladder on the same N-d core)."""

    def _cfg(self):
        return bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")

    def test_uniform_z_matches_2d(self):
        # z-uniform data: the Az half-steps are exact no-ops, so the 3D
        # step must equal the 2D step broadcast over the z cells, bitwise.
        cfg = self._cfg()
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        base = np.asarray(transport.sod_initial_condition(cfg, 1))[0]
        rng = np.random.RandomState(11)
        f2d = jnp.asarray(
            base[None, None] * (1.0 + 0.2 * rng.rand(4, 3, 1, 1, 1))
        )
        f3d = jnp.broadcast_to(f2d[:, :, None], (4, 3, 2) + base.shape)
        kw = dict(dx=0.25, dy=0.5, dt=0.01, knudsen=0.5)
        step2 = transport.make_inhomogeneous_step_2d(cfg, coll, **kw)
        step3 = transport.make_inhomogeneous_step_3d(cfg, coll, dz=0.4, **kw)
        out2 = np.asarray(jax.jit(step2)(f2d, pre))
        out3 = np.asarray(jax.jit(step3)(f3d, pre))
        for k in range(2):
            np.testing.assert_array_equal(out3[:, :, k], out2)

    def test_mass_conserved_3d(self):
        cfg = self._cfg()
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        rng = np.random.RandomState(5)
        base = np.asarray(transport.sod_initial_condition(cfg, 1))[0]
        f = jnp.asarray(
            base[None, None, None]
            * (1.0 + 0.2 * rng.rand(3, 2, 2, 1, 1, 1))
        )
        step = transport.make_inhomogeneous_step_3d(
            cfg, coll, dx=0.3, dy=0.2, dz=0.25, dt=0.01, knudsen=1.0
        )
        out = jax.jit(step)(f, pre)
        tot0 = float(jnp.sum(f))
        assert abs(float(jnp.sum(out)) - tot0) / tot0 < 2e-4
        step_free = transport.make_inhomogeneous_step_3d(
            cfg, coll, dx=0.3, dy=0.2, dz=0.25, dt=0.01, knudsen=1e30
        )
        tot2 = float(jnp.sum(jax.jit(step_free)(f, pre)))
        assert abs(tot2 - tot0) / tot0 < 1e-13

    def test_shard_map_3d_parity_and_local_ffts(self):
        # 2x2x2 mesh = all 8 virtual devices; 2 cells/shard on every axis
        # (= the MUSCL halo width)
        cfg = self._cfg()
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        rng = np.random.RandomState(9)
        base = np.asarray(transport.sod_initial_condition(cfg, 1))[0]
        f = jnp.asarray(
            base[None, None, None]
            * (1.0 + 0.3 * rng.rand(4, 4, 4, 1, 1, 1))
        )
        kw = dict(dx=0.3, dy=0.2, dz=0.25, dt=0.01, knudsen=1.0)
        ref = np.asarray(
            jax.jit(transport.make_inhomogeneous_step_3d(cfg, coll, **kw))(
                f, pre
            )
        )
        mesh = bz.make_mesh([("cx", 2), ("cy", 2), ("cz", 2)])
        sh_step = transport.make_sharded_step_3d(
            cfg, coll, mesh, x_axis="cx", y_axis="cy", z_axis="cz", **kw
        )
        f_sh = bz.place_cells(f, mesh, x_axis="cx", y_axis="cy", z_axis="cz")
        out = np.asarray(sh_step(f_sh, pre))
        np.testing.assert_allclose(out, ref, atol=2e-6 * np.abs(ref).max())
        txt = sh_step.lower(f_sh, pre).compile().as_text()
        assert "collective-permute" in txt  # the ppermute halos
        assert "all-gather" not in txt  # ffts stay shard-local

    def test_3d_placement(self):
        cfg = self._cfg()
        base = np.asarray(transport.sod_initial_condition(cfg, 1))[0]
        f = jnp.asarray(np.broadcast_to(base, (2, 2, 2) + base.shape))
        mesh = bz.make_mesh([("cx", 2), ("cz", 2)])
        f_sh = bz.place_cells(f, mesh, x_axis="cx", z_axis="cz")
        assert f_sh.sharding.spec == jax.sharding.PartitionSpec(
            "cx", None, "cz"
        )


class TestSpatialSharding:
    """2D spatial domain decomposition over the device mesh.

    Two formulations, both parity-tested against the unsharded step:
    plain jit over :func:`boltzfft.place_cells`-sharded inputs (GSPMD —
    correct, but measured to ALL-GATHER the cell batch around fft ops),
    and :func:`transport.make_sharded_step_2d` (shard_map + ppermute
    halos — every FFT shard-local, the production decomposition)."""

    def _setup(self, cx=4, cy=2):
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")
        coll, pre = bz.make_collision_operator(cfg, jit=False)
        rng = np.random.RandomState(7)
        base = np.asarray(transport.sod_initial_condition(cfg, 1))[0]
        f = jnp.asarray(
            base[None, None] * (1.0 + 0.3 * rng.rand(cx, cy, 1, 1, 1))
        )  # (Cx, Cy, 8, 8, 8)
        step = transport.make_inhomogeneous_step_2d(
            cfg, coll, dx=0.3, dy=0.2, dt=0.01, knudsen=1.0
        )
        ref = np.asarray(jax.jit(step)(f, pre))
        return cfg, coll, pre, f, step, ref

    def test_gspmd_parity_but_gathers(self):
        _, _, pre, f, step, ref = self._setup()
        mesh = bz.make_mesh([("cx", 4), ("cy", 2)])
        f_sh = bz.place_cells(f, mesh, x_axis="cx", y_axis="cy")
        stepped = jax.jit(step)
        out = np.asarray(stepped(f_sh, pre))
        np.testing.assert_allclose(out, ref, atol=2e-6 * np.abs(ref).max())
        txt = stepped.lower(f_sh, pre).compile().as_text()
        # rolls DO become halo collectives ...
        assert "collective-permute" in txt
        # ... but GSPMD all-gathers the cell batch around the fft op —
        # the documented motivation for make_sharded_step_2d
        assert "all-gather" in txt

    def test_shard_map_step_parity_and_local_ffts(self):
        # 2 cells per shard on each axis (= the MUSCL halo width)
        cfg, coll, pre, f, _, ref = self._setup(cx=8, cy=4)
        mesh = bz.make_mesh([("cx", 4), ("cy", 2)])
        sh_step = transport.make_sharded_step_2d(
            cfg, coll, mesh, dx=0.3, dy=0.2, dt=0.01, knudsen=1.0,
            x_axis="cx", y_axis="cy",
        )
        f_sh = bz.place_cells(f, mesh, x_axis="cx", y_axis="cy")
        out = np.asarray(sh_step(f_sh, pre))
        np.testing.assert_allclose(out, ref, atol=2e-6 * np.abs(ref).max())
        txt = sh_step.lower(f_sh, pre).compile().as_text()
        assert "collective-permute" in txt  # the ppermute halos
        assert "all-gather" not in txt  # ffts stay shard-local

    def test_shard_map_one_axis_only(self):
        cfg, coll, pre, f, _, ref = self._setup(cx=8, cy=2)
        mesh = bz.make_mesh([("cx", 4)])
        sh_step = transport.make_sharded_step_2d(
            cfg, coll, mesh, dx=0.3, dy=0.2, dt=0.01, knudsen=1.0,
            x_axis="cx",
        )
        out = np.asarray(sh_step(bz.place_cells(f, mesh, x_axis="cx"), pre))
        np.testing.assert_allclose(out, ref, atol=2e-6 * np.abs(ref).max())

    def test_halo_narrower_than_stencil_raises(self):
        cfg, coll, pre, f, _, _ = self._setup(cx=4, cy=2)
        mesh = bz.make_mesh([("cx", 4)])
        sh_step = transport.make_sharded_step_2d(
            cfg, coll, mesh, dx=0.3, dy=0.2, dt=0.01, x_axis="cx"
        )
        with pytest.raises(ValueError, match="halo width"):
            sh_step(bz.place_cells(f, mesh, x_axis="cx"), pre)

    def test_1d_placement(self):
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")
        f = transport.sod_initial_condition(cfg, 8)
        mesh = bz.make_mesh([("cx", 8)])
        f_sh = bz.place_cells(f, mesh, x_axis="cx")
        assert f_sh.sharding.spec == jax.sharding.PartitionSpec("cx")
        with pytest.raises(ValueError, match="expected"):
            bz.place_cells(f[0, 0], mesh, x_axis="cx")

