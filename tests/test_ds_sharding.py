"""Radial-sharded ds operator parity on the virtual 8-device CPU mesh.

The ds pipeline's multi-chip story: radial quadrature groups shard over the
mesh; the cross-device gain reduction is a compensated all_gather + ds fold
(a plain f32 psum would collapse the ~49-bit pairs back to 2^-24).
"""

import jax
import numpy as np
import pytest

import boltzfft as bz
from boltzfft import ds

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _setup(nv=8, ns=6, n_radial=6):
    cfg = bz.CollisionConfig(
        nv=nv, ns=ns, n_radial=n_radial, impl="c2c", dtype="float32"
    )
    f64 = np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
    return cfg, ds.from_f64(f64)


class TestRadialSharding:
    @pytest.mark.parametrize(
        "n_shards",
        [2, pytest.param(4, marks=pytest.mark.slow)],
    )
    def test_matches_single_device(self, n_shards):
        # n_radial=6 over 4 shards also exercises zero-weight group padding
        cfg, f = _setup()
        coll_ref, pre_ref = bz.make_ds_collision_operator(cfg, contract="vpu")
        q_ref = ds.to_f64(coll_ref(f, pre_ref))

        mesh = bz.make_mesh([(bz.NODE_AXIS, n_shards)])
        coll_sh, pre_sh = bz.make_sharded_ds_collision_operator(
            cfg, mesh, contract="vpu"
        )
        q_sh = ds.to_f64(coll_sh(f, bz.place_ds(pre_sh, mesh)))

        # fold order differs from the unsharded scan: ds-class tolerance,
        # far beyond f32 (~6e-8)
        scale = np.abs(q_ref).max()
        np.testing.assert_allclose(q_sh, q_ref, atol=1e-13 * scale)

    def test_deterministic(self):
        cfg, f = _setup()
        mesh = bz.make_mesh([(bz.NODE_AXIS, 4)])
        coll, pre = bz.make_sharded_ds_collision_operator(cfg, mesh, contract="vpu")
        pre = bz.place_ds(pre, mesh)
        a = ds.to_f64(coll(f, pre))
        b = ds.to_f64(coll(f, pre))
        np.testing.assert_array_equal(a, b)

    def test_ensemble_and_radial_mesh(self):
        cfg, f = _setup()
        e = 4
        fe = ds.DS(
            np.broadcast_to(np.asarray(f.hi), (e,) + f.hi.shape).copy(),
            np.broadcast_to(np.asarray(f.lo), (e,) + f.lo.shape).copy(),
        )
        coll_ref, pre_ref = bz.make_ds_collision_operator(cfg, contract="vpu")
        q_ref = ds.to_f64(coll_ref(f, pre_ref))

        mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, 2), (bz.NODE_AXIS, 4)])
        coll_sh, pre_sh = bz.make_sharded_ds_collision_operator(
            cfg, mesh, ensemble_axis=bz.ENSEMBLE_AXIS, contract="vpu"
        )
        q_sh = ds.to_f64(coll_sh(fe, bz.place_ds(pre_sh, mesh)))
        assert q_sh.shape == (e,) + q_ref.shape
        scale = np.abs(q_ref).max()
        for i in range(e):
            np.testing.assert_allclose(q_sh[i], q_ref, atol=1e-13 * scale)


class TestHalfStreamSharding:
    @pytest.mark.slow
    def test_half_matches_single_device(self):
        # the half-spectrum g-streams under shard_map: pmz_half tables and
        # correction phase tables shard on the radial axis with the rest
        cfg, f = _setup(nv=6, ns=6, n_radial=4)
        coll_ref, pre_ref = bz.make_ds_collision_operator(cfg, contract="vpu")
        q_ref = ds.to_f64(coll_ref(f, pre_ref))

        mesh = bz.make_mesh([(bz.NODE_AXIS, 2)])
        coll_sh, pre_sh = bz.make_sharded_ds_collision_operator(
            cfg, mesh, contract="oz", g_stream="half", sub_batch=6
        )
        q_sh = ds.to_f64(coll_sh(f, bz.place_ds(pre_sh, mesh)))
        scale = np.abs(q_ref).max()
        np.testing.assert_allclose(q_sh, q_ref, atol=1e-12 * scale)

    @pytest.mark.slow
    def test_tuning_knobs_thread_through(self):
        # group_batch / herm_downstream reach collide_ds per shard (round-3
        # advisor gap: the sharded factory silently applied the auto rules)
        cfg, f = _setup(nv=6, ns=6, n_radial=4)
        coll_ref, pre_ref = bz.make_ds_collision_operator(cfg, contract="vpu")
        q_ref = ds.to_f64(coll_ref(f, pre_ref))

        mesh = bz.make_mesh([(bz.NODE_AXIS, 2)])
        coll_sh, pre_sh = bz.make_sharded_ds_collision_operator(
            cfg, mesh, contract="oz", g_stream="half", sub_batch=6,
            group_batch=2, herm_downstream=True,
        )
        q_sh = ds.to_f64(coll_sh(f, bz.place_ds(pre_sh, mesh)))
        scale = np.abs(q_ref).max()
        np.testing.assert_allclose(q_sh, q_ref, atol=1e-12 * scale)
