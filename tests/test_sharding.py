"""Sharded-vs-single-device parity on a virtual 8-device CPU mesh.

The conftest forces ``--xla_force_host_platform_device_count=8`` so these run
without several accelerators (SURVEY.md section 5's mocked-mesh strategy).
"""

import jax
import numpy as np
import pytest

import boltzfft as bz

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _setup(nv=16, ns=6, **kw):
    cfg = bz.CollisionConfig(nv=nv, ns=ns, impl="rfft", **kw)
    g = cfg.velocity_grid
    f = bz.bkw_f(g.r_squared(), 6.5)
    return cfg, f


class TestNodeSharding:
    @pytest.mark.parametrize("n_shards", [2, 4, 8])
    def test_matches_single_device(self, n_shards):
        cfg, f = _setup()
        coll_ref, pre_ref = bz.make_collision_operator(cfg)
        q_ref = np.asarray(coll_ref(f, pre_ref))

        mesh = bz.make_mesh([(bz.NODE_AXIS, n_shards)])
        coll_sh, pre_sh = bz.make_sharded_collision_operator(cfg, mesh)
        q_sh = np.asarray(coll_sh(f, bz.place(pre_sh, mesh)))

        scale = np.abs(q_ref).max()
        np.testing.assert_allclose(q_sh, q_ref, atol=1e-13 * scale)

    @pytest.mark.parametrize("impl", ["dft", "c2c"])
    @pytest.mark.parametrize("n_shards", [4, 5])
    def test_staged_impls_shard(self, impl, n_shards):
        # every staged pipeline composes with shard_map over local node
        # shards (5 shards: uneven split with zero-weight padding)
        cfg = bz.CollisionConfig(nv=8, ns=12, impl=impl)
        f = bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
        coll_ref, pre_ref = bz.make_collision_operator(
            bz.CollisionConfig(nv=8, ns=12, impl="c2c")
        )
        q_ref = np.asarray(coll_ref(f, pre_ref))
        mesh = bz.make_mesh([(bz.NODE_AXIS, n_shards)])
        coll_sh, pre_sh = bz.make_sharded_collision_operator(cfg, mesh)
        q_sh = np.asarray(coll_sh(f, bz.place(pre_sh, mesh)))
        np.testing.assert_allclose(q_sh, q_ref, atol=1e-12 * np.abs(q_ref).max())

    def test_anisotropic_dft_shards(self):
        # per-axis DFT matrices are replicated alongside the node shards
        cfg = bz.CollisionConfig(nv=8, nvy=6, nvz=10, ns=6, impl="dft")
        f = bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
        coll_ref, pre_ref = bz.make_collision_operator(cfg)
        q_ref = np.asarray(coll_ref(f, pre_ref))
        mesh = bz.make_mesh([(bz.NODE_AXIS, 4)])
        coll_sh, pre_sh = bz.make_sharded_collision_operator(cfg, mesh)
        q_sh = np.asarray(coll_sh(f, bz.place(pre_sh, mesh)))
        np.testing.assert_allclose(q_sh, q_ref, atol=1e-12 * np.abs(q_ref).max())

    def test_uneven_node_count_pads(self):
        # B = 16*6 = 96 doesn't divide 5-chunking x 8 shards without padding.
        cfg, f = _setup(node_chunk=5)
        mesh = bz.make_mesh([(bz.NODE_AXIS, 8)])
        coll_sh, pre_sh = bz.make_sharded_collision_operator(cfg, mesh)
        assert pre_sh.rho.shape[0] % 8 == 0

        coll_ref, pre_ref = bz.make_collision_operator(
            bz.CollisionConfig(nv=16, ns=6, impl="rfft")
        )
        q_ref = np.asarray(coll_ref(f, pre_ref))
        q_sh = np.asarray(coll_sh(f, pre_sh))
        np.testing.assert_allclose(q_sh, q_ref, atol=1e-13 * np.abs(q_ref).max())


class TestEnsembleSharding:
    def test_ensemble_axis(self):
        cfg, f = _setup()
        ens = np.stack([f * s for s in (1.0, 0.5, 0.25, 2.0)] * 2)  # (8, N,N,N)
        mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, 8)])
        coll, pre = bz.make_sharded_collision_operator(
            cfg, mesh, node_axis=None, ensemble_axis=bz.ENSEMBLE_AXIS
        )
        q = np.asarray(coll(ens, pre))
        assert q.shape == ens.shape

        coll_ref, pre_ref = bz.make_collision_operator(cfg)
        q0 = np.asarray(coll_ref(f, pre_ref))
        scale = np.abs(q0).max()
        np.testing.assert_allclose(q[0], q0, atol=1e-13 * scale)
        # bilinearity: Q(2f) = 4 Q(f)
        np.testing.assert_allclose(q[3], 4.0 * q0, atol=1e-12 * scale)

    def test_combined_mesh(self):
        # 2-D mesh: ensemble x node — the full production layout.
        cfg, f = _setup()
        ens = np.stack([f, 0.5 * f])
        mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, 2), (bz.NODE_AXIS, 4)])
        coll, pre = bz.make_sharded_collision_operator(
            cfg, mesh, node_axis=bz.NODE_AXIS, ensemble_axis=bz.ENSEMBLE_AXIS
        )
        q = np.asarray(coll(ens, pre))

        coll_ref, pre_ref = bz.make_collision_operator(cfg)
        q0 = np.asarray(coll_ref(f, pre_ref))
        scale = np.abs(q0).max()
        np.testing.assert_allclose(q[0], q0, atol=1e-13 * scale)
        np.testing.assert_allclose(q[1], 0.25 * q0, atol=1e-13 * scale)


class TestMesh:
    def test_make_mesh_default(self):
        mesh = bz.make_mesh()
        assert mesh.axis_names == (bz.NODE_AXIS,)

    def test_too_many_devices(self):
        with pytest.raises(ValueError):
            bz.make_mesh([(bz.NODE_AXIS, 1024)])
