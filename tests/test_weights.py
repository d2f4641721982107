"""Config/precompute invariants: chunking, padding, weight identities."""

import numpy as np
import pytest

import boltzfft as bz
from boltzfft.weights import build_precomp, repad_nodes


class TestAutoChunk:
    def test_small_configs_unchunked(self):
        cfg = bz.CollisionConfig(nv=16, ns=6, dtype="float32")
        assert cfg.chunk == cfg.n_nodes and cfg.n_chunks == 1

    def test_large_configs_chunked_evenly(self):
        cfg = bz.CollisionConfig(nv=64, ns=32, dtype="float32")
        assert cfg.n_chunks > 1
        # equalized chunks: padded total close to B
        assert cfg.n_nodes_padded - cfg.n_nodes < cfg.chunk

    def test_explicit_chunk_respected(self):
        cfg = bz.CollisionConfig(nv=32, ns=12, node_chunk=96)
        # B = 32 radial * 6 antipodal-reduced spherical nodes = 192
        assert cfg.chunk == 96 and cfg.n_chunks == 2

    def test_chunk_never_exceeds_batch(self):
        cfg = bz.CollisionConfig(nv=16, ns=6, node_chunk=10_000)
        assert cfg.chunk == cfg.n_nodes

    def test_budget_from_device_memory_stats(self, monkeypatch):
        # The budget is a fixed share (6/16) of the device's reported
        # bytes_limit.
        from boltzfft import weights as w

        class FakeDev:
            def __init__(self, limit):
                self._l = limit

            def memory_stats(self):
                return {"bytes_limit": self._l} if self._l else None

        import jax

        monkeypatch.setattr(jax, "local_devices", lambda: [FakeDev(16 << 30)])
        assert w._device_hbm_budget() == 6 << 30
        monkeypatch.setattr(jax, "local_devices", lambda: [FakeDev(32 << 30)])
        assert w._device_hbm_budget() == 12 << 30
        # no stats (the CPU backend) -> fixed fallback
        monkeypatch.setattr(jax, "local_devices", lambda: [FakeDev(None)])
        assert w._device_hbm_budget() == w._FALLBACK_HBM_BUDGET

    def test_budget_drives_chunking(self, monkeypatch):
        from boltzfft import weights as w

        cfg = bz.CollisionConfig(nv=64, ns=32, dtype="float32")
        big = cfg.auto_chunk(budget_bytes=64 << 30)
        small = cfg.auto_chunk(budget_bytes=1 << 30)
        assert big == cfg.n_nodes and small < big
        # default path consults the device
        monkeypatch.setattr(w, "_device_hbm_budget", lambda: 1 << 30)
        assert cfg.auto_chunk() == small

    @pytest.mark.parametrize("backend", ["cpu", "gpu"])
    def test_fit_rule_is_backend_independent(self, monkeypatch, backend):
        # one memory-fit rule everywhere: the chunk depends on the budget
        # and the grid, never on which backend reports the budget
        import jax

        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        big = bz.CollisionConfig(nv=128, ns=12, impl="rfft", dtype="float32")
        assert big.auto_chunk(budget_bytes=64 << 30) == big.n_nodes
        small = bz.CollisionConfig(nv=32, ns=12, impl="rfft", dtype="float32")
        assert small.auto_chunk(budget_bytes=6 << 30) == small.n_nodes

    def test_batch_shares_budget(self):
        # distributions evaluated together (vmapped cells, ensemble members)
        # share one budget: the chunk shrinks with the batch
        cfg = bz.CollisionConfig(nv=32, ns=12, impl="rfft", dtype="float64")
        budget = 6 << 30
        one = cfg.auto_chunk(budget_bytes=budget)
        many = cfg.auto_chunk(budget_bytes=budget, batch=256)
        assert one == cfg.n_nodes and many < one
        n_modes = 32 * 32 * 17
        assert many * 256 * 9 * n_modes * 16 <= budget
        # chunks stay an even split of the node batch
        assert -(-cfg.n_nodes // many) * many - cfg.n_nodes < many


class TestPrecomp:
    def test_padded_nodes_have_zero_weight(self):
        cfg = bz.CollisionConfig(nv=16, ns=6, node_chunk=5)  # B=96 -> pad to 100
        pre = build_precomp(cfg)
        assert pre.rho.shape[0] == cfg.n_nodes_padded
        np.testing.assert_array_equal(
            np.asarray(pre.gain_w[cfg.n_nodes :]), 0.0
        )

    def test_gain_weight_identity(self):
        # gain_w[b] = w_gl[r] * w_sph[s] * rho_r^(gamma+2)
        cfg = bz.CollisionConfig(nv=8, ns=6, n_radial=4, gamma=1.0)
        pre = build_precomp(cfg)
        gl = bz.gauss_legendre(4, 0.0, cfg.r_max)
        from boltzfft.weights import spherical_quadrature
        sph = spherical_quadrature(cfg)  # 3 antipodal-reduced nodes, 2x weight
        expect = np.repeat(gl.weights * gl.nodes**3.0, 3) * np.tile(sph.weights, 4)
        np.testing.assert_allclose(np.asarray(pre.gain_w), expect, rtol=1e-14)

    def test_beta2_positive_at_origin(self):
        # beta2(0) = 16 pi^2 b_gamma sum w_r rho^2 sincc(0) > 0
        cfg = bz.CollisionConfig(nv=8, ns=6)
        pre = build_precomp(cfg)
        assert float(pre.beta2[0, 0, 0]) > 0

    def test_repad_nodes(self):
        cfg = bz.CollisionConfig(nv=8, ns=6)
        pre = build_precomp(cfg)
        b = pre.rho.shape[0]
        pre2 = repad_nodes(pre, b + 7)
        assert pre2.rho.shape[0] == b + 7
        np.testing.assert_array_equal(np.asarray(pre2.gain_w[b:]), 0.0)
        np.testing.assert_array_equal(np.asarray(pre2.rho[:b]), np.asarray(pre.rho))
        with pytest.raises(ValueError):
            repad_nodes(pre, b - 1)
        assert repad_nodes(pre, b) is pre

    def test_rfft_vs_c2c_mode_tables(self):
        pre_r = build_precomp(bz.CollisionConfig(nv=8, ns=6, impl="rfft"))
        pre_c = build_precomp(bz.CollisionConfig(nv=8, ns=6, impl="c2c"))
        assert pre_r.lz.shape[0] == 5 and pre_c.lz.shape[0] == 8
        # half-axis beta2 equals the corresponding slice of the full table
        np.testing.assert_allclose(
            np.asarray(pre_r.beta2), np.asarray(pre_c.beta2[:, :, :5]), rtol=1e-14
        )


class TestOzCmaxConfig:
    """cfg.oz_cmax — the ds accuracy dial as a CollisionConfig field
    (VERDICT r3 ask #6: the accuracy midpoint, plumbed as config)."""

    def test_validation(self):
        bz.CollisionConfig(nv=8, ns=6, oz_cmax=4)  # ok
        with pytest.raises(ValueError, match="oz_cmax"):
            bz.CollisionConfig(nv=8, ns=6, oz_cmax=-1)
        with pytest.raises(ValueError, match="oz_cmax"):
            bz.CollisionConfig(nv=8, ns=6, oz_cmax=15)

    def test_cfg_field_matches_kwarg_bitwise(self):
        """collide_ds(cfg-with-oz_cmax) == collide_ds(..., oz_cmax=) exactly,
        and the per-call kwarg overrides the config field."""
        from boltzfft import ds
        from boltzfft.ds_operator import build_ds_precomp, collide_ds

        kw = dict(nv=8, ns=6, n_radial=2, impl="c2c", dtype="float32")
        cfg = bz.CollisionConfig(**kw)
        cfg4 = bz.CollisionConfig(**kw, oz_cmax=4)
        pre = build_ds_precomp(cfg)
        f = ds.from_f64(
            np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
        )
        q_kw = ds.to_f64(collide_ds(cfg, pre, f, contract="oz", oz_cmax=4))
        q_cfg = ds.to_f64(collide_ds(cfg4, pre, f, contract="oz"))
        np.testing.assert_array_equal(q_kw, q_cfg)
        # per-call kwarg wins over the config field
        q_ovr = ds.to_f64(collide_ds(cfg4, pre, f, contract="oz", oz_cmax=6))
        q_six = ds.to_f64(collide_ds(cfg, pre, f, contract="oz", oz_cmax=6))
        np.testing.assert_array_equal(q_ovr, q_six)
