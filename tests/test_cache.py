"""Persistence: precomp serialization round-trip and compilation cache setup."""

import numpy as np

import boltzfft as bz


class TestPrecompSerialization:
    def test_roundtrip(self, tmp_path):
        cfg = bz.CollisionConfig(nv=16, ns=6, impl="rfft")
        pre = bz.build_precomp(cfg)
        path = tmp_path / "precomp.npz"
        bz.save_precomp(path, cfg, pre)
        cfg2, pre2 = bz.load_precomp(path)
        assert cfg2 == cfg
        for name in pre._fields:
            a, b = getattr(pre, name), getattr(pre2, name)
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_loaded_precomp_computes(self, tmp_path):
        cfg = bz.CollisionConfig(nv=16, ns=6, impl="dft")
        pre = bz.build_precomp(cfg)
        path = tmp_path / "p.npz"
        bz.save_precomp(path, cfg, pre)
        cfg2, pre2 = bz.load_precomp(path)

        f = bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
        import jax

        q1 = np.asarray(jax.jit(lambda x, p: bz.collide(cfg, p, x))(f, pre))
        q2 = np.asarray(jax.jit(lambda x, p: bz.collide(cfg2, p, x))(f, pre2))
        np.testing.assert_array_equal(q1, q2)


class TestCompilationCache:
    def test_enable(self, monkeypatch):
        # no JAX_COMPILATION_CACHE_DIR: the fixed <checkout>/.xla_cache
        import jax

        from boltzfft import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        updates = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: updates.__setitem__(k, v))
        path = bz.enable_compilation_cache()
        assert path == str(cache.CHECKOUT / ".xla_cache")
        assert (cache.CHECKOUT / "boltzfft" / "cache.py").exists()
        assert updates["jax_compilation_cache_dir"] == path

    def test_env_var_wins_and_sets_nothing(self, monkeypatch, tmp_path):
        import jax

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        updates = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: updates.__setitem__(k, v))
        assert bz.enable_compilation_cache() == str(tmp_path)
        assert updates == {}

    def test_default_path_is_fixed(self, monkeypatch):
        # part of the cache key: never a temporary or per-process directory
        import os
        from pathlib import Path

        from boltzfft import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setenv("TMPDIR", "/elsewhere")
        path = cache.compilation_cache_dir()
        assert path == cache.compilation_cache_dir()
        assert Path(path).parent == cache.CHECKOUT
        assert str(os.getpid()) not in path
