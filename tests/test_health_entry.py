"""Self-check utility and the driver entry-point contract."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class TestSelfcheck:
    def test_passes_on_cpu(self):
        from boltzfft.health import selfcheck

        r = selfcheck()
        assert r["ok"], r
        assert r["finite"]
        assert r["rel_linf"] < r["rel_tol"]
        assert r["backend"] == "cpu"

    @pytest.mark.parametrize("impl", ["c2c", "dft"])
    def test_passes_other_impls(self, impl):
        from boltzfft.health import selfcheck

        r = selfcheck(impl=impl, dtype="float32")
        assert r["ok"], r
        assert r["config"]["impl"] == impl

    def test_default_impl_is_backend_choice(self):
        import boltzfft as bz
        from boltzfft.health import selfcheck

        r = selfcheck(nv=8, ns=6)
        assert r["config"]["impl"] == bz.pipeline_choice().impl == "rfft"

    def test_detects_corrupted_weights(self):
        """Known-answer property: a wrong-but-bounded Q must FAIL. Corrupt
        the loss multiplier (beta2 x2) and the gain weights (x0.5) — each is
        the class of silent numerical fault an amplitude envelope misses."""
        from boltzfft.health import selfcheck

        r = selfcheck(pre_transform=lambda p: p._replace(beta2=2.0 * p.beta2))
        assert not r["ok"], r
        assert r["finite"]

        r = selfcheck(
            pre_transform=lambda p: p._replace(gain_w=0.5 * p.gain_w)
        )
        assert not r["ok"], r


class TestGraftEntry:
    def test_entry_compiles_and_runs(self):
        import __graft_entry__ as ge

        fn, (f, pre) = ge.entry()
        q = jax.jit(fn)(f, pre)
        assert q.shape == f.shape
        assert np.all(np.isfinite(np.asarray(q)))

    @pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
    def test_dryrun_multichip(self, capsys):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)
        out = capsys.readouterr().out
        # one ok line per operator family
        for fam in ("[rfft]", "[ds]", "[spatial2d]", "[spatial3d]"):
            assert f"dryrun_multichip ok {fam}" in out

    @pytest.mark.slow
    @pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")
    def test_dryrun_multichip_odd_mesh(self, capsys):
        import __graft_entry__ as ge

        ge.dryrun_multichip(4)
        assert "dryrun_multichip ok" in capsys.readouterr().out

    def test_dryrun_raises_when_devices_short(self):
        # no silent re-run on another backend: too few devices is an error
        import __graft_entry__ as ge

        with pytest.raises(RuntimeError, match="need 64 devices"):
            ge.dryrun_multichip(64)
