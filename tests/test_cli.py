"""CLI drivers: output-format parity and end-to-end runs (CPU backend)."""

import numpy as np
import pytest


def _run(mod_main, argv):
    return mod_main(argv)


class TestMaxwellBKW:
    def test_runs_and_reports(self, capsys):
        from boltzfft.cli.maxwell_bkw import main

        assert main(["--Nv", "16", "--Ns", "6", "--trials", "2"]) == 0
        out = capsys.readouterr().out
        assert "Run arguments:" in out
        assert "Nv = 16" in out
        assert "Statistics for" in out
        assert "Linf error:" in out
        # accuracy at 16^3 (calibrated)
        linf = float(out.split("Linf error:")[1].split()[0])
        assert linf < 6e-4

    def test_anisotropic_flags(self, capsys):
        # --Nvy/--Nvz (reference ctor parity) through eval, norms, and ds
        from boltzfft.cli.maxwell_bkw import main

        assert main(["--Nv", "16", "--Nvy", "12", "--Nvz", "8",
                     "--Ns", "6", "--impl", "c2c"]) == 0
        out = capsys.readouterr().out
        assert "Linf error:" in out
        assert main(["--Nv", "8", "--Nvy", "10", "--Nvz", "6", "--Ns", "6",
                     "--n-radial", "2", "--impl", "ds"]) == 0
        assert "Linf error:" in capsys.readouterr().out

    def test_relaxation_mode(self, capsys):
        from boltzfft.cli.maxwell_bkw import main

        assert main(["--Nv", "16", "--Ns", "6", "--steps", "2", "--dt", "0.25"]) == 0
        out = capsys.readouterr().out
        assert "Relaxation: 2 RK4 steps" in out
        assert "mass drift" in out
        linf = float(out.split("Linf error:")[1].split()[0])
        assert linf < 1e-3

    def test_hard_sphere_kernel(self, capsys):
        from boltzfft.cli.maxwell_bkw import main

        assert main(["--Nv", "8", "--Ns", "6", "--gamma", "1.0"]) == 0
        assert "only meaningful for Maxwell" in capsys.readouterr().out

    def test_c2c_impl(self, capsys):
        from boltzfft.cli.maxwell_bkw import main

        assert main(["--Nv", "8", "--Ns", "6", "--impl", "c2c"]) == 0
        assert "impl = c2c" in capsys.readouterr().out

    def test_ds_impl(self, capsys):
        # compensated pipeline end-to-end; at 8^3 the ds result equals the
        # f64 method error, which the f32 paths cannot reach
        from boltzfft.cli.maxwell_bkw import main

        assert main(["--Nv", "8", "--Ns", "6", "--n-radial", "4",
                     "--impl", "ds"]) == 0
        out = capsys.readouterr().out
        assert "Statistics for boltzfft/ds" in out
        assert "Linf error:" in out

    def test_ds_knob_plumbing(self, monkeypatch):
        # the ds flags (--g-stream, --g1-reversal, --ds-contract) must reach
        # the ds factory with the documented semantics; digits are pinned by
        # the test_half_spectrum oracles, so this only checks the plumbing
        import boltzfft as bz
        from boltzfft.cli import maxwell_bkw

        seen = {}

        def fake_factory(cfg, **kw):
            seen.update(kw)
            raise RuntimeError("stop after capture")

        monkeypatch.setattr(bz, "make_ds_collision_operator", fake_factory)
        args = ["--Nv", "8", "--Ns", "6", "--n-radial", "4", "--impl", "ds",
                "--g-stream", "half", "--g1-reversal", "--ds-contract", "oz"]
        with pytest.raises(RuntimeError, match="stop after capture"):
            maxwell_bkw.main(args)
        assert seen["g1_reversal"] is True
        assert seen["contract"] == "oz"
        assert seen["g_stream"] == "half"

        seen.clear()
        with pytest.raises(RuntimeError, match="stop after capture"):
            maxwell_bkw.main(["--Nv", "8", "--Ns", "6", "--n-radial", "4",
                              "--impl", "ds"])
        # defaults: the backend's engine, full streams, reversal opt-in
        assert seen["contract"] is None
        assert seen["g_stream"] == "full"
        assert not seen["g1_reversal"]

    @pytest.mark.slow
    def test_ds_impl_relaxation(self, capsys):
        # slow tier: test_ds_relaxation covers the ds time-integration path
        from boltzfft.cli.maxwell_bkw import main

        assert main(["--Nv", "6", "--Ns", "6", "--n-radial", "2",
                     "--impl", "ds", "--steps", "2", "--dt", "0.25"]) == 0
        out = capsys.readouterr().out
        assert "Relaxation (ds): 2 RK4 steps" in out
        assert "Linf error:" in out


class TestFFTBenchmark:
    def test_runs(self, capsys):
        from boltzfft.cli.fft_benchmark import main

        assert main(["--Nv", "8", "--Ns", "6", "--chain", "2", "-t", "2"]) == 0
        out = capsys.readouterr().out
        assert "Fastest:" in out
        # round-trip errors at machine precision
        for line in out.splitlines():
            if "L1 err" in line:
                assert float(line.split("L1 err")[1]) < 1e-12


class TestLoopBenchmark:
    def test_runs(self, capsys):
        from boltzfft.cli.loop_benchmark import main

        assert main(["--Nv", "8", "--Ns", "6", "--chain", "2", "-t", "2"]) == 0
        out = capsys.readouterr().out
        assert "pattern1" in out and "pattern2" in out


class TestEnsembleBKW:
    def test_runs(self, capsys):
        from boltzfft.cli.ensemble_bkw import main

        assert main(
            ["--Nv", "8", "--Ns", "6", "--ensemble", "8", "--steps", "2"]
        ) == 0
        out = capsys.readouterr().out
        assert "final mass range" in out

    def test_bad_ensemble_split(self):
        from boltzfft.cli.ensemble_bkw import main

        with pytest.raises(SystemExit):
            main(["--Nv", "8", "--Ns", "6", "--ensemble", "3", "--ens-mesh", "2"])


class TestTaylorGreen2D3V:
    def test_runs_and_decays(self, capsys):
        from boltzfft.cli.taylor_green_2d3v import main

        assert main(["--cells", "4", "--Nv", "8", "--Ns", "6",
                     "--steps", "2", "--n-radial", "4",
                     "--mass-tol", "0.05"]) == 0
        out = capsys.readouterr().out
        assert "bulk-KE" in out and "cells vmapped" in out

    def test_sharded_matches_mode_line(self, capsys):
        from boltzfft.cli.taylor_green_2d3v import main

        assert main(["--cells", "8", "--Nv", "8", "--Ns", "6",
                     "--steps", "2", "--n-radial", "4",
                     "--mass-tol", "0.05", "--mesh", "4x2"]) == 0
        out = capsys.readouterr().out
        assert "spatial decomposition 4x2" in out

    def test_bad_mesh_split(self):
        from boltzfft.cli.taylor_green_2d3v import main

        with pytest.raises(SystemExit):
            main(["--cells", "6", "--Nv", "8", "--Ns", "6", "--mesh", "4x2"])

    def test_ds_rejected(self):
        from boltzfft.cli.taylor_green_2d3v import main

        with pytest.raises(SystemExit):
            main(["--cells", "4", "--Nv", "8", "--Ns", "6", "--impl", "ds"])


class TestTaylorGreen3D3V:
    def test_runs_and_decays(self, capsys):
        from boltzfft.cli.taylor_green_3d3v import main

        assert main(["--cells", "4", "--Nv", "8", "--Ns", "6",
                     "--steps", "2", "--n-radial", "4",
                     "--mass-tol", "0.05"]) == 0
        out = capsys.readouterr().out
        assert "bulk-KE" in out and "cells vmapped" in out
        assert "H trace" in out

    def test_sharded_mode_line(self, capsys):
        from boltzfft.cli.taylor_green_3d3v import main

        assert main(["--cells", "4", "--Nv", "8", "--Ns", "6",
                     "--steps", "2", "--n-radial", "4",
                     "--mass-tol", "0.05", "--mesh", "2x2x2"]) == 0
        out = capsys.readouterr().out
        assert "spatial decomposition 2x2x2" in out

    def test_bad_mesh_split(self):
        from boltzfft.cli.taylor_green_3d3v import main

        with pytest.raises(SystemExit):
            main(["--cells", "6", "--Nv", "8", "--Ns", "6",
                  "--mesh", "4x2x1"])
