"""Multi-process (multi-host analog) tests.

Two real OS processes, each owning 2 forced-host CPU devices, joined via
``jax.distributed`` over localhost — the CPU stand-in for two GPU hosts.
Validates that the (ensemble, node) multihost mesh layout produces results
identical to a single-process evaluation.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import boltzfft as bz

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(rank: int, n: int, port: int, out: str):
    env = dict(os.environ)
    env.update(
        PYTHONPATH=str(REPO),  # the workers import this checkout
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_X64="0",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
        JAX_NUM_PROCESSES=str(n),
        JAX_PROCESS_ID=str(rank),
    )
    return subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "multihost_worker.py"), out],
        env=env,
        cwd=REPO,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


class TestMultiProcess:
    def test_two_process_ensemble_matches_single(self, tmp_path):
        n = 2
        port = _free_port()
        out = str(tmp_path / "q")
        procs = [_launch(r, n, port, out) for r in range(n)]
        logs = []
        for p in procs:
            stdout, _ = p.communicate(timeout=600)
            logs.append(stdout)
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

        q0 = np.load(f"{out}.0.npy")
        q1 = np.load(f"{out}.1.npy")
        np.testing.assert_array_equal(q0, q1)  # both ranks see the same gather

        # single-process reference (same config/ensemble, plain vmap path)
        cfg = bz.CollisionConfig(
            nv=8, ns=6, n_radial=4, impl="rfft", dtype="float32"
        )
        coll, pre = bz.make_collision_operator(cfg)
        g = cfg.velocity_grid
        f_one = np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float32)
        scales = np.linspace(0.5, 1.5, 2 * n).astype(np.float32)
        q_ref = np.stack(
            [np.asarray(coll(s * f_one, pre)) for s in scales]
        )
        scale = np.abs(q_ref).max()
        np.testing.assert_allclose(q0, q_ref, atol=1e-6 * scale)


class TestHelpers:
    def test_single_process_initialize_is_noop(self):
        # no coordinator configured -> single-process run, not an error
        assert bz.initialize_distributed() in (False, True)

    def test_no_coordinator_means_single_process(self, monkeypatch):
        # only JAX_COORDINATOR_ADDRESS or an explicit argument starts a
        # multi-process runtime; other cluster variables are ignored
        import jax

        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.setenv("SLURM_JOB_NODELIST", "host[0-1]")
        called = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: called.append(kw))
        if jax.process_count() == 1:
            assert bz.initialize_distributed() is False
            assert called == []

    def test_local_slice(self):
        start, size = bz.process_local_ensemble_slice(8)
        assert (start, size) == (0, 8 // max(1, 1))  # single process: whole

    def test_multihost_mesh_single_process(self):
        mesh = bz.make_multihost_mesh()
        assert bz.NODE_AXIS in mesh.axis_names
        assert bz.ENSEMBLE_AXIS in mesh.axis_names
