"""Smoke test of boltzfft on NVIDIA GPUs: the main path end to end at the
reference's own sizes, checked against the reference's printed digits, the
plain CPU reference and the drivers' own physics gates.

    python chip_smoke.py           # one GPU: phases card .. timings
    python chip_smoke.py --four    # four GPUs: the sharded paths only

It refuses to run unless JAX's first device is a GPU, and never falls back
to the CPU (the CPU computes only the plain reference Q).  Every phase runs;
a failed phase makes the exit code nonzero and suppresses the result line.
The last line of a passing run is one JSON object naming the device as JAX
reports it.  One process drives the card(s).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# The reference's FFTW logs (BASELINE.md): BKW L-inf at t=6.5, Maxwell
# molecules, Ns=12, GL points = Nv.
BKW_LINF_32 = "4.2512e-05"  # printed digits, Nv=32
BKW_LINF_64 = 3.0686e-12  # Nv=64, held to 1%

# float64 on the card against float64 on the CPU: same algorithm, another
# summation order and another FFT library, so a few ulps of max|Q|.
F64_PARITY_TOL = 1e-12
# float32 pipelines against the card's own float64 Q (relative to max|Q|):
# float32 roundoff through three FFT passes and a 384-node sum is ~1e-6.
F32_TOL = 1e-5
# Sharded against one-card float64 Q: the node psum reassociates the sum.
SHARD_F64_TOL = 1e-13
# maxwell_bkw --Nv 32 --Ns 12 --steps 8 (RK4, dt 0.125, t 5.5 -> 6.5),
# float64 on the CPU: relaxation L-inf against the analytic BKW f(6.5) and
# the mass drift (the gain quadrature's mass-moment error).  The GPU must
# reproduce both to the digits the driver prints (6 and 4).
RELAX_LINF_32 = 7.38612e-05
RELAX_DRIFT_32 = 2.048e-05


class PhaseFailure(Exception):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def rel_linf(a, b) -> float:
    """max|a - b| / max|b| on the host, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }})


def run_phases(phases, ctx) -> list:
    """Run every ``(name, fn)`` phase; return the names of those that
    failed.  A failure is reported with its traceback and the run goes on."""
    failed = []
    for name, fn in phases:
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:  # a phase boundary: record, report, go on
            traceback.print_exc()
            failed.append(name)
            print(f"== phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        else:
            print(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    return failed


def finish(failed: list, devices) -> int:
    """Exit code of the run; prints the result line only when nothing
    failed."""
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(result_line(devices))
    return 0


# --------------------------------------------------------------------------
# helpers that touch the device
# --------------------------------------------------------------------------


def _bkw_eval(cfg, t: float = 6.5):
    """(Q on the default device, error norms vs the analytic BKW df/dt)."""
    import jax.numpy as jnp

    import boltzfft as bz

    collide, pre = bz.make_collision_operator(cfg)
    g = cfg.velocity_grid
    f = jnp.asarray(np.asarray(bz.bkw_f(g.r_squared(), t)), cfg.real_dtype)
    q = collide(f, pre)
    err = bz.error_norms_device(
        q, np.asarray(bz.bkw_dfdt(g.r_squared(), t)),
        cell_volume=g.cell_volume,
    )
    return q, err


def _run_driver(module: str, argv: list) -> str:
    """Run a CLI driver's ``main(argv)`` in this process; return its output.
    Raises PhaseFailure on a nonzero return code."""
    import importlib

    main = importlib.import_module(f"boltzfft.cli.{module}").main
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            sys.__stdout__.write(s)
            buf.write(s)
            return len(s)

        def flush(self):
            sys.__stdout__.flush()

    print(f"-- {module} {' '.join(argv)}", flush=True)
    with contextlib.redirect_stdout(Tee()):
        rc = main(argv)
    check(rc == 0, f"{module} {' '.join(argv)} returned {rc}")
    return buf.getvalue()


def _after(out: str, label: str) -> float:
    return float(out.split(label)[1].split()[0].rstrip(","))


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------


def phase_card(ctx):
    import jax

    from bench import parse_card_line

    raw = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    for line in raw.splitlines():
        if line.strip():
            print(line.strip())
    name, power = parse_card_line(raw)
    ctx["card"] = f"{name}, {power}"
    dev = jax.devices()[0]
    try:
        from boltzfft import _native  # noqa: F401

        quad = "native library (boltzfft/_lib)"
    except ImportError:
        quad = "NumPy leggauss"
    print(f"jax {jax.__version__}; device_kind {dev.device_kind!r}; "
          f"{len(jax.devices())} device(s); Gauss-Legendre from {quad}")


def phase_bkw_f64(ctx):
    import boltzfft as bz

    bad = []
    for impl in ("rfft", "c2c"):
        cfg = bz.CollisionConfig(nv=32, ns=12, impl=impl, dtype="float64")
        q, err = _bkw_eval(cfg)
        ctx[f"q32_{impl}"] = q
        print(f"BKW 32^3/Ns=12 f64 {impl}: L1 {err['L1']:.4e} "
              f"L2 {err['L2']:.4e} Linf {err['Linf']:.4e} "
              f"(reference Linf {BKW_LINF_32})")
        if f"{err['Linf']:.4e}" != BKW_LINF_32:
            bad.append(f"{impl} 32^3 Linf {err['Linf']:.4e}")
    cfg = bz.CollisionConfig(nv=64, ns=12, impl="rfft", dtype="float64")
    q, err = _bkw_eval(cfg)
    ctx["q64_rfft"] = q
    dev = err["Linf"] / BKW_LINF_64 - 1.0
    print(f"BKW 64^3/Ns=12 f64 rfft: L1 {err['L1']:.4e} L2 {err['L2']:.4e} "
          f"Linf {err['Linf']:.4e} (reference {BKW_LINF_64:.4e}, "
          f"{100 * dev:+.3f}%)")
    if abs(dev) > 0.01:
        bad.append(f"64^3 Linf {err['Linf']:.4e} off by >1%")
    check(not bad, "; ".join(bad))


def phase_plain_reference(ctx):
    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    sys.path.insert(0, str(REPO / "tests"))
    from reference_direct import direct_collision

    cfg_c = bz.CollisionConfig(nv=32, ns=12, impl="c2c", dtype="float64")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        collide, pre = bz.make_collision_operator(cfg_c)
        g = cfg_c.velocity_grid
        f = jnp.asarray(np.asarray(bz.bkw_f(g.r_squared(), 6.5)), jnp.float64)
        q_cpu = np.asarray(collide(f, pre))
    print(f"CPU f64 c2c Q at 32^3 on {cpu}")
    q_dft, _ = _bkw_eval(
        bz.CollisionConfig(nv=32, ns=12, impl="dft", dtype="float64"))
    ctx["q32_dft"] = q_dft
    for impl in ("rfft", "c2c", "dft"):
        r = rel_linf(ctx[f"q32_{impl}"], q_cpu)
        print(f"GPU f64 {impl} vs CPU f64 c2c at 32^3: max rel {r:.3e} "
              f"(tol {F64_PARITY_TOL:.0e})")
        check(r <= F64_PARITY_TOL, f"{impl} GPU/CPU parity {r:.3e}")

    # independent NumPy direct sum (no shared code) on a small grid
    for impl in ("rfft", "c2c", "dft"):
        cfg = bz.CollisionConfig(nv=12, ns=12, impl=impl, dtype="float64")
        g = cfg.velocity_grid
        f12 = np.asarray(bz.bkw_f(g.r_squared(), 6.5))
        gl = bz.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
        sph = bz.spherical_design(cfg.ns)
        q_direct = direct_collision(
            f12, gl.nodes, gl.weights, sph.points, sph.weights,
            cfg.domain_length, cfg.gamma, cfg.b_gamma,
        )
        q, _ = _bkw_eval(cfg)
        r = rel_linf(q, q_direct)
        print(f"GPU f64 {impl} vs NumPy direct sum at 12^3: max rel {r:.3e}")
        check(r <= F64_PARITY_TOL, f"{impl} direct-sum parity {r:.3e}")


def phase_f32_tier(ctx):
    import boltzfft as bz

    default_prec = bz.CollisionConfig().dft_precision
    for nv in (32, 64):
        q64 = ctx.get(f"q{nv}_rfft")
        check(q64 is not None, f"no f64 Q at {nv}^3 (phase bkw_f64 failed)")
        for impl, prec in (("rfft", None), ("dft", "highest"),
                           ("dft", "default")):
            kw = {"dft_precision": prec} if prec else {}
            cfg = bz.CollisionConfig(nv=nv, ns=12, impl=impl,
                                     dtype="float32", **kw)
            q, err = _bkw_eval(cfg)
            r = rel_linf(q, q64)
            gated = impl == "rfft" or prec == default_prec
            label = impl + (f"[{prec}]" if prec else "")
            print(f"f32 {label} at {nv}^3 vs GPU f64: max rel {r:.3e}, "
                  f"BKW Linf {err['Linf']:.4e}"
                  + (f" (gate {F32_TOL:.0e})" if gated else " (not gated)"))
            if gated:
                check(r <= F32_TOL, f"f32 {label} {nv}^3 rel {r:.3e}")


def phase_drivers(ctx):
    out = _run_driver("maxwell_bkw", ["--Nv", "32", "--Ns", "12",
                                      "--steps", "8"])
    linf = _after(out.split("Relaxation errors")[1], "Linf error:")
    drift = _after(out, "mass drift:")
    print(f"relaxation Linf {linf:.6g} (CPU f64 {RELAX_LINF_32:.6g}), "
          f"mass drift {drift:.3e} (CPU f64 {RELAX_DRIFT_32:.3e})")
    check(f"{linf:.6g}" == f"{RELAX_LINF_32:.6g}",
          f"relaxation Linf {linf:.6g} != {RELAX_LINF_32:.6g}")
    check(f"{drift:.3e}" == f"{RELAX_DRIFT_32:.3e}",
          f"relaxation mass drift {drift:.3e} != {RELAX_DRIFT_32:.3e}")
    _run_driver("fft_benchmark", ["--Nv", "32", "--Ns", "12"])
    _run_driver("ensemble_bkw", ["--ensemble", "64", "--Nv", "32",
                                 "--steps", "5"])
    _run_driver("sod_1d3v", ["--Nv", "32", "--nx", "64", "--steps", "10"])
    _run_driver("taylor_green_2d3v", ["--cells", "16", "--Nv", "32",
                                      "--steps", "5", "--conserve"])
    _run_driver("taylor_green_3d3v", ["--cells", "8", "--Nv", "16",
                                      "--steps", "3"])


def phase_ds(ctx):
    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import ds
    from boltzfft.health import selfcheck_ds

    # The oz engine at 16^3 is thousands of small bf16 matrix products; with
    # XLA's per-product GEMM autotuning the H100 compile ran past 15 min, and
    # without it takes about 2 min.
    r = selfcheck_ds(nv=16, compiler_options={"xla_gpu_autotune_level": 0})
    print(f"ds selfcheck (oz vs vpu, 16^3): rel {r['rel_linf']:.3e} "
          f"(tol {r['rel_tol']:.0e})")
    check(r["ok"], f"oz engine off vpu by {r['rel_linf']:.3e}")

    cfg = bz.CollisionConfig(nv=32, ns=12, impl="c2c", dtype="float32")
    collide, pre = bz.make_ds_collision_operator(cfg, contract="vpu",
                                                 jit=False)
    g = cfg.velocity_grid
    f = ds.from_f64(np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float64))
    qex = ds.from_f64(np.asarray(bz.bkw_dfdt(g.r_squared(), 6.5), np.float64))

    @jax.jit
    def err(x, p, e):
        d = ds.sub(collide(x, p), e)
        return jnp.max(jnp.abs(d.hi + d.lo))

    linf = float(err(f, pre, qex))
    print(f"BKW 32^3/Ns=12 ds-vpu: Linf {linf:.4e} (reference {BKW_LINF_32})")
    check(f"{linf:.4e}" == BKW_LINF_32, f"ds-vpu Linf {linf:.4e}")


def phase_timings(ctx):
    import bench
    import boltzfft as bz

    card = ctx.get("card", "card unknown")
    rows = []
    for nv, k in ((32, 16), (64, 4)):
        for impl, dtype in (("rfft", "float64"), ("rfft", "float32"),
                            ("dft", "float32")):
            cfg = bz.CollisionConfig(nv=nv, ns=12, impl=impl, dtype=dtype)
            rows.append((f"{impl} {dtype[5:]}-bit {nv}^3",
                         bench.measure(cfg, k=k)))
        rows.append((f"ds-vpu {nv}^3",
                     bench.measure_ds(nv, 12, "vpu", k=1, trials=3)))
    for label, r in rows:
        print(f"timing {label:18s}: median {r['s_per_eval_median']:.4e} "
              f"s/eval (q1 {r['s_per_eval_q1']:.4e}, q3 "
              f"{r['s_per_eval_q3']:.4e}, {r['trials']} trials), BKW Linf "
              f"{r['bkw_linf']:.4e} [{card}]")


# --------------------------------------------------------------------------
# four-card phases
# --------------------------------------------------------------------------


def phase_node_sharded(ctx):
    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    cfg = bz.CollisionConfig(nv=64, ns=12, impl="rfft", dtype="float64")
    g = cfg.velocity_grid
    f = np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float64)
    fs = np.stack([f, 1.01 * f])
    collide, pre = bz.make_collision_operator(cfg)
    q1 = [np.asarray(collide(jnp.asarray(x), pre)) for x in fs]

    for axes in ([(bz.NODE_AXIS, 4)],
                 [(bz.ENSEMBLE_AXIS, 2), (bz.NODE_AXIS, 2)]):
        mesh = bz.make_mesh(axes)
        ens = len(axes) == 2
        coll_sh, pre_sh = bz.make_sharded_collision_operator(
            cfg, mesh, node_axis=bz.NODE_AXIS,
            ensemble_axis=bz.ENSEMBLE_AXIS if ens else None,
        )
        pre_sh = bz.place(pre_sh, mesh)
        x = jnp.asarray(fs if ens else f)
        q = coll_sh(x, pre_sh)
        n_dev = len(q.sharding.device_set)
        q = np.asarray(q)
        ref = np.stack(q1) if ens else q1[0]
        r = rel_linf(q, ref)
        print(f"node-sharded 64^3 f64 rfft on {dict(axes)} ({n_dev} devices)"
              f" vs one card: max rel {r:.3e}, bitwise "
              f"{bool(np.array_equal(q, ref))} (tol {SHARD_F64_TOL:.0e})")
        check(n_dev == 4, f"result on {n_dev} devices, expected 4")
        check(r <= SHARD_F64_TOL, f"sharded {dict(axes)} rel {r:.3e}")


def _spatial_pair(ndim: int, cells: int, nv: int, steps: int, mesh_dims):
    """(unsharded, sharded) Taylor-Green states after ``steps`` Strang
    steps, built the way the CLI driver builds them."""
    import jax

    import boltzfft as bz
    from boltzfft import transport

    if ndim == 2:
        from boltzfft.cli.taylor_green_2d3v import taylor_green_f0 as init
    else:
        from boltzfft.cli.taylor_green_3d3v import taylor_green_f0_3d as init
    cfg = bz.CollisionConfig(nv=nv, ns=12, impl="rfft", dtype="float64")
    g = cfg.velocity_grid
    d = 1.0 / cells
    dt = transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), d)
    collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
    f0 = init(cfg, cells, u0=0.8, temperature=3.0)
    names = ("cx", "cy", "cz")[:ndim]
    spacing = dict(zip(("dx", "dy", "dz"), (d,) * ndim))
    make_local = (transport.make_inhomogeneous_step_2d if ndim == 2
                  else transport.make_inhomogeneous_step_3d)
    make_sharded = (transport.make_sharded_step_2d if ndim == 2
                    else transport.make_sharded_step_3d)
    local = make_local(cfg, collide_fn, dt=dt, knudsen=0.2, **spacing)
    mesh = bz.make_mesh(list(zip(names, mesh_dims)))
    axes = dict(zip(("x_axis", "y_axis", "z_axis"), names))
    sharded = make_sharded(cfg, collide_fn, mesh, dt=dt, knudsen=0.2,
                           **spacing, **axes)

    def run(step, f):
        return jax.jit(lambda x, p: jax.lax.fori_loop(
            0, steps, lambda i, y: step(y, p), x))(f, pre)

    a = np.asarray(run(local, f0))
    fb = run(sharded, bz.place_cells(f0, mesh, **axes))
    return a, np.asarray(fb), len(fb.sharding.device_set)


def phase_spatial_sharded(ctx):
    for ndim, cells, mesh_dims, module, flag in (
        (2, 16, (2, 2), "taylor_green_2d3v", "2x2"),
        (3, 8, (2, 2, 1), "taylor_green_3d3v", "2x2x1"),
    ):
        _run_driver(module, ["--mesh", flag, "--cells", str(cells),
                             "--Nv", "16", "--steps", "5"])
        a, b, n_dev = _spatial_pair(ndim, cells, 16, 5, mesh_dims)
        r = rel_linf(b, a)
        print(f"{ndim}-D Taylor-Green {cells}^{ndim} cells x 16^3, 5 steps, "
              f"mesh {flag} ({n_dev} devices) vs unsharded: max rel {r:.3e},"
              f" bitwise {bool(np.array_equal(a, b))} (tol 1e-12)")
        check(n_dev == 4, f"state on {n_dev} devices, expected 4")
        check(r <= 1e-12, f"{ndim}-D sharded state rel {r:.3e}")


def phase_ds_sharded(ctx):
    import boltzfft as bz
    from boltzfft import ds

    cfg = bz.CollisionConfig(nv=32, ns=12, impl="c2c", dtype="float32")
    f = ds.from_f64(np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5),
                               np.float64))
    coll, pre = bz.make_ds_collision_operator(cfg, contract="vpu")
    q1 = ds.to_f64(coll(f, pre))
    mesh = bz.make_mesh([(bz.NODE_AXIS, 4)])
    coll_sh, pre_sh = bz.make_sharded_ds_collision_operator(
        cfg, mesh, contract="vpu")
    q4 = ds.to_f64(coll_sh(f, bz.place_ds(pre_sh, mesh)))
    r = rel_linf(q4, q1)
    print(f"radial-sharded ds-vpu 32^3 on 4 devices vs one card: max rel "
          f"{r:.3e} (tol 1e-13: the compensated fold reassociates)")
    check(r <= 1e-13, f"ds sharded rel {r:.3e}")


ONE_CARD = (
    ("card", phase_card),
    ("bkw_f64", phase_bkw_f64),
    ("plain_reference", phase_plain_reference),
    ("f32_tier", phase_f32_tier),
    ("drivers", phase_drivers),
    ("ds", phase_ds),
    ("timings", phase_timings),
)
FOUR_CARD = (
    ("card", phase_card),
    ("node_sharded", phase_node_sharded),
    ("spatial_sharded", phase_spatial_sharded),
    ("ds_sharded", phase_ds_sharded),
)


def select_phases(four: bool):
    return FOUR_CARD if four else ONE_CARD


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded paths, on four GPUs")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's first device is "
              f"{devices[0].platform!r}. Nothing was run.", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke.py {'--four ' if args.four else ''}needs {need} "
              f"GPUs; JAX sees {len(devices)}.", file=sys.stderr)
        return 2
    if not (REPO / "boltzfft" / "__init__.py").exists():
        print("chip_smoke.py must run from a boltzfft checkout (no "
              f"boltzfft/ beside {Path(__file__).name}).", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    jax.config.update("jax_enable_x64", True)
    import boltzfft as bz

    bz.enable_compilation_cache()
    failed = run_phases(select_phases(args.four), {})
    return finish(failed, jax.devices())


if __name__ == "__main__":
    sys.exit(main())
