"""Collision-operator benchmark on one GPU: seconds per evaluation, each row
with the BKW error of the program it timed.

Rows, all at the reference's flagship quadrature (Ns=12, GL points = Nv):

* ``rfft`` in float32 and float64 at 32^3 and 64^3 (the staged cuFFT path);
* ``ds`` (compensated double-single, engine named in the row) at 32^3 and
  64^3 — the reference's f64 digits from float32 pairs;
* a batch of 8 independent relaxations at 32^3 (vmapped rfft, f32);
* the 2-D x 3-V Taylor-Green solver (16x16 cells x 16^3 velocities, f32).

Methodology: ``k`` collision evals chained as an Euler relaxation inside one
jit (each step's input depends on the previous output) plus one accuracy
eval, timed around ``block_until_ready``; the row reports the median and the
quartiles of seconds per eval over ``trials`` repeats.  The reference's
best checked-in number at 32^3 is 1.9085e-02 s per eval on a 128-thread
Perlmutter CPU node (``Results/maxwell_bkw_fftw_atomics.txt:167``, f64).

Refuses to run without a GPU.  Any failed row fails the run.  Prints one
JSON line naming the device, its kind and the card's power limit.

    python bench.py
"""

from __future__ import annotations

import json
import subprocess
import time
from functools import partial

import numpy as np

BASELINE_S_PER_EVAL = {32: 1.9085e-02, 64: 4.9432e-01}  # reference, f64 CPU node


def card_info() -> tuple[str, str]:
    """``(name, power_limit)`` of GPU 0 as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return parse_card_line(out)


def parse_card_line(out: str) -> tuple[str, str]:
    """Parse the first line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``: ``"NVIDIA H100 80GB HBM3, 700.00 W"``."""
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("nvidia-smi printed no GPU")
    name, sep, power = lines[0].rpartition(",")
    if not sep or not name.strip() or not power.strip():
        raise ValueError(f"unexpected nvidia-smi line: {lines[0]!r}")
    return name.strip(), power.strip()


def _quartiles(per_eval: list) -> dict:
    q1, med, q3 = np.percentile(np.asarray(per_eval), [25, 50, 75])
    return {
        "s_per_eval_median": float(med),
        "s_per_eval_q1": float(q1),
        "s_per_eval_q3": float(q3),
        "trials": len(per_eval),
    }


def _time_chain(chain, args, k: int, trials: int):
    """Compile + warm ``chain(*args)``, then time ``trials`` runs; returns
    (seconds per eval over the k+1 evals of each run, last output)."""
    import jax

    out = jax.block_until_ready(chain(*args))
    per_eval = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = jax.block_until_ready(chain(*args))
        per_eval.append((time.perf_counter() - t0) / (k + 1))
    return per_eval, out


def measure(cfg, k: int = 16, trials: int = 5) -> dict:
    """Seconds per eval of the staged operator ``cfg`` on BKW data, with the
    BKW L-inf of the same program."""
    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    pre = bz.build_precomp(cfg)
    g = cfg.velocity_grid
    f0 = jnp.asarray(np.asarray(bz.bkw_f(g.r_squared(), 6.5)), cfg.real_dtype)
    dq = jnp.asarray(np.asarray(bz.bkw_dfdt(g.r_squared(), 6.5)),
                     cfg.real_dtype)

    @partial(jax.jit, static_argnums=3)
    def chain(f, p, d, steps):
        body = lambda i, x: x + 1e-3 * bz.collide(cfg, p, x)
        out = jax.lax.fori_loop(0, steps, body, f)
        err = jnp.max(jnp.abs(bz.collide(cfg, p, f) - d))
        return jnp.sum(out), err

    per_eval, (_, err) = _time_chain(chain, (f0, pre, dq, k), k, trials)
    return {
        "impl": cfg.impl, "dtype": cfg.dtype,
        "grid": list(cfg.grid_shape), "ns": cfg.ns,
        **_quartiles(per_eval), "bkw_linf": float(err),
    }


def measure_ds(nv: int, ns: int, engine: str, k: int = 2,
               trials: int = 3) -> dict:
    """Seconds per eval of the compensated pipeline with ``engine``, and its
    BKW L-inf (reduced in ds arithmetic on the device)."""
    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import ds
    from boltzfft.ds_operator import build_ds_precomp, collide_ds

    cfg = bz.CollisionConfig(nv=nv, ns=ns, impl="c2c", dtype="float32")
    pre = build_ds_precomp(cfg, node_mats=engine == "oz")
    g = cfg.velocity_grid
    f = ds.from_f64(np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float64))
    dq = ds.from_f64(np.asarray(bz.bkw_dfdt(g.r_squared(), 6.5), np.float64))

    @jax.jit
    def chain(p, x, d):
        def body(i, s):
            q = collide_ds(cfg, p, s, contract=engine)
            return ds.add(s, ds.mul_f(q, 1e-3))

        out = jax.lax.fori_loop(0, k, body, x)
        e = ds.sub(collide_ds(cfg, p, x, contract=engine), d)
        return jnp.sum(out.hi), jnp.max(jnp.abs(e.hi + e.lo))

    per_eval, (_, err) = _time_chain(chain, (pre, f, dq), k, trials)
    return {
        "impl": f"ds-{engine}", "grid": [nv] * 3, "ns": ns,
        **_quartiles(per_eval), "bkw_linf": float(err),
    }


def measure_batch(nv: int, ns: int, e: int = 8, k: int = 16,
                  trials: int = 5) -> dict:
    """Aggregate throughput of ``e`` independent chained relaxations (vmapped
    rfft, f32) — the reference's own trials are independent evals of one
    input (``maxwell_bkw_fftw.cpp:133-140``)."""
    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    cfg = bz.CollisionConfig(nv=nv, ns=ns, impl="rfft", dtype="float32")
    pre = bz.build_precomp(cfg)
    g = cfg.velocity_grid
    f0 = np.asarray(bz.bkw_f(g.r_squared(), 6.5), np.float64)
    batch = jnp.asarray(np.stack([f0 * (1 + 0.01 * i) for i in range(e)]),
                        jnp.float32)
    dq = jnp.asarray(np.asarray(bz.bkw_dfdt(g.r_squared(), 6.5)), jnp.float32)
    vcoll = jax.vmap(lambda x: bz.collide(cfg, pre, x))

    @jax.jit
    def chain(x, d):
        out = jax.lax.fori_loop(0, k, lambda i, s: s + 1e-3 * vcoll(s), x)
        err = jnp.max(jnp.abs(bz.collide(cfg, pre, x[0]) - d))
        return jnp.sum(out), err

    per_eval, (_, err) = _time_chain(chain, (batch, dq), k, trials)
    # each timed run does e*k + 1 evals; _time_chain divided by k + 1
    per_eval = [t * (k + 1) / (e * k + 1) for t in per_eval]
    return {
        "impl": "rfft, vmapped", "dtype": "float32", "grid": [nv] * 3,
        "ns": ns, "batch": e, **_quartiles(per_eval),
        "bkw_linf": float(err),
    }


def measure_tg2d(cells: int = 16, nv: int = 16, steps: int = 10,
                 trials: int = 3) -> dict:
    """Seconds per collision eval of the 2-D x 3-V Taylor-Green solver
    (cells vmapped, every Strang step chained in one jitted loop; two
    collision evals per cell per step), with its mass drift."""
    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import transport
    from boltzfft.cli.taylor_green_2d3v import taylor_green_f0

    cfg = bz.CollisionConfig(nv=nv, ns=12, impl="rfft", dtype="float32")
    g = cfg.velocity_grid
    d = 1.0 / cells
    dt = transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), d)
    collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
    step = transport.make_inhomogeneous_step_2d(
        cfg, collide_fn, dx=d, dy=d, dt=dt, knudsen=0.2
    )
    f0 = taylor_green_f0(cfg, cells, u0=0.8, temperature=3.0)

    @jax.jit
    def run(f, p):
        out = jax.lax.fori_loop(0, steps, lambda i, x: step(x, p), f)
        return jnp.sum(out), jnp.sum(f)

    evals = steps * cells * cells * 2
    per_run, (m1, m0) = _time_chain(run, (f0, pre), 0, trials)
    return {
        "impl": "rfft, cells vmapped", "dtype": "float32",
        "config": f"{cells}x{cells} cells x {nv}^3, {steps} Strang steps",
        **_quartiles([t / evals for t in per_run]),
        "mass_drift": float(abs(m1 - m0) / m0),
    }


def main() -> int:
    import jax

    jax.config.update("jax_enable_x64", True)
    import boltzfft as bz

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    name, power = card_info()
    bz.enable_compilation_cache()
    engine = bz.pipeline_choice().ds_contract

    rows = {}
    for nv, k in ((32, 32), (64, 8)):
        for dtype in ("float32", "float64"):
            cfg = bz.CollisionConfig(nv=nv, ns=12, impl="rfft", dtype=dtype)
            rows[f"rfft_nv{nv}_ns12_{dtype[5:]}"] = measure(cfg, k=k)
        rows[f"ds_nv{nv}_ns12"] = measure_ds(nv, 12, engine)
    rows["rfft_nv32_ns12_batch8"] = measure_batch(32, 12)
    rows["tg2d_16c_nv16"] = measure_tg2d()

    head = rows["rfft_nv32_ns12_32"]
    result = {
        "metric": "collision_evals_per_sec_nv32_ns12_f32",
        "value": 1.0 / head["s_per_eval_median"],
        "unit": "evals/s",
        "vs_baseline": BASELINE_S_PER_EVAL[32] / head["s_per_eval_median"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": name,
                   "power_limit": power},
        "rows": rows,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
