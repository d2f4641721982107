"""Space-inhomogeneous 1D×3V kinetic solver: transport + collisions.

Solves ``df/dt + v_x df/dx = Q(f, f) / Kn`` by Strang operator splitting:
conservative advection along a periodic spatial axis (second-order
MUSCL/minmod by default, first-order upwind as the fallback scheme), and
the homogeneous collision operator applied cell-wise (the spatial-cell axis
is exactly the ensemble axis of :mod:`boltzfft.sharding` — cells are
independent during the collision substep and couple only through the
advection stencil).

The reference code is spatially homogeneous by design (SURVEY.md section 0:
"no time-stepping loop, no spatial transport"); this module is the
production story the collision kernel exists to serve.  Device mapping:
cells shard over the mesh; the upwind halo exchange is a nearest-neighbor
``jnp.roll`` that GSPMD lowers to a collective permute, while the collision
substep runs the shard_map/vmap path with zero cross-cell traffic.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .weights import CollisionConfig, Precomp


def _advect_upwind_axis(f, v, dx, dt, axis):
    """First-order periodic upwind along ``axis``; ``v`` pre-broadcast."""
    vp = jnp.maximum(v, 0.0)
    vm = jnp.minimum(v, 0.0)
    c = dt / dx
    # backward difference for v > 0, forward for v < 0
    return f - c * (
        vp * (f - jnp.roll(f, 1, axis=axis))
        + vm * (jnp.roll(f, -1, axis=axis) - f)
    )


def _advect_muscl_axis(f, v, dx, dt, axis):
    """Second-order MUSCL (MC limiter) periodic step along ``axis``;
    ``v`` pre-broadcast.  See :func:`advect_muscl` for the scheme."""
    nu = (dt / dx) * v

    dm = f - jnp.roll(f, 1, axis=axis)  # f_i - f_{i-1}
    dp = jnp.roll(dm, -1, axis=axis)  # f_{i+1} - f_i
    # MC limiter: same-signed slopes take min(2|dm|, 2|dp|, |dm+dp|/2),
    # opposite-signed (extrema) clip to zero
    s = jnp.where(
        dm * dp > 0.0,
        jnp.sign(dm) * jnp.minimum(
            jnp.minimum(2.0 * jnp.abs(dm), 2.0 * jnp.abs(dp)),
            0.5 * jnp.abs(dm + dp),
        ),
        0.0,
    )

    up = f + 0.5 * (1.0 - nu) * s  # left-biased face value (for v > 0)
    dn = jnp.roll(f - 0.5 * (1.0 + nu) * s, -1, axis=axis)  # right-biased
    face = jnp.where(v > 0.0, up, dn)  # value at i + 1/2
    flux = v * face
    return f - (dt / dx) * (flux - jnp.roll(flux, 1, axis=axis))


def advect_upwind(f: jnp.ndarray, v_x: jnp.ndarray, dx: float, dt: float):
    """One periodic first-order upwind step of ``df/dt + v_x df/dx = 0``.

    ``f`` has shape ``(Nx, Nv, Nv, Nv)`` (cells leading, velocity axes
    trailing; the first velocity axis is x).  Conservative by construction:
    cell totals change only by fluxes that cancel in the periodic sum.
    """
    v = v_x.reshape(1, -1, 1, 1).astype(f.dtype)
    return _advect_upwind_axis(f, v, dx, dt, 0)


def advect_muscl(f: jnp.ndarray, v_x: jnp.ndarray, dx: float, dt: float):
    """One periodic second-order MUSCL step of ``df/dt + v_x df/dx = 0``.

    MC-limited (monotonized-central, van Leer 1977) piecewise-linear
    reconstruction with the Lax-Wendroff time-centred face value — the
    standard TVD second-order scheme for linear advection: for
    ``nu = v dt/dx``,

        v > 0:  face_{i+1/2} = f_i     + 0.5 (1 - nu) s_i
        v < 0:  face_{i+1/2} = f_{i+1} - 0.5 (1 + nu) s_{i+1}

    with ``s_i = minmod(2(f_i - f_{i-1}), 2(f_{i+1} - f_i),
    (f_{i+1} - f_{i-1})/2)``.  Conservative (flux differences telescope over
    the periodic ring) and TVD for |nu| <= 1; measured L1 order ~2.0 on
    smooth profiles (the MC limiter clips less at extrema than plain minmod:
    4x smaller errors at the same nx).  Replaces the numerically diffusive
    first-order :func:`advect_upwind` as the production scheme.
    """
    v = v_x.reshape(1, -1, 1, 1).astype(f.dtype)
    return _advect_muscl_axis(f, v, dx, dt, 0)


_ADVECT_SCHEMES = {"upwind": advect_upwind, "muscl": advect_muscl}


def cfl_dt(v_max: float, dx: float, safety: float = 0.9) -> float:
    """Largest stable time step for the advection substep (both schemes
    are stable and TVD for |v| dt/dx <= 1)."""
    return safety * dx / v_max


def make_inhomogeneous_step(
    cfg: CollisionConfig,
    collide_fn: Callable[[jnp.ndarray, Precomp], jnp.ndarray],
    *,
    dx: float,
    dt: float,
    knudsen: float = 1.0,
    vmap_cells: bool = True,
    scheme: str = "muscl",
) -> Callable[[jnp.ndarray, Precomp], jnp.ndarray]:
    """Build one Strang-split step ``f -> f(t + dt)``.

    ``collide_fn(f, pre)`` evaluates Q for a single cell (``vmap_cells=True``,
    the plain operator from :func:`boltzfft.make_collision_operator` with
    ``jit=False``) or for the whole stacked cell axis at once
    (``vmap_cells=False`` — pass the ensemble-sharded operator from
    :func:`boltzfft.make_sharded_collision_operator`, whose shard_map already
    vmaps its local cells).

    Splitting: half-step advection, full-step collision (RK2 midpoint on
    ``Q/Kn``), half-step advection — second-order in the splitting error.
    ``scheme``: ``"muscl"`` (second-order TVD, default) or ``"upwind"``
    (first-order).
    """
    if scheme not in _ADVECT_SCHEMES:
        raise ValueError(
            f"scheme must be one of {sorted(_ADVECT_SCHEMES)}, got {scheme!r}"
        )
    advect = _ADVECT_SCHEMES[scheme]
    # host np constant: embeds in the jitted program as a literal
    v_x = np.asarray(cfg.velocity_grid.v, cfg.real_dtype)
    inv_kn = 1.0 / knudsen

    if vmap_cells:
        q_of = jax.vmap(lambda f, pre: collide_fn(f, pre), in_axes=(0, None))
    else:
        q_of = collide_fn

    def step(f, pre):
        f = advect(f, v_x, dx, 0.5 * dt)
        # RK2 midpoint for the stiff-ish collision substep
        k1 = q_of(f, pre)
        f_mid = f + (0.5 * dt * inv_kn) * k1
        k2 = q_of(f_mid, pre)
        f = f + (dt * inv_kn) * k2
        f = advect(f, v_x, dx, 0.5 * dt)
        return f

    return step


_AXIS_SCHEMES = {"upwind": _advect_upwind_axis, "muscl": _advect_muscl_axis}


def _cell_velocities(cfg: CollisionConfig, ndim: int):
    """Velocity coordinate arrays broadcast for ``ndim`` leading cell axes:
    the i-th spatial direction advects with the i-th velocity coordinate."""
    g = cfg.velocity_grid
    rd = cfg.real_dtype
    vs = (g.vx, g.vy, g.vz)[:ndim]
    lead = (1,) * ndim
    # HOST numpy constants, not device arrays: np constants embed directly
    # in the jitted program as literals.
    return tuple(
        np.asarray(v, rd).reshape(
            lead + tuple(-1 if k == i else 1 for k in range(3))
        )
        for i, v in enumerate(vs)
    )


def _make_step_nd(
    cfg: CollisionConfig,
    collide_fn,
    *,
    deltas: Tuple[float, ...],
    dt: float,
    knudsen: float,
    vmap_cells: bool,
    scheme: str,
) -> Callable[[jnp.ndarray, Precomp], jnp.ndarray]:
    """Shared N-dimensional Strang-split step builder (N = len(deltas)
    leading periodic cell axes): palindromic ``A0(dt/2) .. A_{n-1}(dt/2)
    C(dt) A_{n-1}(dt/2) .. A0(dt/2)`` — second-order splitting error."""
    if scheme not in _AXIS_SCHEMES:
        raise ValueError(
            f"scheme must be one of {sorted(_AXIS_SCHEMES)}, got {scheme!r}"
        )
    advect = _AXIS_SCHEMES[scheme]
    ndim = len(deltas)
    vs = _cell_velocities(cfg, ndim)
    inv_kn = 1.0 / knudsen

    if vmap_cells:
        q_one = jax.vmap(lambda f, pre: collide_fn(f, pre), in_axes=(0, None))
    else:
        q_one = collide_fn

    def q_of(f, pre):
        cells = int(np.prod(f.shape[:ndim]))
        flat = f.reshape((cells,) + f.shape[ndim:])
        return q_one(flat, pre).reshape(f.shape)

    def step(f, pre):
        for ax in range(ndim):
            f = advect(f, vs[ax], deltas[ax], 0.5 * dt, ax)
        # RK2 midpoint for the stiff-ish collision substep
        k1 = q_of(f, pre)
        f_mid = f + (0.5 * dt * inv_kn) * k1
        k2 = q_of(f_mid, pre)
        f = f + (dt * inv_kn) * k2
        for ax in reversed(range(ndim)):
            f = advect(f, vs[ax], deltas[ax], 0.5 * dt, ax)
        return f

    return step


def make_inhomogeneous_step_2d(
    cfg: CollisionConfig,
    collide_fn: Callable[[jnp.ndarray, Precomp], jnp.ndarray],
    *,
    dx: float,
    dy: float,
    dt: float,
    knudsen: float = 1.0,
    vmap_cells: bool = True,
    scheme: str = "muscl",
) -> Callable[[jnp.ndarray, Precomp], jnp.ndarray]:
    """One Strang-split 2D×3V step ``f -> f(t + dt)``.

    ``f`` has shape ``(Cx, Cy, Nvx, Nvy, Nvz)`` — two periodic spatial axes
    leading, the velocity grid trailing — solving
    ``df/dt + v_x df/dx + v_y df/dy = Q(f, f)/Kn``.  Splitting order is the
    palindromic ``Ax(dt/2) Ay(dt/2) C(dt) Ay(dt/2) Ax(dt/2)`` (second-order
    splitting error, like the 1D builder).

    ``collide_fn`` semantics match :func:`make_inhomogeneous_step`: a
    single-cell operator with ``vmap_cells=True`` (vmapped over the
    flattened cell list), or an ensemble-sharded operator taking the whole
    flattened ``(Cx*Cy, Nv, Nv, Nv)`` stack with ``vmap_cells=False`` (the
    cell grid is the sharded ensemble axis — zero cross-cell traffic during
    the collision substep; the advection halo is a nearest-neighbor
    collective permute).
    """
    return _make_step_nd(
        cfg, collide_fn, deltas=(dx, dy), dt=dt, knudsen=knudsen,
        vmap_cells=vmap_cells, scheme=scheme,
    )


def make_inhomogeneous_step_3d(
    cfg: CollisionConfig,
    collide_fn: Callable[[jnp.ndarray, Precomp], jnp.ndarray],
    *,
    dx: float,
    dy: float,
    dz: float,
    dt: float,
    knudsen: float = 1.0,
    vmap_cells: bool = True,
    scheme: str = "muscl",
) -> Callable[[jnp.ndarray, Precomp], jnp.ndarray]:
    """One Strang-split 3D×3V step ``f -> f(t + dt)`` — the full kinetic
    phase space.

    ``f`` has shape ``(Cx, Cy, Cz, Nvx, Nvy, Nvz)`` (three periodic spatial
    axes leading), solving ``df/dt + v·grad_x f = Q(f, f)/Kn`` with the
    palindromic splitting ``Ax Ay Az C Az Ay Ax`` (half-steps on every
    advection; second-order splitting error).  ``collide_fn`` semantics
    match :func:`make_inhomogeneous_step_2d` — with ``vmap_cells=False``
    the flattened ``(Cx*Cy*Cz, ...)`` cell stack goes to an
    ensemble-sharded operator in one call.  For an explicit 3-D domain
    decomposition with shard-local FFTs use :func:`make_sharded_step_3d`.
    """
    return _make_step_nd(
        cfg, collide_fn, deltas=(dx, dy, dz), dt=dt, knudsen=knudsen,
        vmap_cells=vmap_cells, scheme=scheme,
    )


def _halo_exchange(f, axis: int, width: int, axis_name: str):
    """Periodic halo exchange along a shard_map mesh axis.

    Returns ``f`` extended by ``width`` cells from each neighboring shard
    along ``axis`` (ring topology — the global periodic boundary IS the
    ring closure).  Two ``lax.ppermute`` — nearest-neighbor sends between
    devices."""
    n = jax.lax.axis_size(axis_name)
    m = f.shape[axis]
    lo = jax.lax.slice_in_dim(f, 0, width, axis=axis)
    hi = jax.lax.slice_in_dim(f, m - width, m, axis=axis)
    # my trailing cells become my RIGHT neighbor's left halo, and vice versa
    left_halo = jax.lax.ppermute(
        hi, axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    right_halo = jax.lax.ppermute(
        lo, axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    return jnp.concatenate([left_halo, f, right_halo], axis=axis)


def _make_sharded_step_nd(
    cfg: CollisionConfig,
    collide_fn,
    mesh,
    *,
    deltas: Tuple[float, ...],
    dt: float,
    axes: Tuple[Optional[str], ...],
    knudsen: float,
    scheme: str,
    jit: bool,
) -> Callable[[jnp.ndarray, Precomp], jnp.ndarray]:
    """Shared N-dimensional spatially-decomposed Strang step (see
    :func:`make_sharded_step_2d` for the design rationale): MUSCL/upwind
    stencils on halo-extended local blocks (``ppermute`` ring exchange per
    sharded axis), collisions vmapped over the shard's local cells with
    every FFT shard-local by construction."""
    from jax.sharding import PartitionSpec as P

    if scheme not in _AXIS_SCHEMES:
        raise ValueError(
            f"scheme must be one of {sorted(_AXIS_SCHEMES)}, got {scheme!r}"
        )
    advect = _AXIS_SCHEMES[scheme]
    halo_w = 2 if scheme == "muscl" else 1
    ndim = len(deltas)
    vs = _cell_velocities(cfg, ndim)
    inv_kn = 1.0 / knudsen
    q_one = jax.vmap(lambda f, pre: collide_fn(f, pre), in_axes=(0, None))

    def advect_ax(f, v, d, dtt, axis, name):
        if name is None:
            return advect(f, v, d, dtt, axis)
        if f.shape[axis] < halo_w:
            raise ValueError(
                f"local cell block of {f.shape[axis]} along axis {axis} is "
                f"smaller than the {scheme!r} stencil's halo width "
                f"{halo_w}; use more cells or fewer shards on that axis"
            )
        ext = _halo_exchange(f, axis, halo_w, name)
        out = advect(ext, v, d, dtt, axis)
        return jax.lax.slice_in_dim(
            out, halo_w, halo_w + f.shape[axis], axis=axis
        )

    def q_of(f, pre):
        cells = int(np.prod(f.shape[:ndim]))
        flat = f.reshape((cells,) + f.shape[ndim:])
        return q_one(flat, pre).reshape(f.shape)

    def local_step(f, pre):
        for ax in range(ndim):
            f = advect_ax(f, vs[ax], deltas[ax], 0.5 * dt, ax, axes[ax])
        k1 = q_of(f, pre)
        f_mid = f + (0.5 * dt * inv_kn) * k1
        k2 = q_of(f_mid, pre)
        f = f + (dt * inv_kn) * k2
        for ax in reversed(range(ndim)):
            f = advect_ax(f, vs[ax], deltas[ax], 0.5 * dt, ax, axes[ax])
        return f

    f_spec = P(*axes)
    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(f_spec, P()),
        out_specs=f_spec,
        check_vma=False,
    )
    return jax.jit(step) if jit else step


def make_sharded_step_2d(
    cfg: CollisionConfig,
    collide_fn: Callable[[jnp.ndarray, Precomp], jnp.ndarray],
    mesh,
    *,
    dx: float,
    dy: float,
    dt: float,
    x_axis: Optional[str] = None,
    y_axis: Optional[str] = None,
    knudsen: float = 1.0,
    scheme: str = "muscl",
    jit: bool = True,
) -> Callable[[jnp.ndarray, Precomp], jnp.ndarray]:
    """2D×3V Strang step with an explicit spatial domain decomposition.

    The cell grid ``(Cx, Cy)`` shards over the mesh axes ``x_axis`` /
    ``y_axis`` (either may be None = that direction stays local).  Inside
    ``shard_map``: the advection stencils run on halo-extended local blocks
    (:func:`_halo_exchange` — width 2 for MUSCL, 1 for upwind; periodic
    ring closure), and the collision substep is a vmap over the shard's
    local cells — ZERO cross-cell communication.

    Why not plain ``jit`` over sharded inputs?  Functionally that works
    (and ``jnp.roll`` does lower to collective-permutes), but XLA's SPMD
    partitioner will not batch-partition the ``fft`` op: it ALL-GATHERS
    the whole cell batch onto every device around each FFT (measured —
    see ``tests/test_transport.py::TestSpatialSharding``), destroying the
    decomposition's point.  The shard_map formulation keeps every FFT
    shard-local by construction.

    ``collide_fn`` is the single-cell operator (jit=False); f has shape
    ``(Cx, Cy, Nvx, Nvy, Nvz)`` with Cx/Cy divisible by their mesh-axis
    sizes.  Place inputs with :func:`boltzfft.place_cells`.
    """
    return _make_sharded_step_nd(
        cfg, collide_fn, mesh, deltas=(dx, dy), dt=dt,
        axes=(x_axis, y_axis), knudsen=knudsen, scheme=scheme, jit=jit,
    )


def make_sharded_step_3d(
    cfg: CollisionConfig,
    collide_fn: Callable[[jnp.ndarray, Precomp], jnp.ndarray],
    mesh,
    *,
    dx: float,
    dy: float,
    dz: float,
    dt: float,
    x_axis: Optional[str] = None,
    y_axis: Optional[str] = None,
    z_axis: Optional[str] = None,
    knudsen: float = 1.0,
    scheme: str = "muscl",
    jit: bool = True,
) -> Callable[[jnp.ndarray, Precomp], jnp.ndarray]:
    """3D×3V Strang step with an explicit 3-D spatial domain decomposition
    — the full-phase-space production configuration.

    The cell grid ``(Cx, Cy, Cz)`` shards over up to three mesh axes (any
    may be None = local).  Same construction as
    :func:`make_sharded_step_2d` — halo-extended MUSCL stencils via
    ``ppermute`` ring exchanges per sharded direction, collisions vmapped
    over shard-local cells, every velocity FFT shard-local (the velocity
    axes are never decomposed; SURVEY §6) — extended to the third axis.
    ``f`` has shape ``(Cx, Cy, Cz, Nvx, Nvy, Nvz)`` with each cell axis
    divisible by its mesh-axis size.  Place inputs with
    :func:`boltzfft.place_cells` (``z_axis=...``).
    """
    return _make_sharded_step_nd(
        cfg, collide_fn, mesh, deltas=(dx, dy, dz), dt=dt,
        axes=(x_axis, y_axis, z_axis), knudsen=knudsen, scheme=scheme,
        jit=jit,
    )


def sod_initial_condition(
    cfg: CollisionConfig,
    nx: int,
    *,
    rho_left: float = 1.0,
    rho_right: float = 0.125,
    t_left: float = 1.0,
    t_right: float = 0.8,
) -> jnp.ndarray:
    """Sod-type Riemann initial data: two half-domains of Maxwellians with
    different density/temperature, zero bulk velocity.  Returns
    ``(nx, Nv, Nv, Nv)``."""
    from .bkw import maxwellian

    g = cfg.velocity_grid
    rsq = np.asarray(g.r_squared())
    m_left = np.asarray(maxwellian(rsq, density=rho_left, temperature=t_left))
    m_right = np.asarray(maxwellian(rsq, density=rho_right, temperature=t_right))
    f = np.where(
        (np.arange(nx) < nx // 2)[:, None, None, None], m_left[None], m_right[None]
    )
    return jnp.asarray(f, cfg.real_dtype)


def density_profile(f: jnp.ndarray, dv: float) -> jnp.ndarray:
    """Per-cell number density (mass moment)."""
    return jnp.sum(f, axis=(1, 2, 3)) * dv**3
