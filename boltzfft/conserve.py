"""Conservative moment projection for the collision operator.

The continuous collision operator conserves mass, momentum and energy
exactly (``∫ ψ Q dv = 0`` for the collision invariants
``ψ ∈ {1, v, |v|²}``); the discrete spectral operator does not — the
gain quadrature's moment error on anisotropic states, the f32/bf16
arithmetic tiers, and plain accumulation leave a small per-eval moment
defect that drifts linearly over long production runs (measured: the
round-5 200-step Taylor-Green discriminators in
``Results/taylor_green_r5.txt`` — ~2e-5 relative mass per step across
impls and Ns).  The reference has no remedy (its drivers evaluate Q once
and never step).

Standard fix from the spectral-Boltzmann literature (the conservation
routine of Gamba & Tharkabhushanam's solvers): project each computed Q
onto the subspace with vanishing invariant moments,

    Q' = Q − Σ_k c_k φ_k,   φ_k = ψ_k(v) · w(v),

with the 5 coefficients ``c`` solving the precomputed 5×5 Gram system
``G c = m(Q)``, ``G_jk = ∫ ψ_j φ_k dv``, ``m_j(Q) = ∫ ψ_j Q dv``.  The
localized weight ``w`` (a Maxwellian at the domain temperature scale)
keeps the correction in the thermal core where Q lives; the projection
is exact (moments of Q' vanish to arithmetic roundoff), linear, and
costs 5 reductions + one fused broadcast per eval — negligible against
the transforms.  It perturbs Q pointwise by O(the moment defect), i.e.
below the method error on resolved grids (asserted by the test suite).

Formulation: everything is one einsum-like contraction over
precomputed host-f64 basis arrays; no data-dependent control flow.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp
import numpy as np

from .weights import CollisionConfig


class ConservePrecomp(NamedTuple):
    """Projection tables: ``psi`` (5, Nx, Ny, Nz) invariant moments ×
    cell volume (so ``m = psi · Q`` sums are integrals), and ``corr``
    (5, Nx, Ny, Nz) = ``G⁻¹``-combined correction fields such that
    ``Q' = Q − Σ_j m_j corr_j``."""

    psi: jnp.ndarray
    corr: jnp.ndarray


def build_conserve_precomp(
    cfg: CollisionConfig, temperature: float = 1.0
) -> ConservePrecomp:
    """Host-f64 basis/Gram build for :func:`project`.

    ``temperature`` sets the Gaussian weight's scale; any positive value
    works (the projection is exact regardless — the weight only shapes
    WHERE the correction mass lives).  The default 1.0 matches the
    BKW/driver temperature scale.
    """
    g = cfg.velocity_grid
    vx = np.asarray(g.vx, np.float64)
    vy = np.asarray(g.vy, np.float64)
    vz = np.asarray(g.vz, np.float64)
    X = vx[:, None, None]
    Y = vy[None, :, None]
    Z = vz[None, None, :]
    r2 = X**2 + Y**2 + Z**2
    one = np.ones_like(r2)
    # collision invariants on the grid
    psi = np.stack([one, X * one, Y * one, Z * one, r2])  # (5, Nx, Ny, Nz)
    w = np.exp(-r2 / (2.0 * temperature))
    phi = psi * w  # weighted correction basis
    dv3 = float(g.cell_volume)
    gram = np.einsum("aijk,bijk->ab", psi, phi) * dv3  # (5, 5)
    ginv = np.linalg.inv(gram)
    # corr_j = sum_k ginv[k, j] phi_k  so that  Q' = Q - m_j corr_j
    corr = np.tensordot(ginv.T, phi, axes=(1, 0))  # (5, Nx, Ny, Nz)
    rd = cfg.real_dtype
    return ConservePrecomp(
        psi=jnp.asarray(psi * dv3, rd), corr=jnp.asarray(corr, rd)
    )


def project(q: jnp.ndarray, cp: ConservePrecomp) -> jnp.ndarray:
    """Remove the invariant-moment defect of ``q`` (leading axes, e.g. a
    cell batch, broadcast): moments of the result vanish to roundoff."""
    m = jnp.einsum("aijk,...ijk->...a", cp.psi, q)
    return q - jnp.einsum("...a,aijk->...ijk", m, cp.corr)


def conservative(
    collide_fn: Callable, cp: ConservePrecomp
) -> Callable:
    """Wrap a collision operator so every Q it returns is projected:
    ``conservative(collide, cp)(f, pre) = project(collide(f, pre), cp)``.
    Composes with vmap/shard_map/the transport steps unchanged."""

    def collide_conservative(f, pre):
        return project(collide_fn(f, pre), cp)

    return collide_conservative
