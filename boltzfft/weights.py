"""Configuration and one-time precompute for the collision operator.

The reference rebuilds the transform weights on the fly inside its hot loop
(``FFTWBoltzmannOperator.cpp:204-222, 252-273``) because materializing the full
``alpha1`` table costs ``B * N^3`` complex words (the abandoned precompute path
at ``FFTWBoltzmannOperator.cpp:72-143``).  This rebuild exploits that the
phase is *separable*:

    alpha1(r, s, l) = exp(-i c rho_r (l . sigma_s))
                    = ax(b, lx) * ay(b, ly) * az(b, lz)

so per-node phases are outer products of three ``(B, N)`` complex vectors —
tiny.  The kernel magnitude ``beta1(r, l) = 4 pi b_gamma sincc(pi rho_r |l| / (2L))``
is recomputed per chunk from ``|l|`` (a single (N,N,N) table), and the loss
multiplier ``beta2`` (grid-sized, node-independent) is fully precomputed.

Everything static (shapes, domain constants, dtype, chunking) lives in
``CollisionConfig``; everything traced lives in the ``Precomp`` pytree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from . import grid as _grid
from . import modes as _modes
from . import quadrature as _quad


# Working-set budget for node chunking when the device reports no memory
# limit (the CPU backend).
_FALLBACK_HBM_BUDGET = 6 << 30
# Share of the device's reported memory the chunked working set may take; the
# rest stays free for XLA's FFT workspace and slack.
_HBM_BUDGET_FRACTION = 6 / 16


def _device_hbm_budget() -> int:
    """Working-set byte budget for node chunking, from the attached device.

    A fixed share of the device's reported memory limit, so larger and smaller
    parts chunk proportionally.  Falls back to a fixed budget when the backend
    reports nothing (CPU).
    """
    import jax

    stats = jax.local_devices()[0].memory_stats()
    limit = stats.get("bytes_limit", 0) if stats else 0
    if limit > 0:
        return int(limit * _HBM_BUDGET_FRACTION)
    return _FALLBACK_HBM_BUDGET


@dataclasses.dataclass(frozen=True)
class CollisionConfig:
    """Static configuration of a collision operator (hashable; jit-safe).

    Physics parameters follow the reference constructor
    (``FFTWBoltzmannOperator.hpp:30-36``): VHS kernel
    ``B(|g|, cos th) = b_gamma * |g|^gamma``; Maxwell molecules are
    ``gamma=0, b_gamma=1/(4 pi)`` (``maxwell_bkw_fftw.cpp:54-55``).
    """

    nv: int = 32  # velocity grid points, x axis (all axes unless nvy/nvz given)
    ns: int = 12  # spherical design size (see quadrature.SPHERICAL_DESIGN_FILES)
    # Anisotropic per-axis resolutions (reference operator signature
    # FFTWBoltzmannOperator.hpp:32 takes Nvx/Nvy/Nvz); None = nv.  Supported
    # by every impl.
    nvy: Optional[int] = None
    nvz: Optional[int] = None
    n_radial: Optional[int] = None  # Gauss-Legendre points; default nv
    gamma: float = 0.0
    b_gamma: float = 1.0 / (4.0 * math.pi)
    support_radius: float = 5.0  # S
    radial_radius: Optional[float] = None  # R; default 2*S
    length: Optional[float] = None  # L; default ((3+sqrt 2)/2)*S
    dtype: str = "float64"  # "float32" | "float64"
    # impl: "rfft"  — real half-spectrum transforms (fast, bandwidth-optimal);
    #       "c2c"   — reference-faithful complex transforms;
    #       "dft"   — per-axis DFT matrix products (einsums) in place of FFTs.
    impl: str = "rfft"
    node_chunk: Optional[int] = None  # nodes per scan step; None = whole batch
    # Matrix-product precision of the impl="dft" einsums (float32 only; a
    # float64 product is float64 whatever this says).  "default" lets XLA
    # pick the fastest float32 path, which on a GPU with tensor cores may be
    # TF32 (about three decimal digits); "highest" asks for full float32.
    dft_precision: str = "highest"
    # Antipodal-pair reduction: the shipped spherical designs are symmetric
    # (sigma in the table => -sigma in the table, exactly), and the per-node
    # gain contributions of a node and its antipode are bitwise identical
    # (g2(sigma) = g1(-sigma); see quadrature.antipodal_reduce).  True halves
    # the quadrature batch with doubled weights — same sum up to summation
    # order, half the per-node work.  False evaluates all ns nodes like the
    # reference (FFTWBoltzmannOperator.cpp:191-276).
    antipodal: bool = True
    # ds-pipeline accuracy dial (oz engine): Ozaki slice-pair retention
    # level.  None = digit-exact default (cmax=6 at w=7 — the f64 reference's
    # printed BKW digits, see ds_operator._pipeline_slicing).  Lower values
    # trade truncation error for slice-pair FLOPs.  A per-call
    # ``collide_ds(..., oz_cmax=)`` overrides this.  Ignored by the vpu
    # engine and the non-ds impls.
    oz_cmax: Optional[int] = None

    def __post_init__(self):
        if self.impl not in ("rfft", "c2c", "dft"):
            raise ValueError(
                f"impl must be 'rfft', 'c2c' or 'dft', got {self.impl!r}"
            )
        if self.dft_precision not in ("default", "highest"):
            raise ValueError(
                f"dft_precision must be 'default' or 'highest', got "
                f"{self.dft_precision!r}"
            )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32/float64, got {self.dtype!r}")
        for name, n in (("nv", self.nv), ("nvy", self.nvy), ("nvz", self.nvz)):
            if n is not None and n % 2 != 0:
                raise ValueError(f"{name} must be even (FFT mode ordering)")
        if self.ns not in _quad.SPHERICAL_DESIGN_FILES:
            raise ValueError(
                f"No spherical design with {self.ns} points; available: "
                f"{sorted(_quad.SPHERICAL_DESIGN_FILES)}"
            )
        if self.antipodal and self.ns % 2:
            raise ValueError("antipodal reduction requires an even ns")
        if self.oz_cmax is not None and not (0 <= self.oz_cmax <= 14):
            raise ValueError(
                f"oz_cmax must be in [0, 14] (slice-pair level sum), got "
                f"{self.oz_cmax!r}"
            )

    # ---- derived static quantities -------------------------------------
    @property
    def grid_shape(self) -> tuple:
        return (self.nv, self.nvy or self.nv, self.nvz or self.nv)

    @property
    def is_isotropic(self) -> bool:
        s = self.grid_shape
        return s[0] == s[1] == s[2]

    @property
    def n_gl(self) -> int:
        return self.n_radial if self.n_radial is not None else self.nv

    @property
    def r_max(self) -> float:
        if self.radial_radius is not None:
            return self.radial_radius
        return 2.0 * self.support_radius

    @property
    def domain_length(self) -> float:
        if self.length is not None:
            return self.length
        return 0.5 * (3.0 + math.sqrt(2.0)) * self.support_radius

    @property
    def ns_eff(self) -> int:
        """Spherical nodes actually evaluated: ns/2 under the (exact)
        antipodal-pair reduction, ns otherwise."""
        return self.ns // 2 if self.antipodal else self.ns

    @property
    def n_nodes(self) -> int:
        """Quadrature batch size B = N_gl * N_sph(effective)."""
        return self.n_gl * self.ns_eff

    @property
    def chunk(self) -> int:
        c = self.node_chunk if self.node_chunk is not None else self.auto_chunk()
        return max(1, min(c, self.n_nodes))

    def auto_chunk(
        self, budget_bytes: Optional[int] = None, batch: int = 1
    ) -> int:
        """Node-chunk size: the largest even split of the node batch whose
        working set fits the device-memory budget.

        The per-chunk working set is ~6 complex mode-grid arrays
        (alpha1*f_hat, alpha2*f_hat, g1, g2, h, h_hat — the reference
        materializes 5 of these at full batch size,
        ``FFTWBoltzmannOperator.cpp:30-37``, which cannot fit at
        Nv=64/Ns=32) plus ~3 equivalents of XLA FFT workspace.  The budget
        defaults to what the attached device reports
        (see ``_device_hbm_budget``).  ``batch`` is the number of
        distributions one device evaluates at once (vmapped cells or
        ensemble members), which share the budget.
        """
        nx, ny, nz = self.grid_shape
        n_modes = nx * ny * (nz // 2 + 1 if self.impl == "rfft" else nz)
        if budget_bytes is None:
            budget_bytes = _device_hbm_budget()
        itemsize = 16 if self.dtype == "float64" else 8
        per_node = 9 * n_modes * itemsize * batch
        cap = max(1, budget_bytes // per_node)
        if cap >= self.n_nodes:
            return self.n_nodes
        n_chunks = -(-self.n_nodes // cap)
        return -(-self.n_nodes // n_chunks)

    @property
    def n_chunks(self) -> int:
        return -(-self.n_nodes // self.chunk)

    @property
    def n_nodes_padded(self) -> int:
        return self.n_chunks * self.chunk

    @property
    def real_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32

    @property
    def complex_dtype(self):
        return jnp.complex128 if self.dtype == "float64" else jnp.complex64

    @property
    def velocity_grid(self) -> _grid.VelocityGrid:
        return _grid.VelocityGrid(
            nv=self.nv, length=self.domain_length, nvy=self.nvy, nvz=self.nvz
        )


class Precomp(NamedTuple):
    """Traced (pytree) side of the operator: quadrature + mode tables.

    Node-major arrays carry the flattened quadrature batch ``b = r * Ns + s``
    padded to ``n_nodes_padded`` (padded entries have ``gain_w == 0``), so the
    node axis shards/chunks cleanly.
    """

    rho: jnp.ndarray  # (Bp,)   radial node per batch entry
    sigma: jnp.ndarray  # (Bp, 3) spherical direction per batch entry
    gain_w: jnp.ndarray  # (Bp,)   w_gl * w_sph * rho^(gamma+2)
    lx: jnp.ndarray  # (N,)    FFT-order modes, axis 0
    ly: jnp.ndarray  # (N,)
    lz: jnp.ndarray  # (N,) for c2c/dft | (N/2+1,) for rfft (Nyquist -> -N/2)
    norm_l: jnp.ndarray  # |l| on the (possibly half) mode grid
    beta2: jnp.ndarray  # loss multiplier on the (possibly half) mode grid
    # DFT matrices for impl="dft", stored as stacked real planes [re, im] of
    # shape (2, N, N) for the real-valued einsums of the dft pipeline.
    # ``dft_fwd``/``dft_inv`` are the x-axis matrices; the y/z
    # fields are None on cubic grids (all axes share the x matrix) and carry
    # per-axis matrices on anisotropic grids (reference ctor parity:
    # ``FFTWBoltzmannOperator.hpp:32``).
    dft_fwd: Optional[jnp.ndarray] = None  # (2, Nx, Nx) forward DFT matrix
    dft_inv: Optional[jnp.ndarray] = None  # (2, Nx, Nx) normalized inverse DFT
    dft_fwd_y: Optional[jnp.ndarray] = None  # (2, Ny, Ny) when anisotropic
    dft_inv_y: Optional[jnp.ndarray] = None
    dft_fwd_z: Optional[jnp.ndarray] = None  # (2, Nz, Nz) when anisotropic
    dft_inv_z: Optional[jnp.ndarray] = None

    def dft_fwd_axes(self) -> tuple:
        """(x, y, z) forward-matrix stacks (shared x matrix when cubic)."""
        return (
            self.dft_fwd,
            self.dft_fwd_y if self.dft_fwd_y is not None else self.dft_fwd,
            self.dft_fwd_z if self.dft_fwd_z is not None else self.dft_fwd,
        )

    def dft_inv_axes(self) -> tuple:
        return (
            self.dft_inv,
            self.dft_inv_y if self.dft_inv_y is not None else self.dft_inv,
            self.dft_inv_z if self.dft_inv_z is not None else self.dft_inv,
        )


def sincc(x: np.ndarray | jnp.ndarray, eps: float):
    """Singularity-free sinc: ``sin(x + eps) / (x + eps)``.

    Reproduces the reference helper bit-for-bit (``FFTWBoltzmannOperator.hpp:17-21``;
    dtype-matched eps as in ``BoltzmannCUDAKernels.hpp:8-29``), including its
    tiny O(eps) bias away from 0 — required for 1e-12-level parity.
    """
    xp = jnp if isinstance(x, jnp.ndarray) else np
    return xp.sin(x + eps) / (x + eps)


def spherical_quadrature(cfg: CollisionConfig) -> _quad.SphericalQuadrature:
    """The configuration's spherical rule, antipodally reduced when enabled."""
    sph = _quad.spherical_design(cfg.ns)
    if cfg.antipodal:
        sph = _quad.antipodal_reduce(sph)
    return sph


def build_precomp(cfg: CollisionConfig) -> Precomp:
    """Build the quadrature/mode/weight pytree (float64 host math, cast once)."""
    n = cfg.nv
    length = cfg.domain_length

    gl = _quad.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
    sph = spherical_quadrature(cfg)
    ns = sph.n  # == cfg.ns_eff

    # Node-major flattening b = r * Ns + s (FFTWBoltzmannOperator.cpp:196).
    rho = np.repeat(gl.nodes, ns)  # (B,)
    sigma = np.tile(sph.points, (cfg.n_gl, 1))  # (B, 3)
    gain_w = np.repeat(
        gl.weights * gl.nodes ** (cfg.gamma + 2.0), ns
    ) * np.tile(sph.weights, cfg.n_gl)

    # Pad the node axis so it splits into equal chunks (and shards evenly).
    pad = cfg.n_nodes_padded - cfg.n_nodes
    if pad:
        rho = np.concatenate([rho, np.ones(pad)])
        sigma = np.concatenate([sigma, np.tile([[0.0, 0.0, 1.0]], (pad, 1))])
        gain_w = np.concatenate([gain_w, np.zeros(pad)])

    nx, ny, nz = cfg.grid_shape
    lx = _modes.fft_modes(nx)
    ly = _modes.fft_modes(ny)
    lz = _modes.rfft_modes(nz) if cfg.impl == "rfft" else _modes.fft_modes(nz)
    norm_l = _modes.mode_norm_grid(lx, ly, lz)

    # Matmul-form DFT matrices (impl="dft"): F[m, x] = exp(-2 pi i m x / N),
    # Vinv[x, m] = exp(+2 pi i m x / N) / N — the inverse carries jnp's 1/N
    # normalization per axis so the overall scaling matches fftn/ifftn.
    # Anisotropic grids get one matrix pair per axis.
    dft_fwd = dft_inv = None
    dft_fwd_y = dft_inv_y = dft_fwd_z = dft_inv_z = None
    if cfg.impl == "dft":
        def dft_pair(n_axis):
            m = np.arange(n_axis)
            ph = 2.0 * np.pi * np.outer(m, m) / n_axis
            fwd = np.stack([np.cos(ph), -np.sin(ph)])  # exp(-i ph)
            inv = np.stack([np.cos(ph) / n_axis, np.sin(ph) / n_axis])
            return fwd, inv

        dft_fwd, dft_inv = dft_pair(nx)
        if not cfg.is_isotropic:
            dft_fwd_y, dft_inv_y = dft_pair(ny)
            dft_fwd_z, dft_inv_z = dft_pair(nz)

    # Loss-term multiplier beta2(l) = sum_r 16 pi^2 b_gamma w_r rho_r^(gamma+2)
    #   * sincc(pi rho_r |l| / L)   (FFTWBoltzmannOperator.cpp:287-293).
    eps64 = float(np.finfo(np.float64).eps)
    radial_w = gl.weights * gl.nodes ** (cfg.gamma + 2.0)  # (R,)
    arg = (np.pi / length) * gl.nodes[:, None] * norm_l.reshape(1, -1)
    beta2 = (
        16.0 * np.pi**2 * cfg.b_gamma * (radial_w @ sincc(arg, eps64))
    ).reshape(norm_l.shape)

    rd = cfg.real_dtype
    return Precomp(
        rho=jnp.asarray(rho, rd),
        sigma=jnp.asarray(sigma, rd),
        gain_w=jnp.asarray(gain_w, rd),
        lx=jnp.asarray(lx, rd),
        ly=jnp.asarray(ly, rd),
        lz=jnp.asarray(lz, rd),
        norm_l=jnp.asarray(norm_l, rd),
        beta2=jnp.asarray(beta2, rd),
        dft_fwd=None if dft_fwd is None else jnp.asarray(dft_fwd, rd),
        dft_inv=None if dft_inv is None else jnp.asarray(dft_inv, rd),
        dft_fwd_y=None if dft_fwd_y is None else jnp.asarray(dft_fwd_y, rd),
        dft_inv_y=None if dft_inv_y is None else jnp.asarray(dft_inv_y, rd),
        dft_fwd_z=None if dft_fwd_z is None else jnp.asarray(dft_fwd_z, rd),
        dft_inv_z=None if dft_inv_z is None else jnp.asarray(dft_inv_z, rd),
    )


def repad_nodes(pre: Precomp, target_b: int) -> Precomp:
    """Grow the padded node axis of a ``Precomp`` to ``target_b`` entries.

    Extra entries carry ``gain_w == 0`` (and a harmless unit node), so they
    change nothing numerically — used to make the node axis divide evenly
    across mesh devices and scan chunks.
    """
    b = pre.rho.shape[0]
    if target_b < b:
        raise ValueError(f"target_b={target_b} < current node count {b}")
    if target_b == b:
        return pre
    pad = target_b - b
    dt = pre.rho.dtype
    return pre._replace(
        rho=jnp.concatenate([pre.rho, jnp.ones((pad,), dt)]),
        sigma=jnp.concatenate(
            [pre.sigma, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dt), (pad, 1))]
        ),
        gain_w=jnp.concatenate([pre.gain_w, jnp.zeros((pad,), dt)]),
    )
