"""boltzfft — fast Fourier spectral method for the Boltzmann collision
operator in JAX.

A JAX/XLA rebuild of the capabilities of the reference C++/CUDA code
``i3s93/Boltzmann-Fourier-Spectral-Method``: Gauss-Legendre x
spherical-design quadrature decomposition of the VHS collision kernel, batched
3-D FFT evaluation of the gain/loss terms (cuFFT on a GPU), BKW analytic
validation, moments, RK time stepping, and sharding of the quadrature-node and
ensemble axes over several devices.
"""

from .bkw import bkw_dfdt, bkw_f, bkw_k, maxwellian
from .grid import VelocityGrid, domain_from_support
from .conserve import (ConservePrecomp, build_conserve_precomp,
                       conservative, project)
from .moments import Moments, entropy, moments
from .device import PipelineChoice, pipeline_choice
from .operator import collide, gain_spectrum, make_collision_operator
from .quadrature import (
    SPHERICAL_DESIGN_FILES,
    Quadrature1D,
    SphericalQuadrature,
    gauss_legendre,
    spherical_design,
)
from .sharding import (
    ENSEMBLE_AXIS,
    NODE_AXIS,
    make_mesh,
    make_sharded_collision_operator,
    place,
    place_cells,
)
from .cache import enable_compilation_cache, load_precomp, save_precomp
from .checkpoint import RelaxCheckpointer
from . import ds
from . import oz
from .ds_operator import (
    DsPrecomp,
    build_ds_precomp,
    collide_ds,
    make_ds_collision_operator,
    make_sharded_ds_collision_operator,
    place_ds,
)
from .distributed import (
    initialize_distributed,
    make_multihost_mesh,
    process_local_ensemble_slice,
)
from .stats import RunStats, error_norms, error_norms_device, time_fn, trace
from .tune import autotune, autotune_ds
from .timestepper import (
    Trajectory,
    euler_step,
    make_relaxation,
    relax,
    rk2_step,
    rk4_step,
)
from .weights import CollisionConfig, Precomp, build_precomp, repad_nodes, sincc

__version__ = "0.1.0"

__all__ = [
    "CollisionConfig",
    "ENSEMBLE_AXIS",
    "enable_compilation_cache",
    "load_precomp",
    "save_precomp",
    "trace",
    "NODE_AXIS",
    "Trajectory",
    "RelaxCheckpointer",
    "initialize_distributed",
    "make_multihost_mesh",
    "process_local_ensemble_slice",
    "autotune",
    "autotune_ds",
    "ds",
    "DsPrecomp",
    "build_ds_precomp",
    "collide_ds",
    "make_ds_collision_operator",
    "make_sharded_ds_collision_operator",
    "place_ds",
    "euler_step",
    "make_mesh",
    "make_relaxation",
    "make_sharded_collision_operator",
    "place",
    "place_cells",
    "relax",
    "repad_nodes",
    "rk2_step",
    "rk4_step",
    "Precomp",
    "Quadrature1D",
    "RunStats",
    "SphericalQuadrature",
    "SPHERICAL_DESIGN_FILES",
    "VelocityGrid",
    "bkw_dfdt",
    "bkw_f",
    "bkw_k",
    "build_precomp",
    "collide",
    "PipelineChoice",
    "pipeline_choice",
    "domain_from_support",
    "entropy",
    "ConservePrecomp",
    "build_conserve_precomp",
    "conservative",
    "project",
    "error_norms",
    "error_norms_device",
    "gain_spectrum",
    "gauss_legendre",
    "make_collision_operator",
    "maxwellian",
    "moments",
    "Moments",
    "sincc",
    "spherical_design",
    "time_fn",
]
