"""The SVGD class.

PyTorch port of ``svgdcpp_tpu.svgd`` (reference: include/SVGDCpp/SVGD.hpp).
The construction/validation surface, options, Initialize/Run lifecycle,
bounds clamping, annealing, hooks, statistics and parameter hot-swap follow
the JAX package. ``run()`` is a Python loop over the same pure step
function ``build_step_fn()`` returns (the JAX package rolls it into one
``lax.scan``).

Routes (``SVGDOptions.phi_impl``):

  * ``generic``    -- any kernel function: phi by torch.func, one VJP per
                      target over the sources, streamed over row tiles
                      (``ops/phi.phi_generic``). The route of a custom
                      kernel, and of ``log_intermediate_matrices``, whose
                      K and grad-K stacks it builds.
  * ``dense``      -- closed-form RBF phi on the full n x n kernel matrix.
  * ``blocked``    -- the same, streamed over row tiles.
  * ``fused``      -- ONE plain torch sweep per step giving phi (with the
                      previous step's verified median, lag-1) and this
                      step's median-selection counts.
  * ``fused_cuda`` -- the same through the hand-written CUDA kernels
                      (``ops/cuda_phi.py``): the square, full-width triangle
                      or panel triangle sweep, as ``SVGDOptions.fused_sym``
                      resolves for n and m (``fused_sym_form``); the
                      counterpart of the JAX package's ``fused_pallas``. On
                      CPU tensors its wrappers run the plain sweeps.
  * ``rbf_terms``  -- a `+ - * /` composition of pure RBF kernels
                      (kernels/algebra.py): the signed sum of each term's
                      streamed closed-form phi.
  * ``fused_terms`` / ``fused_terms_cuda`` -- the fused lag-1 sweep for a
                      composition whose adaptive slots are all median-scaled
                      and whose constant slots are isotropic: the plain
                      sweep, and the CUDA terms kernels (the counterpart of
                      ``fused_terms_pallas``).
  * ``fused_aniso_terms_cuda`` -- the fused lag-1 triangle sweep for a
                      composition with anisotropic (full-matrix) constant
                      slots, every term positive definite: the CUDA kernel
                      K14's port (the counterpart of
                      ``fused_aniso_terms_pallas``); its plain version on
                      CPU tensors.
  * ``cuda``       -- one RBF with a full P fixed over the step, through
                      the CUDA square kernel (K15's port; the counterpart of
                      the opt-in ``pallas``); ``phi_rbf_blocked`` on CPU
                      tensors.
  * ``auto``       -- the JAX package's rule. On a CUDA device its TPU rule,
                      with CUDA_FUSED_MIN_PARTICLES and the CUDA routes in
                      place of the TPU ones; on the CPU its non-TPU rule.
                      A kernel that is neither the built-in RBF nor a
                      composition that flattens to RBF terms takes
                      ``generic``.

With ``log_intermediate_matrices`` every step also returns the step's
scores, K, grad-K and new coordinates (``ops/phi.kernel_matrix_and_grad``,
n x n x m, for small debug runs), and ``run()`` writes them through
``utils/logging.write_intermediate_matrices`` and keeps them as
``_intermediate_logs``.

``SVGDOptions.mesh`` takes a ``parallel.ParticleGroup``
(``make_particle_mesh()`` or ``make_particle_group()``) and splits the
particle axis over its ranks, the driver's API and lifecycle unchanged:
every rank builds the driver with the same options and calls the same
methods (the collectives pair up), each steps its own rows, and ``run()``
returns the gathered global coordinates on every rank. The trajectory is
the one the same route gives without a mesh, up to float summation order.
The plain routes and the debug dump take this rank's rows against the
sources and scores gathered once a step (the ``_cross`` sweeps), with the
route's own median over the group's summed counts; ``fused_cuda`` and
``fused_terms_cuda`` run the sharded engine's forms (the triangle chunk,
the panel chunk or the cross sweep, ``parallel/sharded.resolve_sharded_sym``).
``fused_aniso_terms_cuda`` and ``cuda`` raise under a mesh, as their JAX
counterparts do, and so does a particle count that does not split evenly.
A JAX route name whose CUDA counterpart has another name raises ValueError
naming it.

Where it runs: a coordinate matrix that is a tensor keeps its device; any
other (a numpy array, a list) goes to ``SVGDOptions.device``, the card by
default. Without a CUDA device that default raises: pass ``device="cpu"``.

On the fused routes each step reads ONE boolean on the host: whether the
median bracket held (ops/median.fused_median_from_counts). When it did not,
the bisection fallback runs and ``median_fallbacks`` counts it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.func import vmap

from .core.exceptions import DimensionMismatchError, SVGD_LOG_PREFIX
from .core.types import ParticleStore, as_store, as_tensor, place_coords
from .kernels.algebra import (
    flatten_rbf_terms,
    fused_aniso_terms_supported,
    fused_terms_eligible,
    fused_terms_statically_positive,
    matrix_is_psd,
    refill_median_slots,
    split_iso_aniso_terms,
    term_precision,
    term_psd_flags,
)
from .kernels.gaussian_rbf import GaussianRBFKernel, rbf_kernel_fn
from .kernels.kernel import Kernel, _as_param_tuple
from .models.model import Model, params_on
from .ops.cuda_phi import (
    MAX_ANISO_TERMS,
    MAX_M,
    SYM_MIN_N,
    cholesky_factors,
    phi_rbf_aniso_terms_fused_cuda,
    phi_rbf_cuda,
    phi_rbf_fused_cuda,
    phi_rbf_terms_fused_cuda,
    resolve_sym,
    symmetric_eigen,
)
from .ops.median import (
    centered_count_env,
    fused_lag1_plan,
    fused_median_from_counts,
)
from .ops.phi import (
    dot_bf16,
    kernel_matrix_and_grad,
    kernel_matrix_and_grad_cross,
    phi_generic,
    phi_generic_cross,
    phi_rbf,
    phi_rbf_blocked,
    phi_rbf_cross,
    phi_rbf_fused_counts,
    phi_rbf_terms,
    phi_rbf_terms_cross,
    phi_rbf_terms_fused_counts,
)
from .optimizers.base import Optimizer
from .utils.logging import write_intermediate_matrices

#: Above this particle count the dense n x n phi switches to the
#: tile-streamed implementation (the JAX package's rule).
DENSE_PHI_MAX_PARTICLES = 1024

#: On a CUDA device, auto takes the fused kernel routes above this particle
#: count. Set to the JAX package's TPU rule (TPU_FUSED_MIN_PARTICLES) as a
#: starting point; the crossover on the card is not measured yet.
CUDA_FUSED_MIN_PARTICLES = 256

#: Routes of the JAX package whose CUDA counterpart has another name.
_CUDA_NAMES = {
    "fused_pallas": "fused_cuda",
    "fused_terms_pallas": "fused_terms_cuda",
    "fused_aniso_terms_pallas": "fused_aniso_terms_cuda",
    "pallas": "cuda",
}

_ROUTES = (
    "generic", "dense", "blocked", "fused", "fused_cuda", "rbf_terms",
    "fused_terms", "fused_terms_cuda", "fused_aniso_terms_cuda", "cuda",
)
_SINGLE_RBF_ROUTES = ("dense", "blocked", "fused", "fused_cuda", "cuda")
_TERMS_ROUTES = (
    "rbf_terms", "fused_terms", "fused_terms_cuda", "fused_aniso_terms_cuda",
)
_FUSED_TERMS_ROUTES = (
    "fused_terms", "fused_terms_cuda", "fused_aniso_terms_cuda",
)
_FUSED_ROUTES = ("fused", "fused_cuda") + _FUSED_TERMS_ROUTES
_KERNEL_ROUTES = (
    "fused_cuda", "fused_terms_cuda", "fused_aniso_terms_cuda", "cuda",
)


def _skip_section(name: str) -> None:
    """SVGD.section_hook's stand-in when no one times the sections."""


def _coords_store(coords, device) -> ParticleStore:
    """The particle store of SVGDOptions.coordinate_matrix: a tensor (or a
    store) keeps its device, the caller's choice; anything else goes to
    ``device``. The card is never swapped for the CPU quietly."""
    if isinstance(coords, ParticleStore):
        return coords
    return as_store(
        place_coords(coords, device, SVGD_LOG_PREFIX + "SVGDOptions.device")
    )


def _check_mesh(mesh):
    """SVGDOptions.mesh: None or a parallel.ParticleGroup."""
    if mesh is None:
        return None
    from .parallel.mesh import ParticleGroup

    if not isinstance(mesh, ParticleGroup):
        raise TypeError(
            SVGD_LOG_PREFIX + "SVGDOptions.mesh takes a parallel."
            "ParticleGroup (make_particle_mesh() or make_particle_group()), "
            f"got {type(mesh).__name__}"
        )
    return mesh


def _aniso_accumulators(split) -> int:
    """Gradient accumulators of an iso/aniso term split: one shared by the
    isotropic terms, one per anisotropic term."""
    iso_idx, aniso_idx = split
    return (1 if iso_idx else 0) + len(aniso_idx)


def _same_slots(a, b) -> bool:
    """Whether two factor keys (per term, its (slot tensor, sign) pairs)
    name the same tensors with the same signs in the same terms."""
    return len(a) == len(b) and all(
        len(ta) == len(tb) and all(
            pa is pb and sa == sb for (pa, sa), (pb, sb) in zip(ta, tb))
        for ta, tb in zip(a, b))


def _check_aniso_split(split) -> None:
    """Raise for a split the CUDA anisotropic sweep does not take."""
    n_w = _aniso_accumulators(split)
    if n_w > MAX_ANISO_TERMS:
        raise ValueError(
            "phi_impl='fused_aniso_terms_cuda' takes at most "
            f"{MAX_ANISO_TERMS} gradient accumulators on a CUDA device (one "
            "for the isotropic terms, one per anisotropic term), got "
            f"{n_w}; use 'rbf_terms'."
        )


@dataclasses.dataclass
class SVGDOptions:
    """Options struct (reference SVGDOptions, SVGD.hpp:27-52).

    ``lower_bound=None`` / ``upper_bound=None`` disable bound checking, the
    reference's +/-inf sentinel (SVGD.hpp:41-43, 184-190).
    """

    dimension: int = 0
    num_iterations: int = 0
    coordinate_matrix: Any = None  # (n, m) tensor/array or ParticleStore
    kernel: Optional[Kernel] = None
    model: Optional[Model] = None
    optimizer: Optional[Optimizer] = None
    lower_bound: Any = None
    upper_bound: Any = None
    intermediate_matrices_output_path: str = "log.txt"
    parallel: bool = True  # accepted for parity; the sweeps are data parallel
    log_intermediate_matrices: bool = False
    # --- extensions shared with svgdcpp_tpu ---
    phi_impl: str = "auto"  # 'auto' or one of the routes above
    row_tile: int = 1024
    #: A parallel.ParticleGroup to split the particle axis over.
    mesh: Any = None
    #: Annealed SVGD: per-iteration temperature tau scaling the scores. A
    #: (num_iterations,) array, or a callable iteration (int) -> tau.
    annealing: Any = None
    #: Record per-step statistics (phi RMS, max step size, bandwidth) during
    #: run(); available afterwards as ``svgd.stats`` (stacked numpy arrays).
    track_stats: bool = False
    #: Median-selection bins per fused sweep: fused_bins + 1 threshold
    #: compares per pair. The count-verified bracket and its bisection
    #: fallback hold for any value.
    fused_bins: int = 2
    #: Operand dtype of the single-RBF fused kernel sweep ('fused_cuda',
    #: and 'auto' where it takes that route): 'float32' (default) or
    #: 'bfloat16', the JAX package's opt-in: K1's, K2's and K3's bf16
    #: instances (Gram operands, pair weights and the contraction's records
    #: rounded to bf16, float32 accumulation; the norms and the epilogue's
    #: coordinates float32). Under ``mesh`` it turns the triangle schedule
    #: off for the cross sweep, whose single-RBF form takes it, as the JAX
    #: driver's does. The other routes ignore it. Any other value raises.
    fused_dot_dtype: str = "float32"
    #: Which form of the sweep the 'fused_cuda' and 'fused_terms_cuda'
    #: routes run (ops/cuda_phi.resolve_sym): None (default) the JAX
    #: package's rule, the full-width triangle kernel from SYM_MIN_N
    #: particles up and the panel triangle kernel past the TPU's accumulator
    #: budget (N = 262,144 at d = 2, N = 131,072 for the hierarchical BLR);
    #: False the square kernel; True the full-width triangle kernel at any n
    #: (advisory in the JAX package, which takes the panel or the square
    #: form where its budget is exceeded); "panel" the panel kernel. The
    #: form a driver resolved is ``SVGD.fused_sym_form``.
    fused_sym: Any = None
    #: Where a coordinate matrix that is not a tensor goes: the card by
    #: default ("cpu" to ask for the CPU). A tensor keeps its own device.
    device: Any = "cuda"


def _prepare_bound(bound, dimension, name) -> Optional[torch.Tensor]:
    """Validate/broadcast a bound to shape (m,) (reference SVGD.hpp:193-216)."""
    if bound is None:
        return None
    b = as_tensor(bound).to(torch.float64).reshape(-1)
    if b.shape[0] == 1:
        b = b.expand(dimension)
    elif b.shape[0] != dimension:
        raise DimensionMismatchError(
            f"The provided {name} bounds have incorrect dimensions."
        )
    return b


class SVGD:
    """SVGD (reference SVGD class, SVGD.hpp:84-511)."""

    def __init__(self, *args, **kwargs):
        # SVGD(options) or
        # SVGD(dim, iter, coords, kernel, model, optimizer, [lower, upper, ...])
        # (reference SVGD.hpp:93-250).
        if len(args) == 1 and isinstance(args[0], SVGDOptions) and not kwargs:
            opts = args[0]
        else:
            names = [
                "dimension",
                "num_iterations",
                "coordinate_matrix",
                "kernel",
                "model",
                "optimizer",
                "lower_bound",
                "upper_bound",
                "parallel",
                "log_intermediate_matrices",
                "intermediate_matrices_output_path",
            ]
            if len(args) > len(names):
                raise TypeError(
                    f"SVGD() takes at most {len(names)} positional arguments "
                    f"({len(args)} given)"
                )
            merged = dict(zip(names, args))
            dup = set(merged) & set(kwargs)
            if dup:
                raise TypeError(
                    "SVGD() got multiple values for argument(s): "
                    + ", ".join(sorted(dup))
                )
            merged.update(kwargs)
            opts = SVGDOptions(**merged)

        self.options = opts
        #: The ParticleGroup the particle axis is split over, or None.
        self.mesh = _check_mesh(opts.mesh)
        self.store: ParticleStore = _coords_store(
            opts.coordinate_matrix,
            opts.device if self.mesh is None else self.mesh.device,
        )
        self.dimension = self.store.dimension
        self.num_particles = self.store.num_particles
        self.num_iterations = int(opts.num_iterations)
        if self.mesh is not None:
            self._check_mesh_split()

        # Dimension check (reference SVGD.hpp:169-173).
        if self.dimension != int(opts.dimension):
            raise DimensionMismatchError(
                "Specified dimension does not match the particle coordinate matrix."
            )

        # Null-component validation (reference SVGD.hpp:223-236).
        if opts.kernel is None:
            raise ValueError(SVGD_LOG_PREFIX + "[Argument Error] Invalid Kernel object.")
        if opts.model is None:
            raise ValueError(SVGD_LOG_PREFIX + "[Argument Error] Invalid Model object.")
        if opts.optimizer is None:
            raise ValueError(
                SVGD_LOG_PREFIX + "[Argument Error] Invalid Optimizer object."
            )
        self.kernel: Kernel = opts.kernel
        self.model: Model = opts.model
        self.optimizer: Optimizer = opts.optimizer

        # Share the particle store with the kernel (the reference's
        # shared-pointer contract, SVGD.hpp:176, GaussianRBFKernel.hpp:52).
        if hasattr(self.kernel, "store"):
            self.kernel.store = self.store

        self.lower_bound = _prepare_bound(opts.lower_bound, self.dimension, "lower")
        self.upper_bound = _prepare_bound(opts.upper_bound, self.dimension, "upper")
        self.check_bounds = self.lower_bound is not None or self.upper_bound is not None
        if self.check_bounds:
            print(SVGD_LOG_PREFIX + "Bound checking enabled.")

        self.log_intermediate_matrices = bool(opts.log_intermediate_matrices)
        self.intermediate_matrices_output_path = opts.intermediate_matrices_output_path
        #: Called with each section's name as the step ends it (scores,
        #: plan, sweep, median, optimizer on the fused routes; scores,
        #: scale, sweep, optimizer on the others), for a profiler to time
        #: the driver's own step. Read when the step is built.
        self.section_hook = None
        self._initialized = False

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def initialize(self):
        """Initialize components and build the step (reference SVGD.hpp:268-296).

        A full reset: the annealing iteration, the optimizer state, the
        median brackets (re-seeded from the CURRENT coordinates) and the
        fallback count start over.
        """
        self.model.initialize()
        self.kernel.initialize()
        coords = self.store.value
        self._opt_state = self.optimizer.init(coords.dtype, coords.device)
        if self.mesh is not None:
            self._opt_state = self.optimizer.shard_state(
                self._opt_state, self.mesh.rows(self.num_particles))
        self._iteration = 0
        self._scale_aux = None
        #: Bisection fallbacks taken by the fused routes' median update.
        self.median_fallbacks = 0
        self._select_impl()
        self._step_fn = self.build_step_fn()
        self._initialized = True
        return self

    def _check_mesh_split(self):
        """Under a mesh: the coordinates on the group's device. Any particle
        count splits (``ParticleGroup.rows``); an uneven one takes the plain
        routes only (``_select_impl``)."""
        mesh = self.mesh
        device = self.store.value.device
        if device != mesh.device and not (
            device.type == mesh.device.type == "cuda"
            and mesh.device.index is None
        ):
            raise ValueError(
                SVGD_LOG_PREFIX + f"the coordinates are on {device}, "
                f"SVGDOptions.mesh's ranks on {mesh.device}"
            )

    def _mesh_even(self) -> bool:
        """Whether the particles split evenly over SVGDOptions.mesh (no
        mesh: trivially). The kernel routes' sharded forms need it, as the
        JAX driver's Mosaic sweep does (``_mesh_pallas_ok``)."""
        return (self.mesh is None
                or self.num_particles % self.mesh.world_size == 0)

    def _select_impl(self):
        opts = self.options
        dot_bf16(opts.fused_dot_dtype)
        self._is_rbf = (
            isinstance(self.kernel, GaussianRBFKernel)
            and self.kernel._kernel_fn is rbf_kernel_fn
        )
        # (slot_index, owning kernel) pairs whose inverse-scale parameter is
        # recomputed every step (a composed kernel's RBF slots included).
        self._adaptive_slots = self.kernel.adaptive_slots()
        # Algebraic flattening of `+ - * /` trees of pure RBF kernels
        # (kernels/algebra.py): closed-form phi instead of the generic VJP.
        self._rbf_terms = (
            None if self._is_rbf else flatten_rbf_terms(self.kernel)
        )
        self._refresh_psd()
        on_cuda = self.store.value.device.type == "cuda"
        impl = opts.phi_impl
        if self.log_intermediate_matrices:
            # The debug dump needs the K and grad-K stacks, which only the
            # generic route builds (the reference logs them too,
            # SVGD.hpp:346-358).
            impl = "generic"
        elif impl == "auto":
            # An uneven split under a mesh takes the plain routes, as the
            # JAX driver's auto does off its Mosaic sweep.
            impl = self._auto_impl(on_cuda and self._mesh_even())
        if impl not in _ROUTES:
            hint = (
                f" (its CUDA counterpart is {_CUDA_NAMES[impl]!r})"
                if impl in _CUDA_NAMES else ""
            )
            raise ValueError(f"unknown phi_impl {impl!r}{hint}")
        if impl in _SINGLE_RBF_ROUTES and not self._is_rbf:
            raise ValueError(
                f"phi_impl={impl!r} requires an uncomposed GaussianRBFKernel."
            )
        if impl in _TERMS_ROUTES and self._rbf_terms is None:
            raise ValueError(
                f"phi_impl={impl!r} requires a `+ - * /` composition of "
                "pure GaussianRBFKernels (see kernels/algebra.py)."
            )
        params = self.kernel.parameters
        if impl == "fused_aniso_terms_cuda":
            if not fused_aniso_terms_supported(
                self._rbf_terms, self._adaptive_slots, params
            ):
                raise ValueError(
                    "phi_impl='fused_aniso_terms_cuda' requires "
                    "median-scaled adaptive slots, no division terms, and "
                    "every term's effective precision positive definite; "
                    "use 'rbf_terms' for the general case."
                )
            if on_cuda:
                _check_aniso_split(split_iso_aniso_terms(
                    self._rbf_terms, self._adaptive_slots, params
                ))
        if impl in ("fused_terms", "fused_terms_cuda"):
            if not fused_terms_eligible(
                self._rbf_terms, self._adaptive_slots, params
            ):
                raise ValueError(
                    f"phi_impl={impl!r} requires every adaptive slot to "
                    "be median-scaled and every constant slot isotropic "
                    "(gamma * I); use 'rbf_terms' for the general case."
                )
            if impl == "fused_terms_cuda" and not (
                fused_terms_statically_positive(
                    self._rbf_terms, self._adaptive_slots, params
                )
            ):
                raise ValueError(
                    "phi_impl='fused_terms_cuda' requires every effective "
                    "term gamma to be provably positive (no division terms, "
                    "positive constant scales); use 'fused_terms'."
                )
        if self.mesh is not None and impl in ("fused_aniso_terms_cuda",
                                              "cuda"):
            raise ValueError(
                f"phi_impl={impl!r} does not support SVGDOptions.mesh (the "
                "sweep is single-device); use "
                + ("'rbf_terms'" if impl == "fused_aniso_terms_cuda"
                   else "'fused_cuda' or 'blocked'")
                + " under a mesh."
            )
        if impl in ("fused_cuda", "fused_terms_cuda") and not self._mesh_even():
            raise ValueError(
                f"phi_impl={impl!r} with SVGDOptions.mesh requires "
                f"num_particles ({self.num_particles}) to divide evenly "
                f"over the {self.mesh.world_size} ranks of the group; use "
                "'fused'/'fused_terms' (the plain sweeps take any n), or "
                "phi_impl='auto'. Do NOT pad the particle set with "
                "duplicates: padded rows would bias phi and the n^2 median."
            )
        if impl in ("fused", "fused_cuda") and (
            getattr(self.kernel, "scale_method", None)
            != GaussianRBFKernel.ScaleMethod.MEDIAN
        ):
            raise ValueError(
                "phi_impl='fused' requires ScaleMethod.MEDIAN (the fused "
                "sweep produces median-selection counts)."
            )
        self._phi_impl = impl
        #: The form of the sweep the fused kernel routes run: False (square),
        #: True (full-width triangle) or "panel" (ops/cuda_phi.resolve_sym
        #: of SVGDOptions.fused_sym for this n, m and term count); under a
        #: mesh the sharded engine's "full", "panel" or False (the cross
        #: sweep) for the group's world size; None on the other routes.
        self.fused_sym_form = None
        if self.mesh is not None and impl in ("fused_cuda",
                                              "fused_terms_cuda"):
            from .parallel.sharded import resolve_sharded_sym

            self.fused_sym_form = resolve_sharded_sym(
                opts.fused_sym, True, self.num_particles, self.dimension,
                self.mesh.world_size, impl == "fused_cuda",
                num_terms=(None if impl == "fused_cuda"
                           else len(self._rbf_terms)),
                dot_dtype=opts.fused_dot_dtype,
            )
        elif impl == "fused_cuda":
            self.fused_sym_form = resolve_sym(
                opts.fused_sym, self.num_particles, self.dimension
            )
        elif impl == "fused_terms_cuda":
            self.fused_sym_form = resolve_sym(
                opts.fused_sym, self.num_particles, self.dimension,
                len(self._rbf_terms),
            )

    def _auto_impl(self, on_cuda: bool) -> str:
        """phi_impl='auto': the JAX package's rule, its TPU branch on a CUDA
        device (CUDA_FUSED_MIN_PARTICLES and the CUDA routes in place of
        TPU_FUSED_MIN_PARTICLES and the Mosaic ones), its non-TPU branch on
        the CPU."""
        fused_threshold = (
            CUDA_FUSED_MIN_PARTICLES if on_cuda else DENSE_PHI_MAX_PARTICLES
        )
        n = self.num_particles
        if self._rbf_terms is not None:
            params = self.kernel.parameters
            eligible = fused_terms_eligible(
                self._rbf_terms, self._adaptive_slots, params
            )
            # The kernel route needs every effective gamma provably positive
            # (as the Mosaic one does); an eligible composition that is not
            # (division terms) goes to the plain sweep, and keeps the exact
            # same-step median of 'rbf_terms' up to the non-kernel
            # threshold.
            kernel_route = (
                eligible
                and on_cuda
                and fused_terms_statically_positive(
                    self._rbf_terms, self._adaptive_slots, params
                )
            )
            threshold = fused_threshold if kernel_route else DENSE_PHI_MAX_PARTICLES
            if n > threshold and eligible:
                return "fused_terms_cuda" if kernel_route else "fused_terms"
            if on_cuda and self._aniso_terms_kernel_route():
                return "fused_aniso_terms_cuda"
            return "rbf_terms"
        if not self._is_rbf:
            return "generic"
        if (
            self.kernel.scale_method == GaussianRBFKernel.ScaleMethod.MEDIAN
            and n > fused_threshold
        ):
            return "fused_cuda" if on_cuda else "fused"
        return "dense" if n <= DENSE_PHI_MAX_PARTICLES else "blocked"

    def _aniso_terms_kernel_route(self) -> bool:
        """Whether the JAX package's TPU rule would take the anisotropic
        fused sweep (``_aniso_terms_auto_ok``): a supported composition
        with at least one anisotropic term and at most 8 gradient
        accumulators, from SYM_MIN_N particles up, never under a mesh. Its
        VMEM budget has no counterpart on the card and is left out."""
        if self.mesh is not None:
            return False
        params = self.kernel.parameters
        if not fused_aniso_terms_supported(
            self._rbf_terms, self._adaptive_slots, params
        ):
            return False
        split = split_iso_aniso_terms(
            self._rbf_terms, self._adaptive_slots, params
        )
        return (
            bool(split[1])
            and _aniso_accumulators(split) <= MAX_ANISO_TERMS
            and self.num_particles >= SYM_MIN_N
        )

    def _refresh_psd(self):
        """PSD-ness of the quadratic forms the closed-form routes clamp:
        MEDIAN scales are PSD by construction, HESSIAN scales may be
        indefinite, constant matrices are eigenvalue-checked on their
        current values (re-run on hot-swap); a composed kernel gets one flag
        per term (kernels/algebra.term_psd_flags)."""
        self._term_psd = (
            None if self._rbf_terms is None else term_psd_flags(
                self._rbf_terms, self._adaptive_slots, self.kernel.parameters
            )
        )
        if not self._is_rbf:
            self._rbf_psd = True
            return
        method = self.kernel.scale_method
        if method == GaussianRBFKernel.ScaleMethod.MEDIAN:
            self._rbf_psd = True
        elif method == GaussianRBFKernel.ScaleMethod.HESSIAN:
            self._rbf_psd = False
        else:
            self._rbf_psd = matrix_is_psd(self.kernel.parameters[0])

    # Hooks: a user-overridden per-step hook runs before each step, in the
    # reference's hook-then-phi order (SVGD.hpp:373-400).
    @staticmethod
    def _hook_override(obj, base_fns):
        """The overridden hook, honoring both the snake_case ``step`` and
        the CamelCase ``Step`` spelling (a subclass may override either)."""
        cls = type(obj)
        if getattr(cls, "Step", None) not in base_fns:
            return obj.Step
        if getattr(cls, "step", None) not in base_fns:
            return obj.step
        return None

    _MODEL_BASE_HOOKS = (Model.step, Model.Step)
    _KERNEL_BASE_HOOKS = (
        Kernel.step,
        Kernel.Step,
        GaussianRBFKernel.step,
        GaussianRBFKernel.Step,
    )

    def _has_custom_hooks(self) -> bool:
        return (
            self._hook_override(self.model, self._MODEL_BASE_HOOKS) is not None
            or self._hook_override(self.kernel, self._KERNEL_BASE_HOOKS)
            is not None
        )

    # ------------------------------------------------------------------
    # Pure step construction
    # ------------------------------------------------------------------
    def _phi(self, coords, scores, kparams, sources=None, source_scores=None):
        if self.mesh is not None:
            return self._phi_cross(coords, sources, source_scores, kparams)
        if self._phi_impl == "generic":
            return phi_generic(
                coords, scores, self.kernel.kernel_pure, kparams,
                self.options.row_tile,
            )
        if self._phi_impl == "rbf_terms":
            return phi_rbf_terms(
                coords, scores, kparams, self._rbf_terms,
                self.options.row_tile, psd_flags=self._term_psd,
            )
        if self._phi_impl == "dense":
            return phi_rbf(coords, scores, kparams[0], psd=self._rbf_psd)
        if self._phi_impl == "blocked":
            return phi_rbf_blocked(
                coords, scores, kparams[0], self.options.row_tile,
                psd=self._rbf_psd,
            )
        if self._phi_impl == "cuda":
            return phi_rbf_cuda(
                coords, scores, kparams[0], psd=self._rbf_psd,
                eig=self._fixed_p_eigen(kparams[0]),
            )
        raise ValueError(f"unknown phi_impl {self._phi_impl!r}")

    def _phi_cross(self, coords, sources, source_scores, kparams):
        """phi of this rank's rows against the gathered sources and scores
        (the plain routes under a mesh)."""
        tile = self.options.row_tile
        if self._phi_impl == "generic":
            return phi_generic_cross(
                coords, sources, source_scores, self.kernel.kernel_pure,
                kparams, tile,
            )
        if self._phi_impl == "rbf_terms":
            return phi_rbf_terms_cross(
                coords, sources, source_scores, kparams, self._rbf_terms,
                tile, psd_flags=self._term_psd,
            )
        return phi_rbf_cross(coords, sources, source_scores, kparams[0], tile,
                             psd=self._rbf_psd)

    def _fixed_p_eigen(self, p):
        """(lam, V) of P_sym/2 for the 'cuda' route where the step can keep
        it: a MEDIAN scale is gamma I, so (its diagonal, I) on the device;
        a CONSTANT P is decomposed once, on its device, and kept while the
        step carries the same tensor (a hot-swap or a new run() may bring a
        new one), up to MAX_M: past it K15 takes P itself, so nothing is
        decomposed. None for a HESSIAN scale, which changes every step: the
        wrapper decomposes it each call, on the card, up to MAX_M."""
        method = self.kernel.scale_method
        if method == GaussianRBFKernel.ScaleMethod.MEDIAN:
            return p.diagonal(), torch.eye(
                p.shape[0], dtype=p.dtype, device=p.device
            )
        if (method == GaussianRBFKernel.ScaleMethod.CONSTANT
                and p.shape[0] <= MAX_M):
            cached = getattr(self, "_constant_eigen", None)
            if cached is None or cached[0] is not p:
                self._constant_eigen = (p, symmetric_eigen(p))
            return self._constant_eigen[1]
        return None

    def _aniso_factors(self, kparams, plists):
        """cholesky_factors of the anisotropic terms' precisions for the
        fused anisotropic sweep, kept while the step sums the same slot
        tensors in the same terms: a constant P is factored once, and a
        hot-swap or a new run() that brings new tensors renews them. The
        key is each term's slots (the tensors themselves) and signs, not
        term_precision's result, which may be a new tensor every step. None
        where a hot-swap left no such term."""
        if not plists:
            return None
        key = tuple(tuple((kparams[idx], sign) for idx, sign in plist)
                    for plist in plists)
        cached = getattr(self, "_aniso_factor_cache", None)
        if cached is None or not _same_slots(cached[0], key):
            ps = [term_precision(plist, kparams) for plist in plists]
            self._aniso_factor_cache = (key,
                                        cholesky_factors(ps, ps[0].device))
        return self._aniso_factor_cache[1]

    def _scale_params(self, coords, mparams, kparams, scale_aux, slot_mparams,
                      sources=None):
        """Per-step bandwidth adaptation (reference kernel Step(),
        GaussianRBFKernel.hpp:141-156): each adaptive slot is refilled by
        its owning kernel, threading the warm-start aux. Under a mesh a
        median slot selects on the gathered ``sources`` with the group's
        summed counts, and a Hessian slot sums the ranks' rows."""
        if not self._adaptive_slots:
            return kparams, scale_aux
        kparams = list(kparams)
        new_aux = list(scale_aux)
        target, kw = coords, {}
        if self.mesh is not None:
            from .parallel.sharded import sharded_hessian_scale

            target = sources
            kw["count_env"] = lambda **env: centered_count_env(
                coords, sources, group=self.mesh,
                n_global=self.num_particles, return_centered=True, **env,
            )
        for i, (idx, owner) in enumerate(self._adaptive_slots):
            if owner.target_model is self.model:
                mp = mparams
            else:
                mp = slot_mparams[i]  # None when the slot has no model
            if (self.mesh is not None and owner.scale_method
                    == GaussianRBFKernel.ScaleMethod.HESSIAN):
                kparams[idx] = sharded_hessian_scale(
                    coords, owner.target_model.hessian_log_density_pure, mp,
                    self.mesh, self.num_particles,
                )
            elif scale_aux[i] is not None and hasattr(owner, "compute_scale_with_aux"):
                kparams[idx], new_aux[i] = owner.compute_scale_with_aux(
                    target, mp, scale_aux[i], **kw
                )
            elif mp is not None:
                kparams[idx] = owner.compute_scale_pure(target, mp, **kw)
            else:
                kparams[idx] = owner.compute_scale_pure(target, **kw)
        return tuple(kparams), tuple(new_aux)

    def build_step_fn(self):
        """Return the pure step: state -> (state, stats | None); with
        ``log_intermediate_matrices`` the stats are the step's debug
        matrices (log_model_grad, kernel, kernel_grad, coords).

        state = {coords, opt_state, kernel_params, model_params, scale_aux,
        slot_model_params, iteration}, the same keys as the JAX package's
        (``utils/convert.py`` carries a state across).
        """
        coords0 = self.store.value
        annealing = self.options.annealing
        if annealing is not None and not callable(annealing):
            annealing_arr = as_tensor(annealing).to(coords0.device)
            last = annealing_arr.shape[0] - 1
            annealing = lambda it: annealing_arr[min(max(int(it), 0), last)]  # noqa: E731

        bounds = [
            None if b is None else b.to(dtype=coords0.dtype, device=coords0.device)
            for b in (self.lower_bound, self.upper_bound)
        ]
        fused = self._phi_impl in _FUSED_ROUTES
        fused_terms = self._phi_impl in _FUSED_TERMS_ROUTES
        fused_aniso = self._phi_impl == "fused_aniso_terms_cuda"
        on_kernels = self._phi_impl in _KERNEL_ROUTES
        fused_bins = int(self.options.fused_bins)
        dot_dtype = self.options.fused_dot_dtype
        if fused_terms:
            median_slot_idx = [idx for idx, _ in self._adaptive_slots]
            term_signs = [s for s, _ in self._rbf_terms]
            term_plists = [p for _, p in self._rbf_terms]
        if fused_aniso:
            # Which terms are anisotropic is fixed for the step built here;
            # a hot-swap that changes it rebuilds the step.
            self._aniso_split = split_iso_aniso_terms(
                self._rbf_terms, self._adaptive_slots, self.kernel.parameters
            )
            iso_idx, aniso_idx = self._aniso_split
        row_tile = self.options.row_tile
        track_stats = self.options.track_stats
        collect_debug = self.log_intermediate_matrices
        section = self.section_hook or _skip_section
        mesh = self.mesh
        if mesh is not None and fused:
            from .parallel.sharded import sharded_fused_sweep

        def step_fn(state, _=None):
            coords = state["coords"]
            mparams = state["model_params"]
            # Through grad_log_density_pure so a model's closed-form score
            # override is honored.
            scores = vmap(
                lambda x: self.model.grad_log_density_pure(x, mparams)
            )(coords)
            if annealing is not None:
                tau = annealing(state["iteration"])
                scores = scores * torch.as_tensor(
                    tau, dtype=scores.dtype, device=scores.device
                )
            section("scores")
            sources = source_scores = None
            if mesh is not None:
                # One gather of each a step, shared by the median and phi.
                sources = mesh.all_gather_rows(coords, self.num_particles)
                source_scores = mesh.all_gather_rows(scores,
                                                     self.num_particles)
                section("gather")
            if fused:
                # ONE O(n^2) sweep: phi with the PREVIOUS step's verified
                # median (lag-1) + this step's selection counts.
                n, m = self.num_particles, coords.shape[1]
                aux = state["scale_aux"][0]
                fdt = aux["med"].dtype
                gamma, sel = fused_lag1_plan(aux, n, fused_bins, coords.dtype)
                thresholds = sel["edges"]
                if fused_terms:
                    # Refill every (median) adaptive slot with the lag-1
                    # scale; constant slots keep their state values
                    # (isotropy checked at initialize and on hot-swap).
                    kparams, gammas = refill_median_slots(
                        state["kernel_params"], median_slot_idx, gamma, m,
                        coords.dtype, term_plists,
                    )
                else:
                    kparams = (
                        gamma
                        * torch.eye(m, dtype=coords.dtype, device=coords.device),
                    )
                section("plan")
                if mesh is not None:
                    phi, counts = sharded_fused_sweep(
                        coords, scores, sources, source_scores, mesh,
                        thresholds, self.fused_sym_form, on_kernels,
                        gamma=None if fused_terms else gamma,
                        gammas=gammas if fused_terms else None,
                        signs=term_signs if fused_terms else None,
                        row_tile=row_tile, dot_dtype=dot_dtype,
                    )
                elif fused_aniso:
                    # The kept factors stand for the precisions.
                    phi, counts = phi_rbf_aniso_terms_fused_cuda(
                        coords, scores,
                        [gammas[i] for i in iso_idx],
                        [term_signs[i] for i in iso_idx],
                        None,
                        [term_signs[i] for i in aniso_idx],
                        thresholds,
                        lowers=self._aniso_factors(
                            kparams, [term_plists[i] for i in aniso_idx]),
                    )
                elif fused_terms and on_kernels:
                    phi, counts = phi_rbf_terms_fused_cuda(
                        coords, scores, gammas, term_signs, thresholds,
                        sym=self.fused_sym_form,
                    )
                elif fused_terms:
                    phi, counts = phi_rbf_terms_fused_counts(
                        coords, scores, gammas, term_signs, thresholds,
                        row_tile,
                    )
                elif on_kernels:
                    phi, counts = phi_rbf_fused_cuda(
                        coords, scores, gamma, thresholds,
                        sym=self.fused_sym_form, dot_dtype=dot_dtype,
                    )
                else:
                    phi, counts = phi_rbf_fused_counts(
                        coords, scores, gamma, thresholds, row_tile
                    )
                section("sweep")
                # Under a mesh the counts are the group's sums and the
                # brackets the same on every rank, so every rank takes the
                # fallback, and its collective count passes, together.
                med_new, lo1, hi1, lo2, hi2, fell_back = fused_median_from_counts(
                    counts, sel, n * n,
                    lambda: centered_count_env(
                        coords, sources, group=mesh, n_global=n,
                        row_tile=row_tile),
                    initialized=aux["hi1"] >= aux["lo1"],
                )
                if fell_back:
                    self.median_fallbacks += 1
                scale_aux = (
                    {
                        "med": med_new.to(fdt),
                        "lo1": lo1.to(fdt),
                        "hi1": hi1.to(fdt),
                        "lo2": lo2.to(fdt),
                        "hi2": hi2.to(fdt),
                        "disp": aux["disp"],
                    },
                )
                section("median")
            else:
                kparams, scale_aux = self._scale_params(
                    coords, mparams, state["kernel_params"], state["scale_aux"],
                    state["slot_model_params"], sources,
                )
                section("scale")
                phi = self._phi(coords, scores, kparams, sources,
                                source_scores)
                section("sweep")
            # getattr: duck-typed user optimizers need not subclass Optimizer
            if getattr(self.optimizer, "needs_params", False):
                opt_state, inc = self.optimizer.step(
                    state["opt_state"], phi, coords
                )
            else:
                opt_state, inc = self.optimizer.step(state["opt_state"], phi)
            new_coords = coords + inc
            if bounds[0] is not None:
                new_coords = torch.maximum(new_coords, bounds[0])
            if bounds[1] is not None:
                new_coords = torch.minimum(new_coords, bounds[1])
            if any(a is not None for a in scale_aux):
                # Max particle displacement of THIS update (clamp included,
                # over the group under a mesh): next step's bracket expands
                # by 2x this.
                moved = torch.max(torch.sum((new_coords - coords) ** 2, dim=1))
                if mesh is not None:
                    moved = mesh.all_reduce_max(moved)
                disp = torch.sqrt(moved)
                scale_aux = tuple(
                    {**a, "disp": disp.to(a["disp"].dtype)}
                    if a is not None
                    else None
                    for a in scale_aux
                )
            new_state = {
                "coords": new_coords,
                "opt_state": opt_state,
                "kernel_params": kparams,
                "model_params": mparams,
                "scale_aux": scale_aux,
                "slot_model_params": state["slot_model_params"],
                "iteration": state["iteration"] + 1,
            }
            stats = None
            if collect_debug:
                # Under a mesh this rank's row bands; run() gathers them.
                if mesh is None:
                    k_mat, k_grad = kernel_matrix_and_grad(
                        coords, self.kernel.kernel_pure, kparams
                    )
                else:
                    k_mat, k_grad = kernel_matrix_and_grad_cross(
                        coords, sources, self.kernel.kernel_pure, kparams
                    )
                stats = {
                    "log_model_grad": scores,
                    "kernel": k_mat,
                    "kernel_grad": k_grad,
                    "coords": new_coords,
                }
            elif track_stats:
                # 'bandwidth' assumes an (m, m) inverse-scale in slot 0; a
                # custom kernel may carry none: report NaN then.
                if kparams and getattr(kparams[0], "ndim", 0) == 2:
                    bandwidth = kparams[0][0, 0]
                else:
                    bandwidth = torch.full(
                        (), float("nan"), dtype=coords.dtype, device=coords.device
                    )
                if mesh is None:
                    phi_rms = torch.sqrt(torch.mean(phi * phi))
                    step_max = torch.max(torch.sqrt(
                        torch.sum((new_coords - coords) ** 2, dim=1)))
                else:
                    phi_rms = torch.sqrt(
                        mesh.all_reduce_sum(torch.sum(phi * phi))
                        / (self.num_particles * coords.shape[1]))
                    step_max = torch.sqrt(mesh.all_reduce_max(torch.max(
                        torch.sum((new_coords - coords) ** 2, dim=1))))
                stats = {
                    "phi_rms": phi_rms,
                    "step_max": step_max,
                    "bandwidth": bandwidth,
                }
            section("optimizer")
            return new_state, stats

        return step_fn

    def make_state(self):
        """Assemble the state from the current component parameters, on the
        coordinates' device; under a mesh this rank's rows of the
        coordinates and of the optimizer state."""
        coords = self.store.value
        state = {
            "coords": coords,
            "opt_state": self._opt_state,
            # Kernel params follow the coords dtype: adaptive slots are
            # REPLACED each step by values derived from coords.
            "kernel_params": tuple(
                as_tensor(p).to(dtype=coords.dtype, device=coords.device)
                for p in self.kernel.parameters
            ),
            # Model params follow the coords' device and floating dtype: a
            # float64 data matrix against float32 coords would otherwise
            # promote the scores to float64.
            "model_params": params_on(
                self.model.parameters, coords.device, coords.dtype
            ),
            # Foreign-model params per adaptive slot, read FRESH so a
            # hot-swap on a kernel's private target model is honored.
            "slot_model_params": tuple(
                params_on(
                    owner.target_model.parameters, coords.device, coords.dtype
                )
                if getattr(owner, "target_model", None) is not None
                and owner.target_model is not self.model
                else None
                for _, owner in self._adaptive_slots
            ),
            "scale_aux": self._current_scale_aux(coords),
            "iteration": int(getattr(self, "_iteration", 0)),
        }
        if self.mesh is None:
            return state
        # This rank's rows, as the sharded engine's states hold them
        # (utils/checkpoint gathers and splits a ShardedState).
        from .parallel.sharded import ShardedState

        state["coords"] = coords[self.mesh.rows(self.num_particles)]
        return ShardedState(state, self)

    def _current_scale_aux(self, coords):
        """Per-adaptive-slot warm-start aux (carried across run() calls)."""
        stored = getattr(self, "_scale_aux", None)
        if stored is not None:
            return stored
        if self._phi_impl in ("fused", "fused_cuda"):
            # {med, lo, hi, disp}: the INITIAL positions' median seeds the
            # lag-1 fused pipeline.
            return (self.kernel.init_fused_aux(coords),)
        if self._phi_impl in _FUSED_TERMS_ROUTES:
            # Composed kernel: the same seed, computed at the root by the
            # first adaptive leaf (its median_method, its kept median).
            return (self._adaptive_slots[0][1].init_fused_aux(coords),)
        return tuple(
            owner.init_scale_aux(coords)
            if hasattr(owner, "init_scale_aux")
            else None
            for _, owner in self._adaptive_slots
        )

    def _absorb_state(self, state):
        coords = state["coords"]
        if self.mesh is not None:
            coords = self.mesh.all_gather_rows(coords, self.num_particles)
        self.store.value = coords
        self._opt_state = state["opt_state"]
        self._scale_aux = state["scale_aux"]
        self._iteration = int(state["iteration"])
        self.kernel.update_parameters(state["kernel_params"])

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def step(self):
        """Execute one SVGD step (reference SVGD::Step, SVGD.hpp:373-400)."""
        self._require_init()
        if self._has_custom_hooks():
            self._eager_hooks()
        new_state, _ = self._step_fn(self.make_state())
        self._absorb_state(new_state)

    def run(self):
        """Execute num_iterations steps (reference SVGD::Run, SVGD.hpp:338-366)."""
        self._require_init()
        hooks = self._has_custom_hooks()
        collected = []
        state = None if hooks else self.make_state()
        for _ in range(self.num_iterations):
            if hooks:
                # Host-side hooks may change the model or kernel: rebuild the
                # state from the components around each step.
                self._eager_hooks()
                state = self.make_state()
            state, stats = self._step_fn(state)
            if hooks:
                self._absorb_state(state)
            if stats is not None:
                collected.append(stats)
        if state is not None and not hooks:
            self._absorb_state(state)
        if collected:
            stacked = {key: torch.stack([s[key] for s in collected])
                       for key in collected[0]}
            if self.log_intermediate_matrices and self.mesh is not None:
                # The ranks' row bands (dim 1 of the (T, n_local, ...)
                # stacks) put together into the global matrices.
                stacked = {
                    key: self.mesh.all_gather_rows(
                        v.transpose(0, 1).contiguous(),
                        self.num_particles).transpose(0, 1)
                    for key, v in stacked.items()
                }
            stacked = {key: v.cpu().numpy() for key, v in stacked.items()}
            if self.log_intermediate_matrices:
                self._intermediate_logs = stacked
                if self.mesh is None or self.mesh.rank == 0:
                    write_intermediate_matrices(
                        self.intermediate_matrices_output_path, stacked
                    )
            else:
                self.stats = stacked
        return self.store.value

    def _eager_hooks(self):
        model_hook = self._hook_override(self.model, self._MODEL_BASE_HOOKS)
        if model_hook is not None:
            model_hook()
        kernel_hook = self._hook_override(self.kernel, self._KERNEL_BASE_HOOKS)
        if kernel_hook is not None:
            kernel_hook()

    def _require_init(self):
        if not self._initialized:
            raise RuntimeError(
                SVGD_LOG_PREFIX + "Initialize() must be called before stepping."
            )

    # ------------------------------------------------------------------
    # Parameter hot-swap (reference SVGD.hpp:304-332)
    # ------------------------------------------------------------------
    def update_kernel_parameters(self, params):
        if not getattr(self, "_initialized", False):
            # Before initialize() there are no route flags yet; initialize()
            # derives them from the new values.
            self.kernel.update_parameters(_as_param_tuple(params))
            self.kernel.initialize()
            return
        # Validate against the PROSPECTIVE values before mutating the
        # kernel: a rejected swap leaves the running driver untouched.
        new_params = _as_param_tuple(params)
        new_split = None
        if self._phi_impl == "fused_aniso_terms_cuda":
            if not fused_aniso_terms_supported(
                self._rbf_terms, self._adaptive_slots, new_params
            ):
                raise ValueError(
                    "phi_impl='fused_aniso_terms_cuda' requires every "
                    "term's effective precision to stay positive definite; "
                    "the swapped parameters violate that. Rebuild with "
                    "phi_impl='rbf_terms'."
                )
            new_split = split_iso_aniso_terms(
                self._rbf_terms, self._adaptive_slots, new_params
            )
            if self.store.value.device.type == "cuda":
                _check_aniso_split(new_split)
        if self._phi_impl in ("fused_terms", "fused_terms_cuda"):
            # The fused-terms sweep reads each constant slot as gamma =
            # P[0, 0]; an anisotropic swap would be silently truncated.
            if not fused_terms_eligible(
                self._rbf_terms, self._adaptive_slots, new_params
            ):
                raise ValueError(
                    "phi_impl='fused_terms' requires isotropic constant "
                    "slots; the swapped parameters are anisotropic. Rebuild "
                    "with phi_impl='rbf_terms' for anisotropic compositions."
                )
            if self._phi_impl == "fused_terms_cuda" and not (
                fused_terms_statically_positive(
                    self._rbf_terms, self._adaptive_slots, new_params
                )
            ):
                raise ValueError(
                    "phi_impl='fused_terms_cuda' requires every constant "
                    "slot gamma to stay positive; the swapped parameters "
                    "violate that. Rebuild with phi_impl='fused_terms'."
                )
        self.kernel.update_parameters(new_params)
        self.kernel.initialize()
        # The step reads the PSD flags when it runs, so re-deriving them is
        # enough (the JAX package rebuilds its compiled step instead); the
        # iso/aniso split is fixed in the step, so a new one rebuilds it.
        self._refresh_psd()
        if new_split is not None and new_split != self._aniso_split:
            self._step_fn = self.build_step_fn()

    def update_model_parameters(self, params):
        self.model.update_parameters(params)
        self.model.initialize()

    # ------------------------------------------------------------------
    # CamelCase aliases
    # ------------------------------------------------------------------
    Initialize = initialize
    Run = run
    Step = step
    UpdateKernelParameters = update_kernel_parameters
    UpdateModelParameters = update_model_parameters
