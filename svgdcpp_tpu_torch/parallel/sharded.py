"""Multi-GPU SVGD: the particle axis split over the ranks of a group.

Port of ``svgdcpp_tpu.parallel.sharded`` (the JAX package's ``shard_map``
engine) onto ``torch.distributed``. Each rank owns n/D contiguous particle
rows on its own device; the two globally coupled computations run over the
group's collectives (``parallel/mesh.ParticleGroup``):

  1. phi's cross-rank kernel blocks: this rank's rows against the gathered
     global set (one all-gather of the coordinates and one of the scores per
     step), or, with ``fused_sym``, this rank's chunk of the GLOBAL upper
     triangle, whose raw accumulators are summed over the group before each
     rank finishes its band;
  2. the global pairwise-distance median: per-rank int64 threshold counts
     summed over the group, then the same deterministic selection on every
     rank.

Scores, the optimizer and the position update are local. ``local_step`` of
the JAX package is ``ShardedSVGD._step``, a plain function of this rank's
tensors that ``step_state``/``run_state`` call once per step; each
``all_gather`` / ``psum`` / ``pmax`` is a collective on the group.

Ported: gather mode (cold and warm median), the fused single sweep
(``fused_phi``) as the cross sweep, the full-width triangle ("full") and
the panel triangle ("panel"), the built-in RBF and composed kernels that
flatten to RBF terms, MEDIAN / HESSIAN / CONSTANT scales, bounds,
annealing, ``track_stats`` and parameter hot-swap. ``phi_mode='ring'``, the
generic (VJP) kernel path, intermediate-matrix logging and custom hooks
raise NotImplementedError naming their ROADMAP.md item; checkpoints are
the caller's (``init_state``/``run_state`` take and return the state).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from ..core.exceptions import DimensionMismatchError, UnsetError
from ..core.types import as_tensor
from ..kernels.algebra import (
    flatten_rbf_terms,
    fused_terms_eligible,
    fused_terms_statically_positive,
    matrix_is_psd,
    refill_median_slots,
    term_psd_flags,
)
from ..kernels.gaussian_rbf import ScaleMethod, scale_from_median
from ..models.model import params_on
from ..ops.cuda_phi import (
    check_dimension,
    phi_rbf_fused_cuda_cross,
    phi_rbf_fused_sym_chunk_cuda,
    phi_rbf_sympanel_chunk_cuda,
    phi_rbf_terms_fused_cuda_cross,
    phi_rbf_terms_fused_sym_chunk_cuda,
)
from ..ops.median import (
    SELECT_DTYPE,
    centered_count_env,
    fused_lag1_plan,
    fused_median_from_counts,
    fused_median_seed,
    kth_smallest_bisect,
    median_sq_bracket_from_sample,
    warm_median_select,
)
from ..ops.phi import (
    phi_rbf_cross,
    phi_rbf_cross_fused_counts,
    phi_rbf_fused_sym_finish,
    phi_rbf_terms_cross,
    phi_rbf_terms_cross_fused_counts,
    phi_rbf_terms_fused_sym_finish,
)
from ..ops.sym_plan import sym_panel_sharded_plan, sym_sharded_plan
from ..svgd import SVGD, _not_ported, _skip_section
from .mesh import ParticleGroup, initialize_distributed, place_replicated


# ----------------------------------------------------------------------
# Collective building blocks
# ----------------------------------------------------------------------


def sharded_pairwise_median(coords_local, sources_global, group, *,
                            bins: int = 16, passes: int = 6,
                            row_tile: int = 512):
    """Global median of all n^2 pairwise distances, on every rank.

    ``coords_local`` is this rank's rows, ``sources_global`` the gathered
    global set. Per-rank int64 threshold counts are summed over the group
    (``ops/median.centered_count_env``) and the count bisection is the same
    on every rank, so every rank returns the same median. Even-count
    semantics follow the reference (GaussianRBFKernel.hpp:224-245)."""
    n = sources_global.shape[0]
    total = n * n
    count_fn, hi0 = centered_count_env(
        coords_local, sources_global, group=group, n_global=n,
        row_tile=row_tile,
    )
    ks = (total // 2, total // 2 + 1) if total % 2 == 0 else ((total + 1) // 2,)
    mids = kth_smallest_bisect(count_fn, ks, 0.0, hi0, bins=bins, passes=passes)
    return torch.mean(torch.sqrt(mids))


def sharded_median_scale(coords_local, sources_global, group, **kwargs):
    """P = log(n)/median^2 * I with the group's median."""
    n, m = sources_global.shape
    med = sharded_pairwise_median(coords_local, sources_global, group,
                                  **kwargs)
    return scale_from_median(med, n, m, coords_local.dtype)


def sharded_hessian_scale(coords_local, hessian_fn: Callable, model_params,
                          group, n_global: int):
    """P = 1/(2 d n) * sum_i -hess log p(x_i), the sum over the group.
    ``hessian_fn`` is the model's ``hessian_log_density_pure``
    (reference GaussianRBFKernel.hpp:199-209)."""
    m = coords_local.shape[1]
    local_sum = torch.sum(
        vmap(lambda x: hessian_fn(x, model_params))(coords_local), dim=0
    )
    return -group.all_reduce_sum(local_sum) / (2.0 * m * n_global)


def _band(acc, group, n_local):
    """This rank's columns of a (rows, n) accumulator."""
    return acc[:, group.rank * n_local:(group.rank + 1) * n_local]


def sym_sharded_phi(coords_local, scores_local, sources, scores_global,
                    group, thresholds, *, gamma=None, gammas=None,
                    signs=None):
    """The full-width triangle schedule (the counterpart of the JAX
    package's ``sym_sharded_phi``): this rank's chunk of the GLOBAL tile
    list through the chunk wrapper (K4 for one RBF's ``gamma``, K10/K11 for
    a composed kernel's ``gammas`` and ``signs``), the raw (2m, n)
    accumulator and int64 upper counts summed over the group, this rank's
    band finished. The self-pair correction and 2U - n run once, on the
    sums. Returns (phi_local, counts (T,) int64 global)."""
    n = sources.shape[0]
    if gammas is None:
        acc, upper = phi_rbf_fused_sym_chunk_cuda(
            sources, scores_global, gamma, thresholds, group.world_size,
            group.rank,
        )
    else:
        acc, upper = phi_rbf_terms_fused_sym_chunk_cuda(
            sources, scores_global, gammas, signs, thresholds,
            group.world_size, group.rank,
        )
    acc = group.all_reduce_sum(acc)
    upper = group.all_reduce_sum(upper)
    band = _band(acc, group, coords_local.shape[0])
    scores_band = scores_local.to(acc.dtype)
    if gammas is None:
        phi = phi_rbf_fused_sym_finish(band, scores_band, gamma, n)
    else:
        phi = phi_rbf_terms_fused_sym_finish(band, scores_band, signs, n)
    return phi.to(coords_local.dtype), 2 * upper - n


def sym_panel_sharded_phi(coords_local, scores_local, sources, scores_global,
                          group, thresholds, *, gamma):
    """The panel triangle schedule of one RBF (the counterpart of the JAX
    package's ``sym_panel_sharded_phi``): this rank's chunk of the card's
    panel list through K5's wrapper, scattered onto the (2m, n)
    accumulator, summed over the group with the upper counts, this rank's
    band finished. Returns (phi_local, counts (T,) int64 global)."""
    n = sources.shape[0]
    acc, upper = phi_rbf_sympanel_chunk_cuda(
        sources, scores_global, gamma, thresholds, group.world_size,
        group.rank,
    )
    acc = group.all_reduce_sum(acc)
    upper = group.all_reduce_sum(upper)
    band = _band(acc, group, coords_local.shape[0])
    phi = phi_rbf_fused_sym_finish(band, scores_local.to(acc.dtype), gamma, n)
    return phi.to(coords_local.dtype), 2 * upper - n


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ShardedSVGDConfig:
    """Config of the sharded step (the JAX package's ShardedSVGDConfig).

    ``fused_cuda`` is ``fused_pallas``'s counterpart: the fused sweep
    through the CUDA kernels; None = auto, on when the group's device is a
    CUDA device and the kernel qualifies (the built-in RBF, or every
    effective term gamma provably positive); True forces it (on the CPU its
    wrappers run their plain versions); False keeps the plain sweep.
    ``fused_sym``: None = the JAX decision for the global n, m and the
    group's world size (full-width triangle while the TPU's accumulator
    budget holds, else the panel form for the built-in RBF, else the cross
    sweep); True = that decision, raising where it is the cross sweep;
    "full" / "panel" force the form at any n; False keeps the cross sweep.
    """

    scale_method: ScaleMethod = ScaleMethod.MEDIAN
    constant_scale: Any = None  # (m, m) for ScaleMethod.CONSTANT
    lower_bound: Any = None
    upper_bound: Any = None
    median_bins: int = 16
    median_passes: int = 6
    row_tile: int = 1024
    #: 'gather' (one all-gather per step); 'ring' is not ported yet.
    phi_mode: str = "gather"
    #: Carry the median bracket across steps (one verified count pass per
    #: step instead of a full bisection; ops/median.warm_median_select).
    warm_start: bool = True
    #: (num_iterations,) array or callable iteration -> tau scaling the
    #: scores; None = no annealing.
    annealing: Any = None
    #: Record per-step stats (phi RMS, max step, bandwidth) in ``stats``.
    track_stats: bool = False
    #: ONE sweep per step gives phi (lag-1 median) and this step's
    #: selection counts, summed over the group. Gather mode + MEDIAN only;
    #: with a composed kernel, the fused-terms form.
    fused_phi: bool = False
    fused_bins: int = 2
    #: 'float32' only (the bfloat16 opt-in is not ported).
    fused_dot_dtype: str = "float32"
    fused_cuda: Optional[bool] = None
    fused_sym: Any = None
    #: 'auto' / 'rbf_terms' (the algebraic terms path) / 'generic' (not
    #: ported yet).
    kernel_phi: str = "auto"
    log_intermediate_matrices: bool = False
    intermediate_matrices_output_path: str = "log.txt"
    #: The JAX package's name of ``fused_cuda``: raises, naming it.
    fused_pallas: Any = None

    def __post_init__(self):
        if self.fused_pallas is not None:
            raise ValueError(
                "fused_pallas is the JAX package's option; its CUDA "
                "counterpart is 'fused_cuda'"
            )
        if self.kernel_phi not in ("auto", "rbf_terms", "generic"):
            raise ValueError(
                "kernel_phi must be 'auto', 'rbf_terms' or 'generic', "
                f"got {self.kernel_phi!r}"
            )
        if self.phi_mode not in ("gather", "ring"):
            raise ValueError(
                f"phi_mode must be 'gather' or 'ring', got {self.phi_mode!r}"
            )
        if self.scale_method == ScaleMethod.CONSTANT and self.constant_scale is None:
            raise ValueError(
                "ScaleMethod.CONSTANT requires constant_scale to be set."
            )
        if self.fused_sym not in (None, False, True, "full", "panel"):
            raise ValueError(
                "fused_sym must be None, False, True, 'full' or 'panel', "
                f"got {self.fused_sym!r}"
            )
        if self.fused_phi:
            if self.scale_method != ScaleMethod.MEDIAN:
                raise ValueError("fused_phi requires ScaleMethod.MEDIAN.")
            if self.phi_mode != "gather":
                raise ValueError("fused_phi currently requires phi_mode='gather'.")
        elif self.fused_cuda:
            raise ValueError("fused_cuda=True requires fused_phi=True.")
        if self.fused_sym and not self.fused_phi:
            raise ValueError("fused_sym=True requires fused_phi=True.")
        if self.log_intermediate_matrices and self.phi_mode != "gather":
            raise ValueError(
                "log_intermediate_matrices requires phi_mode='gather' (the "
                "debug dump rebuilds the global kernel matrices from the "
                "gathered source set)."
            )


class ShardedSVGD:
    """SVGD over the particle axis of a ParticleGroup (the JAX package's
    ShardedSVGD, same constructor and methods; ``mesh`` is the group, by
    default :func:`initialize_distributed`'s: the default group's, or a
    one-rank world where none exists).

    Each rank builds the engine with the same arguments and calls the same
    methods in the same order: the collectives pair up across the ranks.
    ``init_state(coords)`` takes the GLOBAL (n, m) coordinates (every rank
    the same) and keeps this rank's rows; ``run`` returns the gathered
    global coordinates.

    ``kernel=None``: the built-in Gaussian RBF, bandwidth by
    ``config.scale_method``. ``kernel=<Kernel>``: a `+ - * /` composition
    of pure RBF kernels (kernels/algebra.py); every adaptive slot is
    refilled each step with the group's median or Hessian.
    """

    def __init__(self, model, optimizer, num_particles: int, dimension: int,
                 mesh: Optional[ParticleGroup] = None,
                 config: Optional[ShardedSVGDConfig] = None, kernel=None):
        self.model = model
        self.optimizer = optimizer
        self.kernel = kernel
        self.mesh = mesh if mesh is not None else initialize_distributed()
        self.config = config or ShardedSVGDConfig()
        self.num_particles = int(num_particles)
        self.dimension = int(dimension)
        cfg = self.config
        n_dev = self.mesh.world_size
        if self.num_particles % n_dev != 0:
            raise DimensionMismatchError(
                f"num_particles ({self.num_particles}) must divide evenly "
                f"over {n_dev} ranks. Do NOT pad the particle set with "
                "duplicates: padded particles participate in phi and the "
                "median and bias the posterior."
            )
        if cfg.phi_mode == "ring":
            raise _not_ported("phi_mode='ring'",
                              "item 11 (parallel/ring.py)")
        if cfg.log_intermediate_matrices:
            raise _not_ported("log_intermediate_matrices=True",
                              "item 12 (the debug dump)")
        if cfg.fused_dot_dtype != "float32":
            raise _not_ported(f"fused_dot_dtype={cfg.fused_dot_dtype!r}",
                              "item 15 (the bfloat16 operand opt-in)")
        if kernel is not None:
            kernel.initialize()
            self._adaptive_slots = kernel.adaptive_slots()
            if cfg.kernel_phi == "generic":
                raise _not_ported("kernel_phi='generic'",
                                  "item 9a (the generic route)")
            self._rbf_terms = flatten_rbf_terms(kernel)
            if self._rbf_terms is None:
                if cfg.kernel_phi == "rbf_terms":
                    raise ValueError(
                        "kernel_phi='rbf_terms' requires a `+ - * /` "
                        "composition of pure GaussianRBFKernels (see "
                        "kernels/algebra.py)."
                    )
                raise _not_ported("a kernel that is not an RBF composition",
                                  "item 9a (the generic route)")
            self._validate_fused_kernel()
        else:
            self._adaptive_slots = []
            self._rbf_terms = None
        if self._has_custom_hooks():
            raise _not_ported("custom model or kernel Step hooks",
                              "item 12 (the eager hook loop)")
        self._refresh_psd()
        if cfg.scale_method == ScaleMethod.HESSIAN:
            self._rbf_psd = False
        elif cfg.scale_method == ScaleMethod.CONSTANT:
            self._rbf_psd = matrix_is_psd(as_tensor(cfg.constant_scale))
        else:
            self._rbf_psd = True
        self._state = None
        self.stats = None
        #: Bisection fallbacks taken by the fused median update.
        self.median_fallbacks = 0
        #: Called with each section's name as the step ends it (scores,
        #: gather, plan, sweep, median, optimizer on the fused step; scores,
        #: gather, scale, sweep, optimizer on the others), for a profiler
        #: to time the step, as SVGD.section_hook.
        self.section_hook = None
        self._fused_cuda = self._resolve_fused_cuda()
        self._fused_sym = self._resolve_fused_sym()

    def _validate_fused_kernel(self):
        """Composed-kernel fused mode: every term must collapse to an
        isotropic gamma_t * sq (re-run on hot-swap)."""
        if not self.config.fused_phi:
            return
        if not fused_terms_eligible(
            self._rbf_terms, self._adaptive_slots, self.kernel.parameters
        ):
            raise ValueError(
                "fused_phi with a kernel requires a `+ - * /` tree "
                "of pure RBFs whose adaptive slots are all median-"
                "scaled and whose constant slots are isotropic "
                "(gamma * I); use kernel_phi='rbf_terms' for the general "
                "case."
            )

    def _resolve_fused_cuda(self) -> bool:
        """Whether the fused sweep goes through the CUDA wrappers (see
        ShardedSVGDConfig.fused_cuda)."""
        cfg = self.config
        if not cfg.fused_phi or cfg.fused_cuda is False:
            return False
        on_cuda = self.mesh.device.type == "cuda"
        kernel_ok = self.kernel is None or fused_terms_statically_positive(
            self._rbf_terms, self._adaptive_slots, self.kernel.parameters
        )
        if cfg.fused_cuda is None:
            use = on_cuda and kernel_ok
        elif not kernel_ok:
            raise ValueError(
                "fused_cuda requires every effective term gamma to be "
                "provably positive (no division terms, positive constant "
                "scales)."
            )
        else:
            use = True
        if use and on_cuda:
            check_dimension(self.dimension)
        return use

    def _resolve_fused_sym(self):
        """The form of the fused sweep: "full", "panel" or False (see
        ShardedSVGDConfig.fused_sym). The JAX decision chunks by the
        group's world size."""
        cfg = self.config
        if cfg.fused_sym is False or not cfg.fused_phi:
            return False
        n, m, world = self.num_particles, self.dimension, self.mesh.world_size
        if cfg.fused_sym in ("full", "panel"):
            if not self._fused_cuda:
                raise ValueError(
                    f"fused_sym={cfg.fused_sym!r} requires the CUDA fused "
                    "sweep (fused_cuda)."
                )
            if cfg.fused_sym == "panel" and self.kernel is not None:
                raise ValueError(
                    "fused_sym='panel' takes the built-in single RBF only "
                    "(the JAX package has no sharded composed panel sweep)."
                )
            return cfg.fused_sym
        mode = False
        if self._fused_cuda:
            if sym_sharded_plan(n, m, world) is not None:
                mode = "full"
            elif self.kernel is None and sym_panel_sharded_plan(
                n, m, world
            ) is not None:
                mode = "panel"
        if cfg.fused_sym is None:
            return mode
        if not mode:
            raise ValueError(
                "fused_sym=True requires the CUDA fused sweep (fused_cuda) "
                "and a global particle count in the triangle regime: "
                "full-width ((2m+1, n_pad) accumulator within the TPU "
                "budget, ops/sym_plan.sym_sharded_plan) or the single-RBF "
                "panel regime (ops/sym_plan.sym_panel_sharded_plan); "
                "'full' or 'panel' force a form at any n."
            )
        return mode

    def _refresh_psd(self):
        """Per-term PSD clamp flags of a composed kernel (re-run on
        hot-swap)."""
        if self._rbf_terms is not None:
            self._term_psd = term_psd_flags(
                self._rbf_terms, self._adaptive_slots, self.kernel.parameters
            )
        else:
            self._term_psd = None

    def update_kernel_parameters(self, params):
        """Hot-swap composed-kernel parameters; takes effect at the next
        init_state()/run(coords)."""
        if self.kernel is None:
            raise UnsetError(
                "update_kernel_parameters requires a composed/user kernel; "
                "the built-in RBF fast path's scale is governed by "
                "config.scale_method."
            )
        self.kernel.update_parameters(params)
        self.kernel.initialize()
        self._refresh_trace_flags()

    UpdateKernelParameters = update_kernel_parameters

    def _refresh_trace_flags(self):
        """Re-derive the fused eligibility, the PSD flags and the sweep's
        route from the kernel's current values."""
        self._validate_fused_kernel()
        self._refresh_psd()
        self._fused_cuda = self._resolve_fused_cuda()
        self._fused_sym = self._resolve_fused_sym()

    def _has_custom_hooks(self) -> bool:
        if SVGD._hook_override(self.model, SVGD._MODEL_BASE_HOOKS) is not None:
            return True
        return (
            self.kernel is not None
            and SVGD._hook_override(self.kernel, SVGD._KERNEL_BASE_HOOKS)
            is not None
        )

    # ------------------------------------------------------------------
    @property
    def _has_median(self) -> bool:
        if self.kernel is not None:
            return any(o.scale_method == ScaleMethod.MEDIAN
                       for _, o in self._adaptive_slots)
        return self.config.scale_method == ScaleMethod.MEDIAN

    @property
    def _warm(self) -> bool:
        return self.config.warm_start and self._has_median

    def _scale(self, coords_local, sources, model_params):
        cfg = self.config
        if cfg.scale_method == ScaleMethod.MEDIAN:
            return sharded_median_scale(
                coords_local, sources, self.mesh, bins=cfg.median_bins,
                passes=cfg.median_passes, row_tile=cfg.row_tile,
            )
        if cfg.scale_method == ScaleMethod.HESSIAN:
            return sharded_hessian_scale(
                coords_local, self.model.hessian_log_density_pure,
                model_params, self.mesh, self.num_particles,
            )
        return as_tensor(cfg.constant_scale).to(
            dtype=coords_local.dtype, device=coords_local.device
        )

    def _median_scale_warm(self, coords_local, sources, scale_aux):
        """Warm-started group median (ops/median.warm_median_select)."""
        cfg = self.config
        n = self.num_particles
        total = n * n
        lo1_d, hi1_d, lo2_d, hi2_d, disp = scale_aux
        count_fn, hi0 = centered_count_env(
            coords_local, sources, group=self.mesh, n_global=n,
            row_tile=cfg.row_tile,
        )

        def sample_fn():
            # The gathered sources are the same on every rank, so is the
            # sample.
            return median_sq_bracket_from_sample(sources, min(1 << 16, total))

        med, n_lo1, n_hi1, n_lo2, n_hi2 = warm_median_select(
            count_fn, total, hi0, lo1_d, hi1_d, lo2_d, hi2_d, disp,
            sample_bracket_fn=sample_fn, bins=cfg.median_bins,
            passes=cfg.median_passes,
        )
        scale = scale_from_median(med, n, coords_local.shape[1],
                                  coords_local.dtype)
        return scale, (n_lo1, n_hi1, n_lo2, n_hi2, disp)

    def _slot_scales(self, coords_local, sources, model_params, scale_aux,
                     kparams, slot_mparams):
        """Refill every adaptive slot of a composed kernel: the shared
        median scale once, each Hessian slot from its own model."""
        cfg = self.config
        kparams = list(kparams)
        med_scale = None
        if self._has_median:
            if self._warm:
                med_scale, scale_aux = self._median_scale_warm(
                    coords_local, sources, scale_aux
                )
            else:
                med_scale = sharded_median_scale(
                    coords_local, sources, self.mesh, bins=cfg.median_bins,
                    passes=cfg.median_passes, row_tile=cfg.row_tile,
                )
        for i, (idx, owner) in enumerate(self._adaptive_slots):
            if owner.scale_method == ScaleMethod.MEDIAN:
                kparams[idx] = med_scale.to(kparams[idx].dtype)
            elif owner.scale_method == ScaleMethod.HESSIAN:
                mp = (model_params if owner.target_model is self.model
                      else slot_mparams[i])
                kparams[idx] = sharded_hessian_scale(
                    coords_local, owner.target_model.hessian_log_density_pure,
                    mp, self.mesh, self.num_particles,
                ).to(kparams[idx].dtype)
        return tuple(kparams), scale_aux

    def _fused_sweep(self, coords_local, scores_local, sources, kparams,
                     scale_aux, section):
        """The fused step's sweep and median update: phi with the previous
        step's verified median and this step's counts, summed over the
        group."""
        cfg, group = self.config, self.mesh
        n = self.num_particles
        fused_terms = self.kernel is not None
        lo1_b, hi1_b, lo2_b, hi2_b, disp_a, med = scale_aux
        fdt = med.dtype
        aux = {"med": med, "lo1": lo1_b, "hi1": hi1_b, "lo2": lo2_b,
               "hi2": hi2_b, "disp": disp_a}
        gamma, sel = fused_lag1_plan(aux, n, int(cfg.fused_bins),
                                     coords_local.dtype)
        thresholds = sel["edges"]
        if fused_terms:
            signs = [s for s, _ in self._rbf_terms]
            kparams, gammas = refill_median_slots(
                kparams, [idx for idx, _ in self._adaptive_slots], gamma,
                self.dimension, coords_local.dtype,
                [plist for _, plist in self._rbf_terms],
            )
        else:
            kparams = (gamma * torch.eye(self.dimension, dtype=coords_local.dtype,
                                         device=coords_local.device),)
        section("plan")
        scores = group.all_gather_rows(scores_local)
        if self._fused_sym == "panel":
            phi_local, counts = sym_panel_sharded_phi(
                coords_local, scores_local, sources, scores, group,
                thresholds, gamma=gamma,
            )
        elif self._fused_sym:
            phi_local, counts = sym_sharded_phi(
                coords_local, scores_local, sources, scores, group,
                thresholds, gamma=None if fused_terms else gamma,
                gammas=gammas if fused_terms else None,
                signs=signs if fused_terms else None,
            )
        else:
            if fused_terms and self._fused_cuda:
                phi_local, counts_local = phi_rbf_terms_fused_cuda_cross(
                    coords_local, sources, scores, gammas, signs, thresholds,
                )
            elif fused_terms:
                phi_local, counts_local = phi_rbf_terms_cross_fused_counts(
                    coords_local, sources, scores, gammas, signs, thresholds,
                    cfg.row_tile,
                )
            elif self._fused_cuda:
                phi_local, counts_local = phi_rbf_fused_cuda_cross(
                    coords_local, sources, scores, gamma, thresholds,
                )
            else:
                phi_local, counts_local = phi_rbf_cross_fused_counts(
                    coords_local, sources, scores, gamma, thresholds,
                    cfg.row_tile,
                )
            counts = group.all_reduce_sum(counts_local)
        section("sweep")
        med_new, lo1, hi1, lo2, hi2, fell_back = fused_median_from_counts(
            counts, sel, n * n,
            lambda: centered_count_env(
                coords_local, sources, group=group, n_global=n,
                row_tile=cfg.row_tile,
            ),
            initialized=hi1_b >= lo1_b,
        )
        if fell_back:
            self.median_fallbacks += 1
        scale_aux = (lo1.to(fdt), hi1.to(fdt), lo2.to(fdt), hi2.to(fdt),
                     disp_a, med_new.to(fdt))
        section("median")
        return phi_local, kparams, scale_aux

    def _step(self, state):
        """One step of this rank (the JAX package's ``local_step``): state
        -> (state, stats | None)."""
        cfg, group = self.config, self.mesh
        n = self.num_particles
        section = self.section_hook or _skip_section
        coords_local = state["coords"]
        mparams = state["model_params"]
        kparams = state["kernel_params"]
        scale_aux = state["scale_aux"]
        scores_local = vmap(
            lambda x: self.model.grad_log_density_pure(x, mparams)
        )(coords_local)
        if self._annealing is not None:
            tau = self._annealing(state["iteration"])
            scores_local = scores_local * torch.as_tensor(
                tau, dtype=scores_local.dtype, device=scores_local.device
            )
        section("scores")
        # One gather shared by the bandwidth and phi.
        sources = group.all_gather_rows(coords_local)
        section("gather")
        if self.kernel is not None and not cfg.fused_phi:
            kparams, scale_aux = self._slot_scales(
                coords_local, sources, mparams, scale_aux, kparams,
                state["slot_model_params"],
            )
            section("scale")
            scores = group.all_gather_rows(scores_local)
            phi_local = phi_rbf_terms_cross(
                coords_local, sources, scores, kparams, self._rbf_terms,
                cfg.row_tile, psd_flags=self._term_psd,
            )
            section("sweep")
        elif cfg.fused_phi:
            phi_local, kparams, scale_aux = self._fused_sweep(
                coords_local, scores_local, sources, kparams, scale_aux,
                section,
            )
        else:
            if self._warm:
                p_matrix, scale_aux = self._median_scale_warm(
                    coords_local, sources, scale_aux
                )
            else:
                p_matrix = self._scale(coords_local, sources, mparams)
            kparams = (p_matrix,)
            section("scale")
            scores = group.all_gather_rows(scores_local)
            phi_local = phi_rbf_cross(
                coords_local, sources, scores, p_matrix, cfg.row_tile,
                psd=self._rbf_psd,
            )
            section("sweep")
        if getattr(self.optimizer, "needs_params", False):
            opt_state, inc = self.optimizer.step(
                state["opt_state"], phi_local, coords_local
            )
        else:
            opt_state, inc = self.optimizer.step(state["opt_state"], phi_local)
        new_coords = coords_local + inc
        lower, upper = self._bounds
        if lower is not None:
            new_coords = torch.maximum(new_coords, lower.to(new_coords.dtype))
        if upper is not None:
            new_coords = torch.minimum(new_coords, upper.to(new_coords.dtype))
        moved_sq = torch.sum((new_coords - coords_local) ** 2, dim=1)
        if self._warm or cfg.fused_phi:
            # The max displacement over the group -> the next bracket.
            disp = torch.sqrt(group.all_reduce_max(torch.max(moved_sq)))
            scale_aux = (tuple(scale_aux[:4])
                         + (disp.to(scale_aux[4].dtype),)
                         + tuple(scale_aux[5:]))
        stats = None
        if cfg.track_stats:
            m = coords_local.shape[1]
            phi_rms = torch.sqrt(
                group.all_reduce_sum(torch.sum(phi_local * phi_local))
                / (n * m)
            )
            step_max = torch.sqrt(group.all_reduce_max(torch.max(moved_sq)))
            if kparams and getattr(kparams[0], "ndim", 0) == 2:
                bandwidth = kparams[0][0, 0]
            else:
                bandwidth = torch.full((), float("nan"),
                                       dtype=coords_local.dtype,
                                       device=coords_local.device)
            stats = {"phi_rms": phi_rms, "step_max": step_max,
                     "bandwidth": bandwidth}
        section("optimizer")
        return {
            "coords": new_coords,
            "opt_state": opt_state,
            "model_params": mparams,
            "kernel_params": tuple(kparams),
            "slot_model_params": state["slot_model_params"],
            "scale_aux": tuple(scale_aux),
            "iteration": state["iteration"] + 1,
        }, stats

    def _prepare_step(self, device, dtype):
        """The per-run constants of the step: bounds and annealing on the
        device."""
        cfg = self.config

        def bound(b):
            if b is None:
                return None
            b = as_tensor(b).to(dtype=dtype, device=device).reshape(-1)
            if b.shape[0] == 1:
                b = b.expand(self.dimension)
            elif b.shape[0] != self.dimension:
                raise DimensionMismatchError(
                    "The provided bounds have incorrect dimensions."
                )
            return b

        self._bounds = (bound(cfg.lower_bound), bound(cfg.upper_bound))
        annealing = cfg.annealing
        if annealing is not None and not callable(annealing):
            arr = as_tensor(annealing).to(device)
            last = arr.shape[0] - 1
            annealing = lambda it: arr[min(max(int(it), 0), last)]  # noqa: E731
        self._annealing = annealing

    # ------------------------------------------------------------------
    def init_state(self, coords):
        """This rank's state from the GLOBAL (n, m) coordinates (every rank
        passes the same): its rows, a zeroed optimizer state split the same
        way, the parameters whole, and the median aux (the fused seed from
        the initial positions for fused_phi)."""
        if tuple(np.shape(coords)) != (self.num_particles, self.dimension):
            raise DimensionMismatchError(
                f"coords must be ({self.num_particles}, {self.dimension})."
            )
        if self.kernel is not None:
            self._refresh_trace_flags()
        group = self.mesh
        coords_global = place_replicated(coords, group)
        rows = group.rows(self.num_particles)
        local = coords_global[rows].contiguous()
        device, dtype = local.device, local.dtype
        opt_state = self.optimizer.shard_state(
            self.optimizer.init(dtype, device), rows)
        if self.kernel is not None:
            kparams = tuple(as_tensor(p).to(dtype=dtype, device=device)
                            for p in self.kernel.parameters)
        else:
            kparams = (torch.eye(self.dimension, dtype=dtype, device=device),)
        return {
            "coords": local,
            "opt_state": opt_state,
            "model_params": params_on(self.model.parameters, device, dtype),
            "kernel_params": kparams,
            "slot_model_params": tuple(
                params_on(owner.target_model.parameters, device, dtype)
                if getattr(owner, "target_model", None) is not None
                and owner.target_model is not self.model
                else None
                for _, owner in self._adaptive_slots
            ),
            "scale_aux": self._init_scale_aux(coords_global),
            "iteration": 0,
        }

    def _init_scale_aux(self, coords_global):
        device = coords_global.device
        if self.config.fused_phi:
            # The median of the INITIAL positions seeds the lag-1 pipeline
            # (the driver's fused_median_seed contract); a composed
            # kernel's first adaptive leaf reuses the median its
            # constructor took on the same coordinates.
            if self._adaptive_slots:
                seed = self._adaptive_slots[0][1].init_fused_aux(coords_global)
            else:
                seed = fused_median_seed(coords_global, "auto")
            return tuple(
                torch.as_tensor(seed[k], dtype=SELECT_DTYPE).to(device)
                for k in ("lo1", "hi1", "lo2", "hi2", "disp", "med")
            )
        # Warm layout: per-rank brackets + disp; hi < lo marks a cold start.
        return tuple(torch.tensor(v, dtype=SELECT_DTYPE, device=device)
                     for v in (0.0, -1.0, 0.0, -1.0, 0.0))

    def step_state(self, state):
        """One sharded step: state -> state (stats recorded if
        configured)."""
        c = state["coords"]
        self._prepare_step(c.device, c.dtype)
        state, stats = self._step(state)
        if stats is not None:
            self._record_stats([stats])
        self._state = state
        return state

    def run_state(self, state, num_steps: int):
        """State-in/state-out run: optimizer moments, the median brackets
        and the iteration count carry across calls."""
        c = state["coords"]
        self._prepare_step(c.device, c.dtype)
        collected = []
        for _ in range(int(num_steps)):
            state, stats = self._step(state)
            if stats is not None:
                collected.append(stats)
        if collected:
            self._record_stats(collected)
        self._state = state
        return state

    def _record_stats(self, collected):
        host = {k: torch.stack([s[k] for s in collected]).cpu().numpy()
                for k in collected[0]}
        if self.stats is None:
            self.stats = host
        else:
            self.stats = {k: np.concatenate([self.stats[k], host[k]])
                          for k in host}

    def run(self, coords=None, num_iterations: int = None):
        """Run num_iterations steps and return the gathered GLOBAL (n, m)
        coordinates. ``coords`` given: a fresh start from them; None:
        continue from the previous run's state."""
        if num_iterations is None or int(num_iterations) <= 0:
            raise ValueError(
                "run() requires a positive num_iterations "
                f"(got {num_iterations!r})."
            )
        if coords is not None:
            self._state = self.init_state(coords)
            self.stats = None
        elif self._state is None:
            raise RuntimeError(
                "run(coords=None) requires a previous run to continue from."
            )
        final = self.run_state(self._state, int(num_iterations))
        return self.mesh.all_gather_rows(final["coords"])
