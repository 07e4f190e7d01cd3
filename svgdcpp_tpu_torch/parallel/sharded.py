"""Multi-GPU SVGD: the particle axis split over the ranks of a group.

Port of ``svgdcpp_tpu.parallel.sharded`` (the JAX package's ``shard_map``
engine) onto ``torch.distributed``. Each rank owns n/D contiguous particle
rows on its own device; the two globally coupled computations run over the
group's collectives (``parallel/mesh.ParticleGroup``):

  1. phi's cross-rank kernel blocks: this rank's rows against the gathered
     global set (one all-gather of the coordinates and one of the scores per
     step), or, with ``fused_sym``, this rank's chunk of the GLOBAL upper
     triangle, whose raw accumulators are summed over the group before each
     rank finishes its band, or, with ``phi_mode='ring'``, the other ranks'
     blocks streamed round the ring with no gather (``parallel/ring.py``);
  2. the global pairwise-distance median: per-rank int64 threshold counts
     summed over the group, then the same deterministic selection on every
     rank.

Scores, the optimizer and the position update are local. ``local_step`` of
the JAX package is ``ShardedSVGD._step``, a plain function of this rank's
tensors that ``step_state``/``run_state`` call once per step; each
``all_gather`` / ``psum`` / ``pmax`` is a collective on the group.

Ported: gather mode (cold and warm median), the fused single sweep
(``fused_phi``) as the cross sweep, the full-width triangle ("full") and
the panel triangle ("panel"), the built-in RBF, composed kernels that
flatten to RBF terms and any other kernel through the generic (VJP) sweep
(``ops/phi.phi_generic_cross`` of the local rows against the gathered
sources), MEDIAN / HESSIAN / CONSTANT scales, bounds, annealing,
``track_stats``, intermediate-matrix logging (each rank's row bands of K
and grad-K, gathered into the global matrices), custom model or kernel
Step hooks (run eagerly before each step), parameter hot-swap,
checkpoints (the engine's states are ``ShardedState``s, which
``utils/checkpoint`` gathers and splits) and the ring schedule
(``phi_mode='ring'``: the built-in RBF, composed kernels as RBF terms and
any other kernel through the generic sweep, the median by count bisection
of ring counts, cold or warm; gather mode is what the fused sweep and the
debug dump need).
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
from ..kernels.gaussian_rbf import (
    ScaleMethod,
    rbf_kernel_fn,
    scale_from_median,
)
from ..models.model import params_on
from ..ops.cuda_phi import (
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
    dot_bf16,
    kernel_matrix_and_grad_cross,
    phi_generic_cross,
    phi_rbf_cross,
    phi_rbf_cross_fused_counts,
    phi_rbf_fused_sym_finish,
    phi_rbf_terms_cross,
    phi_rbf_terms_cross_fused_counts,
    phi_rbf_terms_fused_sym_finish,
)
from ..ops.sym_plan import (
    KERNEL_MAX_M,
    card_resolve_sym,
    sym_panel_sharded_plan,
    sym_sharded_plan,
)
from ..optimizers.base import _map_pair
from ..svgd import SVGD, _skip_section
from ..utils.logging import write_intermediate_matrices
from .mesh import ParticleGroup, initialize_distributed, place_replicated
from .ring import (
    ring_count_le,
    ring_median_scale,
    ring_phi_generic,
    ring_phi_rbf,
    ring_phi_rbf_terms,
)


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


def resolve_sharded_sym(fused_sym, fused_cuda: bool, n: int, m: int,
                        world: int, single_rbf: bool, num_terms=None,
                        dot_dtype: str = "float32"):
    """The form of the fused sweep over ``world`` ranks: "full", "panel"
    or False (the cross sweep), for ``fused_sym`` None (the JAX decision
    for the global n, m and the world size: the full-width triangle while
    the TPU's accumulator budget holds, ops/sym_plan.sym_sharded_plan, else
    the panel form for one RBF, else the cross sweep), True (that decision,
    raising where it is the cross sweep), "full" / "panel" (forced at any
    n and m) or False. The triangle forms need the CUDA sweep
    (``fused_cuda``; on CPU tensors its plain chunk versions run) and
    ``dot_dtype`` 'float32': under 'bfloat16' None takes the cross sweep
    and a forced form raises, as the JAX package's triangle chunks have no
    bf16 form (``sym_ok``, svgd.py:615; ``base_ok``, sharded.py:410). The
    engine's ``fused_sym`` and the driver's under ``SVGDOptions.mesh``
    resolve here.

    Past MAX_M (64) the TPU's budget, which sends wide shapes to the panel
    or the cross sweep, is not the card's: under None the card's rule for
    one RBF or ``num_terms`` terms (``sym_plan.card_resolve_sym``) picks
    "full" or the cross sweep; a forced "panel" runs K5's wide instance."""
    bf16 = dot_bf16(dot_dtype)
    if fused_sym is False:
        return False
    if bf16 and fused_sym is not None:
        raise ValueError(
            f"fused_sym={fused_sym!r} requires fused_dot_dtype='float32': "
            "the triangle chunks have no bfloat16 form (the JAX package's "
            "neither), so the bfloat16 opt-in takes the cross sweep; pass "
            "fused_sym=None or False."
        )
    if fused_sym in ("full", "panel"):
        if not fused_cuda:
            raise ValueError(
                f"fused_sym={fused_sym!r} requires the CUDA fused sweep "
                "(fused_cuda)."
            )
        if fused_sym == "panel" and not single_rbf:
            raise ValueError(
                "fused_sym='panel' takes the built-in single RBF only "
                "(the JAX package has no sharded composed panel sweep)."
            )
        return fused_sym
    mode = False
    if fused_cuda and not bf16:
        if m > KERNEL_MAX_M:
            mode = "full" if card_resolve_sym(n, m, num_terms) else False
        elif sym_sharded_plan(n, m, world) is not None:
            mode = "full"
        elif single_rbf and sym_panel_sharded_plan(n, m, world) is not None:
            mode = "panel"
    if fused_sym is None:
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


def sharded_fused_sweep(coords_local, scores_local, sources, scores_global,
                        group, thresholds, form, cuda: bool, *, gamma=None,
                        gammas=None, signs=None, row_tile: int = 1024,
                        dot_dtype: str = "float32"):
    """One fused sweep of this rank's rows over the group: phi_local and the
    GLOBAL int64 selection counts at ``thresholds``. ``form`` as
    :func:`resolve_sharded_sym` gives it: "panel" (K5's chunk), "full"
    (K4's chunk for one RBF's ``gamma``, K10/K11's for a composed kernel's
    ``gammas`` and ``signs``) or False: the local rows against the
    gathered sources, through K1 / the terms square kernel (K6/K7's port)
    when ``cuda`` and the plain cross sweeps otherwise, the counts summed
    over the group. ``dot_dtype`` reaches K1's cross form (its bf16
    instance, or on CPU tensors its plain version), as the JAX package
    passes it to ``phi_rbf_fused_pallas_cross`` alone. Shared by the engine
    and the driver under a mesh."""
    terms = gammas is not None
    if form == "panel":
        return sym_panel_sharded_phi(
            coords_local, scores_local, sources, scores_global, group,
            thresholds, gamma=gamma,
        )
    if form:
        return sym_sharded_phi(
            coords_local, scores_local, sources, scores_global, group,
            thresholds, gamma=None if terms else gamma,
            gammas=gammas if terms else None, signs=signs if terms else None,
        )
    if terms and cuda:
        phi_local, counts_local = phi_rbf_terms_fused_cuda_cross(
            coords_local, sources, scores_global, gammas, signs, thresholds,
        )
    elif terms:
        phi_local, counts_local = phi_rbf_terms_cross_fused_counts(
            coords_local, sources, scores_global, gammas, signs, thresholds,
            row_tile,
        )
    elif cuda:
        phi_local, counts_local = phi_rbf_fused_cuda_cross(
            coords_local, sources, scores_global, gamma, thresholds,
            dot_dtype=dot_dtype,
        )
    else:
        phi_local, counts_local = phi_rbf_cross_fused_counts(
            coords_local, sources, scores_global, gamma, thresholds, row_tile,
        )
    return phi_local, group.all_reduce_sum(counts_local)


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
    #: 'gather' (one all-gather per step) or 'ring' (the blocks rotate
    #: round the group, parallel/ring.py; no rank holds the global set).
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
    #: SVGDOptions.fused_dot_dtype: 'float32' (default) or 'bfloat16', the
    #: cross sweep's K1 bf16 instance for the built-in RBF (the triangle
    #: forms have none: fused_sym None takes the cross sweep under it, a
    #: forced form raises).
    fused_dot_dtype: str = "float32"
    fused_cuda: Optional[bool] = None
    fused_sym: Any = None
    #: 'auto' (RBF terms where the kernel flattens, else the generic VJP
    #: sweep) / 'rbf_terms' / 'generic'.
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
        dot_bf16(self.fused_dot_dtype)
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
        if kernel is not None:
            kernel.initialize()
            self._adaptive_slots = kernel.adaptive_slots()
            # `+ - * /` trees of pure RBF kernels flatten to signed
            # closed-form terms (kernels/algebra.py); any other kernel, or
            # kernel_phi='generic', takes the generic VJP sweep.
            self._rbf_terms = (
                None if cfg.kernel_phi == "generic"
                else flatten_rbf_terms(kernel)
            )
            if cfg.kernel_phi == "rbf_terms" and self._rbf_terms is None:
                raise ValueError(
                    "kernel_phi='rbf_terms' requires a `+ - * /` "
                    "composition of pure GaussianRBFKernels (see "
                    "kernels/algebra.py)."
                )
            self._validate_fused_kernel()
        else:
            self._adaptive_slots = []
            self._rbf_terms = None
        self._refresh_psd()
        if cfg.scale_method == ScaleMethod.HESSIAN:
            self._rbf_psd = False
        elif cfg.scale_method == ScaleMethod.CONSTANT:
            self._rbf_psd = matrix_is_psd(as_tensor(cfg.constant_scale))
        else:
            self._rbf_psd = True
        self._state = None
        self.stats = None
        #: Per-call chunks of the debug matrices (see intermediate_logs).
        self._intermediate_log_chunks = None
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
        return use

    def _resolve_fused_sym(self):
        """The form of the fused sweep: "full", "panel" or False (see
        ShardedSVGDConfig.fused_sym and :func:`resolve_sharded_sym`)."""
        cfg = self.config
        if not cfg.fused_phi:
            return False
        return resolve_sharded_sym(
            cfg.fused_sym, self._fused_cuda, self.num_particles,
            self.dimension, self.mesh.world_size, self.kernel is None,
            num_terms=(None if self._rbf_terms is None
                       else len(self._rbf_terms)),
            dot_dtype=cfg.fused_dot_dtype,
        )

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

    # Hooks (reference Model::Step / Kernel::Step, Model.hpp:413 /
    # Kernel.hpp:356): a custom per-step hook runs on the host before each
    # step, and the state re-reads the parameters it may have changed.
    def _has_custom_hooks(self) -> bool:
        if SVGD._hook_override(self.model, SVGD._MODEL_BASE_HOOKS) is not None:
            return True
        return (
            self.kernel is not None
            and SVGD._hook_override(self.kernel, SVGD._KERNEL_BASE_HOOKS)
            is not None
        )

    def _eager_hooks(self):
        hook = SVGD._hook_override(self.model, SVGD._MODEL_BASE_HOOKS)
        if hook is not None:
            hook()
        if self.kernel is not None:
            hook = SVGD._hook_override(self.kernel, SVGD._KERNEL_BASE_HOOKS)
            if hook is not None:
                hook()

    def _refresh_component_params(self, state):
        """The state with the model's and kernel's current parameters
        (after the hooks ran), the kernel's route flags re-derived."""
        state = ShardedState(state, self)
        c = state["coords"]
        state["model_params"] = params_on(self.model.parameters, c.device,
                                          c.dtype)
        if self.kernel is not None:
            state["kernel_params"] = tuple(
                as_tensor(p).to(dtype=c.dtype, device=c.device)
                for p in self.kernel.parameters
            )
            self._refresh_trace_flags()
            state["slot_model_params"] = self._slot_model_params(c.device,
                                                                 c.dtype)
        return state

    def _slot_model_params(self, device, dtype):
        """Foreign-model parameters per adaptive slot (None where the slot
        has no model or the engine's own)."""
        return tuple(
            params_on(owner.target_model.parameters, device, dtype)
            if getattr(owner, "target_model", None) is not None
            and owner.target_model is not self.model
            else None
            for _, owner in self._adaptive_slots
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

    def _cold_median_scale(self, coords_local, sources):
        """The group's median scale by full count bisection: gathered
        sources, or ring counts in ring mode (``sources`` None)."""
        cfg = self.config
        kw = dict(bins=cfg.median_bins, passes=cfg.median_passes,
                  row_tile=cfg.row_tile)
        if sources is None:
            return ring_median_scale(coords_local, self.mesh,
                                     self.num_particles, **kw)
        return sharded_median_scale(coords_local, sources, self.mesh, **kw)

    def _scale(self, coords_local, sources, model_params):
        cfg = self.config
        if cfg.scale_method == ScaleMethod.MEDIAN:
            return self._cold_median_scale(coords_local, sources)
        if cfg.scale_method == ScaleMethod.HESSIAN:
            return sharded_hessian_scale(
                coords_local, self.model.hessian_log_density_pure,
                model_params, self.mesh, self.num_particles,
            )
        return as_tensor(cfg.constant_scale).to(
            dtype=coords_local.dtype, device=coords_local.device
        )

    def _median_scale_warm(self, coords_local, sources, scale_aux):
        """Warm-started group median (ops/median.warm_median_select). In
        ring mode (``sources`` None) the counts stream round the ring and
        there is no sample bracket: sampling pairs needs the global set."""
        cfg = self.config
        n = self.num_particles
        total = n * n
        lo1_d, hi1_d, lo2_d, hi2_d, disp = scale_aux
        count_fn, hi0 = centered_count_env(
            coords_local, sources, group=self.mesh, n_global=n,
            row_tile=cfg.row_tile,
        )
        if sources is None:
            def count_fn(thr):
                return ring_count_le(coords_local, thr, self.mesh, n,
                                     row_tile=cfg.row_tile)

            sample_fn = None
        else:
            def sample_fn():
                # The gathered sources are the same on every rank, so is
                # the sample.
                return median_sq_bracket_from_sample(sources,
                                                     min(1 << 16, total))

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
                med_scale = self._cold_median_scale(coords_local, sources)
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
        phi_local, counts = sharded_fused_sweep(
            coords_local, scores_local, sources, scores, group, thresholds,
            self._fused_sym, self._fused_cuda,
            gamma=None if fused_terms else gamma,
            gammas=gammas if fused_terms else None,
            signs=signs if fused_terms else None, row_tile=cfg.row_tile,
            dot_dtype=cfg.fused_dot_dtype,
        )
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
        ring = cfg.phi_mode == "ring"
        # One gather shared by the bandwidth and phi; none in ring mode.
        sources = None if ring else group.all_gather_rows(coords_local)
        section("gather")
        if self.kernel is not None and not cfg.fused_phi:
            kparams, scale_aux = self._slot_scales(
                coords_local, sources, mparams, scale_aux, kparams,
                state["slot_model_params"],
            )
            section("scale")
            if ring and self._rbf_terms is not None:
                phi_local = ring_phi_rbf_terms(
                    coords_local, scores_local, kparams, self._rbf_terms,
                    group, n, psd_flags=self._term_psd,
                    row_tile=cfg.row_tile,
                )
            elif ring:
                phi_local = ring_phi_generic(
                    coords_local, scores_local, self.kernel.kernel_pure,
                    kparams, group, n, cfg.row_tile,
                )
            elif self._rbf_terms is not None:
                phi_local = phi_rbf_terms_cross(
                    coords_local, sources, group.all_gather_rows(scores_local),
                    kparams, self._rbf_terms, cfg.row_tile,
                    psd_flags=self._term_psd,
                )
            else:
                phi_local = phi_generic_cross(
                    coords_local, sources, group.all_gather_rows(scores_local),
                    self.kernel.kernel_pure, kparams, cfg.row_tile,
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
            if ring:
                phi_local = ring_phi_rbf(
                    coords_local, scores_local, p_matrix, group, n,
                    psd=self._rbf_psd, row_tile=cfg.row_tile,
                )
            else:
                phi_local = phi_rbf_cross(
                    coords_local, sources, group.all_gather_rows(scores_local),
                    p_matrix, cfg.row_tile, psd=self._rbf_psd,
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
        if cfg.log_intermediate_matrices:
            # This rank's row bands of the global K and grad-K at the
            # step's kernel parameters (reference SVGD.hpp:346-366);
            # _gather_logs puts the bands together.
            kfn = (self.kernel.kernel_pure if self.kernel is not None
                   else rbf_kernel_fn)
            k_band, g_band = kernel_matrix_and_grad_cross(
                coords_local, sources, kfn, kparams
            )
            stats = {"log_model_grad": scores_local, "kernel": k_band,
                     "kernel_grad": g_band, "coords": new_coords}
        elif cfg.track_stats:
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
        return ShardedState({
            "coords": local,
            "opt_state": opt_state,
            "model_params": params_on(self.model.parameters, device, dtype),
            "kernel_params": kparams,
            "slot_model_params": self._slot_model_params(device, dtype),
            "scale_aux": self._init_scale_aux(coords_global),
            "iteration": 0,
        }, self)

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
        """One sharded step: state -> state (stats or debug matrices
        recorded if configured; custom hooks run first)."""
        return self.run_state(state, 1)

    def run_state(self, state, num_steps: int):
        """State-in/state-out run: optimizer moments, the median brackets
        and the iteration count carry across calls. Custom model or kernel
        hooks run before every step (the reference's hook-then-phi order,
        SVGD.hpp:373-390), the state re-reading the parameters after
        them."""
        c = state["coords"]
        self._prepare_step(c.device, c.dtype)
        hooks = self._has_custom_hooks()
        collected = []
        for _ in range(int(num_steps)):
            if hooks:
                self._eager_hooks()
                state = self._refresh_component_params(state)
            state, stats = self._step(state)
            if stats is not None:
                collected.append(stats)
        if collected:
            stacked = {k: torch.stack([s[k] for s in collected])
                       for k in collected[0]}
            if self.config.log_intermediate_matrices:
                self._write_logs(stacked)
            else:
                self._record_stats(stacked)
        state = ShardedState(state, self)
        self._state = state
        return state

    def _record_stats(self, stacked):
        host = {k: v.cpu().numpy() for k, v in stacked.items()}
        if self.stats is None:
            self.stats = host
        else:
            self.stats = {k: np.concatenate([self.stats[k], host[k]])
                          for k in host}

    @property
    def intermediate_logs(self):
        """The stacked (T, ...) global debug matrices of every logged step
        since the last run(coords) (None before any): log_model_grad,
        kernel, kernel_grad, coords, as numpy arrays on every rank."""
        chunks = self._intermediate_log_chunks
        if chunks is None:
            return None
        if len(chunks) > 1:
            self._intermediate_log_chunks = [
                {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
            ]
        return self._intermediate_log_chunks[0]

    @intermediate_logs.setter
    def intermediate_logs(self, value):
        self._intermediate_log_chunks = None if value is None else [value]

    def _write_logs(self, stacked):
        """Put the ranks' row bands together into the global matrices
        (rows are the particle axis: dim 1 of the (T, n_local, ...) stacks),
        keep them, and append the new steps to the file on rank 0 with
        continuing step numbers (reference SVGD.hpp:460-476)."""
        group = self.mesh
        host = {
            k: group.all_gather_rows(v.transpose(0, 1).contiguous())
            .transpose(0, 1).cpu().numpy()
            for k, v in stacked.items()
        }
        if self._intermediate_log_chunks is None:
            prior_steps = 0
            self._intermediate_log_chunks = [host]
        else:
            prior_steps = sum(c["coords"].shape[0]
                              for c in self._intermediate_log_chunks)
            self._intermediate_log_chunks.append(host)
        if group.rank == 0:
            write_intermediate_matrices(
                self.config.intermediate_matrices_output_path, host,
                start_step=prior_steps + 1, append=prior_steps > 0,
            )

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
            self.intermediate_logs = None
        elif self._state is None:
            raise RuntimeError(
                "run(coords=None) requires a previous run to continue from."
            )
        final = self.run_state(self._state, int(num_iterations))
        return self.mesh.all_gather_rows(final["coords"])


class ShardedState(dict):
    """A state of :class:`ShardedSVGD`: this rank's rows of the coordinates
    and of the optimizer's particle-major leaves, the other leaves whole.
    It knows its engine, so ``utils/checkpoint`` can gather a state into
    the global arrays the JAX package saves (``to_global``, a collective)
    and give each rank its rows of a restored one (``from_global``, the
    split of ``utils/convert.sharded_state_from_numpy``)."""

    def __init__(self, state, engine: ShardedSVGD):
        super().__init__(state)
        self.engine = engine

    def _particle_leaves(self):
        """Which optimizer leaves are particle-major, from a global-shaped
        zero state of the engine's optimizer."""
        opt = self.engine.optimizer
        c = self["coords"]
        return opt.state_is_particle_sharded(opt.init(c.dtype, c.device))

    def to_global(self) -> dict:
        group, n = self.engine.mesh, self.engine.num_particles
        state = dict(self)
        state["coords"] = group.all_gather_rows(self["coords"], n)
        state["opt_state"] = _map_pair(
            self["opt_state"], self._particle_leaves(),
            lambda x, rows: group.all_gather_rows(x, n) if rows else x,
        )
        return state

    def from_global(self, state) -> "ShardedState":
        engine = self.engine
        rows = engine.mesh.rows(engine.num_particles)
        state = dict(state)
        state["coords"] = state["coords"][rows].contiguous()
        state["opt_state"] = engine.optimizer.shard_state(state["opt_state"],
                                                          rows)
        return ShardedState(state, engine)

    def barrier(self):
        """Wait for every rank of the engine's group (after rank 0 wrote)."""
        self.engine.mesh.all_reduce_sum(
            torch.zeros((), device=self["coords"].device))

