"""Algebraic flattening of composed RBF kernel trees.

PyTorch port of ``svgdcpp_tpu.kernels.algebra``. Two identities keep a
`+ - * /` tree of pure Gaussian RBF kernels (reference Kernel.hpp:55-223)
inside the closed form:

  * phi is LINEAR in k:   phi_{a*k1 + b*k2} = a*phi_{k1} + b*phi_{k2}
  * RBF products COLLAPSE: exp(-d^T P1 d) * exp(-d^T P2 d)
                             = exp(-d^T (P1+P2) d)      (same for /: P1-P2)

so the tree flattens to a signed sum of RBF terms, each with an effective
precision matrix that is a signed sum of leaf parameter slots. A term is
``(sign, ((param_idx, psign), ...))`` representing

    sign * exp( - d^T ( sum_i psign * params[param_idx] ) d ).

``flatten_rbf_terms`` returns the term list, or ``None`` when the kernel is
not a pure-RBF arithmetic tree (custom leaf, non-single-term divisor, or a
term blow-up past ``MAX_RBF_TERMS``). The checks on concrete parameter
values run in float64 numpy on the host, once per initialize or hot-swap.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.types import as_tensor

Term = Tuple[int, Tuple[Tuple[int, int], ...]]

# Products of sums multiply term counts; past this the generic VJP path is
# likely cheaper than many O(n^2) closed-form sweeps.
MAX_RBF_TERMS = 16


def _host(p) -> np.ndarray:
    """A concrete parameter slot as a float64 numpy array."""
    return np.asarray(as_tensor(p).detach().cpu(), dtype=np.float64)


def flatten_rbf_terms(kernel, _offset: int = 0) -> Optional[List[Term]]:
    """Flatten a composed kernel into signed RBF terms, or None.

    ``_offset`` is the position of ``kernel``'s first parameter inside the
    ROOT kernel's concatenated parameter tuple (composition concatenates
    child parameters; reference Kernel.hpp:77-81).
    """
    from .gaussian_rbf import GaussianRBFKernel, rbf_kernel_fn

    info = getattr(kernel, "_compose_info", None)
    if info is None:
        # Leaf: a pure (un-overridden) Gaussian RBF with its single
        # inverse-scale parameter slot.
        if (
            isinstance(kernel, GaussianRBFKernel)
            and kernel._kernel_fn is rbf_kernel_fn
            and len(kernel.parameters) == 1
        ):
            return [(1, ((_offset, 1),))]
        return None

    op_name, left, right, n1 = info
    lt = flatten_rbf_terms(left, _offset)
    rt = flatten_rbf_terms(right, _offset + n1)
    if lt is None or rt is None:
        return None

    if op_name == "added":
        out = lt + rt
    elif op_name == "subtracted":
        out = lt + [(-s, p) for s, p in rt]
    elif op_name == "multiplied":
        # (sum_a) * (sum_b) distributes; each pair of RBF factors collapses
        # by adding precision matrices.
        out = [(sa * sb, pa + pb) for sa, pa in lt for sb, pb in rt]
    elif op_name == "divided":
        # Only a single-term positive divisor stays inside the RBF algebra:
        # 1/exp(-d^T P d) = exp(-d^T (-P) d).
        if len(rt) != 1 or rt[0][0] != 1:
            return None
        _, pdiv = rt[0]
        neg = tuple((idx, -ps) for idx, ps in pdiv)
        out = [(sa, pa + neg) for sa, pa in lt]
    else:  # pragma: no cover - future operators
        return None

    if len(out) > MAX_RBF_TERMS:
        return None
    return out


def _median_slot_indices(adaptive_slots):
    """The adaptive slot indices when every adaptive slot is median-scaled,
    else None."""
    from .gaussian_rbf import GaussianRBFKernel

    idx = set()
    for i, owner in adaptive_slots:
        if owner.scale_method != GaussianRBFKernel.ScaleMethod.MEDIAN:
            return None
        idx.add(i)
    return idx


def fused_terms_eligible(terms, adaptive_slots, parameters) -> bool:
    """True when a flattened term list can run the single-sweep fused path
    (ops/phi.phi_rbf_terms_fused_counts + lag-1 median): at least one
    adaptive slot, every adaptive slot median-scaled (one lag-1 median
    serves them all), and every constant slot currently isotropic
    (gamma * I), so all terms share one squared-distance tile. Checked on
    the CONCRETE values at initialize(); the driver re-checks a hot-swap.
    """
    if terms is None or not adaptive_slots:
        return False
    adaptive_idx = _median_slot_indices(adaptive_slots)
    if adaptive_idx is None:
        return False
    for _, plist in terms:
        for idx, _ in plist:
            if idx not in adaptive_idx and not _slot_is_isotropic(parameters[idx]):
                return False
    return True


def _slot_is_isotropic(p) -> bool:
    """True when a concrete parameter slot holds gamma * I (the shared
    predicate for fused_terms eligibility and the iso/aniso term split)."""
    p = _host(p)
    return p.ndim == 2 and bool(np.allclose(p, p[0, 0] * np.eye(p.shape[0])))


def split_iso_aniso_terms(terms, adaptive_slots, parameters):
    """(iso_idx, aniso_idx): indices into ``terms`` of the terms whose
    effective P is isotropic (every constant slot gamma * I; adaptive
    slots are median-scaled, hence isotropic) and of the others."""
    adaptive_idx = {idx for idx, _ in adaptive_slots}
    iso, aniso = [], []
    for t_i, (_, plist) in enumerate(terms):
        is_iso = all(
            idx in adaptive_idx or _slot_is_isotropic(parameters[idx])
            for idx, _ in plist
        )
        (iso if is_iso else aniso).append(t_i)
    return tuple(iso), tuple(aniso)


def fused_aniso_terms_supported(terms, adaptive_slots, parameters) -> bool:
    """True when the composition can run the ANISOTROPIC fused sweep
    (kernel K14, ``fused_phi_aniso_terms_sym`` on the card): flattenable,
    at least one adaptive slot, every adaptive slot median-scaled, no
    division terms, and every term's constant part C = sum(sign * P) PSD
    when the term has an adaptive slot (C + gamma*I is then PD for any
    gamma > 0) and PD outright when it has none, with a tolerance relative
    to C's largest eigenvalue."""
    if terms is None or not adaptive_slots:
        return False
    adaptive_idx = _median_slot_indices(adaptive_slots)
    if adaptive_idx is None:
        return False
    for _, plist in terms:
        c_const = None
        has_adaptive = False
        for idx, psign in plist:
            if psign <= 0:
                return False
            if idx in adaptive_idx:
                has_adaptive = True
                continue
            p = _host(parameters[idx])
            if p.ndim != 2:
                return False
            contrib = psign * p
            c_const = contrib if c_const is None else c_const + contrib
        if c_const is None:
            continue  # purely adaptive term: gamma * I, always PD
        eigs = np.linalg.eigvalsh(0.5 * (c_const + c_const.T))
        min_eig = float(eigs.min())
        tol = 1e-12 * float(np.abs(eigs).max())
        ok = min_eig >= -tol if has_adaptive else min_eig > tol
        if not ok:
            return False
    return True


def fused_terms_statically_positive(terms, adaptive_slots, parameters) -> bool:
    """True when every term's effective isotropic gamma is provably > 0:
    all slot signs positive (no division) and every constant slot's scalar
    positive (median slots are log(n)/med^2 > 0). The kernel route takes
    only such compositions, as the JAX package's Mosaic route does; the
    others stay on the plain sweep."""
    adaptive = {idx for idx, _ in adaptive_slots}
    for _, plist in terms:
        for idx, psign in plist:
            if psign <= 0:
                return False
            if idx not in adaptive and float(_host(parameters[idx])[0, 0]) <= 0.0:
                return False
    return True


def term_is_psd(term: Term) -> bool:
    """True when the term's effective precision is a nonnegative combination
    of leaf parameters (the positional rule: it assumes every leaf is PSD;
    call sites with kernel context use :func:`term_psd_flags`)."""
    return all(ps > 0 for _, ps in term[1])


def matrix_is_psd(p, tol: float = -1e-12) -> bool:
    """PSD check on the symmetric part (the quadratic form only sees it).

    The single definition used by the driver and the term flags: keep the
    symmetrization rule and tolerance here.
    """
    p = _host(p)
    if p.ndim != 2 or p.shape[0] != p.shape[1]:
        return False
    return bool(np.linalg.eigvalsh(0.5 * (p + p.T)).min() >= tol)


def term_psd_flags(terms, adaptive_slots, parameters):
    """Per-term PSD-ness from slot TYPES and concrete values: a term's
    quadratic form may be clamped at zero only when every slot enters with
    positive sign, median slots count as PSD, Hessian slots never do, and
    constant slots pass :func:`matrix_is_psd`. A list aligned with
    ``terms``."""
    from .gaussian_rbf import GaussianRBFKernel

    slot_method = {idx: owner.scale_method for idx, owner in adaptive_slots}

    def slot_psd(idx):
        method = slot_method.get(idx)
        if method == GaussianRBFKernel.ScaleMethod.MEDIAN:
            return True
        if method is not None:  # HESSIAN
            return False
        return matrix_is_psd(parameters[idx])

    return [
        all(ps > 0 and slot_psd(idx) for idx, ps in plist)
        for _, plist in terms
    ]


def term_precision(plist, kernel_params):
    """Effective precision matrix of one term: sum_i psign * params[idx]."""
    p = None
    for idx, psign in plist:
        contrib = kernel_params[idx] if psign > 0 else -kernel_params[idx]
        p = contrib if p is None else p + contrib
    return p


def term_gamma(plist, kernel_params):
    """Effective isotropic gamma of one term: sum_i psign *
    params[idx][0, 0], a 0-d tensor on the parameters' device (only
    meaningful once ``fused_terms_eligible`` proved every slot isotropic)."""
    return sum(float(psign) * kernel_params[idx][0, 0] for idx, psign in plist)


def refill_median_slots(kernel_params, median_slot_idx, gamma, dim, dtype,
                        plists):
    """Refill every median adaptive slot with ``gamma * I`` and return
    (kernel_params, per-term gammas): the fused multi-term step's parameter
    refresh (constant slots keep their state values). ``gamma`` is a 0-d
    tensor; nothing is read on the host."""
    kparams = list(kernel_params)
    med_scale = gamma * torch.eye(dim, dtype=dtype, device=gamma.device)
    for idx in median_slot_idx:
        kparams[idx] = med_scale
    kparams = tuple(kparams)
    return kparams, [term_gamma(plist, kparams) for plist in plists]
