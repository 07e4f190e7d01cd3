"""Profiling and timing on the card, and the H100's bounds.

Port of ``svgdcpp_tpu.utils.profiling``:

  * ``sync`` -- wait for the devices of every tensor of a state.
  * ``step_timer`` -- per-step times of a state -> state step function,
    between CUDA events when the state lives on the card (the host's clock
    on the CPU).
  * ``trace`` -- a ``torch.profiler`` context over the CPU and the card
    that writes a Chrome trace (``<log_dir>/trace.json``, readable in
    Perfetto or chrome://tracing).
  * ``speed_of_light`` -- the least time an NVIDIA H100 could take for one
    RBF phi step, so a measured step can be judged against the card.

The bounds below count the work each function needs, whatever a kernel's
design runs, at the published peaks of the NVIDIA H100 SXM5 80GB at its
700 W limit (NVIDIA's data sheet): 67 TFLOP/s FP32 outside the tensor
cores, 495 TFLOP/s dense TF32 on them, 34 TFLOP/s FP64, 3.35 TB/s HBM3.
A card set below 700 W runs slower under load, so a ratio to these bounds
is stated beside the card's power limit. ``chip_smoke.py`` takes its
bounds from here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _cuda_devices(tree):
    return sorted({t.device.index or 0 for t in _tensors(tree) if t.is_cuda})


def sync(tree):
    """Wait until every CUDA device that holds a tensor of ``tree`` (a
    tensor, or dicts, tuples and lists of them) has finished its queued
    work; returns ``tree``. The CPU needs no wait."""
    for index in _cuda_devices(tree):
        torch.cuda.synchronize(index)
    return tree


@dataclasses.dataclass
class StepTiming:
    mean_s: float
    p50_s: float
    p90_s: float
    steps: int

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.mean_s if self.mean_s else float("inf")


def step_timer(step_fn: Callable, state, *, steps: int = 20, warmup: int = 2,
               chunk: int = 5) -> StepTiming:
    """Time a state -> state step function, ``chunk`` dependent steps a
    measurement after ``warmup`` untimed ones.

    On the card a chunk lies between two CUDA events on the current stream
    (its time is the card's, idle gaps between launches included, since
    the events fire in the stream's order); on the CPU it is the host's
    clock around the chunk."""
    for _ in range(warmup):
        state = step_fn(state)
    sync(state)
    devices = _cuda_devices(state)
    times = []
    done = 0
    while done < steps:
        if devices:
            with torch.cuda.device(devices[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(chunk):
                    state = step_fn(state)
                end.record()
                sync(state)
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / chunk)
        else:
            t0 = time.perf_counter()
            for _ in range(chunk):
                state = step_fn(state)
            times.append((time.perf_counter() - t0) / chunk)
        done += chunk
    arr = np.asarray(times)
    return StepTiming(float(arr.mean()), float(np.percentile(arr, 50)),
                      float(np.percentile(arr, 90)), done)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the CPU and, where there is one, the card;
    on exit the trace goes to ``<log_dir>/trace.json`` (Chrome's trace
    format). ``log_dir`` defaults to ``svgd-trace`` under the temporary
    directory. Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "svgd-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def speed_of_light(n: int, m: int, *, thresholds: int = 3,
                   peak_flops: float | None = None,
                   bytes_per_s: float | None = None) -> float:
    """The least time (seconds) one RBF phi step at (n, m) could take on
    the card: the flagship's fused triangle sweep (phi and the median's
    ``thresholds`` counts over the n(n+1)/2 unordered pairs,
    :func:`sweep_bound` of ``fused_phi_counts_sym``), which dominates the
    step. The peaks default to the NVIDIA H100 SXM5 80GB at 700 W (FP32
    outside the tensor cores, 67 TFLOP/s; HBM3, 3.35 TB/s; NVIDIA's data
    sheet)."""
    flops, nbytes = sweep_work("fused_phi_counts_sym", n, m, T=thresholds)
    return max(flops / (peak_flops or PEAK_FP32_FLOPS),
               nbytes / (bytes_per_s or PEAK_BYTES_PER_S))


#: Published H100 SXM peaks at 700 W: FP32 outside the tensor cores, and
#: HBM3 bandwidth (NVIDIA's data sheet).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations over the FP32 peak and the bytes over the memory
    rate."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sweep_bound(kernel, n, m, T=3, n_iso=1, n_aniso=0, pairs=None,
                n_c=None, all_pairs=False, n_t=None):
    """bound() of one kernel call: :func:`bound` of :func:`sweep_work`."""
    return bound(*sweep_work(kernel, n, m, T, n_iso, n_aniso, pairs, n_c,
                             all_pairs, n_t))


def sweep_work(kernel, n, m, T=3, n_iso=1, n_aniso=0, pairs=None,
               n_c=None, all_pairs=False, n_t=None):
    """(flops, nbytes) of one kernel call, with the FP32 operations each
    pair of the function needs, whatever the kernel's design runs (an FMA
    as 2; an ex2, a compare and any other operation as 1):

      * the difference x_i - x_j once (m) and its square sum (2m);
      * an isotropic term 6 (scale, ex2, the FMAs into k_c and into w);
        one RBF 2 (scale, ex2);
      * per direction, KS = sum k s_j (2m) and each gradient accumulator
        D = sum w (x_i - x_j) from that same difference (2m);
      * T compares;
      * an anisotropic term its form |z_ti - z_tj|^2 (3m) and 6 to
        combine; one accumulator D_t each; KS once for all terms;
      * K15: the form sum_k lam_k (dz_k)^2 (4m: the difference, a multiply
        and an FMA), 2 for the exponential, KS and D_z = sum k dz (2m each)
        per direction (``all_pairs``: over the n^2 ordered pairs and one
        direction, as it was counted before the triangle); its wide
        instance (``phi_rbf_wide``, float32 at every m but 1-8 and 11) the
        JAX kernel's form, the dot
        x_i . y_j (2m) and q_i + q_j - 2G (3), with the same exponential
        and contractions, and it reads the operand Y = X P_sym/2 and the
        norms q besides;
      * the count pass (count_le_cross): the squared distance, 3m by
        differences up to m = 4 and 2m + 3 by the Gram identity above (the
        norms once per point), and ceil(log2(T + 1)) compares, the search
        of a pair's bin among the sorted thresholds (the prefix sum over
        the bins is per block, not per pair).

    The square kernels take n^2 ordered pairs and one direction; the triangle
    kernels, full-width and panel alike, and K15, whose function is
    symmetric in the pair, n(n+1)/2 unordered pairs (diagonal included)
    and both; a chunk kernel the ``pairs`` of its tiles or panels
    (the whole triangle by default); the count pass of one set against
    itself (``n_c`` None: the median's passes on one device) n(n+1)/2
    pairs, since sq is symmetric, and of rows against other columns (the
    sharded engine's) n x n_c. count_bound_all_pairs gives the count
    pass's bound as it was counted before the triangle and the bins. Bytes:
    the function's inputs read once (coordinates, scores, precisions,
    thresholds) and its outputs written once (phi, or a chunk's raw (2m, n)
    accumulator; the int64 counts). One particle set of n, as on every main
    path; a square kernel's cross form takes ``n_t`` targets against the n
    sources (n_t x n ordered pairs, the targets read and their phi written
    once). A bf16 instance (``..._bf16``) computes its family's function:
    the same count."""
    kernel = kernel.removesuffix("_bf16")
    cross = n_t is not None
    n_t = n if n_t is None else n_t
    square_pairs = n_t * n
    tri_pairs = n * (n + 1) / 2 if pairs is None else pairs
    contract = 4 * m  # KS and one D, one direction
    out_floats = n * m
    if kernel == "fused_phi_counts_square":
        flops = square_pairs * (3 * m + 2 + T + contract)
    elif kernel in ("fused_phi_counts_sym", "fused_phi_counts_sympanel",
                    "fused_phi_counts_sym_chunk",
                    "fused_phi_counts_sympanel_chunk"):
        flops = tri_pairs * (3 * m + 2 + T + 2 * contract)
    elif kernel == "fused_phi_terms_square":
        flops = square_pairs * (3 * m + 6 * n_iso + T + contract)
    elif kernel in ("fused_phi_terms_sym", "fused_phi_terms_sympanel",
                    "fused_phi_terms_sym_chunk"):
        flops = tri_pairs * (3 * m + 6 * n_iso + T + 2 * contract)
    elif kernel in ("fused_phi_aniso_terms_sym",
                    "fused_phi_aniso_terms_wide"):
        n_w = (1 if n_iso else 0) + n_aniso
        flops = tri_pairs * (3 * m + T + 6 * n_iso + n_aniso * (3 * m + 6)
                             + 2 * (2 * m + 2 * m * n_w))
    elif kernel == "phi_rbf_square":
        flops = (square_pairs * (4 * m + 2 + contract) if all_pairs
                 else tri_pairs * (4 * m + 2 + 2 * contract))
        T = 0
    elif kernel == "phi_rbf_wide":
        flops = tri_pairs * (2 * m + 3 + 2 + 2 * contract)
        T = 0
    elif kernel == "count_le_cross":
        sq_ops = 3 * m if m <= 4 else 2 * m + 3
        compares = math.ceil(math.log2(T + 1))
        if n_c is None:  # a self count: one set, the triangle and diagonal
            flops = n * (n + 1) / 2 * (sq_ops + compares)
            return flops, 4 * n * m + 12 * T
        flops = n * n_c * (sq_ops + compares)
        return flops, 4 * (n + n_c) * m + 12 * T
    else:
        raise ValueError(kernel)
    if kernel.endswith("_chunk"):
        out_floats = 2 * n * m
    if cross:
        out_floats = (2 if kernel.endswith("_chunk") else 1) * n_t * m
    nbytes = (4 * (2 * n * m + (n_t * m if cross else 0) + n_aniso * m * m
                   + n_iso + T) + 4 * out_floats + 8 * T)
    if kernel == "phi_rbf_square":
        nbytes += 4 * m * m
    if kernel == "phi_rbf_wide":  # P, and the operands Y and q
        nbytes += 4 * (m * m + n * m + n)
    return flops, nbytes


#: Published H100 SXM dense TF32 and bf16 tensor-core peaks (NVIDIA's data
#: sheet); the bf16 peak bounds the bfloat16 opt-in's instances, whose
#: products are bf16 x bf16 (bf16 mma.sync in K1's,
#: csrc/square_bf16_sm90.cuh, and in K2's, K3's and K15's,
#: csrc/bf16_tri_sm90.cuh).
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12


def square_tensor_bound(n, m, T=3, n_terms=None, n_t=None, bf16=False):
    """(bound_ms, bound_by) of a square kernel's function over one set of n
    with the work its tensor-core body puts there on the TF32 tensor cores:
    per ordered pair the Gram product (2m) and the contraction, K1's
    K . [S | X | 1] (2 (2m + 1)) or the terms' k_c . S and w . [X | 1]
    (2m + 2 (m + 1), the same 6m + 2 in all), at PEAK_TF32_FLOPS; the rest
    at the FP32 peak: for one RBF (``n_terms`` None) 4 + T (sq from the
    Gram tile and the norms, 2; the scale and the ex2, 2; T compares), for
    ``n_terms`` terms 4 + 6 n_terms + T (sq and its clamp at 0, 4; each
    term as sweep_bound counts one, 6; T compares); and sweep_bound's bytes
    at the memory rate: the largest of the three, each resource busy at
    once. ``n_t``: the cross form's targets against the n sources.
    ``bf16``: the tensor work at PEAK_BF16_FLOPS (K1's bf16 instance)."""
    kernel = ("fused_phi_counts_square" if n_terms is None
              else "fused_phi_terms_square")
    _, nbytes = sweep_work(kernel, n, m, T, n_iso=n_terms or 1, n_t=n_t)
    pairs = n * (n if n_t is None else n_t)
    fp32 = 4 + T if n_terms is None else 4 + 6 * n_terms + T
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS
    return max(
        (pairs * (6 * m + 2) / peak * 1e3, "tensor operations"),
        (pairs * fp32 / PEAK_FP32_FLOPS * 1e3, "operations"),
        (nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
    )


def tri_tensor_bound(n, m, T=3, n_terms=None, pairs=None, n_aniso=0,
                     fixed_p=False, bf16=False):
    """(bound_ms, bound_by) of a triangle kernel's function with the work
    its wide body (csrc/wide_tri_sm90.cuh: every m but 1-8 and 11) puts on
    the TF32 tensor cores: per unordered pair (``pairs``, the whole
    triangle n(n + 1)/2 by default) the Gram product (2m) and both
    directions' contractions,
    W [S | X] and W^T [S | X] (2 x 4m), at PEAK_TF32_FLOPS; the rest at
    the FP32 peak: sq and its clamp (4), the weights (one RBF, ``n_terms``
    None: 2; else 6 a term), T compares and the D weight's row and column
    sums (2); and the bytes of sweep_work at the memory rate: the largest
    of the three.

    ``n_aniso`` > 0: K14's wide term groups (``n_terms`` isotropic terms,
    None or 0 for none), each group a sweep of its own: group 0 the Gram
    product, sq, its terms, the counts and, with a term, the contractions
    and sums (with none, the count kernel's pass does its Gram product
    and counts); each of the n_aniso groups the Gram product, sq, one term
    and the contractions and sums, no counts. ``fixed_p``: K15's wide
    sweep, one RBF's work with no counts (its Gram product pairs X with
    Y = X P_sym/2). The panels (K3/K5, K12/K13) do the triangle's work.
    ``bf16``: the tensor work at PEAK_BF16_FLOPS (the bfloat16 opt-in's
    K2, K3 and K15 instances)."""
    tri = n * (n + 1) / 2 if pairs is None else pairs
    if n_aniso:
        n_iso = n_terms or 0
        tensor = 2 * m + (8 * m if n_iso else 0) + n_aniso * 10 * m
        fp32 = (4 + 6 * n_iso + T + (2 if n_iso else 0)
                + n_aniso * (4 + 6 + 2))
        _, nbytes = sweep_work("fused_phi_aniso_terms_wide", n, m, T,
                               n_iso=n_iso, n_aniso=n_aniso)
    elif fixed_p:
        tensor, fp32 = 10 * m, 4 + 2 + 2
        _, nbytes = sweep_work("phi_rbf_wide", n, m)
    else:
        tensor = 10 * m
        fp32 = 4 + (2 if n_terms is None else 6 * n_terms) + T + 2
        kernel = ("fused_phi_counts_sym" if n_terms is None
                  else "fused_phi_terms_sym")
        if pairs is not None:
            kernel += "_chunk"
        _, nbytes = sweep_work(kernel, n, m, T, n_iso=n_terms or 1,
                               pairs=pairs)
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS
    return max(
        (tri * tensor / peak * 1e3, "tensor operations"),
        (tri * fp32 / PEAK_FP32_FLOPS * 1e3, "operations"),
        (nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
    )


def count_bound_all_pairs(n, m, T, n_c=None):
    """bound() of the count pass over all n x n_c ordered pairs with T
    compares a pair (n_c = n by default): the count sweep_bound took before
    it counted a self count's triangle and the sorted bins' search, kept
    beside it so that ratios to the bound stay comparable."""
    n_c = n if n_c is None else n_c
    flops = n * n_c * ((3 * m if m <= 4 else 2 * m + 3) + T)
    return bound(flops, 4 * (n + n_c) * m + 12 * T)


#: Published H100 SXM float64 peak outside the tensor cores (NVIDIA's data
#: sheet), for the decomposition's bound.
PEAK_FP64_FLOPS = 34e12


def eigen_bound(m):
    """(bound_ms, bound_by) of one decomposition of an (m, m) float64
    matrix with its eigenvectors: about 9 m^3 float64 operations (the
    symmetric QR algorithm's count, Golub and Van Loan), over the float64
    peak, against P read and lam and V written once over the memory
    rate."""
    ops_ms = 9 * m**3 / PEAK_FP64_FLOPS * 1e3
    bytes_ms = 8 * (2 * m * m + m) / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
