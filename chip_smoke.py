#!/usr/bin/env python3
"""Smoke test of svgdcpp_tpu_torch on one CUDA GPU (an NVIDIA H100).

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``svgdcpp_tpu_torch/csrc`` and runs
thirty-one phases, one line each (several for phases 2, 3, 7-9 and
14-31):

  1. device and build: the card's name and power limit, torch and CUDA
     versions, nvcc build seconds and ptxas's registers and spill bytes of
     every kernel instance;
  2. the square kernel (fused_phi_counts_square) against its plain torch
     version on the card, float32, at six shapes including the cross form
     and the shape phase 4 gives it; the library's split count
     (svgd_square_splits) against its Python copy (sym_plan.square_splits)
     at 330 shapes; scores as a row-slice view off a 16-byte boundary at
     m = 50, square and cross;
  3. the triangle kernel (fused_phi_counts_sym) against the plain version
     at n = 2048, 10000 and 10007, every micro-tile instance (m = 1-8 and
     11) at n = 10007 off origin at T = 1, 3 and 8, counts equal at m <= 4,
     and both kernels' times beside the plain version's (CUDA events,
     median of 50 calls after warm-up);
  4. the main path through SVGD(...).initialize().run() at n = 1500 (the
     square kernel's range), 50 iterations;
  5. the flagship: MVN d=2, N=10000, RBF with the median bandwidth,
     AdaGrad lr 0.1, 1000 iterations through the triangle kernel; updates/s
     and the posterior's moment errors;
  6. the kernel route against the plain route ('fused') for 20 steps from
     the same x0, and two kernel routes against each other (the float32
     atomics' run-to-run floor);
  7. the composed-kernel kernels (fused_phi_terms_square, _sym) against
     their plain version: square and cross at m = 2 and 11 with two and
     three terms, including (1500, 11), the shape phase 10 gives it; the
     square kernel at every instance, m = 1-4 (CUDA cores) and m = 5, 8,
     11, 13, 16, 32, 50, 64 (tensor cores), at T = 1, 3 and 8 with signs
     (1, 1), (1, -1) and three terms, square (n = 1337 off origin) and
     cross, counts equal (grid inputs above m = 4), a scores view off a
     16-byte boundary at m = 11 and 50, float64 rows at (1500, 11) and
     (1000, 50) with two terms (within 2.5e-3 of max |phi|), and two calls
     on one input equal; triangle at n = 2048, 10000, 10007 and 32768 (m =
     11), and at
     n = 10007 off origin every instance of the micro-tile body (m = 1-8
     and 11) and of the wider body (m = 9, 16, 50), each at T = 1, 3 and
     8 with signs (1, 1), (1, -1) and three terms, counts equal at m <= 4;
  8. the single-term kernels at m = 11 and 50 (and runtime-m instances),
     including (1000, 50), the flat-BLR shape, and the square kernel's
     cross form at m = 13 and 50; at (1000, 50) on Gaussian inputs the
     square kernel and the plain version against float64 rows
     (f64_rows_reference), the kernel within 2.5e-3 of max |phi|;
  9. times, kernel against plain: terms-sym (10000, 11) and (32768, 11),
     terms-square (1500, 11) and (1500, 2), K1 (1000, 50) and (1000, 11),
     K2 (10000, 11) and (10000, 50);
 10. the hierarchical-BLR main path (median RBF + 0.1 I, Adam) at n = 1500,
     50 iterations: auto picks fused_terms_cuda, 50 terms-square launches;
 11. hierarchical BLR at full width: N = 10000, d = 10 (m = 11), 1000
     iterations, 1000 terms-sym launches; updates/s and training accuracy;
 12. flat BLR at full width: N = 1000, d = 50, 1000 iterations (the bench
     runs 4000; cut for time), 1000 K1 launches at m = 50, training
     accuracy above 0.5; then the kernel route against the plain route
     for 20 steps from one x0 (within 1e-3), the float64 plain route
     printed as the floor;
 13. the hierarchical kernel route against the plain route ('fused_terms')
     for 20 steps at N = 10000;
 14. the anisotropic terms kernel (fused_phi_aniso_terms_sym, K14's port)
     against its plain version: m = 2 (iso + 1 aniso off origin, aniso
     only), m = 11 (the main path's shape (10240, 11), iso + 3 aniso, iso +
     7 aniso, a negative sign) and m = 50, and one anisotropic term at
     m = 1, 3, 5, 16 and 32; one anisotropic term up to m = 32 takes the
     one-pass kernel, the others the term-group kernel;
 15. the fixed-P kernel (phi_rbf_square, K15's port: the triangle at
     m = 1-8 and 11, the square sweep above) against phi_rbf /
     phi_rbf_blocked: isotropic (1500, 2), the HESSIAN scale of the d = 11
     target at (10240, 11), a full PD P at (1000, 50), an indefinite P with
     psd=False, and an offset of 200; the decomposition on the card
     (sym_eigen) against torch.linalg.eigh in float64 at m = 2, 3, 11 (the
     HESSIAN P), 50 and 64, indefinite ones included; the HESSIAN call
     under torch.cuda.set_sync_debug_mode("error"), which raises on any
     synchronisation;
 16. times, kernel against plain: K14 at (10240, 11) with 2, 4 and 8
     gradient accumulators (2 with the driver's kept Cholesky factor and
     factoring each call), K15 at (10240, 11) and (1500, 2), sym_eigen at
     m = 11 beside torch.linalg.eigh on the CPU and on the card;
 17. the anisotropic main path (scripts/check_aniso_posterior.py's
     configuration: d = 11 MVN, median RBF + RBF with a full constant P,
     N = 10240, AdaGrad 0.05), auto picks fused_aniso_terms_cuda, 1000
     iterations, 1000 K14 launches; updates/s and the moment errors
     (printed, not gated: the configuration does not converge in 1000
     iterations), the first step against 'rbf_terms' and the posterior
     moments against 'rbf_terms' on the card;
 18. the 'cuda' route: a HESSIAN RBF on the same target at N = 10240, 1000
     iterations, 1000 K15 and 1000 sym_eigen launches; 20 steps against
     'blocked'; a MEDIAN RBF on the flagship at n = 1500, 50 iterations, 50
     K15 launches and no decomposition;
 19. the panel triangle kernel of one RBF (fused_phi_counts_sympanel, K3's
     port) against its plain version (the panel schedule in torch): forced
     at n = 10007 with 3 and 8 super-blocks off origin, at (262144, 2) (path
     A's shape) and (65536, 11), all at T = 3 (the kernel's fixed-T
     instance); at T = 1 and 8 (its runtime-T instance) at n = 10007, m = 2
     and at n = 9001, m = 5 (a runtime-m instance; also T = 3), counts
     equal; against the full-width kernel at (1048576, 2), both also
     against a float64 reference on a row subset;
 20. the terms panel kernel (fused_phi_terms_sympanel, K12/K13's port)
     against its plain version: (131072, 11, two terms) at the hierarchical
     BLR's signs (path B's shape; K12's on the TPU), (65536, 11, three
     terms) (K13's), (262144, 2, two terms) and forced small panels with a
     negative sign; at m = 11 forced small panels off origin (n = 10007, 3
     super-blocks: ragged strips, diagonal panels) at T = 1, 3 and 8, with
     one term and with a negative sign, and at m = 5 (n = 9001, two and
     three terms, T = 3 and 8); counts equal at m <= 4, within 1e-6 n^2
     above;
 21. times: the panel kernels against the full-width ones (K2, terms-sym)
     at (262144, 2), (1048576, 2) and (131072, 11, two terms), and the plain
     versions under 10 s a call (CUDA events; median of 50 calls, of 5 at
     1048576 and of 3 for a plain version over 0.25 s); phases 19-24
     also print the seconds since the script started;
 22. path A: the flagship at N = 262144 through 'auto', 100 iterations, the
     panel form with 100 panel-kernel launches and no K2 launch; updates/s,
     the moment errors (printed, not gated) and the KSD before and after
     (it must drop); then N = 1048576 for 4 iterations;
 23. path B: the hierarchical BLR at N = 131072 through 'auto', 50
     iterations, 50 terms-panel launches and no terms-sym launch; updates/s
     and the training accuracy;
 24. the panel route against the full-width route (fused_sym=True) for 20
     steps from one x0 on both paths;
 25. the sharded engine's triangle chunk kernels (fused_phi_counts_sym_chunk,
     K4's port; fused_phi_terms_sym_chunk, K10/K11's) against their plain
     chunk versions, every rank's chunk summed and finished: one RBF at
     (10000, 2), (10007, 2) off origin and (3001, 11) for every world of
     1-8 and at (10007, 5) off origin for worlds 2, 3 and 8; the composed
     kernel at (10000, 11) with two and three terms (one negative) for
     worlds 1, 2, 3, 4 and 8, at (10007, 2) and (10007, 5) off origin at
     worlds 2 and 3 and at m = 9, 10, 12 and 16 (n = 3001), one RBF at
     m = 17 and 50 (n = 3001), these for every world; the sums also
     against K2 and the terms triangle kernel (counts equal);
 26. the panel chunk kernel (fused_phi_counts_sympanel_chunk, K5's port)
     against its plain version at (262144, 2) for worlds 2 and 4 and on
     forced small panels at n = 10007 (worlds 2-8), at T = 1, 3 and 8 and at
     m = 5 (n = 9001), and against K3's port; counts equal;
 27. the count kernel (count_le_cross, K16's port) against the plain count
     pass: square and cross at (10000, 2), (10000, 11) and 5000 x 10000,
     17 and 40 thresholds; counts equal on grid inputs, within
     1e-6 n_r n_c on Gaussian ones; the hybrid median through it; past
     the sweeps' 64 dimensions (m = 65 and 100, 2048 x 3001) the wide
     instance the same way, the hybrid median through it within 1e-3 of
     the plain pass's and of the float64 exact median, and auto on the
     card raising with the sweeps' item-17 error; the self form (one set
     as rows and columns, the triangle) at odd n off origin, m = 1, 2, 4,
     11 and 65, T = 1, 3, 17, 32 and 33 (both threshold designs) with
     shuffled, duplicate, negative and past-the-largest thresholds: equal
     to the cross form and across calls, equal to the plain pass at m <= 4
     (grid inputs) and within 1e-6 n^2 above;
 28. times of the chunk kernels at world 1 against their plain versions
     and the full-width kernels, each rank's at world 2, and K16's self
     form at 10000^2, 262144^2 and 1048576^2 (17 thresholds; each also
     held to the plain pass), at T = 3 and 32 below 10^6, its cross form
     at 10000^2 and its wide instance at 2048 x 3001 (m = 65 and 100);
 29. the sharded flagship (examples/sharded_example.py's configuration,
     utils/workloads.build_sharded_mvn_svgd) on a one-rank NCCL group,
     N = 10000, 1000 iterations: 1000 K4 launches and no other sweep,
     updates/s and phase 5's moment gates;
 30. the sharded hierarchical BLR at N = 10000, 1000 iterations (1000
     K10/K11 launches, accuracy > 0.5), and the sharded flagship at
     N = 262144, 20 iterations in the panel form (20 K5 launches);
 31. two ranks spawned on the one card over gloo, the flagship and the
     hierarchical BLR at N = 10000 for 20 steps from one x0: each rank 20
     chunk launches, the gathered coordinates within 1e-3 of the one-rank
     run and of the single-device driver's kernel route.

Phase 22 prints the N = 1,048,576 set-up (the median seed, now through
K16) beside the 239.40 s the plain count pass took.

The ``kernels`` line gives, for each kernel, its launches, error against its
plain version and times on the main path it serves first, and its bound:
the larger of the FP32 operations its function needs (counted per pair,
an ex2 or a compare as one; see sweep_bound) over 67 TFLOP/s and the bytes
of its inputs and outputs over 3.35 TB/s, the published H100 SXM peaks
(K16's and K15's paths also ``bound_all_pairs_ms``, counted over all n^2
ordered pairs as before their triangles; sym_eigen, the decomposition
beside K15, 9 m^3 float64 operations over 34 TFLOP/s); and the TPU kernels
it stands for. Every main path resets the launch counts just before it
runs and checks its sweep kernel's count after.

Any failed check raises and the exit code is not 0. Without a CUDA device,
or without the package beside it, the script exits with an error before
printing any result. The last line is the JSON object
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def check(cond, message):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + message)


def time_ms(fn, reps=50, warmup=5):
    """Median milliseconds of ``fn()`` over ``reps`` calls, each between
    two CUDA events, after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def sweep_inputs(n, m, offset, seed, device):
    """float32 coords/scores on the card, with gamma = log(n)/med^2 and
    three thresholds at pair-distance quantiles (so every count is
    non-trivial), from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)) + offset
    s = rng.normal(size=(n, m))
    i, j = rng.integers(0, n, 4096), rng.integers(0, n, 4096)
    sq = np.sum((x[i] - x[j]) ** 2, axis=1)
    q = np.quantile(sq, [0.25, 0.5, 0.75])
    gamma = math.log(n) / float(np.median(sq))

    def dev(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return dev(x), dev(s), dev(gamma), dev(q)


def grid_inputs(n, m, offset, seed, device):
    """sweep_inputs for m > 4 on a grid: coordinates are multiples of 1/8,
    symmetric about ``offset`` (each row's mirror image is also a row, and
    odd n adds the offset itself), and the thresholds lie halfway between
    multiples of 1/64.

    Above m = 4 the plain version builds sq by the Gram identity and the
    kernels by differences. On these inputs the mean is exactly the offset
    and both forms are exact in float32, so no pair lies within rounding of
    a threshold and the counts of both must be equal; on continuous inputs
    a few pairs at a threshold may land on either side."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    half = np.round(rng.normal(size=(n // 2, m)) * 8.0) / 8.0
    rows = [half, -half] + ([np.zeros((1, m))] if n % 2 else [])
    x = np.concatenate(rows)[rng.permutation(n)] + offset
    s = rng.normal(size=(n, m))
    i, j = rng.integers(0, n, 4096), rng.integers(0, n, 4096)
    sq = np.sum((x[i] - x[j]) ** 2, axis=1)
    q = (np.floor(np.quantile(sq, [0.25, 0.5, 0.75]) * 64.0) + 0.5) / 64.0
    gamma = math.log(n) / float(np.median(sq))

    def dev(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return dev(x), dev(s), dev(gamma), dev(q)


def inputs_for(n, m, offset, seed, device):
    """Gaussian inputs at m <= 4, grid inputs above (see grid_inputs)."""
    fn = sweep_inputs if m <= 4 else grid_inputs
    return fn(n, m, offset, seed, device)


def thresholds_of(thr, count):
    """``count`` distinct thresholds from the three of sweep_inputs or
    grid_inputs: cycled and raised by 1e-3 each, which keeps grid inputs'
    thresholds off every multiple of 1/64 (count <= 7 steps of 1e-3 stay
    below the 1/128 to the next one)."""
    import torch

    steps = torch.arange(count, device=thr.device)
    return thr[steps % thr.shape[0]] + 1e-3 * steps.to(thr.dtype)


#: Path A's particle count, its short run's and path B's (utils/workloads'
#: LARGE_MVN_PARTICLES, LARGE_MVN_SHORT_PARTICLES, LARGE_HIER_PARTICLES),
#: their iteration counts, and the steps of phase 24's route comparison.
PATH_A_N, PATH_A_SHORT_N, PATH_B_N = 262144, 1048576, 131072
PATH_A_ITERS, PATH_A_SHORT_ITERS, PATH_B_ITERS = 100, 4, 50
COMPARE_STEPS = 20

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
                n_c=None, all_pairs=False):
    """bound() of one kernel call, with the FP32 operations each pair of the
    function needs, whatever the kernel's design runs (an FMA as 2; an ex2,
    a compare and any other operation as 1):

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
        direction, as it was counted before the triangle);
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
    path."""
    square_pairs = n * n
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
    elif kernel == "fused_phi_aniso_terms_sym":
        n_w = (1 if n_iso else 0) + n_aniso
        flops = tri_pairs * (3 * m + T + 6 * n_iso + n_aniso * (3 * m + 6)
                             + 2 * (2 * m + 2 * m * n_w))
    elif kernel == "phi_rbf_square":
        flops = (square_pairs * (4 * m + 2 + contract) if all_pairs
                 else tri_pairs * (4 * m + 2 + 2 * contract))
        T = 0
    elif kernel == "count_le_cross":
        sq_ops = 3 * m if m <= 4 else 2 * m + 3
        compares = math.ceil(math.log2(T + 1))
        if n_c is None:  # a self count: one set, the triangle and diagonal
            flops = n * (n + 1) / 2 * (sq_ops + compares)
            return bound(flops, 4 * n * m + 12 * T)
        flops = n * n_c * (sq_ops + compares)
        return bound(flops, 4 * (n + n_c) * m + 12 * T)
    else:
        raise ValueError(kernel)
    if kernel.endswith("_chunk"):
        out_floats = 2 * n * m
    nbytes = (4 * (2 * n * m + n_aniso * m * m + n_iso + T) + 4 * out_floats
              + 8 * T)
    if kernel == "phi_rbf_square":
        nbytes += 4 * m * m
    return bound(flops, nbytes)


#: Published H100 SXM dense TF32 tensor-core peak (NVIDIA's data sheet).
PEAK_TF32_FLOPS = 495e12


def square_tensor_bound(n, m, T=3, n_terms=None):
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
    once."""
    pairs = n * n
    fp32 = 4 + T if n_terms is None else 4 + 6 * n_terms + T
    nbytes = 4 * (2 * n * m + (n_terms or 1) + T) + 4 * n * m + 8 * T
    return max(
        (pairs * (6 * m + 2) / PEAK_TF32_FLOPS * 1e3, "tensor operations"),
        (pairs * fp32 / PEAK_FP32_FLOPS * 1e3, "operations"),
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


def chunk_pairs(n, side, blocks):
    """Unordered pairs (diagonal included) in ``blocks``, a list of
    (bi, bj) blocks of ``side`` particles a side over n particles: a
    diagonal block holds j >= i only, ragged blocks their rows and columns
    below n."""
    total = 0
    for bi, bj in blocks:
        rows = max(0, min(side, n - bi * side))
        cols = max(0, min(side, n - bj * side))
        total += rows * (rows + 1) // 2 if bi == bj else rows * cols
    return total


def free_port():
    """A free TCP port on localhost for a torch.distributed rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def require_only(counts, kernel, launches, what, count_launches=0,
                 also=None):
    """The sweep kernels' launches in ``counts`` are ``launches`` of
    ``kernel``, those of ``also`` ({kernel: launches}, the decomposition
    beside K15's sweep on the HESSIAN route) and none of the others, and
    the count kernel (K16's port), which runs under every median whichever
    sweep the path takes, launched at least ``count_launches`` times."""
    from svgdcpp_tpu_torch.ops.cuda_phi import COUNT_KERNEL

    sweeps = {k: v for k, v in counts.items() if k != COUNT_KERNEL}
    want = {k: 0 for k in sweeps}
    want[kernel] = launches
    want.update(also or {})
    check(sweeps == want, f"{what}: launches {counts}, want {want}")
    check(counts[COUNT_KERNEL] >= count_launches,
          f"{what}: {counts[COUNT_KERNEL]} launches of {COUNT_KERNEL}, "
          f"want at least {count_launches}")


def compare_phi(name, got, want):
    """(max |dphi| / max |phi|, max |dphi|), phi within 1e-4 relative."""
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    check(bool(got.isfinite().all()), f"{name}: non-finite phi")
    check(rel <= 1e-4, f"{name}: phi rel err {rel:.3e} > 1e-4")
    return rel, abs_err


def compare(name, got, want, n, m, n_t=None):
    """(max |dphi| / max |phi|, max |dphi|, max |dcounts|) with the checks:
    phi within 1e-4 relative; counts exact at m <= 4, where the kernels and
    the plain version both build sq from differences in one order, and
    within 1e-6 * n_t * n_s above, where the plain version uses the Gram
    identity (ties at a threshold may go either way)."""
    phi_k, cnt_k = got
    phi_p, cnt_p = want
    abs_err = float((phi_k - phi_p).abs().max())
    rel = abs_err / float(phi_p.abs().max())
    dcnt = int((cnt_k - cnt_p).abs().max())
    check(bool(phi_k.isfinite().all()), f"{name}: non-finite phi")
    check(rel <= 1e-4, f"{name}: phi rel err {rel:.3e} > 1e-4")
    if m <= 4:
        check(dcnt == 0, f"{name}: counts differ by {dcnt} (must be equal)")
    else:
        bound = 1e-6 * (n if n_t is None else n_t) * n
        check(dcnt <= bound,
              f"{name}: counts differ by {dcnt} > 1e-6*n_t*n_s = {bound:.3g}")
    return rel, abs_err, dcnt


def ptxas_summary(log_text):
    """{instance: "R regs, S B spill"} from ptxas's -v report, an instance
    named kernel<MM,exact> (sweep_common.cuh), e.g. rbf_square<2,1>
    (phi_rbf_square); the square kernels' tensor-core instances their
    thresholds and the terms kernel's its term count (0: any),
    counts_square<50,1,3> and terms_square<11,1,3,2>; the terms triangle sweep
    (terms_sym.cuh) has a third flag, its term groups: terms_sym<11,1,0>
    and aniso_terms_sym<11,1,1>; the panel kernels their thresholds, and
    the terms panel kernel its term count (0: any), counts_sympanel<2,1,3>
    and terms_sympanel<11,1,3,2>; the count kernel (count_le.cu)
    count_le<MM,exact,gram,binned,P> (P: thresholds held, or binned search
    steps) and count_le_wide<TT>; the one-pass anisotropic kernel
    aniso_terms_sym<MM,exact,NIso,kT> (NIso 0: any number of isotropic
    terms) beside the term-group one, aniso_terms_groups<MM,exact,1>."""
    import re

    out, name = {}, None
    spill = "?"
    for line in log_text.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            inst = re.search(
                r"(?<=\d)(?:fused_)?phi_(\w+?)_kernel"
                r"ILi(\d+)ELb([01])E(?:Lb([01])E)?(?:Li(\d+)E)?(?:Li(\d+)E)?",
                hit.group(1),
            )
            flags = ",".join(g for g in inst.groups()[1:] if g) if inst else ""
            name = f"{inst.group(1)}<{flags}>" if inst else hit.group(1)
            other = re.search(
                r"(count_le_cross_wide|count_le_cross|aniso_terms_sym)"
                r"_kernelI((?:L[ib]\d+E)+)", hit.group(1))
            if other:
                args = ",".join(re.findall(r"L[ib](\d+)E", other.group(2)))
                short = {"count_le_cross": "count_le",
                         "count_le_cross_wide": "count_le_wide"}
                name = f"{short.get(other.group(1), other.group(1))}<{args}>"
            spill = "?"
        hit = re.search(r"(\d+) bytes spill stores", line)
        if hit and name:
            spill = hit.group(1)
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            out[name] = f"{hit.group(1)} regs, {spill} B spill"
            name = None
    return out


def blr_accuracy(coords, features, labels):
    """Training accuracy of the posterior-mean predictive: the particles'
    mean weights (the first d coordinates) classify the data by sign."""
    import numpy as np

    d = features.shape[1]
    w = np.asarray(coords, np.float64)[:, :d].mean(axis=0)
    return float(np.mean(np.sign(features @ w) == labels))


def posterior_metrics(coords, mean, cov):
    """Empirical-moment errors of the particles against the target, the
    first normalized by the Monte-Carlo error of n exact samples (as
    bench.py's posterior_metrics)."""
    import numpy as np

    coords = np.asarray(coords, np.float64)
    n = coords.shape[0]
    emp_mean = coords.mean(axis=0)
    emp_cov = np.cov(coords.T)
    mean_mc = np.sqrt(np.diag(cov) / n)
    cov_mc = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov**2) / n)
    return {
        "mean_err_over_mc": float((np.abs(emp_mean - mean) / mean_mc).max()),
        "cov_rel_err": float(np.linalg.norm(emp_cov - cov) / np.linalg.norm(cov)),
        "cov_err_over_mc": float((np.abs(emp_cov - cov) / cov_mc).max()),
    }


def make_svgd(st, x0, mean, cov, iters, phi_impl="auto", dtype=None,
              fused_sym=None):
    """The flagship driver on the card (utils/workloads.build_mvn_svgd),
    float32 unless ``dtype`` says otherwise."""
    import torch

    from svgdcpp_tpu_torch.utils.workloads import build_mvn_svgd

    x = torch.tensor(x0, dtype=dtype or torch.float32, device="cuda")
    return build_mvn_svgd(x, mean, cov, phi_impl=phi_impl,
                          num_iterations=iters, fused_sym=fused_sym)


def f64_rows_reference(x, s, gammas, signs, thr, rows):
    """phi of ``rows`` of one particle set in float64 (the plain cross sweep
    of the rows against every particle), returned in float32: the reference
    where two float32 kernels differ by their summation order alone."""
    import torch

    from svgdcpp_tpu_torch.ops.phi import phi_rbf_terms_cross_fused_counts

    x64, s64 = x.double(), s.double()
    return phi_rbf_terms_cross_fused_counts(
        x64[rows], x64, s64, [g.double() for g in gammas], signs, thr.double()
    )[0].to(torch.float32)


SHARDED_N, SHARDED_ITERS, SHARDED_LARGE_ITERS = 10000, 1000, 20


def sharded_rank(rank, world, port, queue):
    """Phase 31's rank ``rank`` of ``world``, spawned (not forked) once the
    parent's CUDA is up: a gloo world on the one card (NCCL refuses two
    ranks on one device), the sharded flagship and hierarchical BLR at
    N = 10,000 for COMPARE_STEPS steps from the workloads' x0; puts
    (rank, {case: (gathered coords, launch counts, form)}) on ``queue``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.parallel import initialize_distributed
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_sharded_hier_svgd,
        build_sharded_mvn_svgd,
        flagship_mvn,
    )

    group = initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                   backend="gloo", device="cuda:0")
    out = {}
    mean, cov, x0 = flagship_mvn(SHARDED_N)
    x0 = x0.astype(np.float32)
    feats, labels, x0_h = blr_workload(SHARDED_N, 10, hierarchical=True)
    for case, build, x in (
        ("flagship", lambda: build_sharded_mvn_svgd(x0, mean, cov, group),
         x0),
        ("hier", lambda: build_sharded_hier_svgd(x0_h, feats, labels, group),
         x0_h),
    ):
        engine = build()
        cuda_phi.reset_launch_counts()
        coords = engine.run(x, COMPARE_STEPS)
        torch.cuda.synchronize()
        out[case] = (coords.cpu().numpy(), dict(cuda_phi.launch_counts),
                     engine._fused_sym)
    queue.put((rank, out))
    dist.destroy_process_group()


def main() -> int:
    import torch

    t_start = time.perf_counter()

    def clock():
        """Seconds since the script started (printed on phases 19-24)."""
        return f"t={time.perf_counter() - t_start:.1f}s"

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA device", file=sys.stderr)
        return 1

    import numpy as np

    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.ksd import ksd_rbf
    from svgdcpp_tpu_torch.ops import median as median_mod
    from svgdcpp_tpu_torch.ops.median import (
        count_le_cross,
        count_le_plain,
        pairwise_distance_median_hybrid,
    )
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf,
        phi_rbf_aniso_terms_fused_counts,
        phi_rbf_blocked,
        phi_rbf_cross_fused_counts,
        phi_rbf_fused_counts,
        phi_rbf_fused_sym_finish,
        phi_rbf_sym_chunk_counts,
        phi_rbf_sympanel_chunk_counts,
        phi_rbf_sympanel_fused_counts,
        phi_rbf_terms_cross_fused_counts,
        phi_rbf_terms_fused_counts,
        phi_rbf_terms_fused_sym_finish,
        phi_rbf_terms_sym_chunk_counts,
        phi_rbf_terms_sympanel_fused_counts,
    )
    from svgdcpp_tpu_torch.ops.sym_plan import (
        SQUARE_TENSOR_MIN_M,
        card_panel_plan,
        square_splits,
        sym_tile,
        sym_tile_chunk,
        tpu_terms_panel_kernel,
        upper_tile_rows,
    )
    from svgdcpp_tpu_torch.parallel import initialize_distributed
    from svgdcpp_tpu_torch.utils.workloads import (
        aniso_mvn_workload,
        blr_workload,
        build_aniso_svgd,
        build_blr_svgd,
        build_sharded_hier_svgd,
        build_sharded_mvn_svgd,
        flagship_mvn,
        large_hier_workload,
        large_mvn_workload,
    )

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    # -- phase 1: device and build ------------------------------------
    t0 = time.perf_counter()
    cuda_phi.load_library()
    build_s = time.perf_counter() - t0
    log = cuda_phi.build_log_path()
    ptxas = ptxas_summary(log.read_text() if log.exists() else "")
    print(card)
    print(f"phase 1 device+build: ok torch={torch.__version__} "
          f"cuda={torch.version.cuda} build_s={build_s:.1f} "
          f"ptxas={json.dumps(ptxas)}")

    # -- phase 2: square kernel vs plain ------------------------------
    square_err = 0.0
    # (1500, 2) is the shape phase 4's main path gives the kernel.
    cases = [(1000, 2, 0.0), (1337, 3, 0.0), (600, 8, 0.0), (1000, 2, 1e3),
             (1500, 2, 0.0)]
    for idx, (n, m, off) in enumerate(cases):
        x, s, g, thr = inputs_for(n, m, off, 10 + idx, dev)
        got = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False)
        want = phi_rbf_fused_counts(x, s, g, thr)
        rel, abs_err, dcnt = compare(f"square n={n} m={m} off={off}",
                                     got, want, n, m)
        square_err = max(square_err, abs_err)
        print(f"phase 2 square n={n} m={m} offset={off}: ok "
              f"phi_rel={rel:.3e} count_diff={dcnt}")
    xt, _, _, _ = sweep_inputs(700, 2, 0.0, 20, dev)
    xs, ss, g, thr = sweep_inputs(1500, 2, 0.0, 21, dev)
    got = cuda_phi.phi_rbf_fused_cuda_cross(xt, xs, ss, g, thr)
    want = phi_rbf_cross_fused_counts(xt, xs, ss, g, thr)
    rel, abs_err, dcnt = compare("cross 700x1500", got, want, 1500, 2)
    square_err = max(square_err, abs_err)
    print(f"phase 2 cross n_t=700 n_s=1500 m=2: ok phi_rel={rel:.3e} "
          f"count_diff={dcnt}")
    # The wrapper sizes its workspace by the library's split count: hold
    # sym_plan.square_splits, its Python copy, to it.
    lib = cuda_phi.load_library()
    shapes = [(n_t, n_s, m) for n_t in (1, 64, 700, 1000, 1500, 10007)
              for n_s in (1, 33, 1000, 1500, 20000)
              for m in (1, 2, 3, 4, 5, 8, 9, 11, 16, 50, 64)]
    splits_off = [a for a in shapes
                  if lib.svgd_square_splits(*a) != square_splits(*a)]
    check(not splits_off, f"svgd_square_splits and sym_plan.square_splits "
                          f"differ at (n_t, n_s, m) in {splits_off}")
    print(f"phase 2 splits: svgd_square_splits equals sym_plan.square_splits "
          f"at {len(shapes)} shapes")
    # Scores as a float32 row-slice view, square and cross at m = 50: the
    # view from row 1 starts 8 bytes past a 16-byte boundary, which the
    # tensor-core body's 16-byte copies may not read from (the wrapper
    # copies it).
    x, s, g, thr = inputs_for(1000, 50, 0.0, 22, dev)
    s = torch.cat([s[:1], s])[1:]
    check(s.data_ptr() % 16 != 0, "the scores view starts on a 16-byte "
                                  "boundary: it tests nothing")
    for name, got, want in [
            ("square", cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False),
             phi_rbf_fused_counts(x, s, g, thr)),
            ("cross", cuda_phi.phi_rbf_fused_cuda_cross(x[:700], x, s, g, thr),
             phi_rbf_cross_fused_counts(x[:700], x, s, g, thr))]:
        n_t = got[0].shape[0]
        rel, abs_err, dcnt = compare(f"{name} scores view m=50", got, want,
                                     1000, 50, n_t=n_t)
        square_err = max(square_err, abs_err)
        print(f"phase 2 {name} n_t={n_t} n_s=1000 m=50 scores view at a "
              f"{s.data_ptr() % 16}-byte offset: ok phi_rel={rel:.3e} "
              f"count_diff={dcnt}")

    # -- phase 3: triangle kernel vs plain, and times ------------------
    sym_err = 0.0
    for idx, n in enumerate((2048, 10000, 10007)):
        x, s, g, thr = sweep_inputs(n, 2, 100.0, 30 + idx, dev)
        got = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)
        want = phi_rbf_fused_counts(x, s, g, thr)
        rel, abs_err, dcnt = compare(f"sym n={n}", got, want, n, 2)
        sym_err = max(sym_err, abs_err)
        print(f"phase 3 sym n={n} m=2 offset=100: ok phi_rel={rel:.3e} "
              f"count_diff={dcnt}")
    # Every micro-tile instance (m = 1-8 and 11) at ragged n = 10007 off
    # origin: T = 3 (the fixed-T instance), T = 1 and 8 (the runtime-T
    # one); counts equal at m <= 4 (compare's rule).
    for m in (1, 2, 3, 4, 5, 6, 7, 8, 11):
        x, s, g, thr3 = inputs_for(10007, m, 100.0, 330 + m, dev)
        worst = (0.0, 0)
        for n_t in (3, 1, 8):
            thr = thresholds_of(thr3, n_t)
            got = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)
            want = phi_rbf_fused_counts(x, s, g, thr)
            rel, abs_err, dcnt = compare(f"sym n=10007 m={m} T={n_t}", got,
                                         want, 10007, m)
            sym_err = max(sym_err, abs_err)
            worst = (max(worst[0], rel), max(worst[1], dcnt))
        print(f"phase 3 sym n=10007 m={m} offset=100.0 T=1,3,8: ok "
              f"max_phi_rel={worst[0]:.3e} max_count_diff={worst[1]} "
              f"count_bound={1e-6 * 10007 * 10007 if m > 4 else 0:.3g}")
    times = {}
    for n in (1500, 10000):
        x, s, g, thr = sweep_inputs(n, 2, 0.0, 40, dev)
        times[n] = {
            "plain": time_ms(lambda: phi_rbf_fused_counts(x, s, g, thr)),
            "square": time_ms(
                lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False)
            ),
            "sym": time_ms(
                lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)
            ),
        }
        print(f"phase 3 times n={n} m=2 T=3 (ms, median of 50): "
              + " ".join(f"{k}={v:.4f}" for k, v in times[n].items()))

    # -- phase 4: main path, square kernel (n = 1500) ------------------
    mean, cov, x0 = flagship_mvn(1500)
    cuda_phi.reset_launch_counts()
    svgd = make_svgd(st, x0, mean, cov, 50)
    check(svgd._phi_impl == "fused_cuda",
          f"n=1500 routed to {svgd._phi_impl!r}, not 'fused_cuda'")
    out = svgd.run()
    torch.cuda.synchronize()
    main_square = dict(cuda_phi.launch_counts)
    check(bool(out.isfinite().all()) and tuple(out.shape) == (1500, 2),
          "n=1500 run: bad output")
    check(main_square[cuda_phi.SQUARE_KERNEL] == 50
          and main_square[cuda_phi.SYM_KERNEL] == 0,
          f"n=1500, 50 steps: launches {main_square}, want 50 square, 0 sym")
    print(f"phase 4 main path n=1500 50 iters: ok route=fused_cuda "
          f"launches={json.dumps(main_square)} "
          f"fallbacks={svgd.median_fallbacks}")

    # -- phase 5: flagship N=10000, 1000 iterations --------------------
    mean, cov, x0 = flagship_mvn(10000)
    segments, seg_len = 10, 100
    cuda_phi.reset_launch_counts()
    svgd = make_svgd(st, x0, mean, cov, seg_len)
    check(svgd._phi_impl == "fused_cuda",
          f"n=10000 routed to {svgd._phi_impl!r}, not 'fused_cuda'")
    svgd.run()  # warm-up segment, untimed
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(segments - 1):
        svgd.run()
    end.record()
    end.synchronize()
    timed_s = start.elapsed_time(end) / 1e3
    main_sym = dict(cuda_phi.launch_counts)
    out = svgd.store.value
    check(bool(out.isfinite().all()) and tuple(out.shape) == (10000, 2),
          "flagship run: bad output")
    check(main_sym[cuda_phi.SYM_KERNEL] == segments * seg_len
          and main_sym[cuda_phi.SQUARE_KERNEL] == 0,
          f"flagship, 1000 steps: launches {main_sym}, want 1000 sym, 0 square")
    rate = 10000 * (segments - 1) * seg_len / timed_s
    post = posterior_metrics(out.cpu().numpy(), mean, cov)
    check(post["mean_err_over_mc"] <= 1.0,
          f"mean_err_over_mc {post['mean_err_over_mc']:.3f} > 1.0")
    check(post["cov_rel_err"] <= 0.05,
          f"cov_rel_err {post['cov_rel_err']:.4f} > 0.05")
    print(f"phase 5 flagship n=10000 1000 iters: ok route=fused_cuda "
          f"launches={json.dumps(main_sym)} fallbacks={svgd.median_fallbacks} "
          f"updates_per_s={rate:.6g} timed_s={timed_s:.4f} "
          f"posterior={json.dumps(post)}")

    # -- phase 6: kernel route vs plain route, 20 steps ----------------
    # The float64 plain route is printed beside them as the float32 noise
    # floor: AdaGrad divides by sqrt(sum g^2), so where phi is small a
    # rounding difference moves a particle far more than phi's own error.
    # The kernel route runs twice: its float32 atomics sum in an order that
    # changes between runs, and the two runs' distance is its run-to-run
    # floor.
    finals = {}
    for impl, dtype in (("fused_cuda", torch.float32), ("fused", torch.float32),
                        ("fused", torch.float64), ("again", torch.float32)):
        s6 = make_svgd(st, x0, mean, cov, 20,
                       phi_impl="fused_cuda" if impl == "again" else impl,
                       dtype=dtype)
        finals[(impl, dtype)] = s6.run().double()
    ref = finals[("fused", torch.float64)]
    diff = float((finals[("fused_cuda", torch.float32)]
                  - finals[("fused", torch.float32)]).abs().max())
    repeat = float((finals[("fused_cuda", torch.float32)]
                    - finals[("again", torch.float32)]).abs().max())
    floor = {
        impl: float((finals[(impl, torch.float32)] - ref).abs().max())
        for impl in ("fused_cuda", "fused")
    }
    check(diff <= 1e-3, f"fused_cuda vs fused coords differ by {diff:.3e}")
    print(f"phase 6 fused_cuda vs fused n=10000 20 steps: ok "
          f"coords_max_abs_diff={diff:.3e} "
          f"vs_float64_plain={json.dumps(floor)} "
          f"fused_cuda_run_to_run={repeat:.3e}")

    # -- phase 7: terms kernels vs plain -------------------------------
    def terms_gammas(g, signs):
        # the hierarchical config's pair (median gamma, constant 0.1), and
        # a third term at twice the median gamma for three-term cases
        return [g, torch.full_like(g, 0.1), 2.0 * g][:len(signs)]

    # (1500, 11) with two terms is the shape phase 10's main path gives the
    # square kernel.
    terms_sq_err = 0.0
    for idx, (n, m, signs) in enumerate([
        (1000, 2, (1.0, 1.0)), (700, 11, (1.0, 1.0)),
        (1000, 11, (1.0, -1.0, 1.0)), (600, 23, (1.0, 0.5)),
        (1500, 11, (1.0, 1.0)),
    ]):
        x, s, g, thr = inputs_for(n, m, 0.0, 70 + idx, dev)
        gs = terms_gammas(g, signs)
        got = cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr, sym=False)
        want = phi_rbf_terms_fused_counts(x, s, gs, signs, thr)
        rel, abs_err, dcnt = compare(f"terms square n={n} m={m}", got, want,
                                     n, m)
        terms_sq_err = max(terms_sq_err, abs_err)
        print(f"phase 7 terms square n={n} m={m} signs={list(signs)}: ok "
              f"phi_rel={rel:.3e} count_diff={dcnt} "
              f"count_bound={1e-6 * n * n if m > 4 else 0:.3g}")
    xt, _, _, _ = inputs_for(700, 11, 0.0, 75, dev)
    xs, ss, g, thr = inputs_for(1500, 11, 0.0, 76, dev)
    gs = terms_gammas(g, (1.0, 1.0))
    got = cuda_phi.phi_rbf_terms_fused_cuda_cross(xt, xs, ss, gs, (1, 1), thr)
    want = phi_rbf_terms_cross_fused_counts(xt, xs, ss, gs, (1, 1), thr)
    rel, abs_err, dcnt = compare("terms cross 700x1500", got, want, 1500, 11,
                                 n_t=700)
    terms_sq_err = max(terms_sq_err, abs_err)
    print(f"phase 7 terms cross n_t=700 n_s=1500 m=11: ok phi_rel={rel:.3e} "
          f"count_diff={dcnt} count_bound={1e-6 * 700 * 1500:.3g}")
    # Every instance of the square kernel's two bodies: the CUDA cores at
    # m = 1-4, the tensor cores at MM = 8 (m = 5, 8), 11, 16 (13, 16), 32,
    # 50 and 64; T = 3 (the fixed-T instances) and T = 1 and 8 (the
    # runtime-T ones), two terms (constants in registers) with signs (1, 1)
    # and (1, -1), three terms (shared memory); square at ragged n = 1337
    # off origin, cross 700 x 1337. The inputs are on a grid above m = 4,
    # where both the kernel and the plain version take the Gram sq, so the
    # counts must be equal at every m.
    for m in (1, 2, 3, 4, 5, 8, 11, 13, 16, 32, 50, 64):
        x, s, g, thr3 = inputs_for(1337, m, 100.0, 720 + m, dev)
        xt = inputs_for(700, m, 100.0, 780 + m, dev)[0]
        worst = (0.0, 0)
        for n_t, signs in ((3, (1.0, 1.0)), (3, (1.0, -1.0)),
                           (1, (1.0, -1.0)), (8, (1.0, 1.0)),
                           (3, (1.0, -0.5, 0.3))):
            thr = thresholds_of(thr3, n_t)
            gs = terms_gammas(g, signs)
            for form, got, want in (
                    ("square", cuda_phi.phi_rbf_terms_fused_cuda(
                        x, s, gs, signs, thr, sym=False),
                     phi_rbf_terms_fused_counts(x, s, gs, signs, thr)),
                    ("cross", cuda_phi.phi_rbf_terms_fused_cuda_cross(
                        xt, x, s, gs, signs, thr),
                     phi_rbf_terms_cross_fused_counts(xt, x, s, gs, signs,
                                                      thr))):
                name = f"terms {form} m={m} T={n_t} signs={signs}"
                n_rows = got[0].shape[0]
                rel, abs_err, dcnt = compare(name, got, want, 1337, m,
                                             n_t=n_rows)
                check(dcnt == 0, f"{name}: counts differ by {dcnt} on grid "
                                 f"inputs (must be equal)")
                terms_sq_err = max(terms_sq_err, abs_err)
                worst = (max(worst[0], rel), max(worst[1], dcnt))
        body = "tensor cores" if m >= SQUARE_TENSOR_MIN_M else "CUDA cores"
        print(f"phase 7 terms square+cross n=1337 (cross 700x1337) m={m} "
              f"({body}) offset=100.0 T=1,3,8 signs=(1,1),(1,-1),"
              f"(1,-0.5,0.3): ok max_phi_rel={worst[0]:.3e} "
              f"max_count_diff={worst[1]}")
    # Scores as a float32 row-slice view off a 16-byte boundary (the
    # tensor-core body's 16-byte copies may not read from it; the wrapper
    # copies it), square and cross.
    for m in (11, 50):
        x, s, g, thr = inputs_for(1000, m, 0.0, 760 + m, dev)
        s = torch.cat([s[:1], s])[1:]
        check(s.data_ptr() % 16 != 0, "the scores view starts on a 16-byte "
                                      "boundary: it tests nothing")
        gs = terms_gammas(g, (1.0, 1.0))
        for form, got, want in [
                ("square", cuda_phi.phi_rbf_terms_fused_cuda(
                    x, s, gs, (1, 1), thr, sym=False),
                 phi_rbf_terms_fused_counts(x, s, gs, (1, 1), thr)),
                ("cross", cuda_phi.phi_rbf_terms_fused_cuda_cross(
                    x[:700], x, s, gs, (1, 1), thr),
                 phi_rbf_terms_cross_fused_counts(x[:700], x, s, gs, (1, 1),
                                                  thr))]:
            n_t = got[0].shape[0]
            name = f"terms {form} scores view m={m}"
            rel, abs_err, dcnt = compare(name, got, want, 1000, m, n_t=n_t)
            check(dcnt == 0, f"{name}: counts differ by {dcnt} on grid "
                             f"inputs (must be equal)")
            terms_sq_err = max(terms_sq_err, abs_err)
            print(f"phase 7 terms {form} n_t={n_t} n_s=1000 m={m} scores "
                  f"view at a {s.data_ptr() % 16}-byte offset: ok "
                  f"phi_rel={rel:.3e} count_diff={dcnt}")
    # The tensor-core products against float64 rows (f64_rows_reference) on
    # Gaussian inputs, at phase 10's shape and the flat BLR's width, with
    # the hierarchical pair of terms: the kernel's and the float32 plain
    # version's distance over max |phi|, held to ROADMAP's 2.5e-3 for a
    # TF32 contraction; and two calls on one input, which must give the same
    # phi (the splits are summed in order, with no float atomics).
    for n, m in ((1500, 11), (1000, 50)):
        x, s, g, thr = sweep_inputs(n, m, 0.0, 790 + m, dev)
        gs = terms_gammas(g, (1.0, 1.0))
        rows = torch.arange(0, n, 7, device=dev)
        ref = f64_rows_reference(x, s, gs, (1.0, 1.0), thr, rows)
        scale = float(ref.abs().max())
        first = cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, (1, 1), thr,
                                                  sym=False)[0]
        second = cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, (1, 1), thr,
                                                   sym=False)[0]
        f64_err = {
            name: float((phi[rows] - ref).abs().max()) / scale
            for name, phi in (
                ("kernel", first),
                ("plain", phi_rbf_terms_fused_counts(x, s, gs, (1, 1),
                                                     thr)[0]))
        }
        check(f64_err["kernel"] <= 2.5e-3,
              f"terms square n={n} m={m}: {f64_err['kernel']:.3e} of max "
              f"|phi| from float64 > 2.5e-3")
        check(bool((first == second).all()),
              f"terms square n={n} m={m}: two calls differ by "
              f"{float((first - second).abs().max()):.3e}")
        print(f"phase 7 terms square n={n} m={m} vs float64 rows: ok "
              f"max_rel={json.dumps(f64_err)} (limit 2.5e-3); two calls "
              f"equal")
    terms_sym_err = 0.0
    for idx, (n, m, off) in enumerate([
        (2048, 11, 100.0), (10000, 11, 100.0), (10007, 11, 100.0),
        (32768, 11, 0.0), (2048, 2, 100.0), (2100, 50, 0.0),
    ]):
        x, s, g, thr = inputs_for(n, m, off, 80 + idx, dev)
        gs = terms_gammas(g, (1.0, 1.0))
        got = cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, (1, 1), thr, sym=True)
        want = phi_rbf_terms_fused_counts(x, s, gs, (1, 1), thr)
        rel, abs_err, dcnt = compare(f"terms sym n={n} m={m}", got, want, n, m)
        terms_sym_err = max(terms_sym_err, abs_err)
        print(f"phase 7 terms sym n={n} m={m} offset={off}: ok "
              f"phi_rel={rel:.3e} count_diff={dcnt} "
              f"count_bound={1e-6 * n * n if m > 4 else 0:.3g}")
    # The micro-tile body's instances (m = 1-8 and 11) and the wider body's
    # (the runtime instances of 16 at m = 9 and 16, of 64 at 50) at ragged
    # n = 10007 off origin: T = 3 (the fixed-T instance) and T = 1 and 8
    # (the runtime-T one), two terms (constants in registers) with signs
    # (1, 1) and (1, -1), three terms (shared memory); counts equal at
    # m <= 4 (compare's rule).
    for m in (1, 2, 3, 4, 5, 6, 7, 8, 11, 9, 16, 50):
        x, s, g, thr3 = inputs_for(10007, m, 100.0, 700 + m, dev)
        worst = (0.0, 0)
        for n_t, signs in ((3, (1.0, 1.0)), (3, (1.0, -1.0)),
                           (1, (1.0, -1.0)), (8, (1.0, 1.0)),
                           (3, (1.0, -0.5, 0.3))):
            thr = thresholds_of(thr3, n_t)
            gs = terms_gammas(g, signs)
            got = cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                    sym=True)
            want = phi_rbf_terms_fused_counts(x, s, gs, signs, thr)
            rel, abs_err, dcnt = compare(
                f"terms sym n=10007 m={m} T={n_t} signs={signs}", got, want,
                10007, m)
            terms_sym_err = max(terms_sym_err, abs_err)
            worst = (max(worst[0], rel), max(worst[1], dcnt))
        print(f"phase 7 terms sym n=10007 m={m} offset=100.0 T=1,3,8 "
              f"signs=(1,1),(1,-1),(1,-0.5,0.3): ok max_phi_rel="
              f"{worst[0]:.3e} max_count_diff={worst[1]} count_bound="
              f"{1e-6 * 10007 * 10007 if m > 4 else 0:.3g}")

    # -- phase 8: K1/K2 at m = 11 and 50 vs plain -----------------------
    # (1000, 50) is the flat-BLR shape; m = 13, 20, 37 run the runtime-m
    # instances (MM = 16, 32, 64); the cross form at m = 13 and 50.
    for idx, m in enumerate((13, 50)):
        xt, _, _, _ = inputs_for(700, m, 0.0, 80 + idx, dev)
        xs, ss, g, thr = inputs_for(1500, m, 0.0, 82 + idx, dev)
        got = cuda_phi.phi_rbf_fused_cuda_cross(xt, xs, ss, g, thr)
        want = phi_rbf_cross_fused_counts(xt, xs, ss, g, thr)
        rel, abs_err, dcnt = compare(f"cross 700x1500 m={m}", got, want,
                                     1500, m, n_t=700)
        square_err = max(square_err, abs_err)
        print(f"phase 8 cross n_t=700 n_s=1500 m={m}: ok phi_rel={rel:.3e} "
              f"count_diff={dcnt} count_bound={1e-6 * 700 * 1500:.3g}")
    # The tensor-core products against float64 at the flat-BLR shape on
    # Gaussian inputs: every 7th row of phi in float64 (f64_rows_reference),
    # the kernel's and the float32 plain version's distance to it over
    # max |phi|, held to ROADMAP's 2.5e-3 for a TF32 contraction.
    x, s, g, thr = sweep_inputs(1000, 50, 0.0, 89, dev)
    rows = torch.arange(0, 1000, 7, device=dev)
    ref = f64_rows_reference(x, s, [g], (1.0,), thr, rows)
    scale = float(ref.abs().max())
    f64_err = {
        name: float((phi[rows] - ref).abs().max()) / scale
        for name, phi in (
            ("kernel", cuda_phi.phi_rbf_fused_cuda(x, s, g, thr,
                                                   sym=False)[0]),
            ("plain", phi_rbf_fused_counts(x, s, g, thr)[0]))
    }
    check(f64_err["kernel"] <= 2.5e-3,
          f"square n=1000 m=50: {f64_err['kernel']:.3e} of max |phi| from "
          f"float64 > 2.5e-3")
    print(f"phase 8 square n=1000 m=50 vs float64 rows: ok "
          f"max_rel={json.dumps(f64_err)} (limit 2.5e-3)")
    for idx, (n, m, sym) in enumerate([
        (1000, 50, False), (1000, 11, False), (500, 13, False),
        (400, 20, False), (600, 37, False), (2048, 11, True),
        (10000, 11, True), (2048, 50, True), (3000, 37, True),
    ]):
        x, s, g, thr = inputs_for(n, m, 0.0, 90 + idx, dev)
        got = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=sym)
        want = phi_rbf_fused_counts(x, s, g, thr)
        kind = "sym" if sym else "square"
        rel, abs_err, dcnt = compare(f"{kind} n={n} m={m}", got, want, n, m)
        if sym:
            sym_err = max(sym_err, abs_err)
        else:
            square_err = max(square_err, abs_err)
        print(f"phase 8 {kind} n={n} m={m}: ok phi_rel={rel:.3e} "
              f"count_diff={dcnt} count_bound={1e-6 * n * n:.3g}")

    # -- phase 9: times, kernel vs plain --------------------------------
    def terms_fns(sym):
        return (
            lambda x, s, g, t: cuda_phi.phi_rbf_terms_fused_cuda(
                x, s, g, (1, 1), t, sym=sym),
            lambda x, s, g, t: phi_rbf_terms_fused_counts(x, s, g, (1, 1), t),
        )

    def single_fns(sym):
        return (
            lambda x, s, g, t: cuda_phi.phi_rbf_fused_cuda(
                x, s, g[0], t, sym=sym),
            lambda x, s, g, t: phi_rbf_fused_counts(x, s, g[0], t),
        )

    # The main paths' shapes first (hier N=10k and n=1500, flat BLR), then
    # K9's range on the TPU (n = 32768) and the single-term kernels at
    # m = 11 and 50 on both sweeps.
    times9 = {}
    for label, n, m, (fn_k, fn_p) in (
        ("terms_sym", 10000, 11, terms_fns(True)),
        ("terms_square", 1500, 11, terms_fns(False)),
        ("terms_square", 1500, 2, terms_fns(False)),
        ("square", 1000, 50, single_fns(False)),
        ("terms_sym", 32768, 11, terms_fns(True)),
        ("square", 1000, 11, single_fns(False)),
        ("sym", 10000, 11, single_fns(True)),
        ("sym", 10000, 50, single_fns(True)),
    ):
        x, s, g, thr = sweep_inputs(n, m, 0.0, 99, dev)
        gs = terms_gammas(g, (1, 1))
        plain = time_ms(lambda: fn_p(x, s, gs, thr))
        kern = time_ms(lambda: fn_k(x, s, gs, thr))
        times9[(label, n, m)] = {"kernel": kern, "plain": plain}
        print(f"phase 9 times {label} n={n} m={m} T=3 (ms, median of 50): "
              f"kernel={kern:.4f} plain={plain:.4f}")

    # -- phase 10: hierarchical BLR main path, n = 1500 -------------------
    feats, labels, x0 = blr_workload(1500, 10, hierarchical=True)
    cuda_phi.reset_launch_counts()
    svgd = build_blr_svgd(torch.tensor(x0, device=dev), feats, labels,
                          hierarchical=True, num_iterations=50)
    check(svgd._phi_impl == "fused_terms_cuda",
          f"hier n=1500 routed to {svgd._phi_impl!r}, not 'fused_terms_cuda'")
    out = svgd.run()
    torch.cuda.synchronize()
    main_terms_sq = dict(cuda_phi.launch_counts)
    check(bool(out.isfinite().all()) and tuple(out.shape) == (1500, 11),
          "hier n=1500 run: bad output")
    require_only(main_terms_sq, cuda_phi.TERMS_SQUARE_KERNEL, 50,
                 "hier n=1500, 50 steps")
    print(f"phase 10 hier main path n=1500 m=11 50 iters: ok "
          f"route=fused_terms_cuda launches={json.dumps(main_terms_sq)} "
          f"fallbacks={svgd.median_fallbacks}")

    def segmented_run(svgd, segments):
        """One untimed warm-up segment, then segments - 1 timed ones;
        returns the timed seconds (CUDA events)."""
        svgd.run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(segments - 1):
            svgd.run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    # -- phase 11: hierarchical BLR at full width -----------------------
    feats_h, labels_h, x0_hier = blr_workload(10000, 10, hierarchical=True)
    cuda_phi.reset_launch_counts()
    svgd = build_blr_svgd(torch.tensor(x0_hier, device=dev), feats_h,
                          labels_h, hierarchical=True, num_iterations=seg_len)
    check(svgd._phi_impl == "fused_terms_cuda",
          f"hier N=10000 routed to {svgd._phi_impl!r}")
    timed_s = segmented_run(svgd, segments)
    main_terms_sym = dict(cuda_phi.launch_counts)
    out = svgd.store.value
    check(bool(out.isfinite().all()) and tuple(out.shape) == (10000, 11),
          "hier N=10000 run: bad output")
    require_only(main_terms_sym, cuda_phi.TERMS_SYM_KERNEL, segments * seg_len,
                 "hier N=10000, 1000 steps")
    acc0 = blr_accuracy(x0_hier, feats_h, labels_h)
    acc = blr_accuracy(out.cpu().numpy(), feats_h, labels_h)
    check(acc > 0.5, f"hier training accuracy {acc:.4f} <= 0.5")
    rate = 10000 * (segments - 1) * seg_len / timed_s
    print(f"phase 11 hier N=10000 d=10 1000 iters: ok route=fused_terms_cuda "
          f"launches={json.dumps(main_terms_sym)} "
          f"fallbacks={svgd.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} train_accuracy={acc:.4f} "
          f"(x0: {acc0:.4f})")

    # -- phase 12: flat BLR at full width -------------------------------
    feats, labels, x0_blr = blr_workload(1000, 50)
    cuda_phi.reset_launch_counts()
    svgd = build_blr_svgd(torch.tensor(x0_blr, device=dev), feats, labels,
                          num_iterations=seg_len)
    check(svgd._phi_impl == "fused_cuda",
          f"flat BLR N=1000 routed to {svgd._phi_impl!r}, not 'fused_cuda'")
    timed_s = segmented_run(svgd, segments)
    main_blr = dict(cuda_phi.launch_counts)
    out = svgd.store.value
    check(bool(out.isfinite().all()) and tuple(out.shape) == (1000, 50),
          "flat BLR run: bad output")
    require_only(main_blr, cuda_phi.SQUARE_KERNEL, segments * seg_len,
                 "flat BLR, 1000 steps")
    acc = blr_accuracy(out.cpu().numpy(), feats, labels)
    check(acc > 0.5, f"flat BLR training accuracy {acc:.4f} <= 0.5")
    rate = 1000 * (segments - 1) * seg_len / timed_s
    print(f"phase 12 flat BLR N=1000 d=50 1000 iters (the bench runs 4000; "
          f"cut for time): ok route=fused_cuda launches={json.dumps(main_blr)} "
          f"fallbacks={svgd.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} train_accuracy={acc:.4f}")
    # The kernel route against the plain route for 20 steps from one x0,
    # the float64 plain route printed as the floor (as phases 6 and 13).
    finals = {}
    for impl, dtype in (("fused_cuda", torch.float32),
                        ("fused", torch.float32), ("fused", torch.float64)):
        s12 = build_blr_svgd(torch.tensor(x0_blr, dtype=dtype, device=dev),
                             feats, labels, phi_impl=impl, num_iterations=20)
        finals[(impl, dtype)] = s12.run().double()
    ref = finals[("fused", torch.float64)]
    diff = float((finals[("fused_cuda", torch.float32)]
                  - finals[("fused", torch.float32)]).abs().max())
    floor = {
        impl: float((finals[(impl, torch.float32)] - ref).abs().max())
        for impl in ("fused_cuda", "fused")
    }
    check(diff <= 1e-3,
          f"flat BLR fused_cuda vs fused coords differ by {diff:.3e}")
    print(f"phase 12 flat BLR fused_cuda vs fused N=1000 20 steps: ok "
          f"coords_max_abs_diff={diff:.3e} "
          f"vs_float64_plain={json.dumps(floor)}")

    # -- phase 13: hier kernel route vs plain route, 20 steps -----------
    finals = {}
    for impl, dtype in (("fused_terms_cuda", torch.float32),
                        ("fused_terms", torch.float32),
                        ("fused_terms", torch.float64)):
        s13 = build_blr_svgd(
            torch.tensor(x0_hier, dtype=dtype, device=dev), feats_h, labels_h,
            hierarchical=True, phi_impl=impl, num_iterations=20,
        )
        finals[(impl, dtype)] = s13.run().double()
    ref = finals[("fused_terms", torch.float64)]
    diff = float((finals[("fused_terms_cuda", torch.float32)]
                  - finals[("fused_terms", torch.float32)]).abs().max())
    floor = {
        impl: float((finals[(impl, torch.float32)] - ref).abs().max())
        for impl in ("fused_terms_cuda", "fused_terms")
    }
    check(diff <= 1e-3,
          f"fused_terms_cuda vs fused_terms coords differ by {diff:.3e}")
    print(f"phase 13 hier fused_terms_cuda vs fused_terms N=10000 20 steps: "
          f"ok coords_max_abs_diff={diff:.3e} "
          f"vs_float64_plain={json.dumps(floor)}")

    # -- phase 14: K14 vs plain ---------------------------------------------
    def aniso_ps(g, m, count, seed):
        """``count`` full PD precisions around the median gamma g:
        g (0.5 I + A A^T / m), A ~ N(0, 1) from a numpy seed."""
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(count):
            a = rng.normal(size=(m, m))
            out.append(g * torch.tensor(0.5 * np.eye(m) + a @ a.T / m,
                                        dtype=torch.float32, device=dev))
        return out

    # (10240, 11) with one isotropic and one anisotropic term is the shape
    # phase 17's main path gives the kernel.
    aniso_err = 0.0
    for idx, (n, m, off, iso_s, an_s) in enumerate([
        (2048, 2, 100.0, (1.0,), (0.8,)),
        (10007, 2, 0.0, (), (1.0,)),
        (10240, 11, 0.0, (1.0,), (1.0,)),
        (10240, 11, 0.0, (1.0,), (1.0, 0.5, 0.3)),
        (4096, 11, 0.0, (1.0,), (1.0,) * 7),
        (2048, 50, 0.0, (1.0,), (1.0,)),
        (4096, 11, 0.0, (1.0, -0.4), (-0.3,)),
        # one anisotropic term at the one-pass kernel's runtime-m
        # instances (MM = 8: m = 1, 3 by differences, 5; 16; 32)
        (3001, 1, 4.0, (1.0,), (0.8,)),
        (2048, 3, 0.0, (), (1.0,)),
        (3001, 5, 2.0, (1.0, -0.4), (0.8,)),
        (2048, 16, 0.0, (1.0,), (1.0,)),
        (2048, 32, 0.0, (1.0,), (-0.5,)),
    ]):
        x, s, g, thr = inputs_for(n, m, off, 140 + idx, dev)
        iso_g = [g, 2.0 * g][:len(iso_s)]
        ps = aniso_ps(g, m, len(an_s), 150 + idx)
        got = cuda_phi.phi_rbf_aniso_terms_fused_cuda(x, s, iso_g, iso_s, ps,
                                                      an_s, thr)
        want = phi_rbf_aniso_terms_fused_counts(x, s, iso_g, iso_s, ps, an_s,
                                                thr)
        rel, abs_err, dcnt = compare(f"aniso n={n} m={m}", got, want, n, m)
        aniso_err = max(aniso_err, abs_err)
        print(f"phase 14 aniso n={n} m={m} offset={off} "
              f"iso_signs={list(iso_s)} aniso_signs={list(an_s)}: ok "
              f"phi_rel={rel:.3e} count_diff={dcnt} "
              f"count_bound={1e-6 * n * n if m > 4 else 0:.3g}")

    # -- phase 15: K15 vs phi_rbf / phi_rbf_blocked ----------------------------
    mean_a, cov_a, x0_a, p_a = aniso_mvn_workload(10240)
    x_a = torch.tensor(x0_a, device=dev)
    model_a = st.MultivariateNormal(
        torch.tensor(mean_a, dtype=torch.float32),
        torch.tensor(cov_a, dtype=torch.float32),
    )
    # The HESSIAN scale of the d = 11 target: phase 18's main path's P.
    p_hess = st.GaussianRBFKernel(
        x_a, st.ScaleMethod.HESSIAN, model_a
    ).compute_scale_pure(x_a)
    k15_err = 0.0
    for idx, (label, n, m, off, psd) in enumerate([
        ("isotropic", 1500, 2, 0.0, True),
        ("hessian", 10240, 11, 0.0, False),
        ("full_pd", 1000, 50, 0.0, True),
        ("indefinite", 600, 3, 0.0, False),
        ("isotropic", 2000, 2, 200.0, True),
    ]):
        x, s, g, _ = sweep_inputs(n, m, off, 170 + idx, dev)
        if label == "hessian":
            x, p = x_a, p_hess
        elif label == "full_pd":
            p = aniso_ps(g, m, 1, 180)[0]
        elif label == "indefinite":
            p = g * torch.tensor([[0.5, 0.1, 0.0], [0.1, -0.1, 0.05],
                                  [0.0, 0.05, 0.3]], device=dev)
        else:
            p = g * torch.eye(m, device=dev)
        got = cuda_phi.phi_rbf_cuda(x, s, p, psd=psd)
        # The dense phi_rbf does not center: off origin, the blocked one.
        plain = phi_rbf if n <= 2048 and off == 0.0 else phi_rbf_blocked
        rel, abs_err = compare_phi(f"phi_rbf {label} n={n} m={m}", got,
                                   plain(x, s, p, psd=psd))
        k15_err = max(k15_err, abs_err)
        print(f"phase 15 phi_rbf {label} n={n} m={m} offset={off} psd={psd}: "
              f"ok phi_rel={rel:.3e} plain={plain.__name__}")
    # The decomposition on the card (sym_eigen) against its plain version,
    # torch.linalg.eigh in float64: the sorted eigenvalues within 1e-12 of
    # the largest, V diag(lam) V^T within 1e-12 of P_sym/2 and V^T V of I
    # (relative to max |P_sym/2|; float64 rounding over 10 sweeps).
    eigen_err = 0.0
    for m, kind in ((2, "pd"), (3, "indefinite"), (11, "hessian"),
                    (11, "indefinite"), (50, "pd"), (64, "pd"),
                    (64, "indefinite")):
        rng = np.random.default_rng(190 + m)
        a = rng.normal(size=(m, m))
        if kind == "hessian":
            pm = p_hess.double()
        elif kind == "pd":
            pm = torch.tensor(0.5 * np.eye(m) + a @ a.T / m, device=dev)
        else:
            pm = torch.tensor(np.diag(np.linspace(1.0, -0.5, m)) + 0.1 * a,
                              device=dev)
        lam, v = cuda_phi.symmetric_eigen(pm)
        ps = 0.5 * (pm + pm.T)
        lam_ref = torch.linalg.eigh(ps)[0]
        scale = float(ps.abs().max())
        d_lam = float((torch.sort(lam)[0] - lam_ref).abs().max()) / scale
        d_rec = float(((v * lam) @ v.T - ps).abs().max()) / scale
        d_orth = float((v.T @ v - torch.eye(m, dtype=v.dtype, device=dev))
                       .abs().max())
        eigen_err = max(eigen_err, d_lam * scale)
        check(max(d_lam, d_rec, d_orth) <= 1e-12,
              f"sym_eigen m={m} {kind}: eigenvalues {d_lam:.2e}, "
              f"reconstruction {d_rec:.2e}, orthogonality {d_orth:.2e}")
        print(f"phase 15 sym_eigen m={m} {kind}: ok eig_rel={d_lam:.2e} "
              f"rec_rel={d_rec:.2e} orth={d_orth:.2e} "
              f"negative={int((lam < 0).sum())}")
    # The HESSIAN call as the route makes it reads nothing on the host: any
    # synchronising call inside the wrapper raises under "error".
    x, s = x_a, sweep_inputs(10240, 11, 0.0, 171, dev)[1]
    cuda_phi.phi_rbf_cuda(x, s, p_hess, psd=False)  # warm (cuBLAS, caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cuda_phi.phi_rbf_cuda(x, s, p_hess, psd=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rel, _ = compare_phi("phi_rbf hessian under sync debug", got,
                         phi_rbf_blocked(x, s, p_hess, psd=False))
    print(f"phase 15 phi_rbf hessian n=10240 m=11 under "
          f"set_sync_debug_mode('error'): ok no synchronisation, "
          f"phi_rel={rel:.3e}")

    # -- phase 16: times, K14 and K15 against plain ------------------------
    times16 = {}
    x, s, g, thr = sweep_inputs(10240, 11, 0.0, 160, dev)
    # n_w = 2 is the main path's (the one-pass kernel), timed as the driver
    # calls it, with the Cholesky factor it keeps, and factoring each call;
    # 4 and 8 take the term-group kernel.
    for n_w in (2, 4, 8):
        ps = aniso_ps(g, 11, n_w - 1, 161)
        an_s = (1.0,) * (n_w - 1)
        lowers = cuda_phi.cholesky_factors(ps, dev)
        kern = time_ms(lambda: cuda_phi.phi_rbf_aniso_terms_fused_cuda(
            x, s, [g], (1.0,), ps, an_s, thr, lowers=lowers))
        factored = time_ms(lambda: cuda_phi.phi_rbf_aniso_terms_fused_cuda(
            x, s, [g], (1.0,), ps, an_s, thr))
        plain = time_ms(lambda: phi_rbf_aniso_terms_fused_counts(
            x, s, [g], (1.0,), ps, an_s, thr))
        times16[("aniso", n_w)] = {"kernel": kern, "plain": plain}
        print(f"phase 16 times aniso n=10240 m=11 n_w={n_w} T=3 (ms, median "
              f"of 50): kernel={kern:.4f} (kept factor) "
              f"factored_each_call={factored:.4f} plain={plain:.4f}")
    # As the 'cuda' route calls it: a HESSIAN P decomposed on the card each
    # call, a median's gamma I with its decomposition (diagonal, I).
    for n, m in ((10240, 11), (1500, 2)):
        x, s, g, _ = sweep_inputs(n, m, 0.0, 165, dev)
        if m == 11:
            p, psd, eig = p_hess, False, None
        else:
            p, psd = g * torch.eye(m, device=dev), True
            eig = (p.diagonal(), torch.eye(m, device=dev))
        kern = time_ms(lambda: cuda_phi.phi_rbf_cuda(x, s, p, psd=psd,
                                                     eig=eig))
        plain = time_ms(lambda: phi_rbf_blocked(x, s, p, psd=psd))
        times16[("phi_rbf", n, m)] = {"kernel": kern, "plain": plain}
        print(f"phase 16 times phi_rbf n={n} m={m} psd={psd} (ms, median of "
              f"50): kernel={kern:.4f} plain={plain:.4f}")
    # The decomposition at the HESSIAN P: the kernel, its plain version
    # (torch.linalg.eigh on the CPU, host clock, median of 50) and the same
    # call on the card (which checks its result on the host).
    p_cpu = p_hess.double().cpu()
    kern = time_ms(lambda: cuda_phi.symmetric_eigen(p_hess))
    plain_times = []
    for _ in range(50):
        t0 = time.perf_counter()
        cuda_phi.symmetric_eigen(p_cpu)
        plain_times.append((time.perf_counter() - t0) * 1e3)
    plain = sorted(plain_times)[25]
    library = time_ms(lambda: torch.linalg.eigh(
        0.5 * (p_hess.double() + p_hess.double().T)))
    times16[("sym_eigen", 11)] = {"kernel": kern, "plain": plain,
                                  "library": library}
    print(f"phase 16 times sym_eigen m=11 (ms, median of 50): kernel="
          f"{kern:.4f} plain_cpu={plain:.4f} torch_eigh_on_card={library:.4f}")

    # -- phase 17: the anisotropic main path, N = 10240, d = 11 -------------
    def aniso_driver(phi_impl, iters, kernel_scale=None, dtype=torch.float32):
        return build_aniso_svgd(
            torch.tensor(x0_a, dtype=dtype, device=dev), mean_a, cov_a, p_a,
            phi_impl=phi_impl, num_iterations=iters,
            kernel_scale=kernel_scale,
        )

    cuda_phi.reset_launch_counts()
    svgd = aniso_driver("auto", seg_len)
    check(svgd._phi_impl == "fused_aniso_terms_cuda",
          f"aniso N=10240 routed to {svgd._phi_impl!r}, not "
          "'fused_aniso_terms_cuda'")
    timed_s = segmented_run(svgd, segments)
    main_aniso = dict(cuda_phi.launch_counts)
    out_aniso = svgd.store.value.double()
    check(bool(out_aniso.isfinite().all())
          and tuple(out_aniso.shape) == (10240, 11), "aniso run: bad output")
    require_only(main_aniso, cuda_phi.ANISO_KERNEL, segments * seg_len,
                 "aniso N=10240, 1000 steps")
    rate = 10240 * (segments - 1) * seg_len / timed_s
    post = posterior_metrics(out_aniso.cpu().numpy(), mean_a, cov_a)
    print(f"phase 17 aniso N=10240 d=11 1000 iters: ok "
          f"route=fused_aniso_terms_cuda launches={json.dumps(main_aniso)} "
          f"fallbacks={svgd.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} posterior_not_gated={json.dumps(post)}")
    # The lag-1 seed is x0's median, so the first step uses the bandwidth
    # 'rbf_terms' takes that step.
    first = {impl: aniso_driver(impl, 1).run().double()
             for impl in ("fused_aniso_terms_cuda", "rbf_terms")}
    d_first = float((first["fused_aniso_terms_cuda"]
                     - first["rbf_terms"]).abs().max())
    check(d_first <= 1e-3,
          f"aniso first step: kernel route vs rbf_terms {d_first:.3e} > 1e-3")
    ref = aniso_driver("rbf_terms", seg_len)
    t0 = time.perf_counter()
    ref.run()
    torch.cuda.synchronize()
    ref_seg_s = time.perf_counter() - t0
    # rbf_terms is cut to 300 iterations (and the kernel route rerun to
    # match) if 1000 would take more than a minute.
    ref_iters = segments * seg_len if ref_seg_s * segments <= 60 else 300
    for _ in range(ref_iters // seg_len - 1):
        ref.run()
    if ref_iters == segments * seg_len:
        fused_out = out_aniso
    else:
        fused = aniso_driver("fused_aniso_terms_cuda", ref_iters)
        fused_out = fused.run().double()
    a = fused_out.cpu().numpy()
    r = ref.store.value.double().cpu().numpy()
    d_mean = float(np.abs(a.mean(axis=0) - r.mean(axis=0)).max())
    d_cov = float(np.linalg.norm(np.cov(a.T) - np.cov(r.T))
                  / np.linalg.norm(np.cov(r.T)))
    check(d_mean <= 5e-3 and d_cov <= 5e-3,
          f"aniso vs rbf_terms after {ref_iters} iters: mean {d_mean:.3e}, "
          f"cov {d_cov:.3e} (limits 5e-3)")
    print(f"phase 17 aniso vs rbf_terms: ok first_step_max_abs_diff="
          f"{d_first:.3e} iters={ref_iters} rbf_terms_first_segment_s="
          f"{ref_seg_s:.2f} mean_max_abs_diff={d_mean:.3e} "
          f"cov_fro_rel_diff={d_cov:.3e} "
          f"rbf_terms_posterior_not_gated="
          f"{json.dumps(posterior_metrics(r, mean_a, cov_a))}")

    # -- phase 18: the 'cuda' route (K15) ------------------------------------
    hessian = st.ScaleMethod.HESSIAN
    cuda_phi.reset_launch_counts()
    svgd = aniso_driver("cuda", seg_len, kernel_scale=hessian)
    timed_s = segmented_run(svgd, segments)
    main_k15 = dict(cuda_phi.launch_counts)
    out = svgd.store.value
    check(bool(out.isfinite().all()) and tuple(out.shape) == (10240, 11),
          "HESSIAN cuda run: bad output")
    require_only(main_k15, cuda_phi.PHI_RBF_KERNEL, segments * seg_len,
                 "HESSIAN N=10240, 1000 steps",
                 also={cuda_phi.SYM_EIGEN_KERNEL: segments * seg_len})
    rate = 10240 * (segments - 1) * seg_len / timed_s
    print(f"phase 18 HESSIAN cuda N=10240 d=11 1000 iters: ok route=cuda "
          f"launches={json.dumps(main_k15)} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} psd={svgd._rbf_psd}")
    finals = {}
    for impl, dtype in (("cuda", torch.float32), ("blocked", torch.float32),
                        ("blocked", torch.float64)):
        finals[(impl, dtype)] = aniso_driver(
            impl, 20, kernel_scale=hessian, dtype=dtype
        ).run().double()
    ref = finals[("blocked", torch.float64)]
    diff = float((finals[("cuda", torch.float32)]
                  - finals[("blocked", torch.float32)]).abs().max())
    floor = {impl: float((finals[(impl, torch.float32)] - ref).abs().max())
             for impl in ("cuda", "blocked")}
    check(diff <= 1e-3, f"cuda vs blocked coords differ by {diff:.3e}")
    print(f"phase 18 HESSIAN cuda vs blocked N=10240 20 steps: ok "
          f"coords_max_abs_diff={diff:.3e} "
          f"vs_float64_blocked={json.dumps(floor)}")
    mean, cov, x0 = flagship_mvn(1500)
    cuda_phi.reset_launch_counts()
    svgd = make_svgd(st, x0, mean, cov, 50, phi_impl="cuda")
    out = svgd.run()
    torch.cuda.synchronize()
    main_k15_median = dict(cuda_phi.launch_counts)
    check(bool(out.isfinite().all()) and tuple(out.shape) == (1500, 2),
          "MEDIAN cuda n=1500 run: bad output")
    require_only(main_k15_median, cuda_phi.PHI_RBF_KERNEL, 50,
                 "MEDIAN cuda n=1500, 50 steps")
    print(f"phase 18 MEDIAN cuda n=1500 m=2 50 iters: ok route=cuda "
          f"launches={json.dumps(main_k15_median)}")

    # -- phase 19: K3's port (the panel kernel) vs its plain version --------
    # T = 3 runs the kernel's fixed-T instance, T = 1 and 8 its runtime-T
    # one; m = 5 the runtime-m instance (MM = 8) of the micro-tile body, m =
    # 11 the wide body. Ragged n, and every schedule has diagonal panels; at
    # m = 5 grid inputs make the plain version's Gram sq exact, so its counts
    # must be equal too.
    sympanel_err = 0.0
    for idx, (n, m, off, blocks, n_t) in enumerate([
        (10007, 2, 100.0, 3, 3), (10007, 2, 100.0, 8, 3),
        (PATH_A_N, 2, 0.0, None, 3), (65536, 11, 0.0, None, 3),
        (10007, 2, 100.0, 3, 1), (10007, 2, 0.0, 2, 8),
        (9001, 5, 2.0, 3, 3), (9001, 5, 0.0, 2, 8), (9001, 5, 0.0, 1, 1),
    ]):
        x, s, g, thr = inputs_for(n, m, off, 190 + idx, dev)
        thr = thresholds_of(thr, n_t)
        got = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym="panel",
                                          panel_blocks=blocks)
        want = phi_rbf_sympanel_fused_counts(x, s, g, thr, panel_blocks=blocks)
        rel, abs_err, dcnt = compare(f"sympanel n={n} m={m} T={n_t}", got,
                                     want, n, m)
        check(m > 8 or dcnt == 0,
              f"sympanel n={n} m={m} T={n_t}: counts differ by {dcnt}")
        sympanel_err = max(sympanel_err, abs_err)
        nb, w, _ = card_panel_plan(n, blocks)
        print(f"phase 19 sympanel n={n} m={m} T={n_t} offset={off} nb={nb} "
              f"W={w}: ok phi_rel={rel:.3e} count_diff={dcnt} "
              f"count_bound={1e-6 * n * n if m > 8 else 0:.3g} {clock()}")
    # At 1M the plain version takes about a minute: the panel kernel is held
    # to the full-width one, and both to a float64 reference on a row subset
    # (the bound that float32 summation order alone sets).
    n = PATH_A_SHORT_N
    x, s, g, thr = sweep_inputs(n, 2, 0.0, 195, dev)
    got = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym="panel")
    full = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)
    rows = torch.arange(0, n, n // 2048, device=dev)
    exact = f64_rows_reference(x, s, [g], [1.0], thr, rows)
    scale = float(exact.abs().max())
    f64_rel = {name: float((phi_[rows] - exact).abs().max()) / scale
               for name, phi_ in (("panel", got[0]), ("full_width", full[0]))}
    rel = float((got[0] - full[0]).abs().max() / full[0].abs().max())
    dcnt = int((got[1] - full[1]).abs().max())
    check(bool(got[0].isfinite().all()), "sympanel 1M: non-finite phi")
    check(dcnt == 0, f"sympanel vs sym at 1M: counts differ by {dcnt}")
    # Past 1e-4 the panel kernel must be no further from float64 than the
    # full-width kernel is: the two differ in summation order only.
    check(rel <= 1e-4 or f64_rel["panel"] <= max(1e-4, f64_rel["full_width"]),
          f"sympanel vs sym at 1M: phi rel {rel:.3e}, float64 row-subset "
          f"rel {f64_rel}")
    print(f"phase 19 sympanel vs sym n={n} m=2: ok phi_rel={rel:.3e} "
          f"count_diff={dcnt} vs_float64_rows={json.dumps(f64_rel)} "
          f"rows={rows.numel()} {clock()}")

    # -- phase 20: the terms panel kernel (K12/K13's port) vs plain --------
    # Two terms run the kernel's compile-time term count, others its
    # runtime one; T = 3 its fixed-T instances, T = 1 and 8 the runtime-T
    # ones; m = 2 and 11 exact instances, m = 5 a runtime-m one. The forced
    # small panels off origin (n = 10007, 3 super-blocks) have ragged
    # strips and diagonal panels, so they run the masked chunks.
    terms_panel_err = 0.0
    for idx, (n, m, signs, blocks, tpu, off, n_t) in enumerate([
        (PATH_B_N, 11, (1.0, 1.0), None, "K12", 0.0, 3),
        (65536, 11, (1.0, 1.0, 0.5), None, "K13", 0.0, 3),
        (PATH_A_N, 2, (1.0, 1.0), None, "K12", 0.0, 3),
        (10007, 2, (1.0, -0.5), 3, None, 0.0, 3),
        (4099, 11, (1.0, -0.5, 0.3), 5, None, 0.0, 3),
        (10007, 11, (1.0, 1.0), 3, None, 2.0, 3),
        (10007, 11, (1.0, 1.0), 3, None, 2.0, 1),
        (10007, 11, (1.0, 1.0), 3, None, 0.0, 8),
        (10007, 11, (1.0,), 3, None, 2.0, 3),
        (10007, 11, (1.0, -0.5), 3, None, 2.0, 3),
        (9001, 5, (1.0, 1.0), 3, None, 2.0, 3),
        (9001, 5, (1.0, -0.5, 0.3), 2, None, 0.0, 8),
    ]):
        x, s, g, thr = inputs_for(n, m, off, 200 + idx, dev)
        thr = thresholds_of(thr, n_t)
        gs = terms_gammas(g, signs)
        got = cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                sym="panel",
                                                panel_blocks=blocks)
        want = phi_rbf_terms_sympanel_fused_counts(x, s, gs, signs, thr,
                                                   panel_blocks=blocks)
        rel, abs_err, dcnt = compare(f"terms sympanel n={n} m={m}", got, want,
                                     n, m)
        terms_panel_err = max(terms_panel_err, abs_err)
        on_tpu = tpu_terms_panel_kernel(n, m, len(signs))
        check(tpu is None or on_tpu == tpu,
              f"terms sympanel n={n} m={m}: the TPU runs {on_tpu}, not {tpu}")
        nb, w, _ = card_panel_plan(n, blocks)
        print(f"phase 20 terms sympanel n={n} m={m} signs={list(signs)} "
              f"T={n_t} offset={off} "
              f"nb={nb} W={w} (TPU kernel at this shape: {on_tpu}): ok "
              f"phi_rel={rel:.3e} count_diff={dcnt} "
              f"count_bound={1e-6 * n * n if m > 4 else 0:.3g} {clock()}")

    # -- phase 21: times, panel kernels vs full-width kernels and plain ----
    def plain_ms(fn):
        """time_ms of a plain version: 50 calls, or 3 when one call takes
        more than 0.25 s."""
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        slow = time.perf_counter() - t0 > 0.25
        return time_ms(fn, reps=3 if slow else 50, warmup=0 if slow else 5)

    times21 = {}
    for n, reps in ((PATH_A_N, 50), (PATH_A_SHORT_N, 5)):
        x, s, g, thr = sweep_inputs(n, 2, 0.0, 210, dev)
        t = {
            "kernel": time_ms(lambda: cuda_phi.phi_rbf_fused_cuda(
                x, s, g, thr, sym="panel"), reps=reps, warmup=5 if reps > 5
                else 1),
            "full": time_ms(lambda: cuda_phi.phi_rbf_fused_cuda(
                x, s, g, thr, sym=True), reps=reps, warmup=5 if reps > 5
                else 1),
            # about a minute a call at 1M: not timed there
            "plain": plain_ms(lambda: phi_rbf_sympanel_fused_counts(
                x, s, g, thr)) if n == PATH_A_N else None,
        }
        times21[("sympanel", n, 2)] = t
        print(f"phase 21 times sympanel n={n} m=2 T=3 (ms, median of {reps}): "
              f"panel={t['kernel']:.4f} sym={t['full']:.4f} plain="
              + ("not timed" if t["plain"] is None else f"{t['plain']:.4f}")
              + f" {clock()}")
    x, s, g, thr = sweep_inputs(PATH_B_N, 11, 0.0, 211, dev)
    gs = terms_gammas(g, (1, 1))
    t = {
        "kernel": time_ms(lambda: cuda_phi.phi_rbf_terms_fused_cuda(
            x, s, gs, (1, 1), thr, sym="panel")),
        "full": time_ms(lambda: cuda_phi.phi_rbf_terms_fused_cuda(
            x, s, gs, (1, 1), thr, sym=True)),
        "plain": plain_ms(lambda: phi_rbf_terms_sympanel_fused_counts(
            x, s, gs, (1, 1), thr)),
    }
    times21[("terms_sympanel", PATH_B_N, 11)] = t
    print(f"phase 21 times terms sympanel n={PATH_B_N} m=11 T=3 two terms "
          f"(ms, median of 50): panel={t['kernel']:.4f} "
          f"terms_sym={t['full']:.4f} plain={t['plain']:.4f} {clock()}")

    # -- phase 22: path A, the flagship at N = 262144 and 1048576 -----------
    def timed_run(svgd, warm, timed):
        """``warm`` untimed iterations, then ``timed`` ones between CUDA
        events; returns their seconds."""
        svgd.num_iterations = warm
        svgd.run()
        torch.cuda.synchronize()
        svgd.num_iterations = timed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        svgd.run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    mean_l, cov_l, x0_l = large_mvn_workload(PATH_A_N)
    model_l = st.MultivariateNormal(torch.tensor(mean_l), torch.tensor(cov_l))
    ksd_before = float(ksd_rbf(model_l, x0_l))  # goes to the card
    cuda_phi.reset_launch_counts()
    t0 = time.perf_counter()
    svgd = make_svgd(st, x0_l, mean_l, cov_l, 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(svgd._phi_impl == "fused_cuda" and svgd.fused_sym_form == "panel",
          f"path A routed to {svgd._phi_impl!r} form "
          f"{svgd.fused_sym_form!r}, not 'fused_cuda' 'panel'")
    timed_s = timed_run(svgd, 10, PATH_A_ITERS - 10)
    main_panel = dict(cuda_phi.launch_counts)
    out = svgd.store.value
    check(bool(out.isfinite().all()) and tuple(out.shape) == (PATH_A_N, 2),
          "path A run: bad output")
    # The median seed's two count passes (the hybrid's 17 and 40 edges) go
    # through K16.
    require_only(main_panel, cuda_phi.SYMPANEL_KERNEL, PATH_A_ITERS,
                 f"path A, {PATH_A_ITERS} steps", count_launches=2)
    ksd_after = float(ksd_rbf(model_l, out))
    check(ksd_after < ksd_before,
          f"path A: KSD {ksd_before:.4g} -> {ksd_after:.4g} did not drop")
    rate = PATH_A_N * (PATH_A_ITERS - 10) / timed_s
    post = posterior_metrics(out.cpu().numpy(), mean_l, cov_l)
    print(f"phase 22 path A N={PATH_A_N} {PATH_A_ITERS} iters: ok "
          f"route=fused_cuda form=panel launches={json.dumps(main_panel)} "
          f"fallbacks={svgd.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} (last {PATH_A_ITERS - 10} iters) "
          f"init_s={init_s:.2f} ksd_before={ksd_before:.6g} "
          f"ksd_after={ksd_after:.6g} posterior_not_gated={json.dumps(post)} "
          f"{clock()}")
    del svgd, out
    mean_s1, cov_s1, x0_s1 = large_mvn_workload(PATH_A_SHORT_N)
    cuda_phi.reset_launch_counts()
    t0 = time.perf_counter()
    svgd = make_svgd(st, x0_s1, mean_s1, cov_s1, 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(svgd.fused_sym_form == "panel",
          f"N={PATH_A_SHORT_N} resolved to {svgd.fused_sym_form!r}")
    timed_s = timed_run(svgd, 1, PATH_A_SHORT_ITERS - 1)
    main_panel_1m = dict(cuda_phi.launch_counts)
    out = svgd.store.value
    check(bool(out.isfinite().all())
          and tuple(out.shape) == (PATH_A_SHORT_N, 2), "path A 1M: bad output")
    require_only(main_panel_1m, cuda_phi.SYMPANEL_KERNEL, PATH_A_SHORT_ITERS,
                 f"path A N={PATH_A_SHORT_N}", count_launches=2)
    rate = PATH_A_SHORT_N * (PATH_A_SHORT_ITERS - 1) / timed_s
    print(f"phase 22 path A N={PATH_A_SHORT_N} {PATH_A_SHORT_ITERS} iters: ok "
          f"launches={json.dumps(main_panel_1m)} "
          f"fallbacks={svgd.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} (last {PATH_A_SHORT_ITERS - 1} iters) "
          f"init_s={init_s:.2f} (the median seed through K16; 239.40 s with "
          f"the plain count pass, PERF.md section 5) "
          f"count_launches={main_panel_1m[cuda_phi.COUNT_KERNEL]} {clock()}")
    del svgd, out

    # -- phase 23: path B, the hierarchical BLR at N = 131072 ---------------
    feats_b, labels_b, x0_b = large_hier_workload(PATH_B_N)
    cuda_phi.reset_launch_counts()
    # x0 as the user has it, a numpy array: the builder puts it on the card
    # before the kernel takes its median.
    svgd = build_blr_svgd(x0_b, feats_b, labels_b, hierarchical=True,
                          num_iterations=1)
    check(svgd.store.value.is_cuda, "path B: x0 was not put on the card")
    check(svgd._phi_impl == "fused_terms_cuda"
          and svgd.fused_sym_form == "panel",
          f"path B routed to {svgd._phi_impl!r} form "
          f"{svgd.fused_sym_form!r}, not 'fused_terms_cuda' 'panel'")
    timed_s = timed_run(svgd, 10, PATH_B_ITERS - 10)
    main_tpanel = dict(cuda_phi.launch_counts)
    out = svgd.store.value
    check(bool(out.isfinite().all()) and tuple(out.shape) == (PATH_B_N, 11),
          "path B run: bad output")
    require_only(main_tpanel, cuda_phi.TERMS_SYMPANEL_KERNEL, PATH_B_ITERS,
                 f"path B, {PATH_B_ITERS} steps")
    acc0 = blr_accuracy(x0_b, feats_b, labels_b)
    acc = blr_accuracy(out.cpu().numpy(), feats_b, labels_b)
    check(acc > 0.5, f"path B training accuracy {acc:.4f} <= 0.5")
    rate = PATH_B_N * (PATH_B_ITERS - 10) / timed_s
    print(f"phase 23 path B hier N={PATH_B_N} d=10 {PATH_B_ITERS} iters: ok "
          f"route=fused_terms_cuda form=panel "
          f"launches={json.dumps(main_tpanel)} "
          f"fallbacks={svgd.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} (last {PATH_B_ITERS - 10} iters) "
          f"train_accuracy={acc:.4f} (x0: {acc0:.4f}) {clock()}")
    del svgd, out

    # -- phase 24: panel route vs full-width route, 20 steps ----------------
    def routes_apart(build, panel_kernel, full_kernel, what):
        """Max |coords| apart after the steps: the panel route against the
        full-width route, and the full-width route against itself from the
        same x0 (the floor that atomics order alone leaves)."""
        finals = []
        for form, kernel in (("panel", panel_kernel), (True, full_kernel),
                             (True, full_kernel)):
            cuda_phi.reset_launch_counts()
            finals.append(build(form).run().double())
            require_only(dict(cuda_phi.launch_counts), kernel, COMPARE_STEPS,
                         f"{what} fused_sym={form!r}")
        return (float((finals[0] - finals[1]).abs().max()),
                float((finals[2] - finals[1]).abs().max()))

    apart24 = {
        "path_a": routes_apart(
            lambda form: make_svgd(st, x0_l, mean_l, cov_l, COMPARE_STEPS,
                                   fused_sym=form),
            cuda_phi.SYMPANEL_KERNEL, cuda_phi.SYM_KERNEL, "path A"),
        "path_b": routes_apart(
            lambda form: build_blr_svgd(
                torch.tensor(x0_b, device=dev), feats_b, labels_b,
                hierarchical=True, num_iterations=COMPARE_STEPS,
                fused_sym=form),
            cuda_phi.TERMS_SYMPANEL_KERNEL, cuda_phi.TERMS_SYM_KERNEL,
            "path B"),
    }
    diffs24 = {path: d for path, (d, _) in apart24.items()}
    floors24 = {path: f for path, (_, f) in apart24.items()}
    for path, diff in diffs24.items():
        check(diff <= 1e-3, f"{path}: panel vs full-width route coords differ "
                            f"by {diff:.3e} after {COMPARE_STEPS} steps")
    print(f"phase 24 panel vs full-width routes {COMPARE_STEPS} steps "
          f"(N={PATH_A_N} path A, N={PATH_B_N} path B): ok "
          f"coords_max_abs_diff={json.dumps(diffs24)} "
          f"full_width_run_twice_floor={json.dumps(floors24)} {clock()}")

    # -- phase 25: K4 and K10/K11 (the triangle's chunks) vs plain ---------
    def chunks_summed(fn, world):
        """Every rank's (acc, upper) of a world, summed as the group sums
        them."""
        acc = upper = None
        for rank in range(world):
            a, u = fn(rank)
            acc = a if acc is None else acc + a
            upper = u if upper is None else upper + u
        return acc, upper

    # The chunk wrappers take the tile side from the library, the plain
    # chunks from sym_plan.sym_tile: both must name the instance's tile.
    lib = cuda_phi.load_library()
    tiles_off = [(m, terms) for m in range(1, cuda_phi.MAX_M + 1)
                 for terms in (0, 1)
                 if lib.svgd_sym_tile(m, terms) != sym_tile(m, bool(terms))]
    check(not tiles_off, f"svgd_sym_tile and sym_plan.sym_tile differ at "
                         f"(m, terms) in {tiles_off}")
    print(f"phase 25 tile sides: svgd_sym_tile equals sym_plan.sym_tile for "
          f"m = 1..{cuda_phi.MAX_M}, one RBF and composed")
    sym_chunk_err = terms_chunk_err = 0.0
    # The main paths' shapes (one RBF at every world of 1-8, the composed
    # kernel at 1, 2, 3, 4 and 8), one RBF's micro-tile instances of m = 5
    # and 11; then the dimensions served by a shared instance (m = 9, 10,
    # 12 and 16 run the instance of 16, whose composed tile is 32; m = 17
    # that of 32) and m = 50, at every world of 1-8.
    every = tuple(range(1, 9))
    for idx, (n, m, off, signs, worlds) in enumerate([
        (10000, 2, 0.0, None, every),
        (10007, 2, 100.0, None, every),
        (10007, 5, 100.0, None, (2, 3, 8)),
        (3001, 11, 0.0, None, every),
        (10000, 11, 0.0, (1.0, 1.0), (1, 2, 3, 4, 8)),
        (10000, 11, 0.0, (1.0, -0.5, 0.3), (1, 2, 3, 4, 8)),
        (10007, 2, 100.0, (1.0, -1.0), (1, 2, 3)),
        (10007, 5, 100.0, (1.0, 1.0), (2, 3)),
        (3001, 9, 0.0, (1.0, 1.0), every), (3001, 10, 0.0, (1.0, 1.0), every),
        (3001, 12, 0.0, (1.0, -0.5, 0.3), every),
        (3001, 16, 0.0, (1.0, 1.0), every),
        (3001, 17, 0.0, None, every), (3001, 50, 0.0, None, every),
    ]):
        x, s, g, thr = inputs_for(n, m, off, 250 + idx, dev)
        if signs is None:
            full = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)

            def kern(w, r):
                return cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, s, g, thr, w, r)

            def plain(w, r):
                return phi_rbf_sym_chunk_counts(x, s, g, thr, w, r)

            def finish(acc):
                return phi_rbf_fused_sym_finish(acc, s, g, n)
        else:
            gs = terms_gammas(g, signs)
            full = cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                     sym=True)

            def kern(w, r):
                return cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                    x, s, gs, signs, thr, w, r)

            def plain(w, r):
                return phi_rbf_terms_sym_chunk_counts(x, s, gs, signs, thr,
                                                      w, r)

            def finish(acc):
                return phi_rbf_terms_fused_sym_finish(acc, s, signs, n)
        for world in worlds:
            acc_k, up_k = chunks_summed(lambda r: kern(world, r), world)
            acc_p, up_p = chunks_summed(lambda r: plain(world, r), world)
            got = (finish(acc_k), 2 * up_k - n)
            rel, abs_err, dcnt = compare(
                f"chunks n={n} m={m} world={world}", got,
                (finish(acc_p), 2 * up_p - n), n, m)
            rel_full, _, dcnt_full = compare(
                f"chunks vs full-width n={n} m={m} world={world}", got, full,
                n, 2)  # the same sq in both kernels: counts equal at any m
            if signs is None:
                sym_chunk_err = max(sym_chunk_err, abs_err)
            else:
                terms_chunk_err = max(terms_chunk_err, abs_err)
            print(f"phase 25 {'sym' if signs is None else 'terms sym'} "
                  f"chunks n={n} m={m} offset={off} signs="
                  f"{list(signs or [1.0])} world={world}: ok phi_rel={rel:.3e} "
                  f"count_diff={dcnt} vs_full_width phi_rel={rel_full:.3e} "
                  f"count_diff={dcnt_full} {clock()}")

    # -- phase 26: K5 (the panel list's chunks) vs plain --------------------
    # As phase 19: T = 3 the fixed-T instance, T = 1 and 8 the runtime-T
    # one, m = 5 the runtime-m instance on grid inputs (counts equal).
    panel_chunk_err = 0.0
    for idx, (n, m, off, blocks, worlds, n_t) in enumerate([
        (PATH_A_N, 2, 0.0, None, (2, 4), 3), (10007, 2, 100.0, 3, (2, 3, 4), 3),
        (10007, 2, 100.0, 8, (4, 8), 3), (10007, 2, 100.0, 3, (2, 3), 1),
        (10007, 2, 0.0, 3, (3,), 8), (9001, 5, 2.0, 3, (2, 3), 3),
        (9001, 5, 0.0, 2, (2,), 8),
    ]):
        x, s, g, thr = inputs_for(n, m, off, 260 + idx, dev)
        thr = thresholds_of(thr, n_t)
        full = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym="panel",
                                           panel_blocks=blocks)
        for world in worlds:
            acc_k, up_k = chunks_summed(
                lambda r: cuda_phi.phi_rbf_sympanel_chunk_cuda(
                    x, s, g, thr, world, r, panel_blocks=blocks), world)
            acc_p, up_p = chunks_summed(
                lambda r: phi_rbf_sympanel_chunk_counts(
                    x, s, g, thr, world, r, panel_blocks=blocks), world)
            got = (phi_rbf_fused_sym_finish(acc_k, s, g, n), 2 * up_k - n)
            rel, abs_err, dcnt = compare(
                f"panel chunks n={n} m={m} T={n_t} world={world}", got,
                (phi_rbf_fused_sym_finish(acc_p, s, g, n), 2 * up_p - n), n,
                m)
            rel_full, _, dcnt_full = compare(
                f"panel chunks vs K3 n={n} m={m} T={n_t} world={world}", got,
                full, n, m)
            check(dcnt == 0 and dcnt_full == 0,
                  f"panel chunks n={n} m={m} T={n_t} world={world}: counts "
                  f"differ by {dcnt} (plain), {dcnt_full} (K3)")
            panel_chunk_err = max(panel_chunk_err, abs_err)
            nb, w, _ = card_panel_plan(n, blocks)
            print(f"phase 26 sympanel chunks n={n} m={m} T={n_t} offset={off} "
                  f"nb={nb} W={w} world={world}: ok phi_rel={rel:.3e} "
                  f"count_diff={dcnt} vs_K3 phi_rel={rel_full:.3e} "
                  f"count_diff={dcnt_full} {clock()}")

    # -- phase 27: K16 (the count pass) vs plain count_le_cross -------------
    def count_thresholds(x, y, num, exact):
        """``num`` thresholds at pair-distance quantiles; on a grid
        (``exact``) halfway between multiples of 1/64."""
        rng = np.random.default_rng(num)
        i = rng.integers(0, x.shape[0], 4096)
        j = rng.integers(0, y.shape[0], 4096)
        sq = ((x[i] - y[j]).double() ** 2).sum(dim=1).cpu().numpy()
        q = np.quantile(sq, np.linspace(0.02, 0.98, num))
        if exact:
            q = (np.floor(q * 64.0) + 0.5) / 64.0
        return torch.tensor(q, dtype=torch.float64, device=dev)

    count_err = 0
    for idx, (n_r, n_c, m) in enumerate([
        (10000, 10000, 2), (10000, 10000, 11), (5000, 10000, 2),
    ]):
        for exact in (True, False):
            fn = grid_inputs if exact else sweep_inputs
            xr = fn(n_r, m, 3.0, 270 + idx, dev)[0]
            xc = xr if n_r == n_c else fn(n_c, m, 3.0, 280 + idx, dev)[0]
            for num in (17, 40):  # the hybrid's edges; two launches
                thr = count_thresholds(xr, xc, num, exact)
                got = cuda_phi.count_le_cuda(xr, xc, thr)
                want = count_le_plain(xr, xc, thr)
                dcnt = int((got - want).abs().max())
                limit = 0 if exact else 1e-6 * n_r * n_c
                check(dcnt <= limit, f"count n_r={n_r} n_c={n_c} m={m} "
                      f"T={num}: counts differ by {dcnt} > {limit:.3g}")
                count_err = max(count_err, dcnt)
                print(f"phase 27 count n_r={n_r} n_c={n_c} m={m} T={num} "
                      f"{'grid' if exact else 'gaussian'}: ok "
                      f"count_diff={dcnt} count_bound={limit:.3g}")
    # The hybrid median (two count passes through K16) against the same
    # selection on the plain pass: a count that differs at an edge moves
    # the result by at most the hybrid's resolution gate, 1e-3 of it.
    x_med = sweep_inputs(10000, 2, 0.0, 290, dev)[0]
    med_k = float(pairwise_distance_median_hybrid(x_med))
    median_mod.count_le_cross = count_le_plain
    try:
        med_p = float(pairwise_distance_median_hybrid(x_med))
    finally:
        median_mod.count_le_cross = count_le_cross
    med_rel = abs(med_k - med_p) / med_p
    check(med_rel <= 1e-3, f"hybrid median through K16 {med_k} vs plain "
          f"{med_p}: rel {med_rel:.3e} > 1e-3")
    print(f"phase 27 hybrid median n=10000 m=2: ok k16={med_k:.9g} "
          f"plain={med_p:.9g} rel={med_rel:.3e} {clock()}")
    # Past MAX_M (the sweeps' 64 dimensions) K16 runs its wide instance:
    # counts against the plain pass as above, the hybrid median through it
    # against the plain pass's and the float64 exact median (the hybrid's
    # resolution gate, 1e-3), and auto on the card keeps the kernel route,
    # which raises there (ROADMAP item 17) instead of running plain torch.
    for m in (65, 100):
        for exact in (True, False):
            fn = grid_inputs if exact else sweep_inputs
            xr = fn(2048, m, 3.0, 292 + m, dev)[0]
            xc = fn(3001, m, 3.0, 293 + m, dev)[0]
            for num in (17, 40):
                thr = count_thresholds(xr, xc, num, exact)
                got = cuda_phi.count_le_cuda(xr, xc, thr)
                want = count_le_plain(xr, xc, thr)
                dcnt = int((got - want).abs().max())
                limit = 0 if exact else 1e-6 * 2048 * 3001
                check(dcnt <= limit, f"count n_r=2048 n_c=3001 m={m} "
                      f"T={num}: counts differ by {dcnt} > {limit:.3g}")
                count_err = max(count_err, dcnt)
                print(f"phase 27 count n_r=2048 n_c=3001 m={m} T={num} "
                      f"{'grid' if exact else 'gaussian'}: ok "
                      f"count_diff={dcnt} count_bound={limit:.3g}")
        x_w = sweep_inputs(2048, m, 0.0, 291 + m, dev)[0]
        cuda_phi.reset_launch_counts()
        med_c = float(pairwise_distance_median_hybrid(x_w))
        launched = cuda_phi.launch_counts[cuda_phi.COUNT_KERNEL]
        median_mod.count_le_cross = count_le_plain
        try:
            med_p = float(pairwise_distance_median_hybrid(x_w))
        finally:
            median_mod.count_le_cross = count_le_cross
        med_x = float(median_mod.pairwise_distance_median_exact(
            x_w.double().cpu()))
        rel_p, rel_x = abs(med_c - med_p) / med_p, abs(med_c - med_x) / med_x
        check(launched >= 2 and rel_p <= 1e-3 and rel_x <= 1e-3,
              f"hybrid median at m={m}: {med_c} vs plain {med_p} (rel "
              f"{rel_p:.3e}) and float64 {med_x} (rel {rel_x:.3e}), "
              f"{launched} K16 launches")
        try:
            make_svgd(st, x_w.cpu().numpy(), np.zeros(m), np.eye(m), 3)
            raised = "no error"
        except ValueError as err:
            raised = str(err)
        check("item 17" in raised,
              f"auto at m={m} on the card: {raised!r}, not item 17's error")
        print(f"phase 27 hybrid median n=2048 m={m} (past MAX_M): ok "
              f"k16={med_c:.9g} plain={med_p:.9g} float64_exact={med_x:.9g} "
              f"rel_plain={rel_p:.3e} rel_float64={rel_x:.3e} "
              f"k16_launches={launched}; auto raises (item 17) {clock()}")

    # The self form (one set as rows and columns: the single-device
    # median's every pass) on odd and ragged n off origin, at T = 1 to 33
    # with shuffled, duplicate, negative and past-the-largest thresholds,
    # so through both of the kernel's threshold designs (predicated at
    # T <= 3, binned above): the self counts equal the cross counts of a
    # clone exactly at every m, equal the plain pass at m <= 4 (grid
    # inputs, where both forms are exact) and lie within 1e-6 n^2 of it
    # above (Gaussian inputs), and a second call repeats them.
    def awkward_thresholds(x, num, exact):
        q = count_thresholds(x, x, num, exact)
        rng = np.random.default_rng(1000 + num)
        if num >= 3:
            q[1] = -0.5
            q[2] = 8.0 * float(((x - x.mean(dim=0)) ** 2).sum(dim=1).max())
        if num >= 5:
            q[4] = q[3]
        return q[torch.as_tensor(rng.permutation(num), device=dev)]

    # A self count moves by 2 for each unordered pair at a threshold, so
    # the Gaussian cases take n >= 2049, where the gate 1e-6 n^2 is above 2.
    for n, m, off in ((4099, 1, 3.0), (10007, 2, 5.0), (3001, 4, -2.0),
                      (2049, 11, 3.0), (2049, 65, 3.0)):
        exact = m <= 4
        x = (grid_inputs if exact else sweep_inputs)(n, m, off, 310 + m,
                                                     dev)[0]
        for num in (1, 3, 17, 32, 33):
            thr = awkward_thresholds(x, num, exact)
            want = count_le_plain(x, x, thr)
            got = cuda_phi.count_le_cuda(x, x, thr)
            again = cuda_phi.count_le_cuda(x, x, thr)
            cross = cuda_phi.count_le_cuda(x, x.clone(), thr)
            check(bool((got == cross).all()),
                  f"self count n={n} m={m} T={num}: differs from the cross "
                  f"form by {int((got - cross).abs().max())}")
            check(bool((again == got).all()),
                  f"self count n={n} m={m} T={num}: a second call differs")
            dcnt = int((got - want).abs().max())
            limit = 0 if exact else 1e-6 * n * n
            check(dcnt <= limit, f"self count n={n} m={m} T={num}: counts "
                  f"differ from the plain pass by {dcnt} > {limit:.3g}")
            count_err = max(count_err, dcnt)
            print(f"phase 27 self count n={n} m={m} offset={off} T={num} "
                  f"{'grid' if exact else 'gaussian'}: ok self==cross, "
                  f"repeat equal, count_diff={dcnt} count_bound={limit:.3g}")

    # -- phase 28: times of the chunk kernels and K16 -----------------------
    def chunk_blocks(n, tile, world, rank):
        nb = -(-n // tile)
        t0, count = sym_tile_chunk(n, world, rank, tile)
        return [(bi, bj) for bi, first, last in upper_tile_rows(nb, t0, count)
                for bj in range(first, last + 1)]

    times28 = {}
    x, s, g, thr = sweep_inputs(10000, 2, 0.0, 300, dev)
    t = {"kernel": time_ms(lambda: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
             x, s, g, thr, 1, 0)),
         "plain": plain_ms(lambda: phi_rbf_sym_chunk_counts(x, s, g, thr, 1,
                                                            0)),
         "full": time_ms(lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr,
                                                             sym=True))}
    ranks = [time_ms(lambda: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
        x, s, g, thr, 2, r)) for r in range(2)]
    side = sym_tile(2)
    bounds = [sweep_bound(cuda_phi.SYM_CHUNK_KERNEL, 10000, 2,
                          pairs=chunk_pairs(10000, side,
                                            chunk_blocks(10000, side, 2, r)))[0]
              for r in range(2)]
    times28[("sym_chunk", 10000, 2)] = t
    print(f"phase 28 times sym chunk n=10000 m=2 T=3 (ms, median of 50): "
          f"world1={t['kernel']:.4f} plain={t['plain']:.4f} "
          f"K2={t['full']:.4f} world2_rank0={ranks[0]:.4f} "
          f"world2_rank1={ranks[1]:.4f} (bounds {bounds[0]:.5f}, "
          f"{bounds[1]:.5f}) {clock()}")
    x, s, g, thr = sweep_inputs(10000, 11, 0.0, 301, dev)
    gs = terms_gammas(g, (1, 1))
    t = {"kernel": time_ms(lambda: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
             x, s, gs, (1, 1), thr, 1, 0)),
         "plain": plain_ms(lambda: phi_rbf_terms_sym_chunk_counts(
             x, s, gs, (1, 1), thr, 1, 0)),
         "full": time_ms(lambda: cuda_phi.phi_rbf_terms_fused_cuda(
             x, s, gs, (1, 1), thr, sym=True))}
    ranks = [time_ms(lambda: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
        x, s, gs, (1, 1), thr, 2, r)) for r in range(2)]
    times28[("terms_sym_chunk", 10000, 11)] = t
    print(f"phase 28 times terms sym chunk n=10000 m=11 T=3 two terms (ms, "
          f"median of 50): world1={t['kernel']:.4f} plain={t['plain']:.4f} "
          f"terms_sym={t['full']:.4f} world2_rank0={ranks[0]:.4f} "
          f"world2_rank1={ranks[1]:.4f} {clock()}")
    x, s, g, thr = sweep_inputs(PATH_A_N, 2, 0.0, 302, dev)
    t = {"kernel": time_ms(lambda: cuda_phi.phi_rbf_sympanel_chunk_cuda(
             x, s, g, thr, 1, 0)),
         "plain": plain_ms(lambda: phi_rbf_sympanel_chunk_counts(
             x, s, g, thr, 1, 0)),
         "full": time_ms(lambda: cuda_phi.phi_rbf_fused_cuda(
             x, s, g, thr, sym="panel"))}
    ranks = [time_ms(lambda: cuda_phi.phi_rbf_sympanel_chunk_cuda(
        x, s, g, thr, 2, r)) for r in range(2)]
    times28[("sympanel_chunk", PATH_A_N, 2)] = t
    print(f"phase 28 times sympanel chunk n={PATH_A_N} m=2 T=3 (ms, median of "
          f"50): world1={t['kernel']:.4f} plain={t['plain']:.4f} "
          f"K3={t['full']:.4f} world2_rank0={ranks[0]:.4f} "
          f"world2_rank1={ranks[1]:.4f} {clock()}")
    # K16: the self form (the seeds at N = 10,000 and 262,144, and the
    # 1,048,576 run's) at the hybrid's 17 edges, held to the plain pass on
    # the same inputs (at 10^6 one plain call of about 50 s, timed alone);
    # at T = 3 and 32 too below 10^6 (the predicated design takes T <= 3,
    # the binned one above); the cross form (the sharded engine's) at
    # 10,000^2; the wide instance at phase 27's shape.
    for n in (10000, PATH_A_N, PATH_A_SHORT_N):
        x = sweep_inputs(n, 2, 0.0, 303, dev)[0]
        thr = count_thresholds(x, x, 17, False)
        reps = {10000: 50, PATH_A_N: 10}.get(n, 3)
        t = {"kernel": time_ms(lambda: cuda_phi.count_le_cuda(x, x, thr),
                               reps=reps, warmup=2)}
        if n < PATH_A_SHORT_N:
            t["plain"] = plain_ms(lambda: count_le_plain(x, x, thr))
            want = count_le_plain(x, x, thr)
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = count_le_plain(x, x, thr)
            end.record()
            end.synchronize()
            t["plain"] = start.elapsed_time(end)
        dcnt = int((cuda_phi.count_le_cuda(x, x, thr) - want).abs().max())
        check(dcnt <= 1e-6 * n * n, f"count n={n}^2: counts differ by "
              f"{dcnt} > {1e-6 * n * n:.3g}")
        count_err = max(count_err, dcnt)
        by_t = {}
        if n < PATH_A_SHORT_N:
            for num in (3, 32):
                thr_t = count_thresholds(x, x, num, False)
                by_t[num] = round(time_ms(
                    lambda: cuda_phi.count_le_cuda(x, x, thr_t), reps=reps,
                    warmup=2), 4)
        times28[("count", n, 2)] = t
        print(f"phase 28 times count self n={n}^2 m=2 T=17 (ms): "
              f"kernel={t['kernel']:.4f} plain={t['plain']:.4f} "
              f"bound={sweep_bound(cuda_phi.COUNT_KERNEL, n, 2, T=17)[0]:.5f} "
              f"bound_all_pairs={count_bound_all_pairs(n, 2, 17)[0]:.5f} "
              f"count_diff={dcnt} count_bound={1e-6 * n * n:.3g} "
              f"kernel_at_T={json.dumps(by_t)} {clock()}")
    x = sweep_inputs(10000, 2, 0.0, 304, dev)[0]
    xc = x.clone()
    thr = count_thresholds(x, x, 17, False)
    times28[("count_cross", 10000, 2)] = {
        "kernel": time_ms(lambda: cuda_phi.count_le_cuda(x, xc, thr)),
        "plain": plain_ms(lambda: count_le_plain(x, xc, thr)),
    }
    t = times28[("count_cross", 10000, 2)]
    print(f"phase 28 times count cross n=10000^2 m=2 T=17 (ms): "
          f"kernel={t['kernel']:.4f} plain={t['plain']:.4f} "
          f"bound={sweep_bound(cuda_phi.COUNT_KERNEL, 10000, 2, T=17, n_c=10000)[0]:.5f} "
          f"{clock()}")
    for m in (65, 100):
        xr = sweep_inputs(2048, m, 3.0, 305 + m, dev)[0]
        xc = sweep_inputs(3001, m, 3.0, 306 + m, dev)[0]
        thr = count_thresholds(xr, xc, 17, False)
        t = {"kernel": time_ms(lambda: cuda_phi.count_le_cuda(xr, xc, thr)),
             "plain": plain_ms(lambda: count_le_plain(xr, xc, thr))}
        times28[("count_wide", 2048, m)] = t
        print(f"phase 28 times count wide n_r=2048 n_c=3001 m={m} T=17 (ms): "
              f"kernel={t['kernel']:.4f} plain={t['plain']:.4f} "
              f"bound={sweep_bound(cuda_phi.COUNT_KERNEL, 2048, m, T=17, n_c=3001)[0]:.6f} "
              f"{clock()}")

    # -- phase 29: the sharded flagship on a one-rank NCCL group ------------
    group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    check(group.backend == "nccl", f"one-rank group on {group.backend!r}")
    mean, cov, x0 = flagship_mvn(SHARDED_N)
    x0 = x0.astype(np.float32)
    cuda_phi.reset_launch_counts()
    eng = build_sharded_mvn_svgd(x0, mean, cov, group)
    check(eng._fused_cuda and eng._fused_sym == "full",
          f"sharded flagship resolved fused_cuda={eng._fused_cuda} "
          f"fused_sym={eng._fused_sym!r}, not 'full'")
    state = eng.init_state(x0)
    state = eng.run_state(state, seg_len)  # warm-up segment, untimed
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = eng.run_state(state, SHARDED_ITERS - seg_len)
    end.record()
    end.synchronize()
    timed_s = start.elapsed_time(end) / 1e3
    main_shard = dict(cuda_phi.launch_counts)
    out = group.all_gather_rows(state["coords"])
    check(bool(out.isfinite().all()) and tuple(out.shape) == (SHARDED_N, 2),
          "sharded flagship: bad output")
    # The sharded median seed's two count passes go through K16.
    require_only(main_shard, cuda_phi.SYM_CHUNK_KERNEL, SHARDED_ITERS,
                 f"sharded flagship, {SHARDED_ITERS} steps", count_launches=2)
    post = posterior_metrics(out.cpu().numpy(), mean, cov)
    check(post["mean_err_over_mc"] <= 1.0,
          f"sharded mean_err_over_mc {post['mean_err_over_mc']:.3f} > 1.0")
    check(post["cov_rel_err"] <= 0.05,
          f"sharded cov_rel_err {post['cov_rel_err']:.4f} > 0.05")
    rate = SHARDED_N * (SHARDED_ITERS - seg_len) / timed_s
    print(f"phase 29 sharded flagship N={SHARDED_N} {SHARDED_ITERS} iters, "
          f"one rank on NCCL: ok fused_sym=full "
          f"launches={json.dumps(main_shard)} "
          f"fallbacks={eng.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} (last {SHARDED_ITERS - seg_len} iters) "
          f"posterior={json.dumps(post)} {clock()}")

    # -- phase 30: the sharded hierarchical BLR and the panel form ----------
    cuda_phi.reset_launch_counts()
    eng = build_sharded_hier_svgd(x0_hier, feats_h, labels_h, group)
    check(eng._fused_cuda and eng._fused_sym == "full",
          f"sharded hier resolved fused_sym={eng._fused_sym!r}")
    state = eng.init_state(x0_hier)
    state = eng.run_state(state, seg_len)
    torch.cuda.synchronize()
    start.record()
    state = eng.run_state(state, SHARDED_ITERS - seg_len)
    end.record()
    end.synchronize()
    timed_s = start.elapsed_time(end) / 1e3
    main_shard_hier = dict(cuda_phi.launch_counts)
    out = group.all_gather_rows(state["coords"])
    check(bool(out.isfinite().all()) and tuple(out.shape) == (SHARDED_N, 11),
          "sharded hier: bad output")
    require_only(main_shard_hier, cuda_phi.TERMS_SYM_CHUNK_KERNEL,
                 SHARDED_ITERS, f"sharded hier, {SHARDED_ITERS} steps")
    acc = blr_accuracy(out.cpu().numpy(), feats_h, labels_h)
    check(acc > 0.5, f"sharded hier training accuracy {acc:.4f} <= 0.5")
    rate = SHARDED_N * (SHARDED_ITERS - seg_len) / timed_s
    print(f"phase 30 sharded hier N={SHARDED_N} d=10 {SHARDED_ITERS} iters: "
          f"ok fused_sym=full launches={json.dumps(main_shard_hier)} "
          f"fallbacks={eng.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} train_accuracy={acc:.4f} {clock()}")
    cuda_phi.reset_launch_counts()
    eng = build_sharded_mvn_svgd(x0_l, mean_l, cov_l, group)
    check(eng._fused_sym == "panel",
          f"sharded N={PATH_A_N} resolved fused_sym={eng._fused_sym!r}")
    state = eng.init_state(x0_l)
    state = eng.run_state(state, 2)
    torch.cuda.synchronize()
    start.record()
    state = eng.run_state(state, SHARDED_LARGE_ITERS - 2)
    end.record()
    end.synchronize()
    timed_s = start.elapsed_time(end) / 1e3
    main_shard_panel = dict(cuda_phi.launch_counts)
    out = state["coords"]
    check(bool(out.isfinite().all()) and tuple(out.shape) == (PATH_A_N, 2),
          "sharded panel: bad output")
    require_only(main_shard_panel, cuda_phi.SYMPANEL_CHUNK_KERNEL,
                 SHARDED_LARGE_ITERS,
                 f"sharded N={PATH_A_N}, {SHARDED_LARGE_ITERS} steps")
    rate = PATH_A_N * (SHARDED_LARGE_ITERS - 2) / timed_s
    print(f"phase 30 sharded flagship N={PATH_A_N} {SHARDED_LARGE_ITERS} "
          f"iters: ok fused_sym=panel launches={json.dumps(main_shard_panel)} "
          f"fallbacks={eng.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} (last {SHARDED_LARGE_ITERS - 2} iters) "
          f"{clock()}")
    del eng, state, out
    # The one-rank runs phase 31 holds the two-rank runs to.
    one_rank = {
        "flagship": build_sharded_mvn_svgd(x0, mean, cov, group).run(
            x0, COMPARE_STEPS).double(),
        "hier": build_sharded_hier_svgd(x0_hier, feats_h, labels_h, group).run(
            x0_hier, COMPARE_STEPS).double(),
    }
    torch.distributed.destroy_process_group()

    # -- phase 31: two ranks on the one card over gloo ----------------------
    driver = {
        "flagship": make_svgd(st, x0, mean, cov, COMPARE_STEPS).run().double(),
        "hier": build_blr_svgd(torch.tensor(x0_hier, device=dev), feats_h,
                               labels_h, hierarchical=True,
                               num_iterations=COMPARE_STEPS).run().double(),
    }
    spawn_ctx = torch.multiprocessing.get_context("spawn")
    queue = spawn_ctx.Queue()
    procs = torch.multiprocessing.start_processes(
        sharded_rank, args=(2, free_port(), queue), nprocs=2, join=False,
        start_method="spawn",
    )
    results = dict(queue.get(timeout=600) for _ in range(2))
    while not procs.join(timeout=120):
        pass
    chunk_kernel = {"flagship": cuda_phi.SYM_CHUNK_KERNEL,
                    "hier": cuda_phi.TERMS_SYM_CHUNK_KERNEL}
    apart31 = {}
    for case in ("flagship", "hier"):
        coords = [torch.tensor(results[r][case][0], device=dev).double()
                  for r in range(2)]
        check(bool((coords[0] == coords[1]).all()),
              f"{case}: the two ranks gathered different coordinates")
        for r in range(2):
            check(results[r][case][2] == "full",
                  f"{case} rank {r}: fused_sym {results[r][case][2]!r}")
            require_only(results[r][case][1], chunk_kernel[case],
                         COMPARE_STEPS, f"{case} rank {r} of 2")
        apart31[case] = {
            "vs_one_rank": float((coords[0] - one_rank[case]).abs().max()),
            "vs_driver": float((coords[0] - driver[case]).abs().max()),
            "one_rank_vs_driver": float(
                (one_rank[case] - driver[case]).abs().max()),
        }
        for what in ("vs_one_rank", "vs_driver"):
            check(apart31[case][what] <= 1e-3,
                  f"{case} two ranks {what}: {apart31[case][what]:.3e} > 1e-3")
    print(f"phase 31 two ranks on one card over gloo, N={SHARDED_N} "
          f"{COMPARE_STEPS} steps: ok coords_max_abs_diff="
          f"{json.dumps(apart31)} launches_per_rank="
          f"{json.dumps({c: [results[r][c][1][chunk_kernel[c]] for r in range(2)] for c in chunk_kernel})} "
          f"{clock()}")

    def main_path(phase, kernel, n, m, launches, times, **work):
        bound_ms, bound_by = sweep_bound(kernel, n, m, **work)
        path = {"phase": phase, "n": n, "m": m, "launches": launches,
                "ms": times["kernel"], "plain_ms": times["plain"],
                "bound_ms": bound_ms, "bound_by": bound_by}
        if "full" in times:  # the full-width kernel at the same shape
            path["full_width_ms"] = times["full"]
        return path

    # Each entry's launches, ms, plain_ms and bound are those of its first
    # main path; main_paths lists every main path that runs the kernel, with
    # the times at that path's shape (phases 3, 9 and 16). No single PyTorch
    # call computes phi with the median counts, or phi with a full P, so
    # there is no library time.
    sq, sym = cuda_phi.SQUARE_KERNEL, cuda_phi.SYM_KERNEL
    t_sq, t_sym = cuda_phi.TERMS_SQUARE_KERNEL, cuda_phi.TERMS_SYM_KERNEL
    aniso, k15 = cuda_phi.ANISO_KERNEL, cuda_phi.PHI_RBF_KERNEL
    eig = cuda_phi.SYM_EIGEN_KERNEL
    sp, t_sp = cuda_phi.SYMPANEL_KERNEL, cuda_phi.TERMS_SYMPANEL_KERNEL
    k4, k10 = cuda_phi.SYM_CHUNK_KERNEL, cuda_phi.TERMS_SYM_CHUNK_KERNEL
    k5, k16 = cuda_phi.SYMPANEL_CHUNK_KERNEL, cuda_phi.COUNT_KERNEL
    k1_1500 = {"kernel": times[1500]["square"], "plain": times[1500]["plain"]}
    k2_10k = {"kernel": times[10000]["sym"], "plain": times[10000]["plain"]}
    paths = {
        sq: [main_path(4, sq, 1500, 2, main_square[sq], k1_1500),
             main_path(12, sq, 1000, 50, main_blr[sq],
                       times9[("square", 1000, 50)])],
        sym: [main_path(5, sym, 10000, 2, main_sym[sym], k2_10k)],
        t_sq: [main_path(10, t_sq, 1500, 11, main_terms_sq[t_sq],
                         times9[("terms_square", 1500, 11)], n_iso=2)],
        t_sym: [main_path(11, t_sym, 10000, 11, main_terms_sym[t_sym],
                          times9[("terms_sym", 10000, 11)], n_iso=2)],
        aniso: [main_path(17, aniso, 10240, 11, main_aniso[aniso],
                          times16[("aniso", 2)], n_aniso=1)],
        k15: [main_path(18, k15, 10240, 11, main_k15[k15],
                        times16[("phi_rbf", 10240, 11)]),
              main_path(18, k15, 1500, 2, main_k15_median[k15],
                        times16[("phi_rbf", 1500, 2)])],
        sp: [main_path(22, sp, PATH_A_N, 2, main_panel[sp],
                       times21[("sympanel", PATH_A_N, 2)]),
             main_path(22, sp, PATH_A_SHORT_N, 2, main_panel_1m[sp],
                       times21[("sympanel", PATH_A_SHORT_N, 2)])],
        t_sp: [main_path(23, t_sp, PATH_B_N, 11, main_tpanel[t_sp],
                         times21[("terms_sympanel", PATH_B_N, 11)],
                         n_iso=2)],
        # One rank: the chunk is the whole triangle or panel list.
        k4: [main_path(29, k4, SHARDED_N, 2, main_shard[k4],
                       times28[("sym_chunk", 10000, 2)])],
        k10: [main_path(30, k10, SHARDED_N, 11, main_shard_hier[k10],
                        times28[("terms_sym_chunk", 10000, 11)], n_iso=2)],
        k5: [main_path(30, k5, PATH_A_N, 2, main_shard_panel[k5],
                       times28[("sympanel_chunk", PATH_A_N, 2)])],
        # The median seed and the fallbacks of path A (the seed's set-up
        # at N = 262,144, then 1,048,576; self counts), and the sharded
        # engine's seed (local rows against the gathered sources), timed at
        # the hybrid's 17 edges.
        k16: [main_path(22, k16, PATH_A_N, 2, main_panel[k16],
                        times28[("count", PATH_A_N, 2)], T=17),
              main_path(22, k16, PATH_A_SHORT_N, 2, main_panel_1m[k16],
                        times28[("count", PATH_A_SHORT_N, 2)], T=17),
              main_path(29, k16, SHARDED_N, 2, main_shard[k16],
                        times28[("count_cross", 10000, 2)], T=17,
                        n_c=SHARDED_N)],
    }
    for path in paths[k16]:
        path["bound_all_pairs_ms"] = count_bound_all_pairs(
            path["n"], path["m"], 17)[0]
    for path in paths[k15]:
        path["bound_all_pairs_ms"] = sweep_bound(
            k15, path["n"], path["m"], all_pairs=True)[0]
    # K1's tensor-core body (m >= 5) moves most of its work off the FP32
    # pipes: its least time with that work on the TF32 tensor cores, printed
    # beside the FP32 bound of the kernels line.
    for path in paths[sq]:
        if path["m"] >= SQUARE_TENSOR_MIN_M:
            tensor_ms, tensor_by = square_tensor_bound(path["n"], path["m"])
            print(f"K1 phase {path['phase']} n={path['n']} m={path['m']}: "
                  f"bound_ms={path['bound_ms']:.6g} ({path['bound_by']}, "
                  f"FP32), on the TF32 tensor cores {tensor_ms:.6g} "
                  f"({tensor_by})")
    # The same for the terms square kernel (K6/K7's port) from m = 5.
    for path in paths[t_sq]:
        if path["m"] >= SQUARE_TENSOR_MIN_M:
            tensor_ms, tensor_by = square_tensor_bound(path["n"], path["m"],
                                                       n_terms=2)
            print(f"K6/K7 phase {path['phase']} n={path['n']} m={path['m']} "
                  f"two terms: bound_ms={path['bound_ms']:.6g} "
                  f"({path['bound_by']}, FP32), on the TF32 tensor cores "
                  f"{tensor_ms:.6g} ({tensor_by})")
    # The decomposition beside K15 on the HESSIAN path, one launch a step.
    eig_bound = eigen_bound(11)
    paths[eig] = [{"phase": 18, "n": 10240, "m": 11,
                   "launches": main_k15[eig],
                   "ms": times16[("sym_eigen", 11)]["kernel"],
                   "plain_ms": times16[("sym_eigen", 11)]["plain"],
                   "bound_ms": eig_bound[0], "bound_by": eig_bound[1]}]

    def entry(name, source, replaces, tpu, err, library_ms=None):
        first = paths[name][0]
        return {"name": name, "route": "cuda",
                "source": f"svgdcpp_tpu_torch/csrc/{source}",
                "replaces": replaces, "tpu_kernels": tpu,
                "launches": first["launches"],
                "max_abs_err": err, "ms": first["ms"],
                "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                "bound_by": first["bound_by"], "library_ms": library_ms,
                "main_paths": paths[name]}

    pallas = "svgdcpp_tpu/ops/pallas_phi.py"
    print(card)  # again beside the numbers, at the end of the output
    print(json.dumps({"kernels": [
        entry(sq, "fused_phi.cu", f"{pallas}:365", ["K1"], square_err),
        entry(sym, "fused_phi.cu", f"{pallas}:546", ["K2"], sym_err),
        entry(t_sq, "fused_phi_terms.cu", f"{pallas}:1963 {pallas}:1908",
              ["K6", "K7"], terms_sq_err),
        entry(t_sym, "fused_phi_terms.cu", f"{pallas}:2299 {pallas}:2240",
              ["K8", "K9"], terms_sym_err),
        entry(aniso, "fused_phi_aniso.cu", f"{pallas}:3205", ["K14"],
              aniso_err),
        entry(k15, "phi_rbf.cu", f"{pallas}:116", ["K15"], k15_err),
        # No TPU kernel of its own: K15's wrapper needs the decomposition
        # that _phi_rbf_pallas_impl's Gram form does without; the library
        # call is torch.linalg.eigh on the card.
        entry(eig, "phi_rbf.cu", f"{pallas}:161", ["K15"], eigen_err,
              library_ms=times16[("sym_eigen", 11)]["library"]),
        entry(sp, "fused_phi_panel.cu", f"{pallas}:860", ["K3"],
              sympanel_err),
        entry(t_sp, "fused_phi_panel.cu", f"{pallas}:2718 {pallas}:2925",
              ["K12", "K13"], terms_panel_err),
        entry(k4, "fused_phi.cu", f"{pallas}:1106", ["K4"], sym_chunk_err),
        entry(k10, "fused_phi_terms.cu", f"{pallas}:1335 {pallas}:1228",
              ["K10", "K11"], terms_chunk_err),
        entry(k5, "fused_phi_panel.cu", f"{pallas}:1555", ["K5"],
              panel_chunk_err),
        entry(k16, "count_le.cu", f"{pallas}:1839", ["K16"],
              float(count_err)),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
