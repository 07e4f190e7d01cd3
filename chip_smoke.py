#!/usr/bin/env python3
"""Smoke test of svgdcpp_tpu_torch on one CUDA GPU (an NVIDIA H100).

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``svgdcpp_tpu_torch/csrc`` and runs
forty-six phases, one line each (several for phases 2, 3, 7-9 and
14-46):

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
     card running 3 steps through the wide triangle (K2); the self form (one set
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
     run and of the single-device driver's kernel route; the
     hierarchical BLR at N = 2000 through the generic (VJP) sweep
     (kernel_phi='generic') for 5 steps, within 1e-3 of the one-rank run,
     no sweep kernel and K16's count passes on each rank; and, at N =
     10000 for 20 steps, the flagship in ring mode (phi_mode='ring', the
     only place on the card where a rotation moves data between ranks; no
     sweep kernel, K16's ring count passes) and the flagship driver under
     SVGDOptions.mesh (the two-rank group, auto: K4's chunk on each rank),
     each within 1e-3 of its one-rank run; the flagship driver under the
     two-rank mesh at N = 10001 (5001 and 5000 rows): auto takes the plain
     'fused' sweep, within 1e-3 of the meshless 'fused' driver after 20
     steps, and a forced 'fused_cuda' raises ValueError;
 32. the generic (autodiff) route at full width: the hierarchical BLR
     (bench.py --config hier: d = 10, m = 11, N = 10000, RBF(median) +
     RBF(0.1 I), Adam 5e-2) for 20 steps with phi_impl='generic' and with
     'rbf_terms' from one x0, within 1e-3; the first step's phi of both
     routes from one state; ms a step (CUDA events after 2 warm-up steps),
     peak memory and K16's launches a step (the adaptive slot's same-step
     median), K16 timed at that shape; ksd_rbf of an RBF given as a custom
     kernel_fn (ksd_squared_generic) on the run's particles within 1e-4 of
     the closed form (float64; float32 printed); then RBF(median) + an
     inverse-multiquadric leaf on the flat BLR (d = 50, N = 1000), auto ->
     generic, 100 steps, training accuracy above 0.5;
 33. the debug dump (log_intermediate_matrices) at n = 64, m = 2, 3 steps:
     the driver's K and grad-K stacks within 1e-5 of float64 ones
     recomputed on the CPU, and its file equal to utils/logging's text of
     the stacks; the same on the engine with one NCCL rank in gather mode;
 34. checkpoints: the flagship at n = 1500 on fused_cuda (K1, no float
     atomics) for 50 steps against 25, a save, a restore into a fresh
     driver and 25 more, equal bit for bit; the same for the sharded
     flagship (N = 10000, one NCCL rank, its cross form through K1) at 20
     steps;
 35. BinomialLikelihood on the card: the JAX test's bounded configuration
     (tests/test_binomial.py) at N = 10000 through fused_cuda (K2), 400
     Adam steps, the particle mean within 4 posterior sd of the MLE;
 36. the driver under SVGDOptions.mesh on a one-rank NCCL group at full
     width, 20 steps from the workloads' x0 beside the meshless driver on
     the same route: the flagship (auto -> fused_cuda, the triangle chunk
     K4 where the meshless driver runs K2), the hierarchical BLR (auto ->
     fused_terms_cuda, K10/K11's chunk where it runs K8/K9) and the flat
     BLR (d = 50, N = 1000, the cross form through K1); coordinates within
     1e-3, ms a step of both (CUDA events after 2 warm-up steps) beside the
     engine's (phases 29 and 30), launches a step, only the expected
     kernel;
 37. the ring schedule (phi_mode='ring', warm median) on one NCCL rank at
     full width: the sharded flagship and hierarchical BLR (fused_phi
     False; the composed kernel as RBF terms), 20 steps against gather
     mode on the same engine (within 1e-3); ms a step of both, peak memory,
     K16's launches a step (the ring's count passes; no sweep kernel) and
     K16's time at each shape (the self count at the warm pass's 9 edges);
 38. the histogram median (median_method='histogram') at N = 10000 on the
     flagship's x0 (m = 2) and the hier bench's (m = 11) against 'exact'
     on the card and float64 on the host (within 1e-5 relative), ms of
     both (median of 10); the cuda route (K15) with a MEDIAN RBF on
     'histogram' at n = 1500 for 50 steps against the same route on
     'exact' (within 1e-3);
 39. TorchOptimizer(torch.optim.Adam, lr=5e-2) on the flat BLR (K1) and
     the hierarchical BLR at N = 10000 (K8/K9) for 20 steps against the
     port's Adam(5e-2): coordinates within 1e-3, ms a step of both;
 40. utils/profiling: step_timer on the flagship's step (N = 10000, K2),
     a trace() of 3 steps written under chiprun_out/chip_smoke_trace/
     whose kernel events name K2's kernel, and speed_of_light(10000, 2)
     equal to K2's bound;
 41. utils/native: the C++ oracle (float64 on the host, exact median every
     step) against the cuda route (K15, median_method='exact') at n = 1500
     for 15 steps from one x0, within 1e-3;
 42. every examples/torch_*_example.py run() on the card at its defaults
     (EXAMPLE_ARGS; nothing cut): mvn and gmm (dense, their moment and
     mode checks), blr (K1, label agreement above 0.8), hierarchical
     (rbf_terms, no sweep kernel), large_scale (K2 at 100000 particles,
     the KSD falls) and sharded (K4 on a one-rank NCCL world, the KSD
     halves), and the large-scale and sharded kernels timed at their
     shapes;
 43. the sweeps past m = 64 (the wide bodies): 43a K1 (square (1000, m),
     cross 700 x 1500), K6/K7 ((1500, m), two terms), K2 and K8/K9 at
     n = 4096 and K4 and K10/K11 at worlds 1 and 2 (ranks summed), at
     m = 65, 123, 256 and 512 on grid inputs, K2 and K8/K9 again at
     (10000, 123) (three terms, one negative): phi within 2.5e-3 of max
     |phi| of the float64 plain version, counts equal to the float64 and
     float32 plain versions'; each instance's kernel us (profiler),
     wrapper ms, FP32 and tensor-core bounds, registers, spills and shared
     memory; then the float32 wide square body (csrc/square_wide_sm90.cuh)
     at m = 65, 123, 124, 256 and 512: K1 square at n = 127, 129, 1000 and
     1500 and cross (700 x 1500), K6/K7 with two terms (FixedTerms<2>) and
     three (AnyTerms) square and two cross, each held as above and called
     twice, bit-identical, the same at (300, 600), in two passes, and its
     instances' 0 bytes of spill; 43d the library's svgd_square_splits and svgd_sym_tile
     against sym_plan's at m = 65-512; 43b each kernel at 43c's shapes
     on grid inputs, held to its plain versions as in 43a (K1 at
     (1000, 123), K6/K7 at (1500, 124) two terms, and the triangle, the
     square form and the world-1 chunk at (10000, 123) one RBF and
     (10000, 124) two terms), and the triangle against the square form
     there, resolve_sym(None) taking the faster (the triangle on a 5%
     tie);
     43c the slice on auto at a9a's width (d = 123): flat BLR N = 1000
     (500 K1 launches, training accuracy above 0.5), flat and
     hierarchical BLR at N = 10000 (the rule's kernels, 20 launches) and
     hierarchical BLR at N = 1500 (the square form, K6/K7), each
     within 1e-3 of its float64 plain route after 20 steps, and the
     engine on a one-rank NCCL group (hier, K10/K11; MVN d = 123 with
     fused_sym="full", K4) within 1e-3 of the driver after 20 steps;
 44. K14 and K15 past m = 64 (both on wide_tri_sm90.cuh's body): 44a K14's
     wide term groups (iso + 1,
     iso + 2 with a negative sign, 0 + 1 and two isotropic terms + 1;
     each group's raw slab against its plain per-group version too) and
     K15's wide sweep at m = 65, 123, 256 and 512 (n = 4096, grid inputs)
     against float64, 44e K14's groups at the tile-128 edges n = 127,
     128, 129 and 257 (m = 65, 123), K15's at n = 1, 129 and 10007
     (m = 65, 123; P positive definite and indefinite), and their
     instances' 0 bytes of spill,
     44b both at (10240, 123), 44c the anisotropic MVN on auto and the
     HESSIAN 'cuda' route at d = 123, gated per call;
 45. the panel sweeps past m = 64 (their float32 wide entries on
     wide_tri_sm90.cuh's body, into the triangle's accumulator): 45a K3 and
     K12/K13 (two terms) at (4096, 65 / 123 / 256), K3 and K5's chunks
     (worlds 1 and 2) at (10000, 123) and K12/K13 at (10000, 124), on
     grid inputs within 2.5e-3 of max |phi| of float64, counts equal, each
     timed beside the full-width triangle at the same shape; then at the
     tile-128 edges n = 127, 128, 129 and 257 (m = 65, 123) and on a forced
     plan of 2 super-blocks at n = 600 whose last is ragged (K5 over worlds
     1-3), and their instances' 0 bytes of spill; 45b the flat
     BLR driver at (10000, 123) and the hierarchical one at (10000, 124)
     with fused_sym="panel" for 20 steps, each sweep call replayed
     against float64 (replay_gate), and the engine with fused_sym="panel"
     on a one-rank NCCL group at (10000, 123) (K5), each chunk call held
     to its float64 plain chunk and the coordinates within 1e-3 of the
     driver's; ms a step of each;
 46. the bfloat16 opt-in (fused_dot_dtype='bfloat16'): 46a K1 at
     (1000, 50), (1000, 16), (1000, 17), (1000, 63), (1000, 64),
     (1000, 65), (1000, 123) and the source edges (1, 2), (33, 17) and
     (10007, 2), its cross form at 5000 and 10000 of 10000 (m = 2), at
     10000 of 10000 (m = 123) and at the edges 33 of 10007 (m = 65) and
     129 of 1 (m = 2) (K1 on square_bf16_sm90.cuh's body, whose record
     columns past 16 n8 tiles, m >= 64, go in chunks along the grid's z),
     K2 at (10000, 2), (10000, 123), (10000, 16) and (10000, 17), K3
     forced at (32768, 2), (10000, 123), (8192, 16) and (8192, 17) (K2
     and K3 on bf16_tri_sm90.cuh's body, whose Gram tile steps k16 at a
     time), K15 (the same body, two Gram tiles an item) at (1500, 2),
     (10240, 123) and the edges (1, 2), (129, 123) and (10007, 123) on
     grid inputs, and at (1500, 11) and (1500, 50) on Gaussian inputs,
     its pack's operands bit for bit, each against its
     bf16 plain version on the card within 1e-3 of max |phi| (counts
     within 1e-6 n_t n) and against the float32 plain version within
     3e-2, with times beside the float32 instance's and bounds at the
     bf16 tensor peak, then 0 bytes of spill of both bodies' instances
     and the pack kernel; 46b the flagship on auto (K2's bf16 instance) for
     1000 iterations, 20 of its sweep calls held to the bf16 plain
     version, its moment errors beside the float32 route's (not gated);
     the flat BLR (K1), the flagship with fused_sym="panel" at N = 32768
     (K3) and the flagship driver under a one-rank NCCL mesh (K1's cross
     form; forced triangles raise), 20 steps each, every call held; ms a
     step of each.

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
from typing import Callable, NamedTuple

from svgdcpp_tpu_torch.utils.profiling import (
    bound,
    count_bound_all_pairs,
    eigen_bound,
    square_tensor_bound,
    sweep_bound,
    tri_tensor_bound,
)


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
    terms) beside the term-group one, aniso_terms_groups<MM,exact,1>, the
    wide ones past m = 64, aniso_wide_groups<kT>, aniso_wide_iso<kT> and
    rbf_wide, the panels' float32 ones past m = 64 (kernels of their own,
    on the float32 wide triangle body) counts_sympanel_wide<kT>,
    counts_sympanel_chunk_wide<kT> and terms_sympanel_wide<kT,NTerms>, and
    the bfloat16 instances counts_square_bf16<kT,NT> (NT accumulator
    tiles), counts_sym_bf16<kT>, counts_sympanel_bf16<kT> and
    rbf_wide_bf16, and the bf16 bodies' pack kernels, bf16_tri_pack and
    square_bf16_pack."""
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
                r"(count_le_cross_wide|count_le_cross|aniso_terms_sym|"
                r"aniso_terms_wide_groups|aniso_terms_wide_iso)_kernelI"
                r"((?:L[ib]\d+E)+)", hit.group(1))
            if other:
                args = ",".join(re.findall(r"L[ib](\d+)E", other.group(2)))
                short = {"count_le_cross": "count_le",
                         "count_le_cross_wide": "count_le_wide",
                         "aniso_terms_wide_groups": "aniso_wide_groups",
                         "aniso_terms_wide_iso": "aniso_wide_iso"}
                name = f"{short.get(other.group(1), other.group(1))}<{args}>"
            if "phi_rbf_wide_kernel" in hit.group(1):
                name = "rbf_wide"
            if "bf16_tri_pack_kernel" in hit.group(1):
                name = "bf16_tri_pack"
            if "square_bf16_pack_kernel" in hit.group(1):
                name = "square_bf16_pack"
            bf16 = re.search(
                r"(?<=\d)(?:fused_)?phi_([a-z_]+_bf16)_kernel"
                r"(?:I((?:Li\d+E)+))?", hit.group(1))
            if bf16:
                args = ",".join(re.findall(r"Li(\d+)E", bf16.group(2) or ""))
                name = bf16.group(1) + (f"<{args}>" if args else "")
            panel = re.search(r"(?<=\d)fused_phi_(\w+?_wide)_kernelI"
                              r"((?:Li\d+E)+)", hit.group(1))
            if panel:
                args = ",".join(re.findall(r"Li(\d+)E", panel.group(2)))
                name = f"{panel.group(1)}<{args}>"
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
#: Phase 32: steps of the generic and rbf_terms runs (the first two untimed)
#: and of the custom-kernel run; phase 33: the debug dump's particles and
#: steps; phase 34: the checkpointed runs; phase 35: the binomial run.
GENERIC_STEPS, GENERIC_WARMUP, IMQ_STEPS = 20, 2, 100
DUMP_N, DUMP_STEPS = 64, 3
CKPT_N, CKPT_STEPS, SHARDED_CKPT_STEPS = 1500, 50, 20
BINOMIAL_N, BINOMIAL_STEPS = 10000, 400
#: Phase 31's generic case: the hierarchical BLR at N = 2,000 through the
#: generic (VJP) sweep for 5 steps.
GENERIC_SHARDED_N, GENERIC_SHARDED_STEPS = 2000, 5


def sharded_rank(rank, world, port, queue):
    """Phase 31's rank ``rank`` of ``world``, spawned (not forked) once the
    parent's CUDA is up: a gloo world on the one card (NCCL refuses two
    ranks on one device), the sharded flagship and hierarchical BLR at
    N = 10,000 for COMPARE_STEPS steps from the workloads' x0, the flagship
    in ring mode (phi_mode='ring', the blocks rotating between the ranks)
    and the flagship driver under SVGDOptions.mesh (auto) for as many, and
    the hierarchical BLR at GENERIC_SHARDED_N through the generic sweep
    (kernel_phi='generic') for GENERIC_SHARDED_STEPS; puts (rank, {case:
    (gathered coords, launch counts, form)}) on ``queue``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.parallel import initialize_distributed
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_mvn_svgd,
        build_sharded_hier_svgd,
        build_sharded_mvn_svgd,
        flagship_mvn,
    )

    class DriverRun:
        """The driver under a mesh with the engines' run(x, steps) and
        _fused_sym."""

        def __init__(self, svgd):
            self.svgd, self._fused_sym = svgd, svgd.fused_sym_form

        def run(self, x, steps):
            return self.svgd.run()

    group = initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                   backend="gloo", device="cuda:0")
    out = {}
    mean, cov, x0 = flagship_mvn(SHARDED_N)
    x0 = x0.astype(np.float32)
    feats, labels, x0_h = blr_workload(SHARDED_N, 10, hierarchical=True)
    feats_g, labels_g, x0_g = blr_workload(GENERIC_SHARDED_N, 10,
                                           hierarchical=True)
    for case, build, x, steps in (
        ("flagship", lambda: build_sharded_mvn_svgd(x0, mean, cov, group),
         x0, COMPARE_STEPS),
        ("hier", lambda: build_sharded_hier_svgd(x0_h, feats, labels, group),
         x0_h, COMPARE_STEPS),
        ("hier_generic", lambda: build_sharded_hier_svgd(
            x0_g, feats_g, labels_g, group, fused_phi=False,
            kernel_phi="generic"), x0_g, GENERIC_SHARDED_STEPS),
        ("flagship_ring", lambda: build_sharded_mvn_svgd(
            x0, mean, cov, group, fused_phi=False, phi_mode="ring"),
         x0, COMPARE_STEPS),
        ("driver_mesh", lambda: DriverRun(build_mvn_svgd(
            x0, mean, cov, num_iterations=COMPARE_STEPS, mesh=group)),
         x0, COMPARE_STEPS),
    ):
        engine = build()
        cuda_phi.reset_launch_counts()
        coords = engine.run(x, steps)
        torch.cuda.synchronize()
        out[case] = (coords.cpu().numpy(), dict(cuda_phi.launch_counts),
                     engine._fused_sym)
    # UNEVEN_N particles over the two ranks (5001 and 5000 rows): auto takes
    # the plain fused sweep, and a forced kernel route raises.
    mean_u, cov_u, x0_u = flagship_mvn(UNEVEN_N)
    svgd = build_mvn_svgd(x0_u.astype(np.float32), mean_u, cov_u,
                          num_iterations=COMPARE_STEPS, mesh=group)
    cuda_phi.reset_launch_counts()
    coords = svgd.run()
    torch.cuda.synchronize()
    counts = dict(cuda_phi.launch_counts)
    try:
        build_mvn_svgd(x0_u.astype(np.float32), mean_u, cov_u,
                       phi_impl="fused_cuda", num_iterations=1, mesh=group)
        refused = ""
    except ValueError as e:
        refused = str(e)
    out["driver_uneven"] = (coords.cpu().numpy(), counts, svgd._phi_impl,
                            refused, group.share(UNEVEN_N))
    queue.put((rank, out))
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# Phases 38-42: the histogram selector, the torch.optim adapter, the
# profiling module, the native helpers and the examples
# ----------------------------------------------------------------------

#: Phase 38: the histogram selector at N = 10,000 (the flagship's and the
#: hier bench's x0; ms the median of HIST_REPS calls), its relative gate
#: against the exact median on the card and the float64 one on the host
#: (the float32 squared distances' rounding; one final bucket is about
#: 1e-9), and the cuda route (K15) at phase 18's n = 1500.
HIST_N, HIST_REPS, HIST_REL_GATE = 10000, 10, 1e-5
HIST_ROUTE_N, HIST_ROUTE_STEPS = 1500, 50
#: Phase 39: the torch.optim adapter on the flat BLR (N = 1000, d = 50, K1)
#: and the hier bench (N = 10,000, d = 10, K8/K9) against the port's Adam:
#: {path: (N, d, hierarchical)}.
ADAPTER_STEPS, ADAPTER_LR = 20, 5e-2
ADAPTER_PATHS = {"flat_blr": (1000, 50, False), "hier": (10000, 10, True)}
#: Phase 40: the flagship's step under step_timer, and the steps traced.
TIMER_N, TIMER_WARMUP, TIMER_STEPS, TIMER_CHUNK, TRACE_STEPS = (
    10000, 2, 20, 5, 3)
#: Phase 41: the C++ oracle against the cuda route (K15, exact median).
ORACLE_N, ORACLE_STEPS = 1500, 15
#: Phase 31's uneven case: the flagship driver under the two-rank mesh at a
#: particle count two ranks do not divide.
UNEVEN_N = 10001
#: Phase 42: each example's run() arguments on the card: the defaults
#: (large_scale 100,000 particles, 100 iterations run twice; sharded 4,096
#: particles, 200 iterations); nothing is cut.
EXAMPLE_ARGS = {"mvn": {}, "gmm": {}, "blr": {}, "hierarchical": {},
                "large_scale": {}, "sharded": {}}


#: Phase 43: the wide sweeps (m > 64). 43a: each widened kernel at every
#: width of WIDE_MS against its float64 plain version on grid inputs (K1
#: square at WIDE_SQUARE_N and cross at WIDE_CROSS, the terms square kernel
#: at WIDE_TERMS_SQUARE_N with two terms, the triangles and chunks at
#: WIDE_TRI_N, the triangles again at WIDE_TRI_BIG_N for m = 123); 43b: the
#: form rule's shapes, (N, m, signs) with signs None for one RBF; 43c: the
#: slice's paths on auto, the flat BLR (WIDE_BLR_N particles,
#: WIDE_BLR_STEPS steps), the N = WIDE_BIG_N flat and hierarchical BLR and
#: engine runs and the hierarchical BLR at WIDE_TERMS_SQUARE_N particles,
#: of COMPARE_STEPS steps, at d = WIDE_D (a9a's 123 features).
WIDE_MS = (65, 123, 256, 512)
WIDE_SQUARE_N, WIDE_CROSS, WIDE_TERMS_SQUARE_N = 1000, (700, 1500), 1500
WIDE_TRI_N, WIDE_TRI_BIG_N = 4096, 10000
WIDE_PHI_GATE = 2.5e-3
WIDE_RULE = ((10000, 123, None), (10000, 124, (1.0, 1.0)))
#: Phase 43b: the triangle is the card's form past 64 where its time is
#: within this share of the square sweep's (sym_plan.card_resolve_sym).
WIDE_SYM_TIE = 0.05
WIDE_D, WIDE_BLR_N, WIDE_BLR_STEPS, WIDE_BIG_N = 123, 1000, 500, 10000


def kernel_us(fn, name, calls=10, tries=3):
    """Mean device us of the kernels whose name holds ``name`` (or any
    name of a tuple: a call's several kernels) (the profiler's events) over
    ``calls`` calls of ``fn``, after one; a trace that lacks any of the
    names (on an H100, a trace held none of a call's kernels once in a run
    of phase 43a's 38 cases, and once lacked one of two) is taken again,
    up to ``tries`` times, else None."""
    names = (name,) if isinstance(name, str) else tuple(name)
    import tempfile
    from pathlib import Path

    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        hits = [ev for ev in events
                if ev.get("ph") == "X" and ev.get("cat") == "kernel"
                and any(nm in ev.get("name", "") for nm in names)]
        if all(any(nm in ev["name"] for ev in hits) for nm in names):
            return sum(float(ev["dur"]) for ev in hits) / calls
    return None


class WideCase(NamedTuple):
    """One of phase 43a's calls: the kernel's call, its plain float64 call
    and its plain float32 call each return (phi, counts); ``n_t`` is the
    cross form's target count (None: one set of n)."""
    label: str
    kernel: str
    n: int
    m: int
    terms: tuple | None
    kern: Callable
    want64: Callable
    want32: Callable
    n_t: int | None = None


def ranks_summed(fn, world, n, finish):
    """(phi, counts) of a chunk sweep over every rank of ``world``:
    ``fn(world, rank)``'s raw accumulators and upper counts summed and
    finished as the engine does."""
    acc = upper = None
    for rank in range(world):
        a, u = fn(world, rank)
        acc = a if acc is None else acc + a
        upper = u if upper is None else upper + u
    return finish(acc), 2 * upper - n


def wide_cases(dev):
    """Phase 43a's calls (WideCase); the chunk kernels' calls sum every
    rank of a world and finish the sum as the engine does."""
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_cross_fused_counts,
        phi_rbf_fused_counts,
        phi_rbf_fused_sym_finish,
        phi_rbf_sym_chunk_counts,
        phi_rbf_terms_fused_counts,
        phi_rbf_terms_fused_sym_finish,
        phi_rbf_terms_sym_chunk_counts,
    )

    def f64(*ts):
        return [t.double() for t in ts]

    cases = []
    for idx, m in enumerate(WIDE_MS):
        off = 100.0 if m == 123 else 0.0
        n = WIDE_SQUARE_N
        x, s, g, thr = grid_inputs(n, m, off, 430 + idx, dev)
        cases.append(WideCase(
            f"K1 square ({n}, {m}) offset={off}", cuda_phi.SQUARE_KERNEL, n,
            m, None,
            lambda x=x, s=s, g=g, thr=thr:
            cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False),
            lambda x=x, s=s, g=g, thr=thr:
            phi_rbf_fused_counts(*f64(x, s, g, thr)),
            lambda x=x, s=s, g=g, thr=thr:
            phi_rbf_fused_counts(x, s, g, thr)))
        n_t, n_s = WIDE_CROSS
        xs, ss, g, thr = grid_inputs(n_s, m, 0.0, 440 + idx, dev)
        xt = grid_inputs(n_t, m, 0.0, 450 + idx, dev)[0]
        cases.append(WideCase(
            f"K1 cross ({n_t} x {n_s}, {m})", cuda_phi.SQUARE_KERNEL, n_s, m,
            None,
            lambda xt=xt, xs=xs, ss=ss, g=g, thr=thr:
            cuda_phi.phi_rbf_fused_cuda_cross(xt, xs, ss, g, thr),
            lambda xt=xt, xs=xs, ss=ss, g=g, thr=thr:
            phi_rbf_cross_fused_counts(*f64(xt, xs, ss, g, thr)),
            lambda xt=xt, xs=xs, ss=ss, g=g, thr=thr:
            phi_rbf_cross_fused_counts(xt, xs, ss, g, thr),
            n_t=n_t))
        n = WIDE_TERMS_SQUARE_N
        x, s, g, thr = grid_inputs(n, m, 0.0, 460 + idx, dev)
        signs = (1.0, 1.0)
        gs = [g, 0.5 * g]
        cases.append(WideCase(
            f"K6/K7 terms square ({n}, {m}) two terms",
            cuda_phi.TERMS_SQUARE_KERNEL, n, m, signs,
            lambda x=x, s=s, gs=gs, thr=thr, signs=signs:
            cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                              sym=False),
            lambda x=x, s=s, gs=gs, thr=thr, signs=signs:
            phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                       thr.double()),
            lambda x=x, s=s, gs=gs, thr=thr, signs=signs:
            phi_rbf_terms_fused_counts(x, s, gs, signs, thr)))
        tri_ns = (WIDE_TRI_N, WIDE_TRI_BIG_N) if m == 123 else (WIDE_TRI_N,)
        for n in tri_ns:
            x, s, g, thr = grid_inputs(n, m, 0.0, 470 + idx + n, dev)
            gs = [g, 0.5 * g]
            # Three terms with a negative sign at m = 123 (the instance
            # of any term count), two at the other widths.
            signs = (1.0, -0.5, 1.0) if m == 123 else (1.0, 1.0)
            if len(signs) == 3:
                gs = [g, 0.5 * g, 2.0 * g]
            cases.append(WideCase(
                f"K2 triangle ({n}, {m})", cuda_phi.SYM_KERNEL, n, m, None,
                lambda x=x, s=s, g=g, thr=thr:
                cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True),
                lambda x=x, s=s, g=g, thr=thr:
                phi_rbf_fused_counts(*f64(x, s, g, thr)),
                lambda x=x, s=s, g=g, thr=thr:
                phi_rbf_fused_counts(x, s, g, thr)))
            cases.append(WideCase(
                f"K8/K9 terms triangle ({n}, {m}) signs={signs}",
                cuda_phi.TERMS_SYM_KERNEL, n, m, signs,
                lambda x=x, s=s, gs=gs, thr=thr, signs=signs:
                cuda_phi.phi_rbf_terms_fused_cuda(
                    x, s, gs, signs, thr, sym=True),
                lambda x=x, s=s, gs=gs, thr=thr, signs=signs:
                phi_rbf_terms_fused_counts(
                    *f64(x, s), f64(*gs), signs, thr.double()),
                lambda x=x, s=s, gs=gs, thr=thr, signs=signs:
                phi_rbf_terms_fused_counts(x, s, gs, signs, thr)))
            if n != WIDE_TRI_N:
                continue
            for world in (1, 2):
                cases.append(WideCase(
                    f"K4 chunks ({n}, {m}) world={world}",
                    cuda_phi.SYM_CHUNK_KERNEL, n, m, None,
                    lambda x=x, s=s, g=g, thr=thr, n=n, world=world:
                    ranks_summed(
                        lambda w, r: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                            x, s, g, thr, w, r), world, n,
                        lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n)),
                    lambda x=x, s=s, g=g, thr=thr:
                    phi_rbf_fused_counts(*f64(x, s, g, thr)),
                    lambda x=x, s=s, g=g, thr=thr, n=n, world=world:
                    ranks_summed(
                        lambda w, r: phi_rbf_sym_chunk_counts(
                            x, s, g, thr, w, r), world, n,
                        lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n))))
                cases.append(WideCase(
                    f"K10/K11 terms chunks ({n}, {m}) signs={signs} "
                    f"world={world}",
                    cuda_phi.TERMS_SYM_CHUNK_KERNEL, n, m, signs,
                    lambda x=x, s=s, gs=gs, thr=thr, n=n, world=world,
                    signs=signs: ranks_summed(
                        lambda w, r: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                            x, s, gs, signs, thr, w, r), world, n,
                        lambda acc: phi_rbf_terms_fused_sym_finish(
                            acc, s, signs, n)),
                    lambda x=x, s=s, gs=gs, thr=thr, signs=signs:
                    phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                               thr.double()),
                    lambda x=x, s=s, gs=gs, thr=thr, n=n, world=world,
                    signs=signs: ranks_summed(
                        lambda w, r: phi_rbf_terms_sym_chunk_counts(
                            x, s, gs, signs, thr, w, r), world, n,
                        lambda acc: phi_rbf_terms_fused_sym_finish(
                            acc, s, signs, n))))
    return cases


#: The float32 wide triangle body's dynamic shared memory
#: (csrc/wide_tri_sm90.cuh WideSym), one block an SM: for one RBF (K2/K4
#: past m = 64) a 3-stage ring of two 128 x 40-float slots, the 128 x
#: 136-float weight tile and 1032 floats of norms, partial sums and
#: thresholds; for terms (K8-K11) a 2-stage ring and two weight tiles (+ 192
#: B of static term constants for any count of terms).
WIDE_SYM_SMEM = 4 * (3 * 2 * 128 * 40 + 128 * 136 + 1032)
WIDE_SYM_TERMS_SMEM = 4 * (2 * 2 * 128 * 40 + 2 * 128 * 136 + 1032)

#: The wide bodies' shared memory (WIDE_SYM_SMEM, dynamic), in bytes:
#: K15's wide sweep and K14's single-term groups on the float32 wide
#: triangle body's one-weight layout (K14's group 0 of two or more
#: isotropic terms on the terms layout, WIDE_SYM_TERMS_SMEM + 192 B of
#: static term constants). The square kernels' (csrc/square_wide_sm90.cuh,
#: dynamic) follows m: wide_smem.
WIDE_SMEM = {"fused_phi_counts_sym": WIDE_SYM_SMEM,
             "fused_phi_counts_sym_chunk": WIDE_SYM_SMEM,
             "fused_phi_terms_sym": WIDE_SYM_TERMS_SMEM,
             "fused_phi_terms_sym_chunk": WIDE_SYM_TERMS_SMEM,
             "fused_phi_aniso_terms_wide": WIDE_SYM_SMEM,
             "phi_rbf_wide": WIDE_SYM_SMEM}

#: The float32 wide triangle body's instances (ptxas names): K2, K4, K8/K9
#: and K10/K11 at MM = 0, T = 3 or any T <= 8 (kT 8), two terms or any
#: count (0).
WIDE_SYM_INSTANCES = tuple(
    f"{k}<0,0,{t}{nt}>"
    for k, nts in (("counts_sym", ("",)), ("counts_sym_chunk", ("",)),
                   ("terms_sym", (",2", ",0")),
                   ("terms_sym_chunk", (",2", ",0")))
    for t in (3, 8) for nt in nts)

#: Phase 43e: the new tile's edges (n = 127, 128, 129 and 257) at these m,
#: and the chunk kernels summed over worlds 1 to WIDE_EDGE_WORLDS.
WIDE_EDGE_NS, WIDE_EDGE_MS, WIDE_EDGE_WORLDS = (127, 128, 129, 257), \
    (65, 123), 3

#: Each wide kernel's ptxas instance names (chip_smoke.ptxas_summary) at
#: T = 3, MM = 0 being the wide instance (K14's and K15's wide kernels
#: have instances of their own).
WIDE_INSTANCES = {"fused_phi_counts_square": ("counts_square<0,0,3>",),
                  "fused_phi_terms_square": ("terms_square<0,0,3,2>",
                                             "terms_square<0,0,3,0>"),
                  "fused_phi_counts_sym": ("counts_sym<0,0,3>",),
                  "fused_phi_counts_sym_chunk": ("counts_sym_chunk<0,0,3>",),
                  "fused_phi_terms_sym": ("terms_sym<0,0,3,2>",
                                          "terms_sym<0,0,3,0>"),
                  "fused_phi_terms_sym_chunk": ("terms_sym_chunk<0,0,3,2>",
                                                "terms_sym_chunk<0,0,3,0>"),
                  "fused_phi_aniso_terms_wide": ("aniso_wide_groups<3>",
                                                 "aniso_wide_iso<3>"),
                  "phi_rbf_wide": ("rbf_wide",)}


def wide_smem(kernel, m):
    """A wide kernel's shared memory in bytes at dimension m: the square
    kernels' from their plan (sym_plan.square_wide_plan; + 192 B of static
    term constants for any count of terms), the others' WIDE_SMEM."""
    from svgdcpp_tpu_torch.ops import sym_plan

    if kernel == "fused_phi_counts_square":
        return sym_plan.square_wide_plan(m).smem
    if kernel == "fused_phi_terms_square":
        return sym_plan.square_wide_plan(m).smem_terms
    return WIDE_SMEM[kernel]


def wide_bounds(kernel, n, m, terms, pairs=None, n_t=None):
    """(FP32 bound, tensor-core bound) of a wide kernel's call, each
    (ms, bound_by); ``n_t``: a square kernel's cross form, n_t targets
    against the n sources."""
    n_iso = len(terms) if terms else 1
    n_terms = len(terms) if terms else None
    fp32 = sweep_bound(kernel, n, m, n_iso=n_iso, pairs=pairs, n_t=n_t)
    if "square" in kernel:
        return fp32, square_tensor_bound(n, m, n_terms=n_terms, n_t=n_t)
    return fp32, tri_tensor_bound(n, m, n_terms=n_terms, pairs=pairs)


def wide_held(label, got, want64, want32):
    """Hold a wide kernel's (phi, counts) to its plain versions' on grid
    inputs: phi finite and within WIDE_PHI_GATE (max relative) of the
    float64 plain version's, the counts (None for K15, which has none)
    equal to both plain versions'. ``label`` starts with its phase.
    Returns (max |dphi|, that relative error)."""
    import torch

    phi_k, cnt_k = got
    phi_w, cnt_w = want64
    cnt_32 = want32[1]
    torch.cuda.synchronize()
    check(bool(phi_k.isfinite().all()), f"phase {label}: non-finite")
    abs_err = float((phi_k.double() - phi_w).abs().max())
    rel = abs_err / float(phi_w.abs().max())
    check(rel <= WIDE_PHI_GATE,
          f"phase {label}: phi rel err {rel:.3e} > {WIDE_PHI_GATE}")
    if cnt_k is not None:
        # Grid inputs: every sq is exact in both forms.
        d64 = int((cnt_k - cnt_w).abs().max())
        d32 = int((cnt_k - cnt_32).abs().max())
        check(d64 == 0 and d32 == 0,
              f"phase {label}: counts differ from the float64 plain "
              f"version's by {d64}, the float32 one's by {d32}")
    return abs_err, rel


def phase_wide_kernels(dev, card, clock, ptxas):
    """Phase 43a (kernels against their plain versions at m > 64, their
    times and bounds) and 43d (the library's plan against sym_plan's past
    64). Returns ({kernel: max |dphi|}, {(label, n, m): times}) for the
    kernels line."""
    from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan

    errs, times = {}, {}
    for case in wide_cases(dev):
        label, kernel, n, m, terms = case[:5]
        abs_err, rel = wide_held(f"43a {label}", case.kern(), case.want64(),
                                 case.want32())
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        k_us = kernel_us(case.kern, kernel, calls=5)
        wrapper = time_ms(case.kern, reps=10, warmup=2)
        pairs = None
        if "chunk" in kernel:  # rank 0's share when the world is 2
            world = int(label.rsplit("=", 1)[1])
            tile = sym_plan.sym_tile(m, terms is not None)
            t0, count = sym_plan.sym_tile_chunk(n, world, 0, tile)
            pairs = chunk_pairs(n, tile, [
                (bi, bj) for bi, b0, b1 in sym_plan.upper_tile_rows(
                    -(-n // tile), t0, count) for bj in range(b0, b1 + 1)])
        (fp_ms, fp_by), (tc_ms, tc_by) = wide_bounds(kernel, n, m, terms,
                                                     pairs, case.n_t)
        times[(label, n, m)] = {"kernel": wrapper, "kernel_us": k_us}
        regs = {inst: ptxas.get(inst, "?") for inst in WIDE_INSTANCES[kernel]}
        print(f"phase 43a {label}: ok phi_rel={rel:.3e} count_diff=0 "
              f"kernel_us={k_us} wrapper_ms={wrapper:.4f} "
              f"bound_fp32_ms={fp_ms:.6g} ({fp_by}) bound_tensor_ms="
              f"{tc_ms:.6g} ({tc_by}) ptxas={json.dumps(regs)} "
              f"smem_bytes={wide_smem(kernel, m)} {card} {clock()}")
    # 43d: the library's split count and tile side against sym_plan's.
    lib = cuda_phi.load_library()
    widths = (65, 66, 100, 123, 124, 127, 128, 129, 200, 256, 300, 511, 512)
    shapes = [(n_t, n_s, m) for n_t in (1, 64, 700, 1000, 10007)
              for n_s in (1, 33, 1500, 20000) for m in widths]
    off = [a for a in shapes
           if lib.svgd_square_splits(*a) != sym_plan.square_splits(*a)]
    check(not off, f"phase 43d: svgd_square_splits and sym_plan."
                   f"square_splits differ at {off}")
    # K1's bf16 instance on its own body's plan (square_bf16_sm90.cuh).
    bf16_shapes = [(n_t, n_s, m) for n_t in (1, 64, 1000, 5000, 10007)
                   for n_s in (1, 33, 1000, 10000)
                   for m in (1, 2, 4, 5, 16, 17, 50, 63, 64, 65, 123, 512)]
    off = [a for a in bf16_shapes if lib.svgd_square_bf16_splits(*a)
           != sym_plan.square_splits(*a, bf16=True)]
    check(not off, f"phase 43d: svgd_square_bf16_splits and sym_plan."
                   f"square_splits(bf16=True) differ at {off}")
    off = [(*a, sq) for a in bf16_shapes for sq in (0, 1)
           if not (sq and a[0] != a[1])
           and lib.svgd_square_bf16_work_bytes(*a, sq)
           != sym_plan.square_bf16_work(*a, bool(sq)).bytes]
    check(not off, f"phase 43d: svgd_square_bf16_work_bytes and sym_plan."
                   f"square_bf16_work differ at {off}")
    off = [(m, t) for m in widths for t in (0, 1)
           if lib.svgd_sym_tile(m, t) != sym_plan.sym_tile(m, bool(t))]
    check(not off, f"phase 43d: svgd_sym_tile and sym_plan.sym_tile differ "
                   f"at {off}")
    print(f"phase 43d mirrors: ok svgd_square_splits at {len(shapes)} shapes "
          f"(svgd_square_bf16_splits and svgd_square_bf16_work_bytes at "
          f"{len(bf16_shapes)}) and svgd_sym_tile "
          f"at m = {list(widths)} equal sym_plan's")
    return errs, times


#: Phase 43a's float32 wide square body (csrc/square_wide_sm90.cuh):
#: K1 (square and the cross form WIDE_CROSS) and K6/K7 (FixedTerms<2>,
#: and AnyTerms through three terms, one negative) at these m and n on grid
#: inputs; its ptxas instances (T = 3 and any T <= 8; two terms and any
#: count), none of which may spill; and the distance from float64 its
#: parent body (square_wide_body) showed at (1000, 123), PR 16.
WIDE_SQUARE_MS = (65, 123, 124, 256, 512)
WIDE_SQUARE_NS = (127, 129, 1000, 1500)
#: ... and past 128 column blocks (m > 512), where the body cuts the
#: columns into passes along the grid's z and streams the target rows: n,
#: m and the cross form's n_t.
WIDE_SQUARE_PASSES = (300, 600, 100)
WIDE_SQUARE_INSTANCES = ("counts_square<0,0,3>", "counts_square<0,0,8>",
                         "terms_square<0,0,3,2>", "terms_square<0,0,3,0>",
                         "terms_square<0,0,8,2>", "terms_square<0,0,8,0>")
WIDE_SQUARE_PARENT_ERR = 8.8e-7


def phase_wide_square(dev, card, clock, ptxas, errs):
    """Phase 43a's float32 wide square body: K1 square at n =
    WIDE_SQUARE_NS and cross (WIDE_CROSS), K6/K7 with two terms (the
    FixedTerms<2> instance) and three (AnyTerms) square at the same n and
    two terms cross, at m = WIDE_SQUARE_MS (T = 3; at n = 129 also T = 5,
    the runtime-T instance), each held to its float64 and float32 plain
    versions (wide_held: phi within WIDE_PHI_GATE of max |phi|, counts
    equal; its max |dphi| into ``errs``) and called twice, bit-identical;
    the same at WIDE_SQUARE_PASSES, past 128 column blocks (K1 square and
    cross, K6/K7 with three terms). Then ptxas's registers, spill and
    shared memory of each instance (WIDE_SQUARE_INSTANCES), none of which
    may spill."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_cross_fused_counts,
        phi_rbf_fused_counts,
        phi_rbf_terms_cross_fused_counts,
        phi_rbf_terms_fused_counts,
    )

    def f64(*ts):
        return [t.double() for t in ts]

    worst, calls, at_123 = 0.0, 0, None

    def held(label, kernel, call, want64, want32):
        nonlocal worst, calls
        got = call()
        abs_err, rel = wide_held(f"43a {label}", got, want64, want32)
        again = call()
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"phase 43a {label}: two calls differ")
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        worst = max(worst, rel)
        calls += 1
        return rel

    k1, k67 = cuda_phi.SQUARE_KERNEL, cuda_phi.TERMS_SQUARE_KERNEL
    for m in WIDE_SQUARE_MS:
        for n in WIDE_SQUARE_NS:
            x, s, g, thr = grid_inputs(n, m, 0.0, 4400 + n + m, dev)
            ths = (thr, thresholds_of(thr, 5)) if n == 129 else (thr,)
            for th in ths:
                rel = held(
                    f"K1 square ({n}, {m}) T={th.shape[0]}", k1,
                    lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, th,
                                                        sym=False),
                    phi_rbf_fused_counts(*f64(x, s, g, th)),
                    phi_rbf_fused_counts(x, s, g, th))
                if (n, m) == (1000, 123):
                    at_123 = f"{rel:.3e}"
            for signs, gs in (((1.0, 1.0), [g, 0.5 * g]),
                              ((1.0, -0.5, 1.0), [g, 0.5 * g, 2.0 * g])):
                held(f"K6/K7 square ({n}, {m}) signs={signs}", k67,
                     lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                         x, s, gs, signs, thr, sym=False),
                     phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                                thr.double()),
                     phi_rbf_terms_fused_counts(x, s, gs, signs, thr))
        n_t, n_s = WIDE_CROSS
        xs, ss, g, thr = grid_inputs(n_s, m, 0.0, 4500 + m, dev)
        xt = grid_inputs(n_t, m, 0.0, 4600 + m, dev)[0]
        held(f"K1 cross ({n_t} x {n_s}, {m})", k1,
             lambda: cuda_phi.phi_rbf_fused_cuda_cross(xt, xs, ss, g, thr),
             phi_rbf_cross_fused_counts(*f64(xt, xs, ss, g, thr)),
             phi_rbf_cross_fused_counts(xt, xs, ss, g, thr))
        signs, gs = (1.0, 1.0), [g, 0.5 * g]
        held(f"K6/K7 cross ({n_t} x {n_s}, {m})", k67,
             lambda: cuda_phi.phi_rbf_terms_fused_cuda_cross(
                 xt, xs, ss, gs, signs, thr),
             phi_rbf_terms_cross_fused_counts(*f64(xt, xs, ss), f64(*gs),
                                              signs, thr.double()),
             phi_rbf_terms_cross_fused_counts(xt, xs, ss, gs, signs, thr))
    n, m, n_t = WIDE_SQUARE_PASSES
    x, s, g, thr = grid_inputs(n, m, 0.0, 4700, dev)
    xt = grid_inputs(n_t, m, 0.0, 4701, dev)[0]
    signs, gs = (1.0, -0.5, 1.0), [g, 0.5 * g, 2.0 * g]
    held(f"K1 square ({n}, {m}), {sym_plan.square_wide_plan(m).passes} "
         f"passes", k1,
         lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False),
         phi_rbf_fused_counts(*f64(x, s, g, thr)),
         phi_rbf_fused_counts(x, s, g, thr))
    held(f"K1 cross ({n_t} x {n}, {m})", k1,
         lambda: cuda_phi.phi_rbf_fused_cuda_cross(xt, x, s, g, thr),
         phi_rbf_cross_fused_counts(*f64(xt, x, s, g, thr)),
         phi_rbf_cross_fused_counts(xt, x, s, g, thr))
    held(f"K6/K7 square ({n}, {m}) signs={signs}", k67,
         lambda: cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                   sym=False),
         phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                    thr.double()),
         phi_rbf_terms_fused_counts(x, s, gs, signs, thr))
    print(f"phase 43a square: ok {calls} calls of the float32 wide square "
          f"body (K1 square and cross, K6/K7 two and three terms) at "
          f"m = {list(WIDE_SQUARE_MS)}, n = {list(WIDE_SQUARE_NS)} and "
          f"{WIDE_CROSS[0]} x {WIDE_CROSS[1]}, and in passes at "
          f"({n}, {m}): within {worst:.3e} of max "
          f"|phi| from float64 (K1 (1000, 123): {at_123}; the parent "
          f"body's {WIDE_SQUARE_PARENT_ERR:.1e}), counts equal, two calls "
          f"bit-identical {card} {clock()}")
    report = {inst: ptxas.get(inst, "?") for inst in WIDE_SQUARE_INSTANCES}
    spilled = [inst for inst, text in report.items()
               if not text.endswith(" 0 B spill")]
    check(not spilled, f"phase 43a: the wide square body's instances spill "
                       f"or were not found in the build log: "
                       f"{ {i: report[i] for i in spilled} }")
    smem = {m: (sym_plan.square_wide_plan(m).smem,
                sym_plan.square_wide_plan(m).smem_terms)
            for m in WIDE_SQUARE_MS}
    print(f"phase 43a square ptxas: ok {json.dumps(report)} dynamic "
          f"smem_bytes (one RBF, terms) by m {json.dumps(smem)}; one block "
          f"of 512 threads an SM")


def phase_wide_edges(dev, card, clock, ptxas, errs):
    """Phase 43e: the float32 wide triangle body (csrc/wide_tri_sm90.cuh,
    tiles of 128) at its tiles' edges, n = WIDE_EDGE_NS at m =
    WIDE_EDGE_MS on grid inputs: K2 (T = 3 and, through the runtime-T
    instance, 5), K8/K9 with two terms and with three (a negative sign),
    and K4 and K10/K11 summed over worlds 1 to WIDE_EDGE_WORLDS, each held
    to its float64 and float32 plain versions (wide_held; its max |dphi|
    into ``errs``). Then ptxas's registers, spill and shared memory of
    every instance of the body (WIDE_SYM_INSTANCES), none of which may
    spill."""
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_fused_counts,
        phi_rbf_fused_sym_finish,
        phi_rbf_sym_chunk_counts,
        phi_rbf_terms_fused_counts,
        phi_rbf_terms_fused_sym_finish,
        phi_rbf_terms_sym_chunk_counts,
    )

    def f64(*ts):
        return [t.double() for t in ts]

    def held(label, kernel, got, want64, want32):
        abs_err, rel = wide_held(f"43e {label}", got, want64, want32)
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        return rel

    worst, calls = 0.0, 0
    for m in WIDE_EDGE_MS:
        for n in WIDE_EDGE_NS:
            x, s, g, thr = grid_inputs(n, m, 0.0, 4300 + n + m, dev)
            for th in (thr, thresholds_of(thr, 5)):
                worst = max(worst, held(
                    f"K2 ({n}, {m}) T={th.shape[0]}", cuda_phi.SYM_KERNEL,
                    cuda_phi.phi_rbf_fused_cuda(x, s, g, th, sym=True),
                    phi_rbf_fused_counts(*f64(x, s, g, th)),
                    phi_rbf_fused_counts(x, s, g, th)))
            for signs, gs in (((1.0, 1.0), [g, 0.5 * g]),
                              ((1.0, -0.5, 1.0), [g, 0.5 * g, 2.0 * g])):
                worst = max(worst, held(
                    f"K8/K9 ({n}, {m}) signs={signs}",
                    cuda_phi.TERMS_SYM_KERNEL,
                    cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                      sym=True),
                    phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                               thr.double()),
                    phi_rbf_terms_fused_counts(x, s, gs, signs, thr)))
            signs, gs = (1.0, 1.0), [g, 0.5 * g]
            for world in range(1, WIDE_EDGE_WORLDS + 1):
                worst = max(worst, held(
                    f"K4 ({n}, {m}) world={world}",
                    cuda_phi.SYM_CHUNK_KERNEL,
                    ranks_summed(
                        lambda w, r: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                            x, s, g, thr, w, r), world, n,
                        lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n)),
                    phi_rbf_fused_counts(*f64(x, s, g, thr)),
                    ranks_summed(
                        lambda w, r: phi_rbf_sym_chunk_counts(
                            x, s, g, thr, w, r), world, n,
                        lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n))))
                worst = max(worst, held(
                    f"K10/K11 ({n}, {m}) world={world}",
                    cuda_phi.TERMS_SYM_CHUNK_KERNEL,
                    ranks_summed(
                        lambda w, r:
                        cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                            x, s, gs, signs, thr, w, r), world, n,
                        lambda acc: phi_rbf_terms_fused_sym_finish(
                            acc, s, signs, n)),
                    phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                               thr.double()),
                    ranks_summed(
                        lambda w, r: phi_rbf_terms_sym_chunk_counts(
                            x, s, gs, signs, thr, w, r), world, n,
                        lambda acc: phi_rbf_terms_fused_sym_finish(
                            acc, s, signs, n))))
                calls += 2
            calls += 4
    print(f"phase 43e edges: ok {calls} calls at n = {list(WIDE_EDGE_NS)}, "
          f"m = {list(WIDE_EDGE_MS)} (chunks over worlds 1-"
          f"{WIDE_EDGE_WORLDS}) within {worst:.3e} of max |phi| from "
          f"float64, counts equal {card} {clock()}")
    report = {inst: ptxas.get(inst, "?") for inst in WIDE_SYM_INSTANCES}
    spilled = [inst for inst, text in report.items()
               if not text.endswith(" 0 B spill")]
    check(not spilled, f"phase 43e: the wide triangle body's instances "
                       f"spill or were not found in the build log: "
                       f"{ {i: report[i] for i in spilled} }")
    print(f"phase 43e ptxas: ok {json.dumps(report)} dynamic smem_bytes="
          f"{WIDE_SYM_SMEM} (one RBF), {WIDE_SYM_TERMS_SMEM} (terms); one "
          f"block of 288 threads an SM")


def phase_wide_rule(dev, card, clock, plain_ms, errs):
    """Phase 43b, at the shapes of phase 43c's paths on grid inputs: K1 at
    the flat BLR's (WIDE_BLR_N, WIDE_D), the terms square kernel at the
    small hierarchical BLR's (WIDE_TERMS_SQUARE_N, WIDE_D + 1) with two
    terms, and at WIDE_RULE's shapes the full-width triangle, the square
    form and the chunk kernel at world 1 (the one-rank engine's), each
    call held to its plain versions (wide_held; its max |dphi| into
    ``errs``) and timed beside them. The triangle must be the form
    resolve_sym(None, ...) returns where it is within WIDE_SYM_TIE of the
    square's time, the square elsewhere. Returns {(name, n, m): {"kernel":
    ms, "plain": ms}} for phase 43c's paths."""
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_fused_counts,
        phi_rbf_fused_sym_finish,
        phi_rbf_sym_chunk_counts,
        phi_rbf_terms_fused_counts,
        phi_rbf_terms_fused_sym_finish,
        phi_rbf_terms_sym_chunk_counts,
    )

    def f64(*ts):
        return [t.double() for t in ts]

    def held(label, kernel, kern, want64, want32):
        abs_err, rel = wide_held(f"43b {label}", kern(), want64, want32)
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        return rel

    out = {}
    # K1 at the flat BLR's shape and the terms square kernel at the small
    # hierarchical BLR's (phase 43c's square paths).
    n, m = WIDE_BLR_N, WIDE_D
    x, s, g, thr = grid_inputs(n, m, 0.0, 479, dev)

    def k1():
        return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False)

    def plain():
        return phi_rbf_fused_counts(x, s, g, thr)
    rel = held(f"K1 square ({n}, {m})", cuda_phi.SQUARE_KERNEL, k1,
               phi_rbf_fused_counts(*f64(x, s, g, thr)), plain())
    out[(cuda_phi.SQUARE_KERNEL, n, m)] = {
        "kernel": time_ms(k1, reps=20, warmup=3), "plain": plain_ms(plain)}
    print(f"phase 43b K1 square ({n}, {m}): ok phi_rel={rel:.3e} "
          f"wrapper_ms={out[(cuda_phi.SQUARE_KERNEL, n, m)]['kernel']:.4f} "
          f"{card} {clock()}")
    n, m = WIDE_TERMS_SQUARE_N, WIDE_D + 1
    x, s, g, thr = grid_inputs(n, m, 0.0, 478, dev)
    gs, signs = [g, 0.5 * g], (1.0, 1.0)

    def k67():
        return cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                 sym=False)

    def plain():
        return phi_rbf_terms_fused_counts(x, s, gs, signs, thr)
    rel = held(f"K6/K7 terms square ({n}, {m}) two terms",
               cuda_phi.TERMS_SQUARE_KERNEL, k67,
               phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                          thr.double()), plain())
    out[(cuda_phi.TERMS_SQUARE_KERNEL, n, m)] = {
        "kernel": time_ms(k67, reps=20, warmup=3), "plain": plain_ms(plain)}
    print(f"phase 43b K6/K7 terms square ({n}, {m}) two terms: ok "
          f"phi_rel={rel:.3e} wrapper_ms="
          f"{out[(cuda_phi.TERMS_SQUARE_KERNEL, n, m)]['kernel']:.4f} "
          f"{card} {clock()}")
    for idx, (n, m, signs) in enumerate(WIDE_RULE):
        x, s, g, thr = grid_inputs(n, m, 0.0, 480 + idx, dev)
        if signs is None:
            def sweep(form):
                return lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr,
                                                           sym=form)

            def chunk():
                return cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, s, g, thr, 1,
                                                             0)

            def finish(acc):
                return phi_rbf_fused_sym_finish(acc, s, g, n)

            def plain():
                return phi_rbf_fused_counts(x, s, g, thr)

            def plain_chunk():
                return phi_rbf_sym_chunk_counts(x, s, g, thr, 1, 0)
            want64 = phi_rbf_fused_counts(*f64(x, s, g, thr))
            names = (cuda_phi.SYM_KERNEL, cuda_phi.SQUARE_KERNEL,
                     cuda_phi.SYM_CHUNK_KERNEL)
            rule = cuda_phi.resolve_sym(None, n, m)
        else:
            gs = [g, 0.5 * g]

            def sweep(form):
                return lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                    x, s, gs, signs, thr, sym=form)

            def chunk():
                return cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                    x, s, gs, signs, thr, 1, 0)

            def finish(acc):
                return phi_rbf_terms_fused_sym_finish(acc, s, signs, n)

            def plain():
                return phi_rbf_terms_fused_counts(x, s, gs, signs, thr)

            def plain_chunk():
                return phi_rbf_terms_sym_chunk_counts(x, s, gs, signs, thr,
                                                      1, 0)
            want64 = phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                                thr.double())
            names = (cuda_phi.TERMS_SYM_KERNEL, cuda_phi.TERMS_SQUARE_KERNEL,
                     cuda_phi.TERMS_SYM_CHUNK_KERNEL)
            rule = cuda_phi.resolve_sym(None, n, m, len(signs))
        what = "one RBF" if signs is None else f"{len(signs)} terms"
        want32 = plain()
        rels = [
            held(f"{names[0]} ({n}, {m}) {what}", names[0], sweep(True),
                 want64, want32),
            held(f"{names[1]} ({n}, {m}) {what}", names[1], sweep(False),
                 want64, want32),
            held(f"{names[2]} ({n}, {m}) {what} world=1", names[2],
                 lambda: ranks_summed(lambda w, r: chunk(), 1, n, finish),
                 want64, want32)]
        # Triangle, square, square, triangle, the median of each.
        t_tri = [time_ms(sweep(True), reps=10, warmup=2)]
        t_sq = [time_ms(sweep(False), reps=10, warmup=2)]
        t_sq.append(time_ms(sweep(False), reps=10, warmup=2))
        t_tri.append(time_ms(sweep(True), reps=10, warmup=2))
        tri_ms, sq_ms = min(t_tri), min(t_sq)
        want = tri_ms <= (1.0 + WIDE_SYM_TIE) * sq_ms
        check(rule is want,
              f"phase 43b ({n}, {m}) {what}: triangle {tri_ms:.4f} ms, "
              f"square {sq_ms:.4f} ms, but resolve_sym(None) gives {rule!r}")
        t_plain = plain_ms(plain)
        out[(names[0], n, m)] = {"kernel": tri_ms, "plain": t_plain}
        out[(names[1], n, m)] = {"kernel": sq_ms, "plain": t_plain}
        out[(names[2], n, m)] = {"kernel": time_ms(chunk, reps=10, warmup=2),
                                 "plain": plain_ms(plain_chunk)}
        print(f"phase 43b form rule ({n}, {m}) {what}: ok triangle_ms="
              f"{t_tri} square_ms={t_sq} resolve_sym(None)={rule} "
              f"(tie within {WIDE_SYM_TIE:g} -> triangle) plain_ms="
              f"{t_plain:.4f} chunk_world1_ms="
              f"{out[(names[2], n, m)]['kernel']:.4f} chunk_plain_ms="
              f"{out[(names[2], n, m)]['plain']:.4f}; against the plain "
              f"versions (triangle, square, chunk) phi_rel="
              f"{[f'{r:.3e}' for r in rels]} counts equal "
              f"{card} {clock()}")
    return out


def wide_mvn(n, d, seed):
    """An MVN target at width d (mean ~ N(0, 1), a diagonal covariance
    from 0.5 to 2) and x0 ~ N(0, 1) in float32, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mean = rng.normal(size=d)
    cov = np.diag(np.linspace(0.5, 2.0, d))
    return mean, cov, rng.normal(size=(n, d)).astype(np.float32)


def phase_wide_paths(dev, card, clock):
    """Phase 43c: the slice on auto at a9a's width (d = WIDE_D): the flat
    BLR at N = WIDE_BLR_N (K1, WIDE_BLR_STEPS steps), the flat and
    hierarchical BLR at N = WIDE_BIG_N and the hierarchical BLR at
    N = WIDE_TERMS_SQUARE_N (the square form, K6/K7), and the sharded
    engine on a one-rank NCCL group (hier, K10/K11; MVN with
    fused_sym="full", K4) against the driver for COMPARE_STEPS steps within
    1e-3. Each BLR kernel route is gated per call: the float64 run of its
    route (its sweeps in their float64 plain versions, recorded_run) for
    COMPARE_STEPS steps, each of those sweep calls replayed in float32
    through the kernel (replay_gate). The COMPARE_STEPS-step trajectories'
    distances from that float64 run, the kernel route's and the float32
    plain route's, are printed readings: a 20-step Adam trajectory moves
    with the seed where a coordinate's phi is near 1e-7 (hier seeds 0-2:
    2.35e-4, 4.79e-4 and 2.00e-3 on an H100, PERF.md). Returns {path:
    (launch counts, kernel, n, m)}."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.parallel import initialize_distributed
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_blr_svgd,
        build_mvn_svgd,
        build_sharded_hier_svgd,
        build_sharded_mvn_svgd,
    )

    out = {}

    def launched(build, steps):
        cuda_phi.reset_launch_counts()
        t0 = time.perf_counter()
        svgd = build()
        final = svgd.run(*steps).double()
        torch.cuda.synchronize()
        return svgd, final, dict(cuda_phi.launch_counts), \
            time.perf_counter() - t0

    def against(label, got, want):
        diff = float((got - want).abs().max())
        check(bool(got.isfinite().all()) and diff <= 1e-3,
              f"phase 43c {label}: coords differ by {diff:.3e}")
        return diff

    def replayed(label, x0, feats, labels, hier, kernel_impl, plain_impl):
        """The kernel route's float64 run (COMPARE_STEPS steps), its sweep
        calls replayed in float32 through the kernel and gated per call,
        and the float32 plain route's distance from that run: (float64
        coordinates, max phi_rel, max count_diff, float32 plain distance)."""
        wrapper = ("phi_rbf_terms_fused_cuda" if hier
                   else "phi_rbf_fused_cuda")

        def build(dt, impl):
            return build_blr_svgd(torch.tensor(x0, dtype=dt, device=dev),
                                  feats, labels, hierarchical=hier,
                                  phi_impl=impl,
                                  num_iterations=COMPARE_STEPS)
        final64, calls = recorded_run(
            lambda: build(torch.float64, kernel_impl), wrapper,
            COMPARE_STEPS)
        rel, dcnt = replay_gate(f"phase 43c {label}", wrapper, calls)
        plain32 = build(torch.float32, plain_impl).run().double()
        return (final64, rel, dcnt,
                float((plain32 - final64).abs().max()))

    d = WIDE_D
    feats, labels, x0 = blr_workload(WIDE_BLR_N, d)
    svgd, final, counts, sec = launched(lambda: build_blr_svgd(
        torch.tensor(x0, device=dev), feats, labels,
        num_iterations=WIDE_BLR_STEPS), ())
    check(svgd._phi_impl == "fused_cuda",
          f"phase 43c flat BLR N={WIDE_BLR_N} routed to {svgd._phi_impl!r}")
    require_only(counts, cuda_phi.SQUARE_KERNEL, WIDE_BLR_STEPS,
                 f"phase 43c flat BLR N={WIDE_BLR_N}")
    acc = blr_accuracy(final.cpu().numpy(), feats, labels)
    check(acc > 0.5, f"phase 43c flat BLR training accuracy {acc:.4f}")
    kernel_run = build_blr_svgd(torch.tensor(x0, device=dev), feats, labels,
                                phi_impl="fused_cuda",
                                num_iterations=COMPARE_STEPS).run().double()
    plain64, rel, dcnt, plain32 = replayed(
        f"flat BLR N={WIDE_BLR_N}", x0, feats, labels, False, "fused_cuda",
        "fused")
    diff = float((kernel_run - plain64).abs().max())
    print(f"phase 43c flat BLR N={WIDE_BLR_N} d={d} {WIDE_BLR_STEPS} iters "
          f"auto: ok route=fused_cuda launches={json.dumps(counts)} "
          f"train_accuracy={acc:.4f} s={sec:.2f}; per-call replay of the "
          f"float64 run's {COMPARE_STEPS} sweeps: max phi_rel={rel:.3e} "
          f"(gate {WIDE_PHI_GATE}) max count_diff={dcnt}; not gated: "
          f"{COMPARE_STEPS} steps coords_max_abs_diff from float64="
          f"{diff:.3e} (float32 fused {plain32:.3e}) {clock()}")
    out["flat_blr"] = (counts, cuda_phi.SQUARE_KERNEL, WIDE_BLR_N, d)

    for hier, n in ((False, WIDE_BIG_N), (True, WIDE_BIG_N),
                    (True, WIDE_TERMS_SQUARE_N)):
        m = d + 1 if hier else d
        feats, labels, x0 = blr_workload(n, d, hierarchical=hier)
        kernel_impl, plain_impl = (("fused_terms_cuda", "fused_terms")
                                   if hier else ("fused_cuda", "fused"))
        form = cuda_phi.resolve_sym(None, n, m, 2 if hier else None)
        kernel = {(False, True): cuda_phi.SYM_KERNEL,
                  (False, False): cuda_phi.SQUARE_KERNEL,
                  (True, True): cuda_phi.TERMS_SYM_KERNEL,
                  (True, False): cuda_phi.TERMS_SQUARE_KERNEL}[(hier, form)]
        svgd, final, counts, sec = launched(lambda: build_blr_svgd(
            torch.tensor(x0, device=dev), feats, labels, hierarchical=hier,
            num_iterations=COMPARE_STEPS), ())
        check(svgd._phi_impl == kernel_impl and svgd.fused_sym_form is form,
              f"phase 43c BLR hier={hier} N={n}: route "
              f"{svgd._phi_impl!r}, form {svgd.fused_sym_form!r}")
        require_only(counts, kernel, COMPARE_STEPS,
                     f"phase 43c BLR hier={hier} N={n}")
        plain64, rel, dcnt, plain32 = replayed(
            f"BLR hier={hier} N={n}", x0, feats, labels, hier, kernel_impl,
            plain_impl)
        diff = float((final - plain64).abs().max())
        name = (("hier" if n == WIDE_BIG_N else "hier_small") if hier
                else "flat_blr_big")
        print(f"phase 43c {name} N={n} m={m} auto: ok "
              f"route={kernel_impl} form={form} kernel={kernel} launches="
              f"{json.dumps(counts)} s={sec:.2f}; per-call replay of the "
              f"float64 run's {COMPARE_STEPS} sweeps: max phi_rel={rel:.3e} "
              f"(gate {WIDE_PHI_GATE}) max count_diff={dcnt}; not gated: "
              f"{COMPARE_STEPS} steps coords_max_abs_diff from float64 "
              f"{kernel_impl}={diff:.3e} (float32 {plain_impl} "
              f"{plain32:.3e}) {clock()}")
        out[name] = (counts, kernel, n, m)
        if name == "hier":
            x0_hier, feats_h, labels_h, driver_hier = x0, feats, labels, final

    group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    check(group.backend == "nccl", f"one-rank group on {group.backend!r}")
    mean, cov, x0_mvn = wide_mvn(WIDE_BIG_N, d, 490)
    driver_mvn = build_mvn_svgd(torch.tensor(x0_mvn, device=dev), mean, cov,
                                num_iterations=COMPARE_STEPS).run().double()
    for name, kernel, build, x0, driver in (
            ("engine_hier", cuda_phi.TERMS_SYM_CHUNK_KERNEL,
             lambda: build_sharded_hier_svgd(x0_hier, feats_h, labels_h,
                                             group, fused_sym="full"),
             x0_hier, driver_hier),
            ("engine_mvn", cuda_phi.SYM_CHUNK_KERNEL,
             lambda: build_sharded_mvn_svgd(x0_mvn, mean, cov, group,
                                            fused_sym="full"),
             x0_mvn, driver_mvn)):
        eng, final, counts, sec = launched(build, (x0, COMPARE_STEPS))
        check(eng._fused_cuda and eng._fused_sym == "full",
              f"phase 43c {name}: fused_cuda={eng._fused_cuda} "
              f"fused_sym={eng._fused_sym!r}")
        require_only(counts, kernel, COMPARE_STEPS, f"phase 43c {name}")
        diff = against(name, final, driver)
        print(f"phase 43c {name} N={WIDE_BIG_N} m={x0.shape[1]} one NCCL "
              f"rank fused_sym=full: ok kernel={kernel} launches="
              f"{json.dumps(counts)} s={sec:.2f}; vs the driver "
              f"{COMPARE_STEPS} steps coords_max_abs_diff={diff:.3e} "
              f"{clock()}")
        out[name] = (counts, kernel, WIDE_BIG_N, x0.shape[1])
    torch.distributed.destroy_process_group()
    return out


#: Phase 44: K14 and K15 past m = 64. 44a: K14's wide term groups
#: (WIDE_P_TERMS: isotropic and anisotropic signs) and K15's wide sweep
#: (WIDE_P_FORMS) at every width of WIDE_MS on WIDE_P_N particles of grid
#: inputs (m = 123 also at +100), each P scaled by 1/m so that every term
#: is alive, K14's raw group slabs also against their plain per-group
#: version; 44e: K14's groups at the tile-128 edges (WIDE_EDGE_NS,
#: WIDE_EDGE_MS); 44b: both at the paths' shape (WIDE_P_BIG_N, WIDE_D); 44c:
#: the anisotropic MVN on auto for WIDE_P_STEPS steps and phase 18's
#: HESSIAN target on 'cuda' for WIDE_P_HESS_STEPS, at d = WIDE_D and
#: N = WIDE_P_BIG_N, each route gated per call (replay_gate).
WIDE_P_N, WIDE_P_BIG_N = 4096, 10240
WIDE_P_STEPS, WIDE_P_HESS_STEPS = 20, 5
WIDE_P_TERMS = {"iso+1": ((1.0,), (1.0,)), "iso+2": ((1.0,), (1.0, -0.5)),
                "0+1": ((), (1.0,)), "2iso+1": ((1.0, -0.5), (1.0,))}
#: K14's wide instances (ptxas names): the single-term groups
#: (fused_phi_aniso_terms_wide_groups_kernel, one weight tile) and group 0
#: of two or more isotropic terms (fused_phi_aniso_terms_wide_iso_kernel,
#: two), at T = 3 and any T <= 8; none may spill (phase 44e).
ANISO_WIDE_INSTANCES = ("aniso_wide_groups<3>", "aniso_wide_groups<8>",
                        "aniso_wide_iso<3>", "aniso_wide_iso<8>")
WIDE_P_FORMS = ("pd", "indefinite", "gamma_i")
#: K15's wide instance (ptxas name; no counts, one instance) and its edges
#: in phase 44e: n = 1 (one ragged tile, the self pair alone), 129 (a tile
#: and one particle) and 10007 (ragged last tile of 79) at m = 65 and 123.
K15_WIDE_INSTANCES = ("rbf_wide",)
K15_EDGE_NS = (1, 129, 10007)
#: replay_gate's least count slack: one pair on the other side of a
#: threshold in both orders, twice over (as tests/test_torch_wide.py's
#: COUNT_SLACK).
REPLAY_COUNT_SLACK = 4



def to32(value):
    """A float tensor (or a list or tuple of them) in float32; anything
    else as it is."""
    import torch

    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return value.to(torch.float32)
    if isinstance(value, (list, tuple)):
        return type(value)(to32(v) for v in value)
    return value


def f64_sweep(name):
    """The float64 plain version of the driver's kernel wrapper ``name``
    (ops/cuda_phi), under the wrapper's signature: what the kernel route
    computes, in float64 on the card."""
    from svgdcpp_tpu_torch.ops import phi as ph

    if name == "phi_rbf_fused_cuda":
        return lambda c, s, g, thr, sym=None, dot_dtype="float32": (
            ph.phi_rbf_fused_counts(c, s, g, thr))
    if name == "phi_rbf_terms_fused_cuda":
        return lambda c, s, gs, signs, thr, sym=None: (
            ph.phi_rbf_terms_fused_counts(c, s, gs, signs, thr))
    if name == "phi_rbf_aniso_terms_fused_cuda":
        return lambda c, s, ig, isg, ps, asg, thr, lowers=None: (
            ph.phi_rbf_aniso_terms_fused_counts(c, s, ig, isg, ps, asg, thr,
                                                lowers=lowers))
    if name == "phi_rbf_cuda":
        def fixed_p(c, s, p, psd=True, eig=None):
            if eig is None:
                half = 0.5 * (p + p.T).double()
            else:
                lam, v = (t.double() for t in eig)
                half = (v * lam) @ v.T
            return ph.phi_rbf_gram(c, s, half, psd=psd)
        return fixed_p
    raise ValueError(name)


def recorded_run(build, wrapper, steps):
    """Run the float64 driver ``build()`` (of ``steps`` steps) with the
    driver's kernel wrapper ``wrapper`` (its name in svgdcpp_tpu_torch.svgd)
    replaced by its float64 plain version (f64_sweep), and return (the
    final coordinates, every call as (args, kwargs, output)): the float64
    run's own sweep calls."""
    import torch

    import svgdcpp_tpu_torch.svgd as driver_module

    real, plain = getattr(driver_module, wrapper), f64_sweep(wrapper)
    calls = []

    def recorder(*args, **kwargs):
        out = plain(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(driver_module, wrapper, recorder)
    try:
        final = build().run().double()
        torch.cuda.synchronize()
    finally:
        setattr(driver_module, wrapper, real)
    check(len(calls) == steps, f"{wrapper}: {len(calls)} recorded sweeps "
                               f"in {steps} steps")
    return final, calls


def replay_gate(label, wrapper, calls):
    """Hold the kernel route per call: each recorded float64 sweep call
    (recorded_run) replayed in float32 through the kernel wrapper
    ``wrapper`` (ops/cuda_phi; the Cholesky factors and decompositions the
    driver keeps stay in float64, as the float32 driver passes them). phi
    must be finite and within WIDE_PHI_GATE of max |phi| of the float64
    call, the counts within REPLAY_COUNT_SLACK or 1e-6 n^2 of its counts,
    the larger (continuous inputs: a pair within rounding of a threshold
    may go either way, in both orders). Returns the largest relative phi
    error and count difference over the calls."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi

    kernel = getattr(cuda_phi, wrapper)
    worst_rel, worst_cnt = 0.0, 0
    for idx, (args, kwargs, out) in enumerate(calls):
        kw32 = {k: (v if k in ("lowers", "eig") else to32(v))
                for k, v in kwargs.items()}
        got = kernel(*to32(tuple(args)), **kw32)
        phi64, cnt64 = out if isinstance(out, tuple) else (out, None)
        phi = got[0] if isinstance(got, tuple) else got
        torch.cuda.synchronize()
        rel = float((phi.double() - phi64).abs().max()) / float(
            phi64.abs().max())
        check(bool(phi.isfinite().all()) and rel <= WIDE_PHI_GATE,
              f"{label} call {idx}: phi rel err {rel:.3e} > {WIDE_PHI_GATE}")
        worst_rel = max(worst_rel, rel)
        if cnt64 is not None:
            n = phi.shape[0]
            bound = max(REPLAY_COUNT_SLACK, 1e-6 * n * n)
            dcnt = int((got[1] - cnt64).abs().max())
            check(dcnt <= bound, f"{label} call {idx}: counts differ by "
                                 f"{dcnt} > {bound:g}")
            worst_cnt = max(worst_cnt, dcnt)
    return worst_rel, worst_cnt


def wide_p_ps(kind, m, count, seed, g, device):
    """``count`` (m, m) precisions for phase 44: "pd" (0.5 I + A A^T/m)/m,
    "indefinite" (diag(1 .. -0.3) + 0.05 A)/m, "gamma_i" the median gamma
    g times I; A ~ N(0, 1) from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.normal(size=(m, m))
        if kind == "pd":
            pm = (0.5 * np.eye(m) + a @ a.T / m) / m
        elif kind == "indefinite":
            pm = (np.diag(np.linspace(1.0, -0.3, m)) + 0.05 * a) / m
        else:
            pm = float(g) * np.eye(m)
        out.append(torch.tensor(pm, dtype=torch.float32, device=device))
    return out


def wide_p_call(kernel, x, s, g, thr, spec):
    """(the kernel's call, its float64 plain call, its float32 plain call)
    of a phase 44 case: K14's wide groups with WIDE_P_TERMS[spec] (P as
    wide_p_ps's "pd"), or K15's wide sweep with the precision ``spec``
    ((kind, P)); each returns (phi, counts or None)."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_aniso_terms_fused_counts,
        phi_rbf_blocked,
    )

    if kernel == cuda_phi.ANISO_WIDE_KERNEL:
        iso_s, an_s = WIDE_P_TERMS[spec]
        iso_g = [g, 2.0 * g][:len(iso_s)]
        ps = wide_p_ps("pd", x.shape[1], len(an_s), 445, g, x.device)

        def plain(dt):
            return lambda: phi_rbf_aniso_terms_fused_counts(
                x.to(dt), s.to(dt), [v.to(dt) for v in iso_g], iso_s,
                [p.to(dt) for p in ps], an_s, thr.to(dt))
        return (lambda: cuda_phi.phi_rbf_aniso_terms_fused_cuda(
            x, s, iso_g, iso_s, ps, an_s, thr),
            plain(torch.float64), plain(x.dtype))
    kind, p = spec
    psd = kind != "indefinite"
    eig = None
    if kind == "gamma_i":  # as the driver hands a median's gamma I
        eig = (p.diagonal(), torch.eye(p.shape[0], device=p.device))

    def plain(dt):
        return lambda: (phi_rbf_blocked(x.to(dt), s.to(dt), p.to(dt),
                                        psd=psd), None)
    return (lambda: (cuda_phi.phi_rbf_cuda(x, s, p, psd=psd, eig=eig), None),
            plain(torch.float64), plain(x.dtype))


def wide_p_bounds(kernel, n, m, spec):
    """(FP32 bound, tensor-core bound) of a phase 44 call, each
    (ms, bound_by)."""
    from svgdcpp_tpu_torch.ops import cuda_phi

    if kernel == cuda_phi.ANISO_WIDE_KERNEL:
        iso_s, an_s = WIDE_P_TERMS[spec]
        return (sweep_bound(kernel, n, m, n_iso=len(iso_s),
                            n_aniso=len(an_s)),
                tri_tensor_bound(n, m, n_terms=len(iso_s),
                                 n_aniso=len(an_s)))
    return sweep_bound(kernel, n, m), tri_tensor_bound(n, m, fixed_p=True)


def wide_p_cases(dev):
    """Phase 44a's cases: (label, kernel, n, m, spec, x, s, g, thr)."""
    from svgdcpp_tpu_torch.ops import cuda_phi

    cases = []
    for idx, m in enumerate(WIDE_MS):
        for off in ((0.0, 100.0) if m == 123 else (0.0,)):
            n = WIDE_P_N
            x, s, g, thr = grid_inputs(n, m, off, 440 + idx, dev)
            for terms in WIDE_P_TERMS:
                cases.append((f"K14 wide ({n}, {m}) offset={off} {terms}",
                              cuda_phi.ANISO_WIDE_KERNEL, n, m, terms, x, s,
                              g, thr))
            for kind in WIDE_P_FORMS:
                p = wide_p_ps(kind, m, 1, 446, g, dev)[0]
                cases.append((f"K15 wide ({n}, {m}) offset={off} {kind}",
                              cuda_phi.PHI_RBF_WIDE_KERNEL, n, m, (kind, p),
                              x, s, g, thr))
    return cases


def phase_wide_p_kernels(dev, card, clock, ptxas):
    """Phase 44a: the wide K14 groups and the wide K15 against their
    float64 plain versions at m > 64 on grid inputs (wide_held), with
    kernel us (profiler), wrapper ms, FP32 and tensor-core bounds,
    registers, spills and shared memory. Returns {kernel: max |dphi|}."""
    from svgdcpp_tpu_torch.ops import cuda_phi

    errs = {}
    for label, kernel, n, m, spec, x, s, g, thr in wide_p_cases(dev):
        kern, want64, want32 = wide_p_call(kernel, x, s, g, thr, spec)
        abs_err, rel = wide_held(f"44a {label}", kern(), want64(), want32())
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        extra = ""
        if kernel == cuda_phi.ANISO_WIDE_KERNEL:
            slab_rel = aniso_slabs_held(f"44a {label}", x, s, g, thr, spec)
            extra = f" slab_rel={slab_rel:.3e}"
            if not WIDE_P_TERMS[spec][0]:  # the counts' own launch
                extra += (f" count_kernel_us="
                          f"{kernel_us(kern, cuda_phi.COUNT_KERNEL, calls=5)}")
        k_us = kernel_us(kern, kernel, calls=5)
        wrapper = time_ms(kern, reps=10, warmup=2)
        (fp_ms, fp_by), (tc_ms, tc_by) = wide_p_bounds(kernel, n, m, spec)
        regs = {inst: ptxas.get(inst, "?")
                for inst in WIDE_INSTANCES[kernel]}
        print(f"phase 44a {label}: ok phi_rel={rel:.3e}"
              f"{' count_diff=0' if kernel.startswith('fused') else ''}"
              f"{extra} kernel_us={k_us} wrapper_ms={wrapper:.4f} "
              f"bound_fp32_ms={fp_ms:.6g} ({fp_by}) bound_tensor_ms="
              f"{tc_ms:.6g} ({tc_by}) ptxas={json.dumps(regs)} "
              f"smem_bytes={wide_smem(kernel, m)} {card} {clock()}")
    return errs


def aniso_slabs_held(label, x, s, g, thr, spec):
    """Hold K14's wide groups' raw slabs (cuda_phi.aniso_wide_groups_cuda,
    one launch of the wide entry) to their float64 plain per-group
    version (ops/phi.aniso_groups_plain) for WIDE_P_TERMS[spec] (P as
    wide_p_call's): each group's KS and D, before any sign or scale,
    within WIDE_PHI_GATE of that part's max |.| (a group that does not
    sweep, exactly 0), the padded columns exactly 0, and the upper counts
    equal to the plain version's on grid inputs (none with no isotropic
    term). ``label`` starts with its phase. Returns the largest relative
    error."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import aniso_groups_plain

    iso_s, an_s = WIDE_P_TERMS[spec]
    iso_g = [g, 2.0 * g][:len(iso_s)]
    m = x.shape[1]
    ps = wide_p_ps("pd", m, len(an_s), 445, g, x.device)
    lowers = cuda_phi.cholesky_factors(ps, x.device)
    acc, upper = cuda_phi.aniso_wide_groups_cuda(x, s, iso_g, iso_s, an_s,
                                                 thr, lowers)
    want, want_upper = aniso_groups_plain(
        x.double(), s.double(), [v.double() for v in iso_g], iso_s, an_s,
        thr.double(), lowers)
    torch.cuda.synchronize()
    w = acc.shape[1] // 2
    check(not acc[:, m:w].any() and not acc[:, w + m:].any(),
          f"phase {label}: the slabs' padded columns are not 0")
    got = torch.cat([acc[:, :m], acc[:, w:w + m]], dim=1).double()
    worst = 0.0
    for grp in range(got.shape[0]):
        for part, cols in (("KS", slice(0, m)), ("D", slice(m, 2 * m))):
            ref, have = want[grp, cols], got[grp, cols]
            scale = float(ref.abs().max())
            if scale == 0.0:
                check(not have.any(), f"phase {label}: group {grp}'s {part}"
                                      f" is not 0")
                continue
            rel = float((have - ref).abs().max()) / scale
            check(bool(have.isfinite().all()) and rel <= WIDE_PHI_GATE,
                  f"phase {label}: group {grp}'s {part} rel err {rel:.3e} "
                  f"> {WIDE_PHI_GATE}")
            worst = max(worst, rel)
    if iso_s:
        diff = int((upper - want_upper).abs().max())
        check(diff == 0, f"phase {label}: upper counts differ by {diff}")
    else:
        check(not upper.any(), f"phase {label}: counts without group 0")
    return worst


def phase_wide_p_edges(dev, card, clock, ptxas, errs):
    """Phase 44e: K14's wide groups (wide_tri_sm90.cuh's body, tiles of
    128) at the tiles' edges, n = WIDE_EDGE_NS at m = WIDE_EDGE_MS on grid
    inputs, every WIDE_P_TERMS set: phi and counts held to the float64 and
    float32 plain versions (wide_held; its max |dphi| into ``errs``), each
    group's slab to its plain version (aniso_slabs_held); K15's wide sweep
    (the same body) at n = K15_EDGE_NS, P positive definite and
    indefinite, held alike. Then ptxas's registers, spill and shared
    memory of ANISO_WIDE_INSTANCES and K15_WIDE_INSTANCES, none of which
    may spill."""
    from svgdcpp_tpu_torch.ops import cuda_phi

    kernel = cuda_phi.ANISO_WIDE_KERNEL
    worst, worst_slab, calls = 0.0, 0.0, 0
    for m in WIDE_EDGE_MS:
        for n in WIDE_EDGE_NS:
            x, s, g, thr = grid_inputs(n, m, 0.0, 4400 + n + m, dev)
            for spec in WIDE_P_TERMS:
                label = f"44e K14 wide ({n}, {m}) {spec}"
                kern, want64, want32 = wide_p_call(kernel, x, s, g, thr,
                                                   spec)
                abs_err, rel = wide_held(label, kern(), want64(), want32())
                errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
                worst = max(worst, rel)
                worst_slab = max(worst_slab,
                                 aniso_slabs_held(label, x, s, g, thr, spec))
                calls += 1
    print(f"phase 44e edges: ok {calls} calls of K14's wide groups at n = "
          f"{list(WIDE_EDGE_NS)}, m = {list(WIDE_EDGE_MS)}, terms "
          f"{list(WIDE_P_TERMS)} within {worst:.3e} of max |phi| from "
          f"float64, counts equal, slabs within {worst_slab:.3e} of their "
          f"plain versions {card} {clock()}")
    # K15's wide sweep at its own edges: the first n rows of at least 64
    # (grid_inputs' median needs pairs).
    kernel, worst, calls = cuda_phi.PHI_RBF_WIDE_KERNEL, 0.0, 0
    for m in WIDE_EDGE_MS:
        for n in K15_EDGE_NS:
            x, s, g, thr = grid_inputs(max(n, 64), m, 0.0, 4450 + n + m, dev)
            x, s = x[:n].contiguous(), s[:n].contiguous()
            for kind in ("pd", "indefinite"):
                p = wide_p_ps(kind, m, 1, 4451, g, dev)[0]
                kern, want64, want32 = wide_p_call(kernel, x, s, g, thr,
                                                   (kind, p))
                abs_err, rel = wide_held(f"44e K15 wide ({n}, {m}) {kind}",
                                         kern(), want64(), want32())
                errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
                worst = max(worst, rel)
                calls += 1
    print(f"phase 44e edges: ok {calls} calls of K15's wide sweep at n = "
          f"{list(K15_EDGE_NS)}, m = {list(WIDE_EDGE_MS)}, P positive "
          f"definite and indefinite, within {worst:.3e} of max |phi| from "
          f"float64 {card} {clock()}")
    report = {inst: ptxas.get(inst, "?")
              for inst in ANISO_WIDE_INSTANCES + K15_WIDE_INSTANCES}
    spilled = [inst for inst, text in report.items()
               if not text.endswith(" 0 B spill")]
    check(not spilled, f"phase 44e: K14's and K15's wide instances spill or "
                       f"were not found in the build log: "
                       f"{ {i: report[i] for i in spilled} }")
    print(f"phase 44e ptxas: ok {json.dumps(report)} dynamic smem_bytes="
          f"{WIDE_SYM_SMEM} (single-term groups, K15), "
          f"{WIDE_SYM_TERMS_SMEM} + 192 static (group 0's terms); one block "
          f"of 288 threads an SM")


def phase_wide_p_shapes(dev, card, clock, plain_ms, errs):
    """Phase 44b: both wide kernels at the paths' shape (WIDE_P_BIG_N,
    WIDE_D) on grid inputs, held as in 44a (their max |dphi| into
    ``errs``): K14 with the anisotropic MVN's terms (iso + 1), beside the
    'rbf_terms' route's sweep (ops/phi.phi_rbf_terms) on the same inputs,
    and K15 with an indefinite P (psd=False, the HESSIAN route's flag).
    Returns {kernel: {"kernel": ms, "plain": ms, "kernel_us": us, ...}}."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import phi_rbf_terms

    n, m = WIDE_P_BIG_N, WIDE_D
    x, s, g, thr = grid_inputs(n, m, 0.0, 449, dev)
    out = {}
    for kernel, spec in ((cuda_phi.ANISO_WIDE_KERNEL, "iso+1"),
                         (cuda_phi.PHI_RBF_WIDE_KERNEL,
                          ("indefinite",
                           wide_p_ps("indefinite", m, 1, 448, g, dev)[0]))):
        kern, want64, want32 = wide_p_call(kernel, x, s, g, thr, spec)
        abs_err, rel = wide_held(f"44b {kernel} ({n}, {m})", kern(),
                                   want64(), want32())
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        t = {"kernel": time_ms(kern, reps=20, warmup=3),
             "kernel_us": kernel_us(kern, kernel, calls=5),
             "plain": plain_ms(want32)}
        (fp_ms, fp_by), (tc_ms, tc_by) = wide_p_bounds(kernel, n, m, spec)
        extra = ""
        if kernel == cuda_phi.ANISO_WIDE_KERNEL:
            # The rbf_terms route's sweep over the same two terms, the
            # median RBF (gamma I) + RBF(P): the flattened terms of slots 0
            # and 1 (kernels/algebra.flatten_rbf_terms), each positive.
            p = wide_p_ps("pd", m, 1, 445, g, dev)[0]
            terms = [(1, ((0, 1),)), (1, ((1, 1),))]
            kparams = (g * torch.eye(m, device=dev), p)
            t["rbf_terms"] = plain_ms(lambda: phi_rbf_terms(
                x, s, kparams, terms, 1024, psd_flags=[True, True]))
            extra = f" rbf_terms_ms={t['rbf_terms']:.4f}"
        out[kernel] = t
        what = spec if isinstance(spec, str) else spec[0]
        print(f"phase 44b {kernel} ({n}, {m}) {what}: ok "
              f"phi_rel={rel:.3e} wrapper_ms={t['kernel']:.4f} kernel_us="
              f"{t['kernel_us']} plain_ms={t['plain']:.4f}{extra} "
              f"bound_fp32_ms={fp_ms:.6g} ({fp_by}) bound_tensor_ms="
              f"{tc_ms:.6g} ({tc_by}) {card} {clock()}")
    return out


def mean_pair_weight(coords, p_matrix, rows=2048):
    """The mean of exp(-d^T P d) over the pairs of the first ``rows``
    particles with every particle, in float64: near 0 where the term is
    dead at these coordinates."""
    import torch

    x = coords.double()
    half = 0.5 * (p_matrix + p_matrix.T).double()
    y = x @ half
    q = (x * y).sum(dim=1)
    form = q[:rows, None] + q[None, :] - 2.0 * x[:rows] @ y.T
    return float(torch.exp(-form.clamp_min(0.0)).mean())


def phase_wide_p_paths(dev, card, clock):
    """Phase 44c: the slice on the card at d = WIDE_D, N = WIDE_P_BIG_N.
    The anisotropic MVN (aniso_mvn_workload(..., dim=WIDE_D)) on auto for
    WIDE_P_STEPS steps, which must route to fused_aniso_terms_cuda and
    launch K14's wide instance only; phase 18's HESSIAN target on 'cuda'
    for WIDE_P_HESS_STEPS steps, K15's wide instance only (no sym_eigen).
    Each route is gated per call (replay_gate on the float64 run's own
    sweep calls); the float32 run's distance from the float64 one after
    its steps is a printed reading, as is the mean kernel weight a pair of
    each anisotropic term (mean_pair_weight), where a dead term shows.
    Returns {path: (launch counts, kernel, n, m)}."""
    import torch

    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils.workloads import (
        aniso_mvn_workload,
        build_aniso_svgd,
    )

    n, d = WIDE_P_BIG_N, WIDE_D
    mean, cov, x0, p_aniso = aniso_mvn_workload(n, dim=d)
    out = {}
    for name, impl, scale, steps, wrapper, kernel in (
            ("aniso", "auto", None, WIDE_P_STEPS,
             "phi_rbf_aniso_terms_fused_cuda", cuda_phi.ANISO_WIDE_KERNEL),
            ("hessian", "cuda", st.ScaleMethod.HESSIAN, WIDE_P_HESS_STEPS,
             "phi_rbf_cuda", cuda_phi.PHI_RBF_WIDE_KERNEL)):
        def build(dtype, impl=impl, scale=scale, steps=steps):
            return build_aniso_svgd(
                torch.tensor(x0, dtype=dtype, device=dev), mean, cov,
                p_aniso, phi_impl=impl, num_iterations=steps,
                kernel_scale=scale)
        cuda_phi.reset_launch_counts()
        t0 = time.perf_counter()
        svgd = build(torch.float32)
        final = svgd.run().double()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(cuda_phi.launch_counts)
        route = "fused_aniso_terms_cuda" if name == "aniso" else "cuda"
        check(svgd._phi_impl == route,
              f"phase 44c {name}: routed to {svgd._phi_impl!r}")
        check(bool(final.isfinite().all()) and tuple(final.shape) == (n, d),
              f"phase 44c {name}: bad output")
        require_only(counts, kernel, steps, f"phase 44c {name}")
        final64, calls = recorded_run(
            lambda: build(torch.float64, impl=route), wrapper, steps)
        rel, dcnt = replay_gate(f"phase 44c {name}", wrapper, calls)
        if name == "aniso":
            p = torch.tensor(p_aniso, dtype=torch.float64, device=dev)
            weights = {"start": mean_pair_weight(torch.tensor(
                x0, device=dev), p), "end": mean_pair_weight(final, p)}
        else:
            p = svgd.kernel.parameters[0]
            weights = {"end": mean_pair_weight(final, p)}
        print(f"phase 44c {name} N={n} d={d} {impl} {steps} steps: ok "
              f"route={route} kernel={kernel} launches={json.dumps(counts)} "
              f"s={sec:.2f}; per-call replay of the float64 run's "
              f"{len(calls)} sweeps in float32: max phi_rel={rel:.3e} "
              f"(gate {WIDE_PHI_GATE}) max count_diff={dcnt}; not gated: "
              f"{steps}-step coords_max_abs_diff from float64="
              f"{float((final - final64).abs().max()):.3e}, mean "
              f"anisotropic kernel weight a pair={json.dumps(weights)} "
              f"{card} {clock()}")
        out[name] = (counts, kernel, n, d)
    return out


#: Phase 45: the panel sweeps past m = 64 (the float32 wide instances of
#: K3, K12/K13 and K5: entries of their own on csrc/wide_tri_sm90.cuh's
#: body, over the panel list's tile pairs into the triangle's
#: accumulator). 45a: K3 and K12/K13 (two terms) at WIDE_PANEL_N particles
#: of grid inputs at each width of WIDE_PANEL_MS, and K3 and K5's chunks
#: (summed over worlds 1 and 2) at (WIDE_BIG_N, WIDE_D) and K12/K13 at
#: (WIDE_BIG_N, WIDE_D + 1), each held to float64 (wide_held) and timed
#: beside the wide triangle at the same shape, then the same kernels at the
#: tile's edges (WIDE_PANEL_EDGE_NS at WIDE_EDGE_MS, and WIDE_PANEL_RAGGED's
#: forced plan) and ptxas's spill of WIDE_PANEL_INSTANCES; 45b: the main
#: paths with fused_sym="panel" at a9a's width for COMPARE_STEPS steps
#: each, every sweep call gated against float64.
WIDE_PANEL_MS = (65, 123, 256)
WIDE_PANEL_N = 4096
WIDE_PANEL_INSTANCES = {
    "fused_phi_counts_sympanel": ("counts_sympanel_wide<3>",
                                  "counts_sympanel_wide<8>"),
    "fused_phi_terms_sympanel": ("terms_sympanel_wide<3,2>",
                                 "terms_sympanel_wide<3,0>",
                                 "terms_sympanel_wide<8,2>",
                                 "terms_sympanel_wide<8,0>"),
    "fused_phi_counts_sympanel_chunk": ("counts_sympanel_chunk_wide<3>",
                                        "counts_sympanel_chunk_wide<8>")}
#: Phase 45a's edges: the default plan of 128-particle tiles at n = 127-257
#: (one or two super-blocks hold particles, the other six's items have a
#: tile wholly past n), and a forced plan of 2 super-blocks of
#: 384 at n = 600, whose last tile lies wholly past n and whose last
#: particle tile is ragged; K5's chunks summed over worlds 1 to
#: WIDE_EDGE_WORLDS.
WIDE_PANEL_EDGE_NS = (127, 128, 129, 257)
WIDE_PANEL_RAGGED = (600, 2)


def wide_panel_cases(dev):
    """Phase 45a's calls: (label, kernel, n, m, terms, the panel call, the
    wide triangle's call at the same shape (None for K5), the float64 and
    float32 plain calls); each call returns (phi, counts)."""
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_fused_counts,
        phi_rbf_fused_sym_finish,
        phi_rbf_terms_fused_counts,
    )

    def f64(*ts):
        return [t.double() for t in ts]

    shapes = [(WIDE_PANEL_N, m) for m in WIDE_PANEL_MS] + [(WIDE_BIG_N,
                                                            WIDE_D)]
    cases = []
    for idx, (n, m) in enumerate(shapes):
        x, s, g, thr = grid_inputs(n, m, 0.0, 451 + idx, dev)
        cases.append((
            f"K3 wide ({n}, {m})", cuda_phi.SYMPANEL_KERNEL, n, m, None,
            lambda x=x, s=s, g=g, thr=thr:
            cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym="panel"),
            lambda x=x, s=s, g=g, thr=thr:
            cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True),
            lambda x=x, s=s, g=g, thr=thr:
            phi_rbf_fused_counts(*f64(x, s, g, thr)),
            lambda x=x, s=s, g=g, thr=thr: phi_rbf_fused_counts(x, s, g,
                                                                thr)))
        mt = m + 1 if n == WIDE_BIG_N else m
        xt, st_, g, thr = (grid_inputs(n, mt, 0.0, 461 + idx, dev)
                           if mt != m else (x, s, g, thr))
        gs, signs = [g, 0.5 * g], (1.0, 1.0)
        cases.append((
            f"K12/K13 wide ({n}, {mt}) two terms",
            cuda_phi.TERMS_SYMPANEL_KERNEL, n, mt, signs,
            lambda x=xt, s=st_, gs=gs, thr=thr, signs=signs:
            cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                              sym="panel"),
            lambda x=xt, s=st_, gs=gs, thr=thr, signs=signs:
            cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                              sym=True),
            lambda x=xt, s=st_, gs=gs, thr=thr, signs=signs:
            phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                       thr.double()),
            lambda x=xt, s=st_, gs=gs, thr=thr, signs=signs:
            phi_rbf_terms_fused_counts(x, s, gs, signs, thr)))
        if n != WIDE_BIG_N:
            continue
        for world in (1, 2):
            cases.append((
                f"K5 wide chunks ({n}, {m}) world={world}",
                cuda_phi.SYMPANEL_CHUNK_KERNEL, n, m, None,
                lambda x=x, s=s, g=g, thr=thr, n=n, world=world:
                ranks_summed(
                    lambda w, r: cuda_phi.phi_rbf_sympanel_chunk_cuda(
                        x, s, g, thr, w, r), world, n,
                    lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n)),
                None,
                lambda x=x, s=s, g=g, thr=thr:
                phi_rbf_fused_counts(*f64(x, s, g, thr)),
                lambda x=x, s=s, g=g, thr=thr: phi_rbf_fused_counts(
                    x, s, g, thr)))
    return cases


def phase_wide_panels(dev, card, clock, ptxas, plain_ms):
    """Phase 45a (see WIDE_PANEL_MS). Returns ({kernel: max |dphi|},
    {(kernel, n, m): {"kernel": ms, "kernel_us": us, "full": the wide
    triangle's ms, "plain": the float32 plain version's ms}})."""
    errs, times = {}, {}
    for label, kernel, n, m, terms, kern, tri, want64, want32 in (
            wide_panel_cases(dev)):
        abs_err, rel = wide_held(f"45a {label}", kern(), want64(), want32())
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        k_us = kernel_us(kern, kernel, calls=5)
        wrapper = time_ms(kern, reps=10, warmup=2)
        tri_ms = time_ms(tri, reps=10, warmup=2) if tri else None
        (fp_ms, fp_by), (tc_ms, tc_by) = wide_bounds(kernel, n, m, terms)
        if "chunk" not in label or label.endswith("world=1"):
            times[(kernel, n, m)] = {"kernel": wrapper, "kernel_us": k_us,
                                     "full": tri_ms,
                                     "plain": plain_ms(want32)}
        regs = {inst: ptxas.get(inst, "?")
                for inst in WIDE_PANEL_INSTANCES[kernel]}
        beside = (f" full_width_triangle_ms={tri_ms:.4f}" if tri_ms
                  else "")
        print(f"phase 45a {label}: ok phi_rel={rel:.3e} count_diff=0 "
              f"kernel_us={k_us} wrapper_ms={wrapper:.4f}{beside} "
              f"bound_fp32_ms={fp_ms:.6g} ({fp_by}) bound_tensor_ms="
              f"{tc_ms:.6g} ({tc_by}) ptxas={json.dumps(regs)} "
              f"smem_bytes="
              f"{WIDE_SYM_TERMS_SMEM if terms else WIDE_SYM_SMEM} "
              f"{card} {clock()}")
    return errs, times


def phase_wide_panel_edges(dev, card, clock, ptxas, errs):
    """Phase 45a's edges: the panels' float32 wide entries at the edges of
    their 128-particle tiles and plans (WIDE_PANEL_EDGE_NS at WIDE_EDGE_MS
    on the default plan, WIDE_PANEL_RAGGED's forced plan at the same m): K3
    (T = 3 and, through the runtime-T instance, 5), K12/K13 with two terms and
    with three (a negative sign), K5's chunks summed over worlds 1 to
    WIDE_EDGE_WORLDS, each held to its float64 and float32 plain versions
    (wide_held; its max |dphi| into ``errs``). Then ptxas's registers and
    spill of every instance (WIDE_PANEL_INSTANCES), none of which may
    spill."""
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_fused_counts,
        phi_rbf_fused_sym_finish,
        phi_rbf_sympanel_chunk_counts,
        phi_rbf_terms_fused_counts,
    )

    def f64(*ts):
        return [t.double() for t in ts]

    def held(label, kernel, got, want64, want32):
        abs_err, rel = wide_held(f"45a edges {label}", got, want64, want32)
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        return rel

    shapes = [(n, None) for n in WIDE_PANEL_EDGE_NS] + [WIDE_PANEL_RAGGED]
    worst, calls = 0.0, 0
    for m in WIDE_EDGE_MS:
        for n, blocks in shapes:
            x, s, g, thr = grid_inputs(n, m, 0.0, 4500 + n + m, dev)
            tag = f"({n}, {m}) panel_blocks={blocks}"
            for th in (thr, thresholds_of(thr, 5)):
                worst = max(worst, held(
                    f"K3 {tag} T={th.shape[0]}", cuda_phi.SYMPANEL_KERNEL,
                    cuda_phi.phi_rbf_fused_cuda(x, s, g, th, sym="panel",
                                                panel_blocks=blocks),
                    phi_rbf_fused_counts(*f64(x, s, g, th)),
                    phi_rbf_fused_counts(x, s, g, th)))
            for signs, gs in (((1.0, 1.0), [g, 0.5 * g]),
                              ((1.0, -0.5, 1.0), [g, 0.5 * g, 2.0 * g])):
                worst = max(worst, held(
                    f"K12/K13 {tag} signs={signs}",
                    cuda_phi.TERMS_SYMPANEL_KERNEL,
                    cuda_phi.phi_rbf_terms_fused_cuda(
                        x, s, gs, signs, thr, sym="panel",
                        panel_blocks=blocks),
                    phi_rbf_terms_fused_counts(*f64(x, s), f64(*gs), signs,
                                               thr.double()),
                    phi_rbf_terms_fused_counts(x, s, gs, signs, thr)))
            for world in range(1, WIDE_EDGE_WORLDS + 1):
                worst = max(worst, held(
                    f"K5 {tag} world={world}", cuda_phi.SYMPANEL_CHUNK_KERNEL,
                    ranks_summed(
                        lambda w, r: cuda_phi.phi_rbf_sympanel_chunk_cuda(
                            x, s, g, thr, w, r, blocks), world, n,
                        lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n)),
                    phi_rbf_fused_counts(*f64(x, s, g, thr)),
                    ranks_summed(
                        lambda w, r: phi_rbf_sympanel_chunk_counts(
                            x, s, g, thr, w, r, blocks), world, n,
                        lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n))))
                calls += 1
            calls += 4
    print(f"phase 45a edges: ok {calls} calls at n = "
          f"{list(WIDE_PANEL_EDGE_NS)} (default plan) and "
          f"(n, panel_blocks) = {WIDE_PANEL_RAGGED}, m = "
          f"{list(WIDE_EDGE_MS)} (K5 over worlds 1-{WIDE_EDGE_WORLDS}) "
          f"within {worst:.3e} of max |phi| from float64, counts equal "
          f"{card} {clock()}")
    report = {inst: ptxas.get(inst, "?")
              for insts in WIDE_PANEL_INSTANCES.values() for inst in insts}
    spilled = [inst for inst, text in report.items()
               if not text.endswith(" 0 B spill")]
    check(not spilled, f"phase 45a: the wide panel instances spill or were "
                       f"not found in the build log: "
                       f"{ {i: report[i] for i in spilled} }")
    print(f"phase 45a ptxas: ok {json.dumps(report)} dynamic smem_bytes="
          f"{WIDE_SYM_SMEM} (one RBF), {WIDE_SYM_TERMS_SMEM} (terms); one "
          f"block of 288 threads an SM")


class CallGate:
    """Keeps every ``every``-th call of the kernel wrapper ``name`` of
    ``module`` (its args, kwargs and output) while in a ``with`` block, the
    wrapper itself still running; ``held(label, plain, phi_gate)`` then
    holds each kept call to ``plain(*args, **kwargs)`` on the same inputs:
    phi within ``phi_gate`` of max |phi| (phi may be finished from a raw
    chunk by ``finish``), the counts within REPLAY_COUNT_SLACK or
    1e-6 n^2. Returns (calls, max phi_rel, max count_diff)."""

    def __init__(self, module, name, every=1):
        self.module, self.name, self.every = module, name, every
        self.calls, self.seen = [], 0

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def keep(*args, **kwargs):
            out = real(*args, **kwargs)
            if self.seen % self.every == 0:
                self.calls.append((args, kwargs, out))
            self.seen += 1
            return out
        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def held(self, label, plain, phi_gate, finish=None):
        import torch

        worst_rel, worst_cnt = 0.0, 0
        for idx, (args, kwargs, out) in enumerate(self.calls):
            want = plain(*args, **kwargs)
            got, want = ((finish(out, args), finish(want, args)) if finish
                         else (out, want))
            torch.cuda.synchronize()
            phi, phi_w = got[0].double(), want[0].double()
            rel = float((phi - phi_w).abs().max() / phi_w.abs().max())
            check(bool(got[0].isfinite().all()) and rel <= phi_gate,
                  f"{label} call {idx}: phi rel err {rel:.3e} > {phi_gate}")
            n = args[0].shape[0]
            bound = max(REPLAY_COUNT_SLACK, 1e-6 * n * n)
            dcnt = int((got[1] - want[1]).abs().max())
            check(dcnt <= bound, f"{label} call {idx}: counts differ by "
                                 f"{dcnt} > {bound:g}")
            worst_rel, worst_cnt = max(worst_rel, rel), max(worst_cnt, dcnt)
        return len(self.calls), worst_rel, worst_cnt


def phase_wide_panel_paths(dev, card, clock):
    """Phase 45b: the main paths with fused_sym="panel" past m = 64, at
    full width, COMPARE_STEPS steps each: the flat BLR driver at
    (WIDE_BIG_N, WIDE_D) (K3's wide instance only) and the hierarchical
    BLR at (WIDE_BIG_N, WIDE_D + 1) (K12/K13's), each gated per call
    (recorded_run and replay_gate: the float64 run's sweep calls replayed
    in float32 through the kernel); the engine on a one-rank NCCL group on
    phase 43c's MVN at d = WIDE_D (K5's, every chunk call held to its
    float64 plain chunk on the same inputs, CallGate), against the driver
    with fused_sym="panel" within 1e-3. ms a step of each. Returns {path:
    (launch counts, kernel, n, m, ms a step)}."""
    import torch

    import svgdcpp_tpu_torch.parallel.sharded as sharded_module
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_fused_sym_finish,
        phi_rbf_sympanel_chunk_counts,
    )
    from svgdcpp_tpu_torch.parallel import initialize_distributed
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_blr_svgd,
        build_mvn_svgd,
        build_sharded_mvn_svgd,
    )

    out = {}
    n, d = WIDE_BIG_N, WIDE_D
    for hier in (False, True):
        m = d + 1 if hier else d
        feats, labels, x0 = blr_workload(n, d, hierarchical=hier)
        impl = "fused_terms_cuda" if hier else "fused_cuda"
        kernel = (cuda_phi.TERMS_SYMPANEL_KERNEL if hier
                  else cuda_phi.SYMPANEL_KERNEL)
        wrapper = ("phi_rbf_terms_fused_cuda" if hier
                   else "phi_rbf_fused_cuda")

        def build(dt, hier=hier, impl=impl, feats=feats, labels=labels,
                  x0=x0):
            return build_blr_svgd(torch.tensor(x0, dtype=dt, device=dev),
                                  feats, labels, hierarchical=hier,
                                  phi_impl=impl, fused_sym="panel",
                                  num_iterations=COMPARE_STEPS)
        cuda_phi.reset_launch_counts()
        svgd = build(torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = svgd.run().double()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / COMPARE_STEPS
        counts = dict(cuda_phi.launch_counts)
        check(svgd.fused_sym_form == "panel" and bool(final.isfinite().all()),
              f"phase 45b BLR hier={hier}: form {svgd.fused_sym_form!r}")
        require_only(counts, kernel, COMPARE_STEPS,
                     f"phase 45b BLR hier={hier}")
        final64, calls = recorded_run(lambda: build(torch.float64), wrapper,
                                      COMPARE_STEPS)
        rel, dcnt = replay_gate(f"phase 45b BLR hier={hier}", wrapper, calls)
        name = "hier" if hier else "flat_blr"
        print(f"phase 45b {name} N={n} m={m} {impl} fused_sym=panel "
              f"{COMPARE_STEPS} steps: ok kernel={kernel} launches="
              f"{json.dumps(counts)} ms_per_step={ms:.4f} (host clock, "
              f"synced); per-call replay of the float64 run's {len(calls)} "
              f"sweeps: max phi_rel={rel:.3e} (gate {WIDE_PHI_GATE}) max "
              f"count_diff={dcnt}; not gated: coords_max_abs_diff from "
              f"float64={float((final - final64).abs().max()):.3e} {card} "
              f"{clock()}")
        out[name] = (counts, kernel, n, m, ms)

    group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    check(group.backend == "nccl", f"one-rank group on {group.backend!r}")
    mean, cov, x0 = wide_mvn(n, d, 490)
    driver = build_mvn_svgd(torch.tensor(x0, device=dev), mean, cov,
                            phi_impl="fused_cuda", fused_sym="panel",
                            num_iterations=COMPARE_STEPS).run().double()
    eng = build_sharded_mvn_svgd(x0, mean, cov, group, fused_sym="panel")
    check(eng._fused_cuda and eng._fused_sym == "panel",
          f"phase 45b engine: fused_cuda={eng._fused_cuda} fused_sym="
          f"{eng._fused_sym!r}")
    cuda_phi.reset_launch_counts()
    with CallGate(sharded_module, "phi_rbf_sympanel_chunk_cuda") as gate:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = eng.run(x0, COMPARE_STEPS).double()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / COMPARE_STEPS
    counts = dict(cuda_phi.launch_counts)
    kernel = cuda_phi.SYMPANEL_CHUNK_KERNEL
    require_only(counts, kernel, COMPARE_STEPS, "phase 45b engine")
    diff = float((final - driver).abs().max())
    check(bool(final.isfinite().all()) and diff <= 1e-3,
          f"phase 45b engine: {diff:.3e} from the driver")

    def plain64(c, s, g, thr, world, rank):
        acc, upper = phi_rbf_sympanel_chunk_counts(
            c.double(), s.double(), g.double(), thr.double(), world, rank)
        return acc, upper

    def finish(out_, args):
        c, s, g = args[0], args[1], args[2]
        acc, upper = out_
        return (phi_rbf_fused_sym_finish(acc.double(), s.double(),
                                         g.double(), c.shape[0]),
                2 * upper - c.shape[0])
    kept, rel, dcnt = gate.held("phase 45b engine", plain64, WIDE_PHI_GATE,
                                finish)
    print(f"phase 45b engine N={n} m={d} one NCCL rank fused_sym=panel "
          f"{COMPARE_STEPS} steps: ok kernel={kernel} launches="
          f"{json.dumps(counts)} ms_per_step={ms:.4f} (host clock, synced); "
          f"each of its {kept} chunk calls against its float64 plain chunk: "
          f"max phi_rel={rel:.3e} (gate {WIDE_PHI_GATE}) max count_diff="
          f"{dcnt}; vs the driver (fused_sym=panel) coords_max_abs_diff="
          f"{diff:.3e} {card} {clock()}")
    out["engine"] = (counts, kernel, n, d, ms)
    torch.distributed.destroy_process_group()
    return out


#: Phase 46: the bfloat16 operand opt-in. 46a: each bf16 instance at
#: BF16_SHAPES (K1's cross form at a two-rank mesh's 5000 rows and at the
#: one-rank mesh's 10,000 of 46b) against its bf16 plain version on the card (float32 with
#: the same roundings) within BF16_GATE of max |phi|, counts within
#: REPLAY_COUNT_SLACK or 1e-6 n_t n, and against the float32 plain
#: version within BF16_F32_GATE (the JAX package's bf16 bound,
#: tests/test_pallas.py:289, at its fixed gamma = 0.6 and n = 200-300) or,
#: where the bf16 function itself (its plain version) stands farther from
#: float32, within that distance plus BF16_GATE: at the median bandwidth
#: of N = 10,000, gamma = log(n) / med = 3.3 at m = 2, the bf16 rounding of
#: sq (2^-8 of |x_i| |x_j|) moves k by up to 5%, and the function stood
#: 3.3e-2 from float32 at (5000 x 10000, 2) on an H100; 46b: the flagship
#: on auto (K2's bf16
#: instance) for BF16_FLAGSHIP_STEPS iterations, the flat BLR (K1's), the
#: flagship with fused_sym="panel" at BF16_PANEL_N (K3's) and the flagship
#: driver under a one-rank NCCL mesh (K1's cross form), COMPARE_STEPS
#: steps each, every sweep call (every BF16_EVERY-th on the flagship, every
#: fourth on the panel path) held to its bf16 plain version as in 46a.
#: K2's, K3's and K15's bf16 instances run csrc/bf16_tri_sm90.cuh's body
#: (its pack kernel, then the sweep; kernel-only times are both's), whose
#: Gram tile steps k16 at a time: BF16_SHAPES holds K2 and K3 at m = 16 and
#: 17 too, K15 (two Gram tiles an item, the rounded Gram not being
#: symmetric) at the tile edges n = 1, 129 and 10007 and, under "K15
#: normal", on Gaussian inputs at m = 11 and 50 (the Gram's order of sums
#: against the plain version's on continuous data); 46a holds K15's pack
#: to its plain version (cuda_phi.bf16_tri_operands) bit for bit and
#: requires 0 bytes of spill of BF16_TRI_INSTANCES. K1's runs
#: csrc/square_bf16_sm90.cuh's pack, the sum of its squares into the norms
#: (torch.sum, the plain version's reduction), the sweep and the finishing
#: pass (kernel-only times are all four's; 46a holds the pack's operands
#: to their plain version, cuda_phi.square_bf16_operands, bit for bit),
#: the sweep in instances of 2, 4, 8 and 16
#: accumulator tiles, its Gram tile in slices of 32 coordinates and the
#: record's columns past 16 tiles (m >= 64) in chunks along the grid's z:
#: BF16_SHAPES holds it at m = 16 and 17, the chunk edges m = 63, 64 and
#: 65, at m = 123 and at the edges of its 64-source tiles and 128-row
#: blocks (n_s = 1, 33, 10007), and 46a requires 0 bytes of spill of
#: BF16_SQUARE_INSTANCES.
BF16_GATE = 1e-3
BF16_F32_GATE = 3e-2
BF16_SHAPES = {"K1": ((1000, 50), (1000, 16), (1000, 17), (1000, 63),
                      (1000, 64), (1000, 65), (1000, 123), (1, 2), (33, 17),
                      (10007, 2)),
               "K1 cross": ((5000, 10000, 2), (10000, 10000, 2),
                            (10000, 10000, 123), (33, 10007, 65),
                            (129, 1, 2)),
               "K2": ((10000, 2), (10000, 123), (10000, 16), (10000, 17)),
               "K3": ((32768, 2), (10000, 123), (8192, 16), (8192, 17)),
               "K15": ((1500, 2), (10240, 123), (1, 2), (129, 123),
                       (10007, 123)),
               "K15 normal": ((1500, 11), (1500, 50))}
BF16_TRI_INSTANCES = ("counts_sym_bf16<3>", "counts_sym_bf16<8>",
                      "counts_sympanel_bf16<3>", "counts_sympanel_bf16<8>",
                      "rbf_wide_bf16", "bf16_tri_pack")
BF16_PACK = "bf16_tri_pack"
BF16_SQUARE_INSTANCES = tuple(f"counts_square_bf16<{kt},{nt}>"
                              for kt in (3, 8) for nt in (2, 4, 8, 16)) + (
                                  "square_bf16_pack",)
#: The names of K1's bf16 call's kernels: the pack, the norms' sums
#: (torch.sum's reduce kernel, whose name holds its functor's), the sweep
#: and the finishing pass.
BF16_SQUARE_PACK, BF16_SQUARE_SUM = "square_bf16_pack", "sum_functor"
BF16_SQUARE_NAMES = (BF16_SQUARE_PACK, BF16_SQUARE_SUM,
                     "fused_phi_counts_square_bf16",
                     "fused_phi_counts_square_finish")
#: The bf16 triangle body's shared memory (Bf16Tri::kSmemBytes): 5 stages
#: of two 16 KB slots and 1 KB of norms, and the 32 KB weight tile.
BF16_TRI_SMEM = 5 * (2 * 16384 + 1024) + 32768
BF16_FLAGSHIP_STEPS, BF16_EVERY, BF16_PANEL_N = 1000, 50, 32768
BF16 = "bfloat16"


def bf16_plain(name):
    """The bf16 plain version (ops/phi) of the kernel wrapper ``name``
    under the wrapper's signature, on the card."""
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops import phi as ph

    if name == "phi_rbf_fused_cuda":
        def fused(c, s, g, thr, sym=None, panel_blocks=None,
                  dot_dtype="float32"):
            form = cuda_phi.resolve_sym(sym, c.shape[0], c.shape[1])
            if form == "panel":
                return ph.phi_rbf_sympanel_fused_counts(
                    c, s, g, thr, panel_blocks, dot_dtype=dot_dtype)
            if form:
                return ph.phi_rbf_sym_fused_counts(c, s, g, thr, dot_dtype)
            return ph.phi_rbf_fused_counts(c, s, g, thr, dot_dtype=dot_dtype)
        return fused
    if name == "phi_rbf_fused_cuda_cross":
        return lambda t, c, s, g, thr, dot_dtype="float32": (
            ph.phi_rbf_cross_fused_counts(t, c, s, g, thr,
                                          dot_dtype=dot_dtype))
    raise ValueError(name)


def bf16_cases(dev):
    """Phase 46a's calls: (label, kernel, n, m, n_t, the bf16 kernel's call,
    the float32 kernel's call, the bf16 plain call, the float32 plain
    call); each returns (phi, counts or None)."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops import phi as ph

    fused, cross = bf16_plain("phi_rbf_fused_cuda"), bf16_plain(
        "phi_rbf_fused_cuda_cross")
    cases = []
    for key, shapes in BF16_SHAPES.items():
        for idx, shape in enumerate(shapes):
            n, m = shape[-2:]
            # The first n rows of at least 64 (the median's sample) and of
            # the cross form's targets, which are its first n_t.
            rows = max(n, shape[0], 64)
            x, s, g, thr = inputs_for(rows, m, 0.0, 470 + 7 * idx + m, dev)
            xt = x[:shape[0]].contiguous()
            x, s = x[:n].contiguous(), s[:n].contiguous()
            if key == "K1 cross":
                n_t = shape[0]
                cases.append((
                    f"K1 bf16 cross ({n_t} x {n}, {m})",
                    cuda_phi.SQUARE_BF16_KERNEL, n, m, n_t,
                    *[(lambda f, dd, xt=xt, x=x, s=s, g=g, thr=thr:
                       (lambda: f(xt, x, s, g, thr, dot_dtype=dd)))(f, dd)
                      for f, dd in ((cuda_phi.phi_rbf_fused_cuda_cross, BF16),
                                    (cuda_phi.phi_rbf_fused_cuda_cross,
                                     "float32"), (cross, BF16),
                                    (cross, "float32"))]))
                continue
            if key.startswith("K15"):
                if key == "K15 normal":
                    x, s, g, thr = sweep_inputs(max(n, 64), m, 0.0,
                                                475 + m, dev)
                    x, s = x[:n].contiguous(), s[:n].contiguous()
                p = (torch.eye(m, device=dev) * g if m <= 4
                     else wide_p_ps("pd", m, 1, 471, g, dev)[0])
                half = 0.5 * (p + p.T).double()
                cases.append((
                    f"{key} bf16 ({n}, {m})", cuda_phi.PHI_RBF_WIDE_BF16_KERNEL,
                    n, m, None,
                    lambda x=x, s=s, p=p: (cuda_phi.phi_rbf_cuda(
                        x, s, p, dot_dtype=BF16), None),
                    lambda x=x, s=s, p=p: (cuda_phi.phi_rbf_cuda(x, s, p),
                                           None),
                    lambda x=x, s=s, half=half: (ph.phi_rbf_gram(
                        x, s, half, dot_dtype=BF16), None),
                    lambda x=x, s=s, half=half: (ph.phi_rbf_gram(x, s, half),
                                                 None)))
                continue
            sym = {"K1": False, "K2": True, "K3": "panel"}[key]
            kernel = {"K1": cuda_phi.SQUARE_BF16_KERNEL,
                      "K2": cuda_phi.SYM_BF16_KERNEL,
                      "K3": cuda_phi.SYMPANEL_BF16_KERNEL}[key]
            cases.append((
                f"{key} bf16 ({n}, {m}){' forced panel' if key == 'K3' else ''}",
                kernel, n, m, None,
                *[(lambda f, dd, x=x, s=s, g=g, thr=thr, sym=sym:
                   (lambda: f(x, s, g, thr, sym=sym, dot_dtype=dd)))(f, dd)
                  for f, dd in ((cuda_phi.phi_rbf_fused_cuda, BF16),
                                (cuda_phi.phi_rbf_fused_cuda, "float32"),
                                (fused, BF16), (fused, "float32"))]))
    return cases


def bf16_bounds(kernel, n, m, n_t=None):
    """(FP32 bound, tensor-core bound at the bf16 peak) of a bf16
    instance's call, each (ms, bound_by)."""
    from svgdcpp_tpu_torch.ops import cuda_phi

    fp32 = sweep_bound(kernel, n, m, n_t=n_t)
    if kernel == cuda_phi.SQUARE_BF16_KERNEL:
        return fp32, square_tensor_bound(n, m, n_t=n_t, bf16=True)
    return fp32, tri_tensor_bound(
        n, m, fixed_p=kernel == cuda_phi.PHI_RBF_WIDE_BF16_KERNEL, bf16=True)


def phase_square_bf16_pack(dev, card):
    """Phase 46a's check of K1's bf16 pack at BF16_SHAPES' K1 shapes: the
    pack's squares summed into q, its rounded rows and record (views of the
    workspace) equal their plain version (cuda_phi.square_bf16_operands)
    bit for bit, on the wrapper's centred operands; the pack's and the
    sums' kernel-only us at the last shape."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi

    shapes = ([(n, n, m, True) for n, m in BF16_SHAPES["K1"]]
              + [(*a, False) for a in BF16_SHAPES["K1 cross"]])
    for n_t, n_s, m, square in shapes:
        x, s, _, thr = inputs_for(max(n_t, n_s, 64), m, 0.0, 490 + m, dev)
        src = x[:n_s]
        center = src.mean(dim=0)
        src_c = (src - center).contiguous()
        tgt_c = src_c if square else (x[:n_t] - center).contiguous()
        sc = s[:n_s].contiguous()
        splits = cuda_phi.load_library().svgd_square_bf16_splits(n_t, n_s, m)
        counts = torch.full((thr.shape[0],), 7, dtype=torch.int64,
                            device=dev)

        def pack():
            return cuda_phi.square_bf16_pack(tgt_c, src_c, sc, square, counts,
                                             splits)

        q_t, q_s, work = pack()
        x_t, x_s, rec = cuda_phi.square_bf16_views(work, n_t, n_s, m, square,
                                                   splits)
        got = (q_t, x_t, q_s, x_s, rec)
        want = cuda_phi.square_bf16_operands(tgt_c, src_c, sc, square)
        torch.cuda.synchronize()
        off = [name for name, a, b in zip(("q_t", "x_t", "q_s", "x_s", "rec"),
                                          got, want)
               if not torch.equal(a, b)]
        check(not off and not counts.any(),
              f"phase 46a K1 bf16 pack ({n_t} x {n_s}, {m}): {off} differ "
              f"from the plain version, counts {counts.tolist()}")
    us = {name: kernel_us(pack, name, calls=5)
          for name in (BF16_SQUARE_PACK, BF16_SQUARE_SUM)}
    print(f"phase 46a K1 bf16 pack: ok q, the rounded rows and the record "
          f"equal their plain version bit for bit at {len(shapes)} shapes; "
          f"kernel_us at the last {json.dumps(us)} {card}")


def phase_fixed_p_bf16_pack(dev, card):
    """Phase 46a's check of K15's bf16 pack at BF16_SHAPES' K15 shapes: the
    workspace the entry fills (views cuda_phi.bf16_tri_views) equals its
    plain version (cuda_phi.bf16_tri_operands) bit for bit: q copied, X, Y
    and the record [S | X | 1] rounded to bf16, on the wrapper's operands
    (centred coordinates, Y and q from gram_operands) with an indefinite
    P; each call's accumulator finite."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
    from svgdcpp_tpu_torch.ops.phi import gram_operands

    lib = cuda_phi.load_library()
    shapes = BF16_SHAPES["K15"] + BF16_SHAPES["K15 normal"]
    for n, m in shapes:
        x, s, g, _ = sweep_inputs(max(n, 64), m, 0.0, 495 + m, dev)
        x, s = x[:n].contiguous(), s[:n].contiguous()
        p = wide_p_ps("indefinite", m, 1, 496, g, dev)[0]
        coords_c = (x - x.mean(dim=0)).contiguous()
        y, q = gram_operands(coords_c, 0.5 * (p + p.T).double())
        work = torch.full((sym_plan.bf16_work_bytes(n, m, gram_y=True),), 7,
                          dtype=torch.uint8, device=dev)
        acc = torch.zeros((2 * m + 1, n), device=dev)
        rc = lib.svgd_phi_rbf_wide_bf16(
            coords_c.data_ptr(), y.data_ptr(), q.data_ptr(), s.data_ptr(), n,
            m, 0, work.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"phase 46a K15 bf16 pack ({n}, {m}): entry "
                       f"returned {rc}")
        got = cuda_phi.bf16_tri_views(work, n, m, gram_y=True)
        want = cuda_phi.bf16_tri_operands(coords_c, s, y, q)
        torch.cuda.synchronize()
        off = [name for name in want if not torch.equal(got[name],
                                                        want[name])]
        check(not off and bool(acc.isfinite().all()),
              f"phase 46a K15 bf16 pack ({n}, {m}): {off} differ from the "
              f"plain version, or the accumulator is not finite")
    print(f"phase 46a K15 bf16 pack: ok q, X, Y and the record equal their "
          f"plain version bit for bit at {len(shapes)} shapes {card}")


def phase_bf16_kernels(dev, card, clock, ptxas, plain_ms):
    """Phase 46a (see BF16_GATE). Returns ({kernel: max |dphi| against the
    bf16 plain version}, {(kernel, n, m): times}, {kernel: launches of the
    phase's own calls})."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan

    errs, times, launched = {}, {}, {}
    phase_square_bf16_pack(dev, card)
    phase_fixed_p_bf16_pack(dev, card)
    for label, kernel, n, m, n_t, kern, kern32, plain, plain32 in (
            bf16_cases(dev)):
        cuda_phi.reset_launch_counts()
        got = kern()
        launched[kernel] = launched.get(kernel, 0) + cuda_phi.launch_counts[
            kernel]
        want, want32 = plain(), plain32()
        torch.cuda.synchronize()
        phi, phi_w, phi_32 = got[0].double(), want[0].double(), \
            want32[0].double()
        check(bool(got[0].isfinite().all()), f"phase 46a {label}: non-finite")
        abs_err = float((phi - phi_w).abs().max())
        rel = abs_err / float(phi_w.abs().max())
        rel32 = float((phi - phi_32).abs().max() / phi_32.abs().max())
        rel_fn = float((phi_w - phi_32).abs().max() / phi_32.abs().max())
        gate32 = max(BF16_F32_GATE, rel_fn + BF16_GATE)
        check(rel <= BF16_GATE, f"phase 46a {label}: phi rel err {rel:.3e} "
                                f"from the bf16 plain version > {BF16_GATE}")
        check(rel32 <= gate32,
              f"phase 46a {label}: phi rel err {rel32:.3e} from the float32 "
              f"plain version > {gate32:.3e}")
        cnt = ""
        if got[1] is not None:
            bound = max(REPLAY_COUNT_SLACK, 1e-6 * (n_t or n) * n)
            dcnt = int((got[1] - want[1]).abs().max())
            d32 = int((got[1] - want32[1]).abs().max())
            check(dcnt <= bound, f"phase 46a {label}: counts differ by "
                                 f"{dcnt} > {bound:g}")
            cnt = f" count_diff={dcnt} count_diff_vs_float32={d32}"
        errs[kernel] = max(errs.get(kernel, 0.0), abs_err)
        names = ((kernel, BF16_PACK) if kernel in (
            cuda_phi.SYM_BF16_KERNEL, cuda_phi.SYMPANEL_BF16_KERNEL,
            cuda_phi.PHI_RBF_WIDE_BF16_KERNEL)
            else BF16_SQUARE_NAMES if kernel == cuda_phi.SQUARE_BF16_KERNEL
            else kernel)
        t = {"kernel": time_ms(kern, reps=10, warmup=2),
             "kernel_us": kernel_us(kern, names, calls=5),
             "f32": time_ms(kern32, reps=10, warmup=2),
             "plain": plain_ms(plain)}
        times[(kernel, n, m)] = t
        (fp_ms, fp_by), (tc_ms, tc_by) = bf16_bounds(kernel, n, m, n_t)
        regs = {k: v for k, v in ptxas.items()
                if k.startswith(kernel.removeprefix("fused_phi_")
                                .removeprefix("phi_"))}
        print(f"phase 46a {label}: ok phi_rel={rel:.3e} (gate {BF16_GATE}) "
              f"phi_rel_vs_float32={rel32:.3e} (gate {gate32:.3e}; the bf16 "
              f"plain version's own {rel_fn:.3e}){cnt} "
              f"wrapper_ms={t['kernel']:.4f} kernel_us={t['kernel_us']} "
              f"float32_instance_ms={t['f32']:.4f} bf16_plain_ms="
              f"{t['plain']:.4f} bound_fp32_ms={fp_ms:.6g} ({fp_by}) "
              f"bound_bf16_tensor_ms={tc_ms:.6g} ({tc_by}) "
              f"ptxas={json.dumps(regs)} {card} {clock()}")
    report = {inst: ptxas.get(inst, "?")
              for inst in BF16_TRI_INSTANCES + BF16_SQUARE_INSTANCES}
    spilled = [inst for inst, text in report.items()
               if not text.endswith(" 0 B spill")]
    check(not spilled, f"phase 46a: the bf16 bodies' instances "
                       f"spill or were not found in the build log: "
                       f"{ {i: report[i] for i in spilled} }")
    square_smem = {m: sym_plan.square_bf16_plan(m).smem
                   for m in sorted({s[-1] for s in BF16_SHAPES["K1"]
                                    + BF16_SHAPES["K1 cross"]})}
    print(f"phase 46a ptxas: ok {json.dumps(report)} dynamic smem_bytes: "
          f"the triangle {BF16_TRI_SMEM} (one block of 384 threads an SM), "
          f"K1's by m {json.dumps(square_smem)} {card}")
    return errs, times, launched


def phase_bf16_paths(dev, card, clock):
    """Phase 46b (see BF16_GATE). Returns {path: (launch counts, kernel, n,
    m, ms a step)}."""
    import torch

    import numpy as np
    import torch

    import svgdcpp_tpu_torch.parallel.sharded as sharded_module
    import svgdcpp_tpu_torch.svgd as driver_module
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.parallel import initialize_distributed
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_blr_svgd,
        build_mvn_svgd,
        flagship_mvn,
    )

    def steps_run(svgd, steps):
        """(final coordinates, launch counts, ms a step by the host clock
        around synchronised runs)."""
        cuda_phi.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = svgd.run().double()
        torch.cuda.synchronize()
        return (final, dict(cuda_phi.launch_counts),
                (time.perf_counter() - t0) * 1e3 / steps)

    out = {}
    n = SHARDED_N
    mean, cov, x0 = flagship_mvn(n, dtype=np.float32)
    metrics = {}
    for dd in ("float32", BF16):
        svgd = build_mvn_svgd(torch.tensor(x0, device=dev), mean, cov,
                              num_iterations=BF16_FLAGSHIP_STEPS,
                              fused_dot_dtype=dd)
        check(svgd._phi_impl == "fused_cuda" and svgd.fused_sym_form is True,
              f"phase 46b flagship {dd}: {svgd._phi_impl!r} "
              f"{svgd.fused_sym_form!r}")
        if dd == BF16:
            with CallGate(driver_module, "phi_rbf_fused_cuda",
                          BF16_EVERY) as gate:
                final, counts, ms = steps_run(svgd, BF16_FLAGSHIP_STEPS)
        else:
            final, counts, ms32 = steps_run(svgd, BF16_FLAGSHIP_STEPS)
        check(bool(final.isfinite().all()), f"phase 46b flagship {dd}")
        metrics[dd] = posterior_metrics(final.cpu().numpy(), mean, cov)
    require_only(counts, cuda_phi.SYM_BF16_KERNEL, BF16_FLAGSHIP_STEPS,
                 "phase 46b flagship bf16")
    kept, rel, dcnt = gate.held("phase 46b flagship",
                                bf16_plain("phi_rbf_fused_cuda"), BF16_GATE)
    print(f"phase 46b flagship N={n} d=2 auto fused_dot_dtype=bfloat16 "
          f"{BF16_FLAGSHIP_STEPS} iters: ok kernel={cuda_phi.SYM_BF16_KERNEL} "
          f"launches={json.dumps(counts)} ms_per_step={ms:.4f} "
          f"(float32 route {ms32:.4f}; host clock, synced); {kept} sweep "
          f"calls against the bf16 plain version: max phi_rel={rel:.3e} "
          f"(gate {BF16_GATE}) max count_diff={dcnt}; not gated: bf16 "
          f"{json.dumps(metrics[BF16])} float32 "
          f"{json.dumps(metrics['float32'])} {card} {clock()}")
    out["flagship"] = (counts, cuda_phi.SYM_BF16_KERNEL, n, 2, ms)

    feats, labels, xb = blr_workload(1000, 50)
    svgd = build_blr_svgd(torch.tensor(xb, device=dev), feats, labels,
                          num_iterations=COMPARE_STEPS, fused_dot_dtype=BF16)
    with CallGate(driver_module, "phi_rbf_fused_cuda") as gate:
        final, counts, ms = steps_run(svgd, COMPARE_STEPS)
    check(bool(final.isfinite().all()) and svgd.fused_sym_form is False,
          "phase 46b flat BLR bf16")
    require_only(counts, cuda_phi.SQUARE_BF16_KERNEL, COMPARE_STEPS,
                 "phase 46b flat BLR bf16")
    kept, rel, dcnt = gate.held("phase 46b flat BLR",
                                bf16_plain("phi_rbf_fused_cuda"), BF16_GATE)
    acc = blr_accuracy(final.cpu().numpy(), feats, labels)
    print(f"phase 46b flat BLR N=1000 d=50 fused_dot_dtype=bfloat16 "
          f"{COMPARE_STEPS} steps: ok kernel={cuda_phi.SQUARE_BF16_KERNEL} "
          f"launches={json.dumps(counts)} ms_per_step={ms:.4f} (host "
          f"clock, synced); {kept} calls against the bf16 plain version: "
          f"max phi_rel={rel:.3e} max count_diff={dcnt}; train_accuracy="
          f"{acc:.4f} {card} {clock()}")
    out["flat_blr"] = (counts, cuda_phi.SQUARE_BF16_KERNEL, 1000, 50, ms)

    mean_p, cov_p, xp = flagship_mvn(BF16_PANEL_N, dtype=np.float32)
    svgd = build_mvn_svgd(torch.tensor(xp, device=dev), mean_p, cov_p,
                          fused_sym="panel", num_iterations=COMPARE_STEPS,
                          fused_dot_dtype=BF16)
    with CallGate(driver_module, "phi_rbf_fused_cuda", 4) as gate:
        final, counts, ms = steps_run(svgd, COMPARE_STEPS)
    check(bool(final.isfinite().all()) and svgd.fused_sym_form == "panel",
          "phase 46b flagship panel bf16")
    require_only(counts, cuda_phi.SYMPANEL_BF16_KERNEL, COMPARE_STEPS,
                 "phase 46b flagship panel bf16")
    kept, rel, dcnt = gate.held("phase 46b flagship panel",
                                bf16_plain("phi_rbf_fused_cuda"), BF16_GATE)
    print(f"phase 46b flagship N={BF16_PANEL_N} fused_sym=panel "
          f"fused_dot_dtype=bfloat16 {COMPARE_STEPS} steps: ok kernel="
          f"{cuda_phi.SYMPANEL_BF16_KERNEL} launches={json.dumps(counts)} "
          f"ms_per_step={ms:.4f} (host clock, synced); {kept} calls against "
          f"the bf16 plain version: max phi_rel={rel:.3e} max count_diff="
          f"{dcnt} {card} {clock()}")
    out["flagship_panel"] = (counts, cuda_phi.SYMPANEL_BF16_KERNEL,
                             BF16_PANEL_N, 2, ms)

    group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    check(group.backend == "nccl", f"one-rank group on {group.backend!r}")
    for sym in (True, "full", "panel"):
        try:
            build_mvn_svgd(torch.tensor(x0, device=dev), mean, cov,
                           mesh=group, fused_sym=sym, fused_dot_dtype=BF16)
        except ValueError:
            continue
        check(False, f"phase 46b mesh: fused_sym={sym!r} under bf16 ran")
    svgd = build_mvn_svgd(torch.tensor(x0, device=dev), mean, cov,
                          mesh=group, num_iterations=COMPARE_STEPS,
                          fused_dot_dtype=BF16)
    with CallGate(sharded_module, "phi_rbf_fused_cuda_cross") as gate:
        final, counts, ms = steps_run(svgd, COMPARE_STEPS)
    check(bool(final.isfinite().all()) and svgd.fused_sym_form is False,
          "phase 46b mesh bf16")
    require_only(counts, cuda_phi.SQUARE_BF16_KERNEL, COMPARE_STEPS,
                 "phase 46b flagship under a mesh bf16")
    kept, rel, dcnt = gate.held("phase 46b mesh",
                                bf16_plain("phi_rbf_fused_cuda_cross"),
                                BF16_GATE)
    print(f"phase 46b flagship N={n} under a one-rank NCCL mesh "
          f"fused_dot_dtype=bfloat16 {COMPARE_STEPS} steps: ok form=False "
          f"(the cross sweep; forced triangles raise) kernel="
          f"{cuda_phi.SQUARE_BF16_KERNEL} launches={json.dumps(counts)} "
          f"ms_per_step={ms:.4f} (host clock, synced); {kept} calls against "
          f"the bf16 plain version: max phi_rel={rel:.3e} max count_diff="
          f"{dcnt} {card} {clock()}")
    out["mesh"] = (counts, cuda_phi.SQUARE_BF16_KERNEL, n, 2, ms)
    torch.distributed.destroy_process_group()
    return out


def host_f64_median(x):
    """The median of all n^2 pairwise distances of ``x`` (self-zeros
    included) in float64 on the host: the distances by differences
    (torch.cdist without the Gram form) and the reference's median of them
    through the native helper (std::nth_element; NumPy without it)."""
    import torch

    from svgdcpp_tpu_torch.utils.native import host_median

    xh = x.detach().cpu().double()
    d = torch.cdist(xh, xh, compute_mode="donot_use_mm_for_euclid_dist")
    return host_median(d.numpy())


def phase_histogram(dev, card, clock):
    """Phase 38; returns the cuda route's launch counts."""
    import torch

    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.median import pairwise_distance_median
    from svgdcpp_tpu_torch.utils.workloads import blr_workload, flagship_mvn

    _, _, x_flag = flagship_mvn(HIST_N)
    _, _, x_hier = blr_workload(HIST_N, 10, hierarchical=True)
    for name, x0 in (("flagship", x_flag), ("hier", x_hier)):
        x = torch.tensor(x0, dtype=torch.float32, device=dev)
        hist = float(pairwise_distance_median(x, "histogram"))
        exact = float(pairwise_distance_median(x, "exact"))
        ref = host_f64_median(x)
        c = x.double() - x.double().mean(dim=0)
        hi0 = float(4.0 * torch.max(torch.sum(c * c, dim=1)) * (1 + 1e-6))
        bucket = hi0 / 1024**3 / ref  # one final bucket near the median
        rel = {"vs_exact_card": abs(hist - exact) / exact,
               "vs_float64_host": abs(hist - ref) / ref,
               "exact_card_vs_float64_host": abs(exact - ref) / ref}
        check(rel["vs_exact_card"] <= HIST_REL_GATE
              and rel["vs_float64_host"] <= HIST_REL_GATE,
              f"phase 38 {name} histogram median: {rel}")
        ms = {m: time_ms(lambda: pairwise_distance_median(x, m),
                         reps=HIST_REPS, warmup=1)
              for m in ("histogram", "exact")}
        print(f"phase 38 histogram median {name} N={HIST_N} m={x.shape[1]}: "
              f"ok histogram={hist:.9g} exact_card={exact:.9g} "
              f"float64_host={ref:.9g} rel_diff={json.dumps(rel)} "
              f"(gate {HIST_REL_GATE:g}; one final bucket {bucket:.3g}) "
              f"histogram_ms={ms['histogram']:.4f} exact_ms={ms['exact']:.4f} "
              f"(median of {HIST_REPS}) {card} {clock()}")
        del x, c

    mean, cov, x0 = flagship_mvn(HIST_ROUTE_N)
    runs = {}
    for method in ("histogram", "exact"):
        x = torch.tensor(x0, dtype=torch.float32, device=dev)
        model = st.MultivariateNormal(torch.tensor(mean).float(),
                                      torch.tensor(cov).float())
        kernel = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN, model,
                                      median_method=method)
        svgd = st.SVGD(st.SVGDOptions(
            dimension=2, num_iterations=HIST_ROUTE_STEPS,
            coordinate_matrix=x.clone(), kernel=kernel, model=model,
            optimizer=st.AdaGrad(2, HIST_ROUTE_N, 0.1),
            phi_impl="cuda")).initialize()
        cuda_phi.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = svgd.run()
        end.record()
        end.synchronize()
        counts = dict(cuda_phi.launch_counts)
        check(bool(out.isfinite().all()), f"phase 38 cuda {method}: bad output")
        require_only(counts, cuda_phi.PHI_RBF_KERNEL, HIST_ROUTE_STEPS,
                     f"phase 38 cuda route, median_method={method!r}")
        runs[method] = (out.double(), counts,
                        start.elapsed_time(end) / HIST_ROUTE_STEPS)
    diff = float((runs["histogram"][0] - runs["exact"][0]).abs().max())
    check(diff <= 1e-3, f"phase 38 cuda route histogram vs exact: {diff:.3e}")
    print(f"phase 38 MEDIAN cuda n={HIST_ROUTE_N} m=2 {HIST_ROUTE_STEPS} iters "
          f"median_method='histogram': ok coords_max_abs_diff_vs_exact="
          f"{diff:.3e} histogram_ms_per_step={runs['histogram'][2]:.4f} "
          f"exact_ms_per_step={runs['exact'][2]:.4f} (CUDA events) "
          f"launches={json.dumps(runs['histogram'][1])} {card} {clock()}")
    return runs["histogram"][1]


def phase_adapter(dev, card, clock):
    """Phase 39; returns {path: launch counts} of the adapter's runs."""
    import torch

    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

    launches = {}
    for name, (n, d, hier) in ADAPTER_PATHS.items():
        kernel = (cuda_phi.TERMS_SYM_KERNEL if hier
                  else cuda_phi.SQUARE_KERNEL)
        feats, labels, x0 = blr_workload(n, d, hierarchical=hier)
        runs = {}
        for opt_name in ("TorchOptimizer(torch.optim.Adam)", "Adam"):
            m = x0.shape[1]
            opt = (st.TorchOptimizer(torch.optim.Adam, m, n, lr=ADAPTER_LR)
                   if opt_name != "Adam"
                   else st.Adam(m, n, ADAPTER_LR, 0.9, 0.999))
            svgd = build_blr_svgd(torch.tensor(x0, device=dev), feats, labels,
                                  hierarchical=hier,
                                  num_iterations=ADAPTER_STEPS, optimizer=opt)
            cuda_phi.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = svgd.run()
            end.record()
            end.synchronize()
            counts = dict(cuda_phi.launch_counts)
            check(bool(out.isfinite().all()),
                  f"phase 39 {name} {opt_name}: bad output")
            require_only(counts, kernel, ADAPTER_STEPS,
                         f"phase 39 {name} {opt_name}")
            runs[opt_name] = (out.double(), counts,
                              start.elapsed_time(end) / ADAPTER_STEPS,
                              svgd._phi_impl)
        (a, ca, ms_a, route), (b, _, ms_b, _) = runs.values()
        diff = float((a - b).abs().max())
        check(diff <= 1e-3, f"phase 39 {name}: adapter {diff:.3e} from Adam")
        launches[name] = ca
        print(f"phase 39 {name} N={n} m={x0.shape[1]} route={route} "
              f"{ADAPTER_STEPS} steps: ok TorchOptimizer(torch.optim.Adam, "
              f"lr={ADAPTER_LR}) vs Adam({ADAPTER_LR}) coords_max_abs_diff="
              f"{diff:.3e} adapter_ms_per_step={ms_a:.4f} adam_ms_per_step="
              f"{ms_b:.4f} adapter_host_overhead_ms_per_step="
              f"{ms_a - ms_b:.4f} (CUDA events over the run) launches="
              f"{json.dumps(ca)} {card} {clock()}")
    return launches


def phase_profiling(dev, card, clock, k2_ms):
    """Phase 40; returns step_timer's launch counts."""
    from pathlib import Path

    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils.profiling import (
        speed_of_light,
        step_timer,
        trace,
    )
    from svgdcpp_tpu_torch.utils.workloads import flagship_mvn

    mean, cov, x0 = flagship_mvn(TIMER_N)
    svgd = make_svgd(st, x0, mean, cov, 1)
    check(svgd._phi_impl == "fused_cuda" and svgd.fused_sym_form is True,
          f"phase 40 flagship on {svgd._phi_impl!r} {svgd.fused_sym_form!r}")

    def step(state):
        return svgd._step_fn(state)[0]

    cuda_phi.reset_launch_counts()
    timing = step_timer(step, svgd.make_state(), steps=TIMER_STEPS,
                        warmup=TIMER_WARMUP, chunk=TIMER_CHUNK)
    counts = dict(cuda_phi.launch_counts)
    require_only(counts, cuda_phi.SYM_KERNEL, TIMER_WARMUP + TIMER_STEPS,
                 "phase 40 step_timer on the flagship")
    trace_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_trace"
    state = svgd.make_state()
    with trace(str(trace_dir)) as log_dir:
        for _ in range(TRACE_STEPS):
            state = step(state)
    events = json.loads((Path(log_dir) / "trace.json").read_text())[
        "traceEvents"]
    k2_events = [e for e in events if e.get("cat") == "kernel"
                 and "fused_phi_counts_sym_kernel" in e.get("name", "")]
    check(len(k2_events) == TRACE_STEPS,
          f"phase 40 trace: {len(k2_events)} K2 kernel events, want "
          f"{TRACE_STEPS}")
    k2_us = sum(float(e["dur"]) for e in k2_events) / max(1, len(k2_events))
    sol_ms = speed_of_light(TIMER_N, 2) * 1e3
    bound_ms = sweep_bound(cuda_phi.SYM_KERNEL, TIMER_N, 2)[0]
    check(sol_ms == bound_ms,
          f"speed_of_light {sol_ms} != K2's bound {bound_ms}")
    print(f"phase 40 profiling: step_timer flagship N={TIMER_N} "
          f"({TIMER_WARMUP} warm-up, {TIMER_STEPS} steps in chunks of "
          f"{TIMER_CHUNK}, CUDA events): ok mean_ms={timing.mean_s * 1e3:.4f} "
          f"p50_ms={timing.p50_s * 1e3:.4f} p90_ms={timing.p90_s * 1e3:.4f} "
          f"steps_per_s={timing.steps_per_s:.6g}; trace {TRACE_STEPS} steps "
          f"-> {Path(log_dir).name}/trace.json, {len(k2_events)} K2 events "
          f"(fused_phi_counts_sym_kernel) of {k2_us:.2f} us each; "
          f"speed_of_light({TIMER_N}, 2) = {sol_ms:.6g} ms = K2's bound, "
          f"K2 wrapper {k2_ms:.4f} ms ({k2_ms / sol_ms:.3g}x) {card} "
          f"{clock()}")
    return counts


def phase_native(dev, card, clock):
    """Phase 41; returns the cuda route's launch counts."""
    import numpy as np
    import torch

    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils import native
    from svgdcpp_tpu_torch.utils.workloads import flagship_mvn

    t0 = time.perf_counter()
    check(native.native_available(), "phase 41: the native helpers did not "
          "build (g++ -O3 -std=c++17 -fPIC -shared native/svgd_host.cpp)")
    build_s = time.perf_counter() - t0
    mean, cov, x0 = flagship_mvn(ORACLE_N)
    t0 = time.perf_counter()
    cpp = native.cpp_oracle_mvn_rbf_adagrad(
        x0, mean, np.linalg.inv(cov), gamma=None, lr=0.1, iters=ORACLE_STEPS)
    cpp_s = time.perf_counter() - t0
    x = torch.tensor(x0, dtype=torch.float32, device=dev)
    model = st.MultivariateNormal(torch.tensor(mean).float(),
                                  torch.tensor(cov).float())
    kernel = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN, model,
                                  median_method="exact")
    svgd = st.SVGD(st.SVGDOptions(
        dimension=2, num_iterations=ORACLE_STEPS,
        coordinate_matrix=x.clone(), kernel=kernel, model=model,
        optimizer=st.AdaGrad(2, ORACLE_N, 0.1), phi_impl="cuda")).initialize()
    cuda_phi.reset_launch_counts()
    out = svgd.run()
    torch.cuda.synchronize()
    counts = dict(cuda_phi.launch_counts)
    require_only(counts, cuda_phi.PHI_RBF_KERNEL, ORACLE_STEPS,
                 "phase 41 cuda route against the C++ oracle")
    diff = float(np.abs(out.double().cpu().numpy() - cpp).max())
    moved = float(np.abs(cpp - x0).max())
    check(diff <= 1e-3 and moved > 1e-2,
          f"phase 41: the cuda route is {diff:.3e} from the C++ oracle "
          f"(the oracle moved {moved:.3e})")
    print(f"phase 41 native: C++ oracle (float64, host, exact median every "
          f"step) vs cuda route (K15, float32, median_method='exact') "
          f"n={ORACLE_N} m=2 {ORACLE_STEPS} steps: ok coords_max_abs_diff="
          f"{diff:.3e} (max move {moved:.3e}) oracle_s={cpp_s:.3f} "
          f"native_build_s={build_s:.2f} launches={json.dumps(counts)} "
          f"{card} {clock()}")
    return counts


def phase_examples(dev, card, clock, plain_ms):
    """Phase 42: every examples/torch_*_example.py run() on the card at
    EXAMPLE_ARGS; returns {example: (launch counts, main-path times or
    None)}."""
    import inspect
    from pathlib import Path

    import numpy as np
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.cuda_phi import resolve_sym
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_fused_counts,
        phi_rbf_sym_chunk_counts,
    )

    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import torch_blr_example
    import torch_gmm_example
    import torch_hierarchical_example
    import torch_large_scale_example
    import torch_mvn_example
    import torch_sharded_example

    k16 = cuda_phi.COUNT_KERNEL
    out = {}

    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    def launched(fn):
        cuda_phi.reset_launch_counts()
        t0 = time.perf_counter()
        ret = fn()
        torch.cuda.synchronize()
        return ret, dict(cuda_phi.launch_counts), time.perf_counter() - t0

    def no_sweep(counts, what):
        check(not any(v for k, v in counts.items() if k != k16),
              f"{what}: a sweep kernel launched: {counts}")

    (x0, final, mean, cov), counts, sec = launched(
        lambda: torch_mvn_example.run(**EXAMPLE_ARGS["mvn"]))
    no_sweep(counts, "phase 42 mvn")
    tol = 2.0 * np.sqrt(np.diag(cov) / x0.shape[0])
    err = np.abs(final.mean(axis=0) - mean)
    check(bool(np.all(err < tol))
          and bool(np.all(final.std(axis=0) > 0.3 * np.sqrt(np.diag(cov)))),
          f"phase 42 mvn moments: mean error {err}, tol {tol}")
    print(f"phase 42 example mvn ({x0.shape[0]} particles, dense): ok "
          f"mean={final.mean(axis=0).tolist()} target={mean.tolist()} "
          f"cov={np.cov(final.T).ravel().tolist()} "
          f"target_cov={cov.ravel().tolist()} s={sec:.2f} {clock()}")
    out["mvn"] = (counts, None)

    (x0, final, (m1, _), (m2, _)), counts, sec = launched(
        lambda: torch_gmm_example.run(**EXAMPLE_ARGS["gmm"]))
    no_sweep(counts, "phase 42 gmm")
    near1 = (np.linalg.norm(final - m1, axis=1)
             < np.linalg.norm(final - m2, axis=1))
    c1, c2 = final[near1].mean(axis=0), final[~near1].mean(axis=0)
    check(0 < near1.sum() < len(near1)
          and np.linalg.norm(c1 - m1) < 1.5 and np.linalg.norm(c2 - m2) < 1.5,
          f"phase 42 gmm modes: {near1.sum()} near mode 1, centers {c1} {c2}")
    print(f"phase 42 example gmm ({x0.shape[0]} particles, dense): ok "
          f"mode1 {int(near1.sum())} particles mean={c1.tolist()} "
          f"target={m1.tolist()}; mode2 {int((~near1).sum())} mean="
          f"{c2.tolist()} target={m2.tolist()} s={sec:.2f} {clock()}")
    out["gmm"] = (counts, None)

    iters = default(torch_blr_example.run, "num_iterations")
    (final, agreement, _), counts, sec = launched(
        lambda: torch_blr_example.run(**EXAMPLE_ARGS["blr"]))
    require_only(counts, cuda_phi.SQUARE_KERNEL,
                 EXAMPLE_ARGS["blr"].get("num_iterations", iters),
                 "phase 42 blr example")
    check(agreement > 0.8, f"phase 42 blr agreement {agreement}")
    print(f"phase 42 example blr ({final.shape[0]} particles, d="
          f"{final.shape[1]}, fused_cuda K1): ok label_agreement="
          f"{agreement:.3f} launches={json.dumps(counts)} s={sec:.2f} "
          f"{clock()}")
    out["blr"] = (counts, None)

    (final, agreement, alpha, _), counts, sec = launched(
        lambda: torch_hierarchical_example.run(
            **EXAMPLE_ARGS["hierarchical"]))
    no_sweep(counts, "phase 42 hierarchical")
    check(agreement > 0.8 and np.isfinite(alpha),
          f"phase 42 hierarchical agreement {agreement}, alpha {alpha}")
    print(f"phase 42 example hierarchical ({final.shape[0]} particles, d="
          f"{final.shape[1]}, rbf_terms below CUDA_FUSED_MIN_PARTICLES): ok "
          f"label_agreement={agreement:.3f} posterior_alpha={alpha:.4f} "
          f"launches={json.dumps(counts)} s={sec:.2f} {clock()}")
    out["hierarchical"] = (counts, None)

    n = EXAMPLE_ARGS["large_scale"].get(
        "num_particles", default(torch_large_scale_example.run,
                                 "num_particles"))
    iters = EXAMPLE_ARGS["large_scale"].get(
        "num_iterations", default(torch_large_scale_example.run,
                                  "num_iterations"))
    form = resolve_sym(None, n, 2)
    kernel = {True: cuda_phi.SYM_KERNEL,
              "panel": cuda_phi.SYMPANEL_KERNEL}[form]
    (final, ksd0, ksd1), counts, sec = launched(
        lambda: torch_large_scale_example.run(**EXAMPLE_ARGS["large_scale"]))
    require_only(counts, kernel, 2 * iters, "phase 42 large_scale example")
    check(ksd1 < ksd0, f"phase 42 large_scale KSD {ksd0} -> {ksd1}")
    x, s, g, thr = sweep_inputs(n, 2, 0.0, 420, dev)
    t_large = {"kernel": time_ms(lambda: cuda_phi.phi_rbf_fused_cuda(
                   x, s, g, thr, sym=form), reps=10, warmup=2),
               "plain": plain_ms(lambda: phi_rbf_fused_counts(x, s, g, thr))}
    print(f"phase 42 example large_scale ({n} particles, {iters} iterations "
          f"run twice, {kernel}): ok KSD {ksd0:.4f} -> {ksd1:.4f} mean="
          f"{final.mean(axis=0).tolist()} launches={json.dumps(counts)} "
          f"s={sec:.2f}; {kernel} at ({n}, 2) kernel_ms={t_large['kernel']:.4f}"
          f" plain_ms={t_large['plain']:.4f} {card} {clock()}")
    out["large_scale"] = (counts, t_large, kernel, n)
    del x, s, g, thr

    n = EXAMPLE_ARGS["sharded"].get(
        "num_particles", default(torch_sharded_example.run, "num_particles"))
    iters = EXAMPLE_ARGS["sharded"].get(
        "num_iterations", default(torch_sharded_example.run,
                                  "num_iterations"))
    (x0, final, ksd0, ksd1), counts, sec = launched(
        lambda: torch_sharded_example.run(**EXAMPLE_ARGS["sharded"]))
    require_only(counts, cuda_phi.SYM_CHUNK_KERNEL, iters,
                 "phase 42 sharded example")
    check(ksd1 < 0.5 * ksd0, f"phase 42 sharded KSD {ksd0} -> {ksd1}")
    x, s, g, thr = sweep_inputs(n, 2, 0.0, 421, dev)
    t_shard = {"kernel": time_ms(lambda: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                   x, s, g, thr, 1, 0)),
               "plain": plain_ms(lambda: phi_rbf_sym_chunk_counts(
                   x, s, g, thr, 1, 0))}
    print(f"phase 42 example sharded ({n} particles, {iters} iterations, one "
          f"NCCL rank, K4): ok KSD {ksd0:.4f} -> {ksd1:.4f} mean="
          f"{final.mean(axis=0).tolist()} launches={json.dumps(counts)} "
          f"s={sec:.2f}; K4 at ({n}, 2) world 1 kernel_ms="
          f"{t_shard['kernel']:.4f} plain_ms={t_shard['plain']:.4f} {card} "
          f"{clock()}")
    out["sharded"] = (counts, t_shard, cuda_phi.SYM_CHUNK_KERNEL, n)
    return out


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
        build_mvn_svgd,
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
    # which runs there since the wide sweeps (phase 43): at n = 2048 the
    # card's rule takes K2's wide triangle, never plain torch.
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
        svgd = make_svgd(st, x_w.cpu().numpy(), np.zeros(m), np.eye(m), 3)
        form = cuda_phi.resolve_sym(None, 2048, m)
        check(svgd._phi_impl == "fused_cuda" and svgd.fused_sym_form is form,
              f"auto at m={m} on the card: {svgd._phi_impl!r}, form "
              f"{svgd.fused_sym_form!r}")
        cuda_phi.reset_launch_counts()
        out = svgd.run()
        kernel = cuda_phi.SYM_KERNEL if form else cuda_phi.SQUARE_KERNEL
        require_only(dict(cuda_phi.launch_counts), kernel, 3,
                     f"auto at m={m}, n=2048, 3 steps")
        check(bool(out.isfinite().all()), f"auto at m={m}: non-finite")
        print(f"phase 27 hybrid median n=2048 m={m} (past MAX_M): ok "
              f"k16={med_c:.9g} plain={med_p:.9g} float64_exact={med_x:.9g} "
              f"rel_plain={rel_p:.3e} rel_float64={rel_x:.3e} "
              f"k16_launches={launched}; auto runs {kernel} (form {form}) "
              f"{clock()}")

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
    # The engine's ms a step, printed again beside phase 36's drivers.
    engine_ms = {"flagship": 1e3 * timed_s / (SHARDED_ITERS - seg_len)}
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
    engine_ms["hier"] = 1e3 * timed_s / (SHARDED_ITERS - seg_len)
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
    feats_g31, labels_g31, x0_g31 = blr_workload(GENERIC_SHARDED_N, 10,
                                                 hierarchical=True)
    k16 = cuda_phi.COUNT_KERNEL
    one_rank = {
        "flagship": build_sharded_mvn_svgd(x0, mean, cov, group).run(
            x0, COMPARE_STEPS).double(),
        "hier": build_sharded_hier_svgd(x0_hier, feats_h, labels_h, group).run(
            x0_hier, COMPARE_STEPS).double(),
        "hier_generic": build_sharded_hier_svgd(
            x0_g31, feats_g31, labels_g31, group, fused_phi=False,
            kernel_phi="generic").run(
            x0_g31, GENERIC_SHARDED_STEPS).double(),
        "flagship_ring": build_sharded_mvn_svgd(
            x0, mean, cov, group, fused_phi=False, phi_mode="ring").run(
            x0, COMPARE_STEPS).double(),
        "driver_mesh": build_mvn_svgd(
            x0, mean, cov, num_iterations=COMPARE_STEPS,
            mesh=group).run().double(),
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

    # -- phase 31 (generic): the hierarchical BLR through the generic sweep,
    # two ranks against one (warm group median; no sweep kernel, K16 counts)
    gen31 = {}
    for r in range(2):
        counts = results[r]["hier_generic"][1]
        check(not any(v for k, v in counts.items() if k != k16),
              f"hier_generic rank {r}: a sweep kernel launched: {counts}")
        check(counts[k16] >= GENERIC_SHARDED_STEPS,
              f"hier_generic rank {r}: {counts[k16]} K16 launches")
        check(results[r]["hier_generic"][2] is False,
              f"hier_generic rank {r}: fused_sym "
              f"{results[r]['hier_generic'][2]!r}")
    coords = [torch.tensor(results[r]["hier_generic"][0], device=dev).double()
              for r in range(2)]
    check(bool((coords[0] == coords[1]).all()),
          "hier_generic: the two ranks gathered different coordinates")
    gen31["vs_one_rank"] = float(
        (coords[0] - one_rank["hier_generic"]).abs().max())
    check(gen31["vs_one_rank"] <= 1e-3,
          f"hier_generic two ranks vs one: {gen31['vs_one_rank']:.3e} > 1e-3")
    gen_drv = build_blr_svgd(torch.tensor(x0_g31, device=dev), feats_g31,
                             labels_g31, hierarchical=True,
                             phi_impl="generic",
                             num_iterations=GENERIC_SHARDED_STEPS)
    gen31["vs_driver_generic"] = float(
        (coords[0] - gen_drv.run().double()).abs().max())
    print(f"phase 31 two ranks on one card over gloo, hier N="
          f"{GENERIC_SHARDED_N} kernel_phi=generic {GENERIC_SHARDED_STEPS} "
          f"steps: ok coords_max_abs_diff={json.dumps(gen31)} "
          f"k16_launches_per_rank="
          f"{[results[r]['hier_generic'][1][k16] for r in range(2)]} "
          f"{clock()}")
    del gen_drv

    # -- phase 31 (ring, mesh): the flagship in ring mode, whose blocks
    # rotate between the two ranks, and the flagship driver under
    # SVGDOptions.mesh (auto: the triangle chunk K4 on each rank)
    apart_rm = {}
    for case, kernel, form in (("flagship_ring", None, False),
                               ("driver_mesh", cuda_phi.SYM_CHUNK_KERNEL,
                                "full")):
        coords = [torch.tensor(results[r][case][0], device=dev).double()
                  for r in range(2)]
        check(bool((coords[0] == coords[1]).all()),
              f"{case}: the two ranks gathered different coordinates")
        for r in range(2):
            counts = results[r][case][1]
            check(results[r][case][2] == form,
                  f"{case} rank {r}: form {results[r][case][2]!r}")
            if kernel is None:
                check(not any(v for k, v in counts.items() if k != k16)
                      and counts[k16] >= COMPARE_STEPS,
                      f"{case} rank {r}: launches {counts}")
            else:
                require_only(counts, kernel, COMPARE_STEPS,
                             f"{case} rank {r} of 2")
        apart_rm[case] = float((coords[0] - one_rank[case]).abs().max())
        check(apart_rm[case] <= 1e-3,
              f"{case} two ranks vs one: {apart_rm[case]:.3e} > 1e-3")
    print(f"phase 31 two ranks on one card over gloo, N={SHARDED_N} "
          f"{COMPARE_STEPS} steps, ring mode and the driver under a mesh: ok "
          f"coords_max_abs_diff_vs_one_rank={json.dumps(apart_rm)} "
          f"launches_per_rank="
          f"{json.dumps({c: results[0][c][1] for c in apart_rm})} "
          f"{clock()}")

    # -- phase 31 (uneven): the flagship driver under the two-rank mesh at
    # UNEVEN_N particles, auto on the plain fused sweep, against the
    # meshless 'fused' driver on the card; fused_cuda raises there
    mean_u, cov_u, x0_u = flagship_mvn(UNEVEN_N)
    meshless_u = make_svgd(st, x0_u, mean_u, cov_u, COMPARE_STEPS,
                           phi_impl="fused").run().double()
    coords = [torch.tensor(results[r]["driver_uneven"][0], device=dev).double()
              for r in range(2)]
    check(bool((coords[0] == coords[1]).all()),
          "driver_uneven: the two ranks gathered different coordinates")
    for r in range(2):
        _, counts, route, refused, share = results[r]["driver_uneven"]
        check(route == "fused", f"driver_uneven rank {r}: auto took {route!r}")
        check("duplicates" in refused,
              f"driver_uneven rank {r}: fused_cuda did not raise ({refused!r})")
        check(not any(v for k, v in counts.items() if k != k16),
              f"driver_uneven rank {r}: a sweep kernel launched: {counts}")
    diff_u = float((coords[0] - meshless_u).abs().max())
    check(diff_u <= 1e-3, f"driver_uneven vs the meshless fused driver: "
          f"{diff_u:.3e}")
    print(f"phase 31 two ranks on one card over gloo, the flagship driver "
          f"under a mesh at N={UNEVEN_N} (rows "
          f"{[results[r]['driver_uneven'][4] for r in range(2)]}) "
          f"{COMPARE_STEPS} steps: ok auto='fused' "
          f"coords_max_abs_diff_vs_meshless_fused={diff_u:.3e} fused_cuda "
          f"raises ValueError ({results[0]['driver_uneven'][3][:60]!r}...) "
          f"launches_per_rank="
          f"{json.dumps([results[r]['driver_uneven'][1] for r in range(2)])} "
          f"{clock()}")
    del meshless_u

    # -- phase 32: the generic (autodiff) route at full width ---------------
    from torch.func import vmap

    def timed_steps(svgd, steps, warmup):
        """Run ``steps`` steps of a driver as run() does; ms a step from CUDA
        events over the steps after ``warmup``."""
        state = svgd.make_state()
        for _ in range(warmup):
            state, _ = svgd._step_fn(state)
        torch.cuda.synchronize()
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        for _ in range(steps - warmup):
            state, _ = svgd._step_fn(state)
        t_end.record()
        t_end.synchronize()
        svgd._absorb_state(state)
        return t_start.elapsed_time(t_end) / (steps - warmup)

    def hier_driver(impl, steps):
        return build_blr_svgd(
            torch.tensor(x0_hier, dtype=torch.float32, device=dev), feats_h,
            labels_h, hierarchical=True, phi_impl=impl, num_iterations=steps)

    s_gen = hier_driver("generic", GENERIC_STEPS)
    s_terms = hier_driver("rbf_terms", GENERIC_STEPS)
    check(s_gen._phi_impl == "generic" and s_terms._phi_impl == "rbf_terms",
          f"hier routes {s_gen._phi_impl!r}, {s_terms._phi_impl!r}")
    # The first step's phi on both routes from one state and one scale.
    st0 = s_gen.make_state()
    c0, mp0 = st0["coords"], st0["model_params"]
    scores0 = vmap(lambda x: s_gen.model.grad_log_density_pure(x, mp0))(c0)
    kp0, _ = s_gen._scale_params(c0, mp0, st0["kernel_params"],
                                 st0["scale_aux"], st0["slot_model_params"])
    phi_gen0 = s_gen._phi(c0, scores0, kp0)
    phi_terms0 = s_terms._phi(c0, scores0, kp0)
    phi32_rel = float((phi_gen0 - phi_terms0).abs().max()
                      / phi_terms0.abs().max())
    check(bool(phi_gen0.isfinite().all()), "generic phi: non-finite")
    del st0, c0, scores0, kp0, phi_gen0, phi_terms0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    cuda_phi.reset_launch_counts()
    gen_ms = timed_steps(s_gen, GENERIC_STEPS, GENERIC_WARMUP)
    main_generic = dict(cuda_phi.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(not any(v for k, v in main_generic.items() if k != k16),
          f"generic route launched a sweep kernel: {main_generic}")
    check(main_generic[k16] >= GENERIC_STEPS,
          f"generic route: {main_generic[k16]} K16 launches in "
          f"{GENERIC_STEPS} steps (the slot's same-step median)")
    cuda_phi.reset_launch_counts()
    terms_ms = timed_steps(s_terms, GENERIC_STEPS, GENERIC_WARMUP)
    terms_counts = dict(cuda_phi.launch_counts)
    out_gen, out_terms = s_gen.store.value, s_terms.store.value
    check(bool(out_gen.isfinite().all())
          and tuple(out_gen.shape) == (10000, 11), "generic run: bad output")
    diff32 = float((out_gen.double() - out_terms.double()).abs().max())
    check(diff32 <= 1e-3,
          f"generic vs rbf_terms coords differ by {diff32:.3e} > 1e-3")
    acc32 = blr_accuracy(out_gen.cpu().numpy(), feats_h, labels_h)
    print(f"phase 32 hier N=10000 d=10 generic vs rbf_terms {GENERIC_STEPS} "
          f"steps: ok coords_max_abs_diff={diff32:.3e} "
          f"first_step_phi_rel={phi32_rel:.3e} generic_ms_per_step="
          f"{gen_ms:.4f} rbf_terms_ms_per_step={terms_ms:.4f} "
          f"generic_over_rbf_terms={gen_ms / terms_ms:.3f} (CUDA events, "
          f"steps {GENERIC_WARMUP + 1}-{GENERIC_STEPS}) peak_memory_gib="
          f"{peak_gib:.3f} (allocated before {base_gib:.3f}) "
          f"k16_launches_per_step={main_generic[k16] / GENERIC_STEPS:.3g} "
          f"launches={json.dumps(main_generic)} rbf_terms_launches="
          f"{json.dumps(terms_counts)} train_accuracy={acc32:.4f} "
          f"{card} {clock()}")
    # K16 at this path's shape: the self count at the warm pass's 9 edges.
    thr = count_thresholds(out_gen, out_gen, 9, False)
    times32 = {
        "kernel": time_ms(lambda: cuda_phi.count_le_cuda(out_gen, out_gen,
                                                         thr)),
        "plain": plain_ms(lambda: count_le_plain(out_gen, out_gen, thr)),
    }
    dcnt = int((cuda_phi.count_le_cuda(out_gen, out_gen, thr)
                - count_le_plain(out_gen, out_gen, thr)).abs().max())
    check(dcnt <= 1e-6 * 10000 * 10000,
          f"count (10000, 11) T=9: counts differ by {dcnt}")
    print(f"phase 32 times count self n=10000^2 m=11 T=9 (ms): "
          f"kernel={times32['kernel']:.4f} plain={times32['plain']:.4f} "
          f"bound={sweep_bound(k16, 10000, 11, T=9)[0]:.5f} "
          f"count_diff={dcnt}")
    # KSD of an RBF given as a custom kernel_fn (the autodiff Stein kernel)
    # against the closed form, on the generic run's particles.
    p32 = s_gen.kernel.parameters[0]

    def rbf_fn(x, params, loc):
        d = x - loc
        return torch.exp(-(d @ params[0] @ d))

    ksd32 = {}
    for dtype in (torch.float64, torch.float32):
        xk = out_gen.to(dtype)
        pk = p32.to(device=dev, dtype=dtype)
        custom = st.Kernel(11, rbf_fn, (pk,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generic_val = float(ksd_rbf(s_gen.model, xk, kernel=custom,
                                    row_tile=64))
        torch.cuda.synchronize()
        ksd_s = time.perf_counter() - t0
        closed_val = float(ksd_rbf(s_gen.model, xk, p_matrix=pk))
        ksd32[str(dtype).split(".")[1]] = {
            "generic": generic_val, "closed": closed_val,
            "rel": abs(generic_val - closed_val) / abs(closed_val),
            "generic_s": round(ksd_s, 3)}
    check(ksd32["float64"]["rel"] <= 1e-4,
          f"generic KSD vs closed form rel {ksd32['float64']['rel']:.3e}")
    print(f"phase 32 ksd_rbf(kernel=custom RBF) through ksd_squared_generic "
          f"on the generic run's particles: ok {json.dumps(ksd32)}")
    del s_terms, out_terms
    # A kernel of the user's own that flatten_rbf_terms cannot flatten:
    # RBF(median) + an inverse-multiquadric leaf, on the flat BLR.
    xb = torch.tensor(x0_blr, dtype=torch.float32, device=dev)
    model_b = st.BayesianLogisticRegression(feats, labels, 0.1)

    def imq(x, params, loc):
        d = x - loc
        return 1.0 / torch.sqrt(1.0 + params[0] * (d @ d))

    kernel_b = st.GaussianRBFKernel(xb, st.ScaleMethod.MEDIAN, model_b) + (
        st.Kernel(50, imq, (np.asarray(0.1),)))
    s_imq = st.SVGD(st.SVGDOptions(
        dimension=50, num_iterations=IMQ_STEPS, coordinate_matrix=xb,
        kernel=kernel_b, model=model_b,
        optimizer=st.Adam(50, 1000, 5e-2, 0.9, 0.999))).initialize()
    check(s_imq._phi_impl == "generic",
          f"auto took {s_imq._phi_impl!r} for the custom kernel")
    cuda_phi.reset_launch_counts()
    imq_ms = timed_steps(s_imq, IMQ_STEPS, GENERIC_WARMUP)
    imq_counts = dict(cuda_phi.launch_counts)
    out = s_imq.store.value
    check(bool(out.isfinite().all()) and tuple(out.shape) == (1000, 50),
          "custom kernel run: bad output")
    check(not any(v for k, v in imq_counts.items() if k != k16)
          and imq_counts[k16] >= IMQ_STEPS,
          f"custom kernel run launches {imq_counts}")
    acc = blr_accuracy(out.cpu().numpy(), feats, labels)
    check(acc > 0.5, f"custom kernel training accuracy {acc:.4f} <= 0.5")
    print(f"phase 32 flat BLR N=1000 d=50 RBF(median) + IMQ leaf, auto -> "
          f"generic, {IMQ_STEPS} steps: ok ms_per_step={imq_ms:.4f} "
          f"launches={json.dumps(imq_counts)} train_accuracy={acc:.4f} "
          f"{clock()}")
    del s_imq, s_gen

    # -- phase 33: the debug dump on the card -------------------------------
    import tempfile
    from pathlib import Path

    from svgdcpp_tpu_torch.kernels.gaussian_rbf import (
        rbf_kernel_fn,
        scale_from_median,
    )
    from svgdcpp_tpu_torch.ops.median import pairwise_distance_median_exact
    from svgdcpp_tpu_torch.ops.phi import kernel_matrix_and_grad
    from svgdcpp_tpu_torch.parallel import ShardedSVGD, ShardedSVGDConfig
    from svgdcpp_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from svgdcpp_tpu_torch.utils.logging import write_intermediate_matrices

    repo = Path(__file__).resolve().parent
    mean_d, cov_d, x0_d = flagship_mvn(DUMP_N)
    xd = torch.tensor(x0_d, dtype=torch.float32, device=dev)

    def dump_error(logs, x_first):
        """max |K - K64|, |G - G64| over the steps against float64 K and
        grad-K recomputed on the CPU from each step's coordinates and the
        exact median's scale."""
        prev = x_first.double().cpu()
        err_k = err_g = 0.0
        for t in range(logs["kernel"].shape[0]):
            med = pairwise_distance_median_exact(prev)
            p = scale_from_median(med, DUMP_N, 2, torch.float64)
            k64, g64 = kernel_matrix_and_grad(prev, rbf_kernel_fn, (p,))
            err_k = max(err_k, float(np.abs(logs["kernel"][t]
                                            - k64.numpy()).max()))
            err_g = max(err_g, float(np.abs(logs["kernel_grad"][t]
                                            - g64.numpy()).max()))
            prev = torch.from_numpy(np.asarray(logs["coords"][t])).double()
        return err_k, err_g

    with tempfile.TemporaryDirectory(dir=repo) as tmp:
        path = Path(tmp) / "driver.txt"
        model_d = st.MultivariateNormal(mean_d, cov_d)
        drv = st.SVGD(st.SVGDOptions(
            dimension=2, num_iterations=DUMP_STEPS, coordinate_matrix=xd,
            kernel=st.GaussianRBFKernel(xd, st.ScaleMethod.MEDIAN, model_d),
            model=model_d, optimizer=st.AdaGrad(2, DUMP_N, 0.1),
            log_intermediate_matrices=True,
            intermediate_matrices_output_path=str(path))).initialize()
        check(drv._phi_impl == "generic", f"dump route {drv._phi_impl!r}")
        drv.run()
        logs = drv._intermediate_logs
        check(logs["kernel"].shape == (DUMP_STEPS, DUMP_N, DUMP_N)
              and logs["kernel_grad"].shape == (DUMP_STEPS, DUMP_N, DUMP_N, 2),
              f"dump shapes {[v.shape for v in logs.values()]}")
        err_k, err_g = dump_error(logs, xd)
        check(max(err_k, err_g) <= 1e-5,
              f"dump K err {err_k:.3e}, grad-K err {err_g:.3e} > 1e-5")
        write_intermediate_matrices(str(Path(tmp) / "again.txt"), logs)
        check(path.read_bytes() == (Path(tmp) / "again.txt").read_bytes(),
              "the driver's dump is not the writer's text of its stacks")
        print(f"phase 33 debug dump n={DUMP_N} m=2 {DUMP_STEPS} steps, "
              f"driver: ok k_max_abs_err={err_k:.3e} "
              f"grad_k_max_abs_err={err_g:.3e} (float64 on the CPU) "
              f"file_bytes={path.stat().st_size} equal to the writer's")
        # The engine on a one-rank NCCL group, gather mode, a near-exact
        # group median (4 passes of 1024 bins).
        group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
        check(group.backend == "nccl", f"one-rank group on {group.backend!r}")
        path = Path(tmp) / "engine.txt"
        eng = ShardedSVGD(
            st.MultivariateNormal(mean_d, cov_d), st.AdaGrad(2, DUMP_N, 0.1),
            DUMP_N, 2, mesh=group, config=ShardedSVGDConfig(
                median_bins=1024, median_passes=4, warm_start=False,
                log_intermediate_matrices=True,
                intermediate_matrices_output_path=str(path)))
        eng.run(xd, DUMP_STEPS)
        logs = eng.intermediate_logs
        err_k, err_g = dump_error(logs, xd)
        check(max(err_k, err_g) <= 1e-5,
              f"engine dump K err {err_k:.3e}, grad-K err {err_g:.3e}")
        write_intermediate_matrices(str(Path(tmp) / "again.txt"), logs)
        check(path.read_bytes() == (Path(tmp) / "again.txt").read_bytes(),
              "the engine's dump is not the writer's text of its stacks")
        print(f"phase 33 debug dump n={DUMP_N} m=2 {DUMP_STEPS} steps, "
              f"engine on one NCCL rank (gather): ok k_max_abs_err="
              f"{err_k:.3e} grad_k_max_abs_err={err_g:.3e}")

        # -- phase 34: checkpoints on the card ------------------------------
        mean_c, cov_c, x0_c = flagship_mvn(CKPT_N)
        x0_c = x0_c.astype(np.float32)
        cuda_phi.reset_launch_counts()
        full = make_svgd(st, x0_c, mean_c, cov_c, CKPT_STEPS,
                         phi_impl="fused_cuda")
        check(full.fused_sym_form is False,
              f"n={CKPT_N} resolved fused_sym {full.fused_sym_form!r}")
        want = full.run().clone()
        half = CKPT_STEPS // 2
        first = make_svgd(st, x0_c, mean_c, cov_c, half, phi_impl="fused_cuda")
        first.run()
        save_checkpoint(Path(tmp) / "driver", first.make_state(), step=half)
        second = make_svgd(st, x0_c, mean_c, cov_c, CKPT_STEPS - half,
                           phi_impl="fused_cuda")
        restored, step = restore_checkpoint(Path(tmp) / "driver",
                                            second.make_state())
        check(step == half and restored["iteration"] == half,
              f"restored step {step}, iteration {restored['iteration']}")
        second._absorb_state(restored)
        got = second.run()
        ckpt_counts = dict(cuda_phi.launch_counts)
        require_only(ckpt_counts, cuda_phi.SQUARE_KERNEL, 2 * CKPT_STEPS,
                     "checkpoint runs")
        check(torch.equal(got, want),
              f"driver resumed run differs by "
              f"{float((got - want).abs().max()):.3e}")
        print(f"phase 34 checkpoint flagship n={CKPT_N} fused_cuda (K1): "
              f"{CKPT_STEPS} steps against {half} + save + restore + "
              f"{CKPT_STEPS - half}: ok equal bit for bit "
              f"launches={json.dumps(ckpt_counts)}")
        # The sharded flagship on its cross form (K1: fused_sym=False; the
        # triangle chunk kernel adds columns with float atomics, so its
        # runs are not bit-reproducible).
        def sharded_flagship():
            return build_sharded_mvn_svgd(x0, mean, cov, group,
                                          fused_sym=False)

        cuda_phi.reset_launch_counts()
        eng = sharded_flagship()
        check(eng._fused_cuda and eng._fused_sym is False,
              f"sharded checkpoint case fused_sym {eng._fused_sym!r}")
        want = eng.run(x0, SHARDED_CKPT_STEPS)
        half = SHARDED_CKPT_STEPS // 2
        eng = sharded_flagship()
        state = eng.run_state(eng.init_state(x0), half)
        save_checkpoint(Path(tmp) / "engine", state, step=half)
        eng = sharded_flagship()
        restored, step = restore_checkpoint(Path(tmp) / "engine",
                                            eng.init_state(x0))
        got = group.all_gather_rows(
            eng.run_state(restored, SHARDED_CKPT_STEPS - half)["coords"])
        shard_ckpt_counts = dict(cuda_phi.launch_counts)
        require_only(shard_ckpt_counts, cuda_phi.SQUARE_KERNEL,
                     2 * SHARDED_CKPT_STEPS, "sharded checkpoint runs",
                     count_launches=2)
        check(torch.equal(got, want),
              f"sharded resumed run differs by "
              f"{float((got - want).abs().max()):.3e}")
        print(f"phase 34 checkpoint sharded flagship N={SHARDED_N} one NCCL "
              f"rank, cross form (K1): {SHARDED_CKPT_STEPS} steps against "
              f"{half} + save + restore + {SHARDED_CKPT_STEPS - half}: ok "
              f"equal bit for bit launches={json.dumps(shard_ckpt_counts)} "
              f"{clock()}")
        del eng, state, restored, got, want
        torch.distributed.destroy_process_group()

    # -- phase 35: BinomialLikelihood on the card ---------------------------
    trials, successes = np.array([200.0, 100.0]), np.array([60.0, 85.0])
    mle = successes / trials
    xb = torch.tensor(np.random.default_rng(35).uniform(
        0.05, 0.95, (BINOMIAL_N, 2)), dtype=torch.float32, device=dev)
    model_b = st.BinomialLikelihood(trials, successes)
    svgd = st.SVGD(st.SVGDOptions(
        dimension=2, num_iterations=BINOMIAL_STEPS, coordinate_matrix=xb,
        kernel=st.GaussianRBFKernel(xb, st.ScaleMethod.MEDIAN, model_b),
        model=model_b, optimizer=st.Adam(2, BINOMIAL_N, 0.005, 0.9, 0.999),
        lower_bound=np.array([1e-3, 1e-3]),
        upper_bound=np.array([1.0 - 1e-3, 1.0 - 1e-3]))).initialize()
    check(svgd._phi_impl == "fused_cuda" and svgd.fused_sym_form is True,
          f"binomial route {svgd._phi_impl!r} form {svgd.fused_sym_form!r}")
    cuda_phi.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = svgd.run()
    torch.cuda.synchronize()
    binom_s = time.perf_counter() - t0
    binom_counts = dict(cuda_phi.launch_counts)
    require_only(binom_counts, cuda_phi.SYM_KERNEL, BINOMIAL_STEPS,
                 f"binomial, {BINOMIAL_STEPS} steps")
    out = out.double().cpu().numpy()
    check(bool(np.isfinite(out).all()) and (out > 0).all()
          and (out < 1).all(), "binomial run left the unit box")
    sd = np.sqrt(mle * (1 - mle) / trials)
    mean_err = np.abs(out.mean(axis=0) - mle) / sd
    check(bool(np.all(mean_err < 4)),
          f"binomial particle mean {out.mean(axis=0)} not within 4 sd of "
          f"the MLE {mle}")
    print(f"phase 35 BinomialLikelihood N={BINOMIAL_N} unit box, Adam 0.005, "
          f"{BINOMIAL_STEPS} steps, fused_cuda (K2): ok "
          f"mean={out.mean(axis=0).tolist()} mle={mle.tolist()} "
          f"err_over_sd={mean_err.tolist()} launches="
          f"{json.dumps(binom_counts)} fallbacks={svgd.median_fallbacks} "
          f"run_s={binom_s:.3f} {clock()}")

    # -- phase 36: the driver under SVGDOptions.mesh on one NCCL rank -------
    group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    check(group.backend == "nccl", f"one-rank group on {group.backend!r}")
    mean36, cov36, x36 = flagship_mvn(SHARDED_N)
    x36 = x36.astype(np.float32)
    feats36, labels36, xb36 = blr_workload(1000, 50)
    drivers36 = (
        # name, builder, kernel under the mesh and its form, meshless kernel
        ("flagship", lambda mesh: build_mvn_svgd(
            torch.tensor(x36, device=dev), mean36, cov36,
            num_iterations=COMPARE_STEPS, mesh=mesh),
         cuda_phi.SYM_CHUNK_KERNEL, "full", cuda_phi.SYM_KERNEL),
        ("hier", lambda mesh: build_blr_svgd(
            torch.tensor(x0_hier, device=dev), feats_h, labels_h,
            hierarchical=True, num_iterations=COMPARE_STEPS, mesh=mesh),
         cuda_phi.TERMS_SYM_CHUNK_KERNEL, "full", cuda_phi.TERMS_SYM_KERNEL),
        ("flat_blr", lambda mesh: build_blr_svgd(
            torch.tensor(xb36, device=dev), feats36, labels36,
            num_iterations=COMPARE_STEPS, mesh=mesh),
         cuda_phi.SQUARE_KERNEL, False, cuda_phi.SQUARE_KERNEL),
    )
    main36 = {}
    for name, make, kernel, form, meshless_kernel in drivers36:
        meshed = make(group)
        check(meshed.fused_sym_form == form,
              f"phase 36 {name}: {meshed._phi_impl!r} form "
              f"{meshed.fused_sym_form!r}, want {form!r}")
        cuda_phi.reset_launch_counts()
        mesh_ms = timed_steps(meshed, COMPARE_STEPS, GENERIC_WARMUP)
        main36[name] = dict(cuda_phi.launch_counts)
        require_only(main36[name], kernel, COMPARE_STEPS,
                     f"phase 36 {name} under a mesh")
        meshless = make(None)
        cuda_phi.reset_launch_counts()
        meshless_ms = timed_steps(meshless, COMPARE_STEPS, GENERIC_WARMUP)
        meshless_counts = dict(cuda_phi.launch_counts)
        require_only(meshless_counts, meshless_kernel, COMPARE_STEPS,
                     f"phase 36 {name} without a mesh")
        got, want = meshed.store.value, meshless.store.value
        check(bool(got.isfinite().all()) and got.shape == want.shape,
              f"phase 36 {name}: bad output")
        diff = float((got.double() - want.double()).abs().max())
        check(diff <= 1e-3, f"phase 36 {name}: the driver under a mesh is "
              f"{diff:.3e} from the meshless driver")
        engine = (f"{engine_ms[name]:.4f} (phase {29 if name == 'flagship' else 30})"
                  if name in engine_ms else "not run")
        print(f"phase 36 {name} driver under SVGDOptions.mesh, one NCCL rank, "
              f"N={got.shape[0]} m={got.shape[1]} {meshed._phi_impl} "
              f"form={form!r}, {COMPARE_STEPS} steps: ok "
              f"coords_max_abs_diff_vs_meshless={diff:.3e} mesh_ms_per_step="
              f"{mesh_ms:.4f} meshless_ms_per_step={meshless_ms:.4f} "
              f"engine_ms_per_step={engine} (CUDA events, steps "
              f"{GENERIC_WARMUP + 1}-{COMPARE_STEPS}) "
              f"{kernel}_launches_per_step="
              f"{main36[name][kernel] / COMPARE_STEPS:.3g} launches="
              f"{json.dumps(main36[name])} meshless_launches="
              f"{json.dumps(meshless_counts)} {card} {clock()}")
        del meshed, meshless, got, want

    # -- phase 37: the ring schedule on one NCCL rank -----------------------
    def timed_run(eng, x):
        """(gathered coords, ms a step from CUDA events after the warm-up
        steps) of COMPARE_STEPS steps of an engine from x."""
        state = eng.run_state(eng.init_state(x), GENERIC_WARMUP)
        torch.cuda.synchronize()
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        state = eng.run_state(state, COMPARE_STEPS - GENERIC_WARMUP)
        t_end.record()
        t_end.synchronize()
        return (group.all_gather_rows(state["coords"]),
                t_start.elapsed_time(t_end) / (COMPARE_STEPS - GENERIC_WARMUP))

    ring37 = {}
    for name, make, x in (
        ("flagship", lambda **c: build_sharded_mvn_svgd(
            x36, mean36, cov36, group, fused_phi=False, **c), x36),
        ("hier", lambda **c: build_sharded_hier_svgd(
            x0_hier, feats_h, labels_h, group, fused_phi=False, **c),
         x0_hier),
    ):
        eng = make(phi_mode="ring")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30
        cuda_phi.reset_launch_counts()
        ring_out, ring_ms = timed_run(eng, x)
        counts = dict(cuda_phi.launch_counts)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(not any(v for k, v in counts.items() if k != k16)
              and counts[k16] >= COMPARE_STEPS,
              f"phase 37 {name} ring launches {counts}")
        gather_out, gather_ms = timed_run(make(), x)
        check(bool(ring_out.isfinite().all())
              and ring_out.shape == gather_out.shape,
              f"phase 37 {name}: bad output")
        diff = float((ring_out.double() - gather_out.double()).abs().max())
        check(diff <= 1e-3, f"phase 37 {name}: ring is {diff:.3e} from "
              "gather mode")
        # K16 at this path's shape: the self count at the warm pass's 9
        # edges (one rank: every ring count pass is a self count).
        thr = count_thresholds(ring_out, ring_out, 9, False)
        t37 = {"kernel": time_ms(lambda: cuda_phi.count_le_cuda(
                   ring_out, ring_out, thr)),
               "plain": plain_ms(lambda: count_le_plain(ring_out, ring_out,
                                                        thr))}
        n37, m37 = ring_out.shape
        ring37[name] = {"n": n37, "m": m37, "launches": counts[k16],
                        "times": t37}
        tile_gib = eng.config.row_tile * n37 * 4 / 2**30
        print(f"phase 37 {name} ring schedule (phi_mode='ring', warm median) "
              f"one NCCL rank, N={n37} m={m37}, {COMPARE_STEPS} steps: ok "
              f"coords_max_abs_diff_vs_gather={diff:.3e} ring_ms_per_step="
              f"{ring_ms:.4f} gather_ms_per_step={gather_ms:.4f} (CUDA "
              f"events, steps {GENERIC_WARMUP + 1}-{COMPARE_STEPS}) "
              f"peak_memory_gib={peak_gib:.4f} (allocated before "
              f"{base_gib:.4f}; one (row_tile, n_loc) float32 tile "
              f"{tile_gib:.4f}) k16_launches_per_step="
              f"{counts[k16] / COMPARE_STEPS:.3g} launches="
              f"{json.dumps(counts)} k16 self T=9 kernel_ms="
              f"{t37['kernel']:.4f} plain_ms={t37['plain']:.4f} {card} "
              f"{clock()}")
        del eng, ring_out, gather_out
    torch.distributed.destroy_process_group()

    # -- phases 38-42: the utilities and the examples -----------------------
    main38 = phase_histogram(dev, card, clock)
    main39 = phase_adapter(dev, card, clock)
    main40 = phase_profiling(dev, card, clock, times[10000]["sym"])
    main41 = phase_native(dev, card, clock)
    main42 = phase_examples(dev, card, clock, plain_ms)

    # -- phase 43: the wide sweeps (m > 64) -----------------------------------
    wide_errs, _ = phase_wide_kernels(dev, card, clock, ptxas)
    phase_wide_square(dev, card, clock, ptxas, wide_errs)
    phase_wide_edges(dev, card, clock, ptxas, wide_errs)
    times43 = phase_wide_rule(dev, card, clock, plain_ms, wide_errs)
    main43 = phase_wide_paths(dev, card, clock)

    # -- phase 44: K14 and K15 past m = 64 ------------------------------------
    wide_p_errs = phase_wide_p_kernels(dev, card, clock, ptxas)
    phase_wide_p_edges(dev, card, clock, ptxas, wide_p_errs)
    times44 = phase_wide_p_shapes(dev, card, clock, plain_ms, wide_p_errs)
    main44 = phase_wide_p_paths(dev, card, clock)

    # -- phase 45: the panel sweeps past m = 64 -------------------------------
    panel_errs, times45 = phase_wide_panels(dev, card, clock, ptxas,
                                            plain_ms)
    phase_wide_panel_edges(dev, card, clock, ptxas, panel_errs)
    main45 = phase_wide_panel_paths(dev, card, clock)

    # -- phase 46: the bfloat16 operand opt-in --------------------------------
    bf16_errs, times46, launched46 = phase_bf16_kernels(dev, card, clock,
                                                        ptxas, plain_ms)
    main46 = phase_bf16_paths(dev, card, clock)

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
                       times9[("square", 1000, 50)]),
             # the flat BLR driver under a one-rank mesh: the cross form
             # at the same shape
             main_path(36, sq, 1000, 50, main36["flat_blr"][sq],
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
                       times28[("sym_chunk", 10000, 2)]),
             main_path(36, k4, SHARDED_N, 2, main36["flagship"][k4],
                       times28[("sym_chunk", 10000, 2)])],
        k10: [main_path(30, k10, SHARDED_N, 11, main_shard_hier[k10],
                        times28[("terms_sym_chunk", 10000, 11)], n_iso=2),
              main_path(36, k10, SHARDED_N, 11, main36["hier"][k10],
                        times28[("terms_sym_chunk", 10000, 11)], n_iso=2)],
        k5: [main_path(30, k5, PATH_A_N, 2, main_shard_panel[k5],
                       times28[("sympanel_chunk", PATH_A_N, 2)])],
        # The median seed and the fallbacks of path A (the seed's set-up
        # at N = 262,144, then 1,048,576; self counts), and the sharded
        # engine's seed (local rows against the gathered sources), timed at
        # the hybrid's 17 edges.
        k16: [main_path(22, k16, PATH_A_N, 2, main_panel[k16],
                        times28[("count", PATH_A_N, 2)], T=17),
              # the adaptive slot's same-step (warm) median on the generic
              # route: the self count at the warm pass's 9 edges
              main_path(32, k16, 10000, 11, main_generic[k16], times32,
                        T=9),
              main_path(22, k16, PATH_A_SHORT_N, 2, main_panel_1m[k16],
                        times28[("count", PATH_A_SHORT_N, 2)], T=17),
              main_path(29, k16, SHARDED_N, 2, main_shard[k16],
                        times28[("count_cross", 10000, 2)], T=17,
                        n_c=SHARDED_N)]
        # the ring schedule's count passes (phase 37), at the warm pass's
        # 9 edges
        + [main_path(37, k16, r["n"], r["m"], r["launches"], r["times"], T=9)
           for r in ring37.values()],
    }
    # Phases 38-42's paths: the histogram median on the cuda route, the
    # torch.optim adapter (K1's flat BLR, the hier bench's triangle), the
    # flagship under step_timer, the cuda route beside the C++ oracle and
    # the examples (the large-scale and sharded ones at their own shapes).
    k15_1500 = times16[("phi_rbf", 1500, 2)]
    paths[k15] += [main_path(38, k15, HIST_ROUTE_N, 2, main38[k15], k15_1500),
                   main_path(41, k15, ORACLE_N, 2, main41[k15], k15_1500)]
    paths[sq] += [main_path(39, sq, 1000, 50, main39["flat_blr"][sq],
                            times9[("square", 1000, 50)]),
                  main_path(42, sq, 1000, 50, main42["blr"][0][sq],
                            times9[("square", 1000, 50)])]
    paths[t_sym].append(main_path(39, t_sym, 10000, 11, main39["hier"][t_sym],
                                  times9[("terms_sym", 10000, 11)], n_iso=2))
    paths[sym].append(main_path(40, sym, TIMER_N, 2, main40[sym], k2_10k))
    for name in ("large_scale", "sharded"):
        counts, t42, kernel, n42 = main42[name]
        paths[kernel].append(main_path(42, kernel, n42, 2, counts[kernel],
                                       t42))
    # Phase 43's paths at a9a's width: K1 at the flat BLR's N = 1000, the
    # form the card's rule picks at N = 10,000 (flat and hierarchical BLR),
    # the engine's chunks; timed in phase 43b.
    # The square kernels' tensor-core bounds are printed with their other
    # paths' below; the triangles' here.
    for counts, kernel, n43, m43 in main43.values():
        single = kernel in (sq, sym, k4)
        path = main_path(43, kernel, n43, m43, counts[kernel],
                         times43[(kernel, n43, m43)],
                         **({} if single else {"n_iso": 2}))
        paths[kernel].append(path)
        if kernel in (sq, t_sq):
            continue
        tensor_ms, tensor_by = wide_bounds(kernel, n43, m43,
                                           None if single else (1, 1))[1]
        print(f"{kernel} phase 43 n={n43} m={m43}: bound_ms="
              f"{path['bound_ms']:.6g} ({path['bound_by']}, FP32), on the "
              f"TF32 tensor cores {tensor_ms:.6g} ({tensor_by})")
    for path in paths[k16]:
        path["bound_all_pairs_ms"] = count_bound_all_pairs(
            path["n"], path["m"], 9 if path["phase"] in (32, 37) else 17)[0]
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
    # Phase 44's paths: K14's wide groups (the anisotropic MVN, iso + 1
    # anisotropic term) and K15's wide sweep (HESSIAN) at (10240, 123),
    # timed in phase 44b; their tensor-core bounds beside the FP32 ones.
    k14w, k15w = cuda_phi.ANISO_WIDE_KERNEL, cuda_phi.PHI_RBF_WIDE_KERNEL
    for name, (counts, kernel, n44, m44) in main44.items():
        work = {"n_iso": 1, "n_aniso": 1} if kernel == k14w else {}
        path = main_path(44, kernel, n44, m44, counts[kernel],
                         times44[kernel], **work)
        path["kernel_us"] = times44[kernel]["kernel_us"]
        if kernel == k14w:
            path["rbf_terms_ms"] = times44[kernel]["rbf_terms"]
            tensor = tri_tensor_bound(n44, m44, n_terms=1, n_aniso=1)
        else:
            tensor = tri_tensor_bound(n44, m44, fixed_p=True)
        path["tensor_bound_ms"] = tensor[0]
        paths[kernel] = [path]
        print(f"{kernel} phase 44 {name} n={n44} m={m44}: bound_ms="
              f"{path['bound_ms']:.6g} ({path['bound_by']}, FP32), on the "
              f"TF32 tensor cores {tensor[0]:.6g} ({tensor[1]})")
    # Phase 45's paths: the panels' wide instances at a9a's width, forced
    # (fused_sym="panel"), timed in phase 45a beside the wide triangles.
    for counts, kernel, n45, m45, ms45 in main45.values():
        n_iso = 2 if kernel == t_sp else 1
        path = main_path(45, kernel, n45, m45, counts[kernel],
                         times45[(kernel, n45, m45)], n_iso=n_iso)
        path["kernel_us"] = times45[(kernel, n45, m45)]["kernel_us"]
        path["ms_per_step"] = ms45
        tensor = tri_tensor_bound(n45, m45,
                                  n_terms=2 if kernel == t_sp else None)
        path["tensor_bound_ms"] = tensor[0]
        path["body"] = "svgdcpp_tpu_torch/csrc/wide_tri_sm90.cuh"
        paths[kernel].append(path)
    # Phase 46's paths: the bf16 instances (K15's has no driver route, as
    # in the JAX package: its launches are phase 46a's own calls).
    sq16, sym16 = cuda_phi.SQUARE_BF16_KERNEL, cuda_phi.SYM_BF16_KERNEL
    sp16, k15_16 = (cuda_phi.SYMPANEL_BF16_KERNEL,
                    cuda_phi.PHI_RBF_WIDE_BF16_KERNEL)
    for name in ("flat_blr", "mesh", "flagship", "flagship_panel"):
        counts, kernel, n46, m46, ms46 = main46[name]
        path = main_path(46, kernel, n46, m46, counts[kernel],
                         times46[(kernel, n46, m46)])
        path["ms_per_step"] = ms46
        path["tensor_bound_ms"] = bf16_bounds(kernel, n46, m46)[1][0]
        paths.setdefault(kernel, []).append(path)
    t15 = times46[(k15_16, 10240, WIDE_D)]
    paths[k15_16] = [main_path(46, k15_16, 10240, WIDE_D, launched46[k15_16],
                               t15)]
    paths[k15_16][0]["tensor_bound_ms"] = bf16_bounds(k15_16, 10240,
                                                      WIDE_D)[1][0]
    paths[k15_16][0]["launches_from"] = (
        "phase 46a's direct calls of phi_rbf_cuda(..., dot_dtype="
        "'bfloat16'): no driver route passes the option to K15")
    # The decomposition beside K15 on the HESSIAN path, one launch a step.
    eig_bound = eigen_bound(11)
    paths[eig] = [{"phase": 18, "n": 10240, "m": 11,
                   "launches": main_k15[eig],
                   "ms": times16[("sym_eigen", 11)]["kernel"],
                   "plain_ms": times16[("sym_eigen", 11)]["plain"],
                   "bound_ms": eig_bound[0], "bound_by": eig_bound[1]}]

    def entry(name, source, replaces, tpu, err, library_ms=None, body=None):
        first = paths[name][0]
        extra = {"body": f"svgdcpp_tpu_torch/csrc/{body}"} if body else {}
        return {"name": name, "route": "cuda",
                "source": f"svgdcpp_tpu_torch/csrc/{source}", **extra,
                "replaces": replaces, "tpu_kernels": tpu,
                "launches": first["launches"],
                "max_abs_err": err, "ms": first["ms"],
                "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                "bound_by": first["bound_by"], "library_ms": library_ms,
                "main_paths": paths[name]}

    # The widened kernels' errors include phase 43a's.
    square_err = max(square_err, wide_errs[sq])
    sym_err = max(sym_err, wide_errs[sym])
    terms_sq_err = max(terms_sq_err, wide_errs[t_sq])
    terms_sym_err = max(terms_sym_err, wide_errs[t_sym])
    sym_chunk_err = max(sym_chunk_err, wide_errs[k4])
    terms_chunk_err = max(terms_chunk_err, wide_errs[k10])
    # The panels' errors include phase 45a's (their wide instances).
    sympanel_err = max(sympanel_err, panel_errs[sp])
    terms_panel_err = max(terms_panel_err, panel_errs[t_sp])
    panel_chunk_err = max(panel_chunk_err, panel_errs[k5])
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
        # The wide instances past m = 64 (phase 44): K14's groups and
        # K15's sweep on wide_tri_sm90.cuh's body.
        entry(k14w, "fused_phi_aniso.cu", f"{pallas}:3205", ["K14"],
              wide_p_errs[k14w], body="wide_tri_sm90.cuh"),
        entry(k15w, "phi_rbf.cu", f"{pallas}:116", ["K15"],
              wide_p_errs[k15w], body="wide_tri_sm90.cuh"),
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
        # The bfloat16 opt-in's instances (phase 46; the error against
        # their bf16 plain versions).
        entry(sq16, "fused_phi.cu", f"{pallas}:365", ["K1"],
              bf16_errs[sq16], body="square_bf16_sm90.cuh"),
        entry(sym16, "fused_phi.cu", f"{pallas}:546", ["K2"],
              bf16_errs[sym16], body="bf16_tri_sm90.cuh"),
        entry(sp16, "fused_phi_panel.cu", f"{pallas}:860", ["K3"],
              bf16_errs[sp16], body="bf16_tri_sm90.cuh"),
        entry(k15_16, "phi_rbf.cu", f"{pallas}:116", ["K15"],
              bf16_errs[k15_16], body="bf16_tri_sm90.cuh"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
