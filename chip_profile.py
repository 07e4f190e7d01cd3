#!/usr/bin/env python3
"""Where the time of a step goes, on one CUDA GPU.

    python3 chip_profile.py [--config mvn|large|hier|generic|blr|aniso|hessian|sharded|count|wide]
                            [--particles N] [--large] [--crossover] [--sass]
                            [--sweeps] [--out PATH]
    python3 chip_profile.py --square-crossover [--forced] [--out PATH]
    python3 chip_profile.py --wide-drift [--out PATH]
    python3 chip_profile.py --wide-breakdown [--out PATH]
    python3 chip_profile.py --bf16 [--out PATH]
    python3 chip_profile.py --float32-check [--out PATH]
    python3 chip_profile.py --aniso-wide [--out PATH]
    python3 chip_profile.py --square-wide [--out PATH]
    python3 chip_profile.py --square-wide-breakdown [--out PATH]
    python3 chip_profile.py --square-bf16 [--out PATH]
    python3 chip_profile.py --wide-panel [--out PATH]
    python3 chip_profile.py --mid-width [PARENT_DIR] [--out PATH]
    python3 chip_profile.py --mid-p PARENT_DIR [--out PATH]
    python3 chip_profile.py --mid-panel PARENT_DIR [--out PATH]
    python3 chip_profile.py --micro-groups PARENT_DIR [--out PATH]

Drives one configuration of svgdcpp_tpu_torch at its full width:

  * ``mvn`` (default): the flagship, MVN d=2, N=10000, RBF with the median
    bandwidth, AdaGrad lr 0.1, route ``fused_cuda`` (triangle kernel);
  * ``large``: the same at N=262144 (path A of the large-N paths,
    utils/workloads.large_mvn_workload), where the route runs the panel
    triangle kernel;
  * ``hier``: hierarchical BLR, d=10 (m=11), N=10000, median RBF + 0.1 I,
    Adam lr 5e-2, route ``fused_terms_cuda`` (terms triangle kernel; with
    ``--particles 131072``, path B, the terms panel kernel);
  * ``generic``: the same hierarchical BLR on the generic route
    (``phi_impl='generic'``, a torch.func VJP per target over row tiles;
    no sweep kernel, so the profiler table shows where its step goes),
    with fewer steps (about 0.6 s a step);
  * ``blr``: flat BLR, d=50, N=1000, median RBF, Adam lr 5e-2, route
    ``fused_cuda`` (square kernel at m=50);
  * ``aniso``: scripts/check_aniso_posterior.py's configuration, MVN d=11,
    N=10240, median RBF + RBF with a full constant P, AdaGrad lr 0.05,
    route ``fused_aniso_terms_cuda`` (the anisotropic terms kernel); then
    that kernel's wrapper with one anisotropic term at m = 2 to 64
    (``aniso_widths``);
  * ``hessian``: the same target with one RBF whose scale is the HESSIAN
    one, route ``cuda`` (the fixed-P square kernel);
  * ``sharded``: the flagship on the sharded engine (examples/
    sharded_example.py's configuration, utils/workloads.
    build_sharded_mvn_svgd) on a one-rank NCCL group, N=10000: the
    triangle's chunk kernel (K4's port), the gathers and sums of the group,
    the same lag-1 median; its sections (``ShardedSVGD.section_hook``)
    add the gather of the coordinates;
  * ``wide``: two cells at a9a's width, one after the other: flat BLR at
    d = 123 (``fused_cuda``; the card's rule takes K2's triangle at
    N = 10,000) and hierarchical BLR at d = 123, m = 124
    (``fused_terms_cuda``, K8/K9's triangle), N = 10,000, the bench's
    models and constants on ``utils/workloads.blr_workload``'s synthetic
    data; each cell's numbers below, and the sweep's share of the busy
    time (``sweep_share_of_busy``);
  * ``count``: no driver's step, only the count kernel (K16's port) at the
    median seed's shapes and path A's set-up at N=1048576 (``count_pass``;
    with ``--sass``, its instances' loops too). Run from an older tree
    with this script copied in, it times that tree's kernel the same way.

``--particles`` sets N for ``mvn``, ``hier`` and ``sharded``; the sweep
kernel read is the one of the form the driver resolved
(``SVGD.fused_sym_form``, ``ShardedSVGD._fused_sym``). From
100000 particles up the step counts below drop to 5 (warm-up), 30 (host),
5 (profiled) and 30 (sections), since a step takes 0.1 s or more. It
prints:

  * host ms/step: CUDA events around 200 unprofiled steps (``run()``), after
    a 20-step warm-up;
  * the device timeline of 20 steps under ``torch.profiler``: device busy
    us/step, the union of the intervals of every kernel, memcpy and memset
    on the card (overlaps counted once), and the idle share,
    ``1 - busy / span``, where span runs from the first device event's start
    to the last one's end. Both come from the trace's device clock, so the
    profiler's host overhead widens the span, not the busy time; hence also
    ``device_idle_share_of_step``, ``1 - busy / (host ms/step)`` against
    the unprofiled step. Also the device events per step, and the sweep
    kernel's us per call;
  * sections of the driver's own step (``SVGD.section_hook``), each ended
    by ``torch.cuda.synchronize()`` and timed on the host clock over 200
    steps: scores, plan, sweep, median post-processing, optimizer
    (``hessian``: scores, scale, sweep, optimizer); each includes one
    synchronize.

With ``--large`` (mvn only) it also runs the triangle kernel once at
n = 100000 and
n = 1000000 (m=2, three thresholds, after one warm-up call, CUDA events)
against the plain torch sweep on the same inputs (host clock; it takes
about a minute at n = 1000000): phi's max |diff| / max |phi| and the count
difference.

With ``--crossover`` it also times the full-width triangle kernels
against the panel kernels on a ladder of n: K2 against K3's port at m = 2
(one RBF) from n = 10000 to 262144 and at m = 5 (the runtime-m instance)
at n = 262144, and the terms triangle kernel against the terms panel
kernel at m = 11 with two terms (the hierarchical BLR's shape) from
n = 16384 to 262144, and the terms kernels' other instances: m = 11 at
T = 8 (n = 131072) and with three terms (n = 65536), m = 2 (n = 262144)
and m = 5 (n = 131072) with two terms; wrapper ms, median of 5 calls
between CUDA events after one warm-up call, three thresholds unless
stated; and the square kernels at m = 2-50, the body the library picks
for each m, K1 at n = 1000 and the terms square kernel (K6/K7's port) at
n = 1500 with two terms (``square_crossover``: kernel-only us of the sweep
and its finishing pass).

``--square-crossover`` runs ``square_crossover`` alone, with no driver;
with ``--forced`` it also times each body at every m: it copies the
package into ``_verify/forced_<min_m>/`` (git-ignored) with the least
tensor-core width kSquareTensorMinM forced to 65 (the CUDA cores at every
m, with the instances that needs) and to 1 (the tensor cores at every m)
(``forced_copy``), and runs ``square_crossover`` in each copy, which builds
its own library.

``--wide-breakdown`` runs ``wide_breakdown`` alone, with no driver
profile: where the wide triangle bodies' time goes. Each variant rewrites
a copy of csrc/ under ``_verify/wide_breakdown/`` (git-ignored; no switch
in the sources) to take one part out (the flush's atomics, the
contraction, its mma, the Gram tile's mma, ...), builds a small harness
of the body on one RBF (and two terms) with nvcc, and times it with CUDA
events: ``wide_pair_body`` over tiles of 64 (the design K2's wide
instance had before ``wide_tri_sm90.cuh``; its header, deleted from the
package, is ``WIDE_TRI_PARENT_HEADER``, which ``parent_csrc`` writes into
each copy as ``wide_tri.cuh``) at (10000,
123) and ``wide_tri_sm90.cuh``'s body at (10000, 124), the width the
wrappers hand it for m = 123. Then the new body at m = 33, 50 and 64 (run at the padded
widths 36, 52, 64) beside the library's K2 and K8/K9 at those m, which
run the narrower instances: where the new body should begin; and
``mma.sync``'s own TF32 rate (m16n8k8 products from registers at 8, 16
and 32 warps an SM), the floor of both bodies (default output
``chiprun_out/wide_breakdown.json``).

``--bf16`` runs ``bf16_breakdown`` alone, with no driver profile: K2's
and K3's bfloat16 instances on the parent's design (``wide_pair_body``
with kBf16, the body those instances ran before ``bf16_tri_sm90.cuh``) and
on the new body, each variant built from a copy of csrc/ under
``_verify/bf16_breakdown/`` with one part taken out (``WIDE_PAIR_VARIANTS``
and ``BF16_VARIANTS``): both bodies' parts at (10000, 2) and (10000, 123)
for K2, (32768, 2) and (10000, 123) for K3; both on a ladder of m at
n = 4096; the pack kernel alone; bf16 ``mma.sync``'s own rate; then, in
the package's library, the bf16 instances beside the float32 K2 at
(10000, 2) and the float32 wide triangle at (10000, 123), kernel-only
(default output ``chiprun_out/bf16_breakdown.json``; the card's name and
power limit first and last).

``--float32-check`` runs ``float32_check`` alone: the float32 instances at
their main-path shapes, kernel-only, through wrappers older trees have
too, so that this script, copied into an older tree's archive, times it
the same way in the same call.

``--square-bf16`` runs ``square_bf16`` alone: K1's bfloat16 instance
(square and cross) on the package's body (``square_bf16_sm90.cuh``)
against the parent's (``square_wide_body`` with kBf16, built from
``SQUARE_WIDE_PARENT_SOURCE`` in a copy under ``_verify/square_bf16/``)
and the float32 instance, kernel-only (the sweep and the finishing pass
apart) and through the wrapper, with both results'
distance from the bf16 and float32 plain versions and each build's
registers and spill (default output ``chiprun_out/square_bf16.json``).

``--wide-panel`` runs ``wide_panel`` alone: the panels' float32 wide
instances (K3, K12/K13, K5's chunks) on the package's body
(``wide_tri_sm90.cuh``, the panel list's tile pairs into the triangle's
accumulator) against the parent's design (``wide_pair_body`` on 64 x 64
tile pairs of a panel into per-panel windows, built from a copy under
``_verify/wide_panel/``), kernel-only and through the wrapper, each beside
the wide triangle at the same shape, and the triangle's order against the
panels' at (131072, 123) (default output ``chiprun_out/wide_panel.json``).

``--fixed-p-wide`` runs ``fixed_p_wide`` alone: K15's float32 wide
instance (``wide_tri_sm90.cuh`` with the FixedPGram form) and its bf16
instance (``bf16_tri_sm90.cuh`` with kAsym) against the parent's design
(``wide_pair_body``, built from ``FIXED_P_WIDE_PARENT_SOURCE`` in a copy
under ``_verify/fixed_p_wide/``), kernel-only (the bf16 pack counted;
parent, new, new, parent) and through the wrapper, each result's
distance from its plain version, at (10240 / 10000 / 10007, 123), (4096,
65 / 123 / 256 / 512) and, for bf16, (1500, 2); beside them K2's float32 wide and bf16
instances at the same shapes; and both builds' registers and spill
(default output ``chiprun_out/fixed_p_wide.json``).

``--mid-width [PARENT_DIR]`` runs ``mid_width`` alone: the float32
triangles K2 (T = 3) and K8/K9 (two and three terms) at n = 10,000 and
the mid widths m = 9, 10, 12-64 (``MID_WIDTH_MS``, with 65 beside them),
kernel-only and through the wrapper, in the tree PARENT_DIR (a
``git archive`` of the parent commit, which builds its own csrc/) and in
this one, one process each, parent, change, change, parent; each call's
distance from the float64 plain version, each build's triangle instances'
registers and spill, and each width's change/parent ratio; without
PARENT_DIR only this tree's forms. Then, in this tree, the forms at
``MID_FORM_SHAPES`` (``mid_width_forms``): the triangle against the square
form, and the panel where the JAX rule picks it, one RBF and two terms,
kernel-only (default output ``chiprun_out/mid_width.json``).

``--mid-p PARENT_DIR`` runs ``mid_p`` alone: K15 (P positive definite
with its decomposition given; an indefinite P decomposed by the parent on
the card each call) and K14 (iso + 1, iso + 2, 0 + 1 on the route the
tree picks, and iso + 1 with the term groups forced) at n = 10,240 and
m = 9, 10, 12-64 (``MID_P_MS``, with m = 11 and 65 as controls), then
K14's one-pass ladder (the one-pass kernel against the wide groups for
one anisotropic term at m = 9-32, n = 2048, 10,240 and 32,768), in the
tree PARENT_DIR (a ``git archive`` of the parent commit) and in this one,
one process each, parent, change, change, parent: kernel-only us (every
event of the port's kernels a call, sym_eigen and K16 included) and
wrapper ms, each call's distance from float64 and each tree's K14 and
K15 instances' registers and spill (default output
``chiprun_out/mid_p.json``).

``--mid-panel PARENT_DIR`` runs ``mid_panel`` alone: K3 (T = 3), K5 at
world 1 and K12/K13 (two terms) with the panel forced at n = 10,000 and
32,768 and m = 9, 10, 11, 12, 16, 17, 32, 33, 54 and 64 (``MID_PANEL_MS``),
m = 11 also at n = 65,536 and 131,072, then the d = 11 switch (K3's panel
against K2's full-width triangle at m = 11, n = 32,768 to 262,144,
``MID_PANEL_SWITCH_NS``), in the tree PARENT_DIR (a ``git archive`` of
the parent commit, which builds its own csrc/) and in this one, one
process each, parent, change, change, parent: kernel-only us and wrapper
ms, each call's distance from float64 at n = 10,000 and each build's panel
instances' registers and spill (default output
``chiprun_out/mid_panel.json``).

``--micro-groups PARENT_DIR`` runs ``micro_groups`` alone: K14's term
groups at m = 2, 5, 8 and 11 (``MICRO_GROUPS_MS``) and n = 2048, 10,240
and 32,768 for iso + 2, iso + 3, iso + 7, 0 + 2 and two isotropic terms
+ 2, and iso + 1 with the groups forced against the one-pass kernel, in
the tree PARENT_DIR (a ``git archive`` of the parent commit, which builds
its own csrc/) and in this one, one process each, parent, change, change,
parent: kernel-only us (every event of K14's and K16's kernels a call)
and wrapper ms, each call's distance from float64 at n = 2048 and each
build's K14 instances' registers and spill; then, in this tree, the
groups with group 0 inside the anisotropic groups' launch
(``MICRO_GROUPS_COMBINED_SOURCE``) against the package's two launches
(default output ``chiprun_out/micro_groups.json``).

``--wide-drift`` runs ``wide_drift`` alone, with no driver profile: how
far the float32 routes move from float64 at d = 123 and N = 10,000 in
chip_smoke.py phase 43c's steps, step by step with each step's median,
every sweep call of the float64 run replayed in float32 through the plain
version and the kernel, and phase 43c's engine gates across seeds
(default output ``chiprun_out/wide_drift.json``).

With ``--sweeps`` it also times the single-RBF triangle kernel
(``fused_phi_counts_sym``, K2's port) at n = 10000, m = 2, T = 3, with the
largest |phi| difference of two calls on one input and of two 20-step runs
of the flagship's kernel route from one x0 (the float32 atomics'
run-to-run floor), its chunk kernel (K4's port) at world 1 and each rank
of world 2, and the square kernel (K1's port) at the flat BLR's (1000, 50)
and at (1500, 2) beside the plain version's ms, and the terms square
kernel (K6/K7's port, two terms) at the hierarchical BLR's (1500, 11), at
(1500, 2) and at (1000, 50) beside its plain version's; then the terms triangle
kernel (``fused_phi_terms_sym``, K8/K9's port) at n = 10000, two terms, T = 3,
at m = 5, 11, 16, 32 and 50, and at m = 11 the terms panel kernel forced
on the same inputs and the chunk kernel (K10/K11's port) at world 1 and
each rank of world 2; then the fixed-P kernel (K15's port) as the
``cuda`` route calls it, at the HESSIAN P of the d = 11 target at
n = 10240 (decomposed in the wrapper) and at a median's gamma I at
n = 1500, m = 2 (decomposition given); the wide triangles at their main
paths' shapes, K2 and K4 (world 1) at (10000, 123) and K8/K9 and K10/K11
(world 1) at (10000, 124) with two terms; and the wide instances past
m = 64 at chip_smoke.py phase 43a's shapes (``wide_cases``: K1 square and
cross, the terms square kernel, K2, the terms triangle and the chunk
kernels at worlds 1 and 2, m = 65, 123, 256 and 512), and K14's wide
term groups and K15's wide sweep at phase 44a's shapes (``wide_p_cases``)
and at the paths' (10240, 123) beside their float32 plain versions; the
panels' wide instances (K3, K12/K13, K5's chunks at worlds 1 and 2) at
chip_smoke.py phase 45a's shapes (``wide_panel_cases``) beside the wide
triangle at the same shape; and the bfloat16 instances (K1 square and
cross, K2, K3, K15) at phase 46a's shapes (``bf16_cases``) beside the
float32 instance and the bf16 plain version at the same shape:
wrapper ms (median of 20 calls between CUDA events after 3 warm-up
calls) and kernel-only us
(the profiler's events of the kernel over 10 calls). Run from an older
tree with this script copied in, it times that tree's kernels the same
way.

With ``--sass`` it also reads the machine code of the panel kernels'
instances that paths A and B launch (one RBF at m = 2, exact, T = 3; the
terms kernel at m = 11, exact, T = 3, two terms; in a tree without the
compile-time T or term count, the exact instance of that m), of the
other sweeps' main-path instances and of the count kernel's (K16's port;
SASS_INSTANCES) with ``cuobjdump --dump-sass``
from the built library, and prints every loop of each (each backward
branch): its instructions, how many of them are FP32 arithmetic,
special-function (MUFU), compares and selects, integer, shared-memory,
shuffle, global, barrier, branch and tensor-core (HMMA) instructions, and
where the loop
evaluates the function, its pairs (MUFU over the terms; for the count
kernel, FP32 instructions over those of one pair's sq) and instructions a
pair. The listing goes to ``chiprun_out/panel_sass.txt``.

The JSON summary goes to ``--out`` (default
``chiprun_out/profile[_<config>].json``). Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


#: The device functions of a launch counter where they differ from its
#: name: K15's wrapper runs the triangle kernel phi_rbf_sym at m = 1-8 and
#: 11 and the square one above.
TRACE_NAMES = {"phi_rbf_square": ("phi_rbf_square", "phi_rbf_sym")}


def device_timeline(trace_path, steps, sweep_name):
    """Busy us/step, idle share, device events/step and the sweep kernel's
    mean us per call from a chrome trace of ``steps`` steps."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    dev = [
        ev for ev in events
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    ]
    if not dev:
        raise RuntimeError("the profiler recorded no device events")
    spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])) for ev in dev]
    busy = union_us(spans)
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    sweep = [float(ev["dur"]) for ev in dev
             if sweep_name is not None
             and any(name + "_kernel" in ev.get("name", "")
                     for name in TRACE_NAMES.get(sweep_name, (sweep_name,)))]
    return {
        "device_busy_us_per_step": busy / steps,
        "device_span_us_per_step": span / steps,
        "device_idle_share": 1.0 - busy / span,
        "device_events_per_step": len(dev) / steps,
        "sweep_kernel": sweep_name,
        "sweep_kernel_calls": len(sweep),
        "sweep_kernel_us_per_call": sum(sweep) / len(sweep) if sweep else None,
    }


class ShardedRunner:
    """A ShardedSVGD driven as the profile drives SVGD: ``run()`` takes
    ``num_iterations`` steps from the engine's current state."""

    def __init__(self, engine, x0):
        self.engine = engine
        self.num_iterations = 1
        self.num_particles = engine.num_particles
        self.fused_sym_form = engine._fused_sym
        engine._state = engine.init_state(x0)

    @property
    def median_fallbacks(self):
        return self.engine.median_fallbacks

    @property
    def section_hook(self):
        return self.engine.section_hook

    @section_hook.setter
    def section_hook(self, hook):
        self.engine.section_hook = hook

    def run(self):
        self.engine.run_state(self.engine._state, self.num_iterations)


def make_driver(st, config, iters, particles=None):
    """(driver, the name of its sweep kernel's device function, without
    ``_kernel``) for ``config`` at full width, with ``particles`` particles
    where given (mvn, hier and sharded)."""
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils.workloads import (
        LARGE_MVN_PARTICLES,
        aniso_mvn_workload,
        blr_workload,
        build_aniso_svgd,
        build_blr_svgd,
    )

    if config == "sharded":
        import numpy as np

        from chip_smoke import free_port
        from svgdcpp_tpu_torch.parallel import initialize_distributed
        from svgdcpp_tpu_torch.utils.workloads import (
            build_sharded_mvn_svgd,
            flagship_mvn,
        )

        group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0)
        mean, cov, x0 = flagship_mvn(particles or 10000)
        x0 = x0.astype(np.float32)
        runner = ShardedRunner(build_sharded_mvn_svgd(x0, mean, cov, group),
                               x0)
        kernel = {"full": cuda_phi.SYM_CHUNK_KERNEL,
                  "panel": cuda_phi.SYMPANEL_CHUNK_KERNEL,
                  False: cuda_phi.SQUARE_KERNEL}[runner.fused_sym_form]
        return runner, kernel
    if config in ("aniso", "hessian"):
        mean, cov, x0, p_aniso = aniso_mvn_workload(10240)
        hessian = config == "hessian"
        svgd = build_aniso_svgd(
            torch.tensor(x0, device="cuda"), mean, cov, p_aniso,
            phi_impl="cuda" if hessian else "auto", num_iterations=iters,
            kernel_scale=st.ScaleMethod.HESSIAN if hessian else None,
        )
        route, kernel = (
            ("cuda", cuda_phi.PHI_RBF_KERNEL) if hessian
            else ("fused_aniso_terms_cuda", cuda_phi.ANISO_KERNEL)
        )
    elif config in ("mvn", "large"):
        from chip_smoke import make_svgd
        from svgdcpp_tpu_torch.utils.workloads import flagship_mvn

        n = LARGE_MVN_PARTICLES if config == "large" else (particles or 10000)
        mean, cov, x0 = flagship_mvn(n)
        svgd = make_svgd(st, x0, mean, cov, iters)
        route = "fused_cuda"
        kernel = {"panel": cuda_phi.SYMPANEL_KERNEL, True: cuda_phi.SYM_KERNEL,
                  False: cuda_phi.SQUARE_KERNEL}[svgd.fused_sym_form]
    elif config in WIDE_CELLS:
        from chip_smoke import WIDE_BIG_N, WIDE_D

        hier = config == "wide_hier"
        feats, labels, x0 = blr_workload(particles or WIDE_BIG_N, WIDE_D,
                                         hierarchical=hier)
        svgd = build_blr_svgd(torch.tensor(x0, device="cuda"), feats, labels,
                              hierarchical=hier, num_iterations=iters)
        route = "fused_terms_cuda" if hier else "fused_cuda"
        kernel = {
            "panel": cuda_phi.TERMS_SYMPANEL_KERNEL if hier
            else cuda_phi.SYMPANEL_KERNEL,
            True: cuda_phi.TERMS_SYM_KERNEL if hier else cuda_phi.SYM_KERNEL,
            False: cuda_phi.TERMS_SQUARE_KERNEL if hier
            else cuda_phi.SQUARE_KERNEL,
        }[svgd.fused_sym_form]
    else:
        hier = config in ("hier", "generic")
        n, d = ((particles or 10000), 10) if hier else (1000, 50)
        feats, labels, x0 = blr_workload(n, d, hierarchical=hier)
        svgd = build_blr_svgd(torch.tensor(x0, device="cuda"), feats, labels,
                              hierarchical=hier, num_iterations=iters,
                              phi_impl="generic" if config == "generic"
                              else "auto")
        route, kernel = ("generic", None) if config == "generic" else (
            ("fused_terms_cuda", {
                "panel": cuda_phi.TERMS_SYMPANEL_KERNEL,
                True: cuda_phi.TERMS_SYM_KERNEL,
                False: cuda_phi.TERMS_SQUARE_KERNEL,
            }[svgd.fused_sym_form]) if hier
            else ("fused_cuda", cuda_phi.SQUARE_KERNEL)
        )
    if svgd._phi_impl != route:
        raise RuntimeError(f"{config} routed to {svgd._phi_impl!r}, not {route!r}")
    return svgd, kernel


#: ``--config wide``'s cells: flat BLR at d = 123 and hierarchical BLR at
#: m = 124 (chip_smoke.WIDE_D), N = 10,000 unless --particles says.
WIDE_CELLS = ("wide_blr", "wide_hier")


def profile_cell(st, config, particles):
    """One configuration's step profile (the module's docstring): host ms a
    step, the device timeline of a profiled window, the sweep's share of
    the busy time, the driver's sections and the profiler's table."""
    import torch

    svgd, sweep_kernel = make_driver(st, config, 1, particles)
    big = svgd.num_particles >= 100_000
    warm, host_steps, steps = (
        (2, 5, 2) if config == "generic"
        else (5, 30, 5) if big else (20, 200, 20))
    result = {"particles": svgd.num_particles, "form": svgd.fused_sym_form,
              "steps": {"warm_up": warm, "host": host_steps,
                        "profiled": steps, "sections": host_steps}}
    svgd.num_iterations = warm
    svgd.run()  # warm-up: builds the kernels and fills the allocator
    result["host_ms_per_step"] = host_ms_per_step(svgd, host_steps)

    svgd.num_iterations = steps
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        svgd.run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        result.update(device_timeline(trace, steps, sweep_kernel))
    result["device_idle_share_of_step"] = (
        1.0 - result["device_busy_us_per_step"] / (1e3 * result["host_ms_per_step"])
    )
    if result["sweep_kernel_us_per_call"] is not None:
        result["sweep_share_of_busy"] = (
            result["sweep_kernel_us_per_call"] * result["sweep_kernel_calls"]
            / steps / result["device_busy_us_per_step"])
    result["profiler_table"] = prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=15
    )
    result["sections_ms_per_step"] = sections_ms(svgd, host_steps)
    result["fallbacks"] = svgd.median_fallbacks
    return result


def host_ms_per_step(svgd, steps):
    import torch

    svgd.num_iterations = steps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    svgd.run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def sections_ms(svgd, steps):
    """Host ms/step of each section of the driver's own step (svgd.py,
    build_step_fn), each ended by a synchronize through SVGD.section_hook:
    scores, plan, sweep, median, optimizer on the fused routes; scores,
    scale, sweep, optimizer on the others. Runs ``steps`` steps on
    ``svgd``."""
    import torch

    totals, last = {}, [0.0]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        totals[name] = totals.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    # The driver reads its hook when it builds the step; the sharded engine
    # when it runs one.
    rebuild = hasattr(svgd, "build_step_fn")
    svgd.section_hook = mark
    if rebuild:
        svgd._step_fn = svgd.build_step_fn()
    svgd.num_iterations = steps
    try:
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        svgd.run()
    finally:
        svgd.section_hook = None
        if rebuild:
            svgd._step_fn = svgd.build_step_fn()
    return {name: v / steps for name, v in totals.items()}


def large_n(n, device):
    """The triangle kernel against the plain sweep at one large n."""
    import numpy as np
    import torch

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import phi_rbf_fused_counts

    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(n, 2)), dtype=torch.float32, device=device)
    s = torch.tensor(rng.normal(size=(n, 2)), dtype=torch.float32, device=device)
    i, j = rng.integers(0, n, 4096), rng.integers(0, n, 4096)
    xn = x.cpu().numpy().astype(np.float64)
    sq = np.sum((xn[i] - xn[j]) ** 2, axis=1)
    thr = torch.tensor(np.quantile(sq, [0.25, 0.5, 0.75]), dtype=torch.float32,
                       device=device)
    g = torch.tensor(math.log(n) / float(np.median(sq)), dtype=torch.float32,
                     device=device)
    cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    phi_k, cnt_k = cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)
    end.record()
    end.synchronize()
    kernel_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    phi_p, cnt_p = phi_rbf_fused_counts(x, s, g, thr)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    return {
        "n": n,
        "sym_kernel_ms": kernel_ms,
        "plain_ms_host_clock": plain_ms,
        "phi_rel_err": float((phi_k - phi_p).abs().max() / phi_p.abs().max()),
        "count_diff": int((cnt_k - cnt_p).abs().max()),
        "counts": [int(c) for c in cnt_k.tolist()],
        "finite": bool(phi_k.isfinite().all()),
    }


def count_pass(st, device):
    """The count kernel (K16's port) at the median seed's shapes: one set
    against itself at 262,144 and 1,048,576 points, m = 2, 17 thresholds
    at pair-distance quantiles; wrapper ms (CUDA events, median of 10 and 3
    calls after two warm-up calls) and kernel ms (the profiler's
    count_le_cross_kernel events over 3 calls); at 262,144 also the
    wrapper ms at T = 3, 17 and 32 (the threshold design the kernel takes
    by T, or, in a tree that forces one, that one); then path A's set-up
    at N = 1,048,576, its driver's construction to the end of the median
    seed (host seconds, synchronized), and its count-kernel launches."""
    import numpy as np
    import torch

    from chip_smoke import make_svgd, sweep_inputs, time_ms
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils.workloads import large_mvn_workload

    def quantiles(x, num):
        rng = np.random.default_rng(17)
        n = x.shape[0]
        i, j = rng.integers(0, n, 4096), rng.integers(0, n, 4096)
        sq = ((x[i] - x[j]).double() ** 2).sum(dim=1).cpu().numpy()
        return torch.tensor(np.quantile(sq, np.linspace(0.02, 0.98, num)),
                            dtype=torch.float32, device=device)

    rows = []
    for n, reps in ((262144, 10), (1048576, 3)):
        x = sweep_inputs(n, 2, 0.0, 303, device)[0]
        thr = quantiles(x, 17)
        wrapper_ms = time_ms(lambda: cuda_phi.count_le_cuda(x, x, thr),
                             reps=reps, warmup=2)
        by_t = {}
        if n == 262144:
            for num in (3, 17, 32):
                thr_t = quantiles(x, num)
                by_t[num] = time_ms(
                    lambda: cuda_phi.count_le_cuda(x, x, thr_t), reps=reps,
                    warmup=2)
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(3):
                counts = cuda_phi.count_le_cuda(x, x, thr)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            timeline = device_timeline(trace, 3, "count_le_cross")
        rows.append({"n": n, "m": 2, "T": 17, "wrapper_ms": wrapper_ms,
                     "wrapper_ms_by_T": by_t,
                     "kernel_ms": timeline["sweep_kernel_us_per_call"] / 1e3,
                     "kernel_calls": timeline["sweep_kernel_calls"],
                     "counts": [int(c) for c in counts.tolist()]})
        print(json.dumps(rows[-1]), flush=True)
        del x
    mean, cov, x0 = large_mvn_workload(1048576)
    cuda_phi.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svgd = make_svgd(st, x0, mean, cov, 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    return {"count_self": rows, "init_s_1048576": init_s,
            "init_count_launches":
                cuda_phi.launch_counts[cuda_phi.COUNT_KERNEL],
            "init_form": svgd.fused_sym_form}


def aniso_widths(device):
    """K14's wrapper with one isotropic and one anisotropic term (a full PD
    P, its factor kept, as the driver calls it) at n = 10240 and m = 2, 5,
    11, 16, 32, 50 and 64, T = 3: ms, median of 20 calls between CUDA
    events after 3 warm-up calls. Run from an older tree with this script
    copied in, it times the kernel that tree takes for one term."""
    import numpy as np
    import torch

    from chip_smoke import sweep_inputs, time_ms
    from svgdcpp_tpu_torch.ops import cuda_phi

    rows = []
    for m in (2, 5, 11, 16, 32, 50, 64):
        x, s, g, thr = sweep_inputs(10240, m, 0.0, 400 + m, device)
        a = np.random.default_rng(500 + m).normal(size=(m, m))
        p = g * torch.tensor(0.5 * np.eye(m) + a @ a.T / m,
                             dtype=torch.float32, device=device)
        lowers = cuda_phi.cholesky_factors([p], device)
        ms = time_ms(lambda: cuda_phi.phi_rbf_aniso_terms_fused_cuda(
            x, s, [g], (1.0,), [p], (1.0,), thr, lowers=lowers),
            reps=20, warmup=3)
        rows.append({"n": 10240, "m": m, "wrapper_ms": ms})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def crossover(device):
    """The full-width triangle kernels against the panel kernels on a
    ladder of n (see the module's docstring)."""
    import torch

    from chip_smoke import sweep_inputs, thresholds_of, time_ms
    from svgdcpp_tpu_torch.ops import cuda_phi

    rows = []
    ladder = [(2, None, n, 3) for n in (10000, 16384, 32768, 65536, 131072,
                                        262144)]
    ladder += [(5, None, 262144, 3)]
    ladder += [(11, (1.0, 1.0), n, 3) for n in (16384, 32768, 65536, 131072,
                                                262144)]
    # the terms panel kernel's other instances: T = 8, three terms (a
    # runtime term count), m = 2 and m = 5 (the runtime-m instance)
    ladder += [(11, (1.0, 1.0), 131072, 8), (11, (1.0, 1.0, 0.5), 65536, 3),
               (2, (1.0, 1.0), 262144, 3), (5, (1.0, 1.0), 131072, 3)]
    for m, signs, n, n_t in ladder:
        x, s, g, thr = sweep_inputs(n, m, 0.0, n + m, device)
        thr = thresholds_of(thr, n_t)
        if signs is None:
            def sweep(form):
                return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=form)
        else:
            gs = [g, torch.full_like(g, 0.1), 2.0 * g][:len(signs)]

            def sweep(form):
                return cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                         sym=form)
        full = time_ms(lambda: sweep(True), reps=5, warmup=1)
        panel = time_ms(lambda: sweep("panel"), reps=5, warmup=1)
        rows.append({"n": n, "m": m, "terms": len(signs) if signs else 1,
                     "T": n_t,
                     "full_width_ms": full, "panel_ms": panel,
                     "panel_over_full": panel / full,
                     "jax_form": cuda_phi.resolve_sym(
                         None, n, m, len(signs) if signs else None)})
    return rows + square_crossover(device)


#: The widths square_crossover times.
CROSSOVER_WIDTHS = (2, 3, 4, 5, 6, 8, 11, 16, 32, 50)


def square_crossover(device):
    """The square kernels around the crossing of their two bodies (the
    tensor cores from kSquareTensorMinM = 5): K1 at the flat BLR's
    n = 1000 and the terms kernel at the hierarchical BLR's n = 1500 (two
    terms), kernel-only us of both passes at CROSSOVER_WIDTHS. To time one
    body at every m, run this in a ``forced_copy``."""
    import torch

    from chip_smoke import kernel_us, sweep_inputs
    from svgdcpp_tpu_torch.ops import cuda_phi

    rows = []
    for m in CROSSOVER_WIDTHS:
        x, s, g, thr = sweep_inputs(1000, m, 0.0, 700 + m, device)
        rows.append({"n": 1000, "m": m, "square_us": kernel_us(
            lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False),
            "fused_phi_counts_square")})
        print(json.dumps(rows[-1]), flush=True)
    for m in CROSSOVER_WIDTHS:
        x, s, g, thr = sweep_inputs(1500, m, 0.0, 750 + m, device)
        gs = [g, torch.full_like(g, 0.1)]
        rows.append({"n": 1500, "m": m, "terms": 2, "terms_square_us":
                     kernel_us(lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                         x, s, gs, (1.0, 1.0), thr, sym=False),
                         "fused_phi_terms_square")})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def forced_copy(dest, min_m):
    """A copy of the package and of these scripts at ``dest`` whose square
    sweeps take the tensor-core body from m = ``min_m`` on
    (kSquareTensorMinM in csrc/square_mma.cuh and its Python mirror): at 1
    the tensor cores at every m; at 65 the CUDA cores at every m, with
    CUDA-core instances (SVGD_DISPATCH_SQ_CUDA_CORES) for the widths of
    CROSSOVER_WIDTHS from 5 to min_m - 1."""
    dest = Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "svgdcpp_tpu_torch", dest / "svgdcpp_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("chip_smoke.py", "chip_profile.py"):
        shutil.copy(ROOT / name, dest / name)
    header = dest / "svgdcpp_tpu_torch" / "csrc" / "square_mma.cuh"
    text, hits = re.subn(r"constexpr int kSquareTensorMinM = \d+;",
                         f"constexpr int kSquareTensorMinM = {min_m};",
                         header.read_text())
    extra = "".join(f"    case {m}: LAUNCH({m}); break; \\\n"
                    for m in CROSSOVER_WIDTHS if 4 < m < min_m)
    text, cases = re.subn(r"(    case 4: LAUNCH\(4\); break;\s*\\\n)",
                          lambda hit: hit.group(1) + extra, text)
    if hits != 1 or cases != 1:
        raise RuntimeError(f"forced_copy: {header} has no kSquareTensorMinM "
                           "or CUDA-core dispatch to rewrite")
    header.write_text(text)
    plan = dest / "svgdcpp_tpu_torch" / "ops" / "sym_plan.py"
    plan.write_text(re.sub(r"SQUARE_TENSOR_MIN_M = \d+",
                           f"SQUARE_TENSOR_MIN_M = {min_m}",
                           plan.read_text()))
    return dest


def forced_crossover():
    """square_crossover in a forced_copy at kSquareTensorMinM = 65 (CUDA
    cores) and 1 (tensor cores), each in its own process: {min_m: rows}."""
    out = {}
    for min_m in (65, 1):
        dest = forced_copy(ROOT / "_verify" / f"forced_{min_m}", min_m)
        rows_file = dest / "square_crossover.json"
        subprocess.run([sys.executable, str(dest / "chip_profile.py"),
                        "--square-crossover", "--out", str(rows_file)],
                       check=True, timeout=1200)
        out[min_m] = json.loads(rows_file.read_text())["square_crossover"]
    return out


def sweeps(st, device):
    """K2, K4 and K1 at their main paths' shapes, the terms triangle kernel
    over m, the terms panel and chunk kernels at m = 11, and K15 at its
    main paths' shapes (see the module's docstring)."""
    import torch

    from chip_smoke import (
        WIDE_BIG_N,
        WIDE_D,
        WIDE_P_BIG_N,
        bf16_cases,
        grid_inputs,
        kernel_us,
        make_svgd,
        sweep_inputs,
        time_ms,
        wide_cases,
        wide_p_call,
        wide_p_cases,
        wide_p_ps,
        wide_panel_cases,
    )
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_fused_counts,
        phi_rbf_terms_fused_counts,
    )
    from svgdcpp_tpu_torch.utils.workloads import (
        aniso_mvn_workload,
        flagship_mvn,
    )

    def timed(label, fn, kernel, plain=None, **extra):
        row = {"case": label, **extra,
               "wrapper_ms": time_ms(fn, reps=20, warmup=3),
               "kernel_us": kernel_us(fn, kernel)}
        if plain is not None:
            row["plain_ms"] = time_ms(plain, reps=20, warmup=3)
        print(json.dumps(row), flush=True)
        return row

    rows = []
    # K2 and K4 at the flagship's shape, with the run-to-run distance of
    # two calls on one input (float32 atomics) and of two 20-step runs of
    # the flagship's kernel route from one x0; K1 at the flat BLR's and at
    # n = 1500 (its kernel name covers any pass of its own).
    x, s, g, thr = sweep_inputs(10000, 2, 0.0, 602, device)
    rows.append(timed(
        "sym", lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True),
        "fused_phi_counts_sym_kernel", n=10000, m=2))
    first, second = (cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)[0]
                     for _ in range(2))
    rows[-1]["repeat_max_abs_diff"] = float((first - second).abs().max())
    mean, cov, x0 = flagship_mvn(10000)
    first, second = (make_svgd(st, x0, mean, cov, 20).run() for _ in range(2))
    rows[-1]["route_20_steps_repeat_max_abs_diff"] = float(
        (first - second).abs().max())
    for world, rank in ((1, 0), (2, 0), (2, 1)):
        rows.append(timed(
            "sym_chunk", lambda: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                x, s, g, thr, world, rank),
            "fused_phi_counts_sym_chunk_kernel", n=10000, m=2, world=world,
            rank=rank))
    for n, m in ((1000, 50), (1500, 2)):
        x, s, g, thr = sweep_inputs(n, m, 0.0, 610 + m, device)
        rows.append(timed(
            "square",
            lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False),
            "fused_phi_counts_square",
            plain=lambda: phi_rbf_fused_counts(x, s, g, thr), n=n, m=m))
    # The terms square kernel (K6/K7's port) at the hierarchical BLR's
    # (1500, 11) with its pair of terms, on the CUDA cores at (1500, 2) and
    # at the flat BLR's width (1000, 50).
    signs = (1.0, 1.0)
    for n, m in ((1500, 11), (1500, 2), (1000, 50)):
        x, s, g, thr = sweep_inputs(n, m, 0.0, 620 + m, device)
        gs = [g, torch.full_like(g, 0.1)]
        rows.append(timed(
            "terms_square", lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                x, s, gs, signs, thr, sym=False),
            "fused_phi_terms_square",
            plain=lambda: phi_rbf_terms_fused_counts(x, s, gs, signs, thr),
            n=n, m=m, terms=2))
    for m in (5, 11, 16, 32, 50):
        x, s, g, thr = sweep_inputs(10000, m, 0.0, 600 + m, device)
        gs = [g, torch.full_like(g, 0.1)]
        rows.append(timed(
            "terms_sym", lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                x, s, gs, signs, thr, sym=True),
            "fused_phi_terms_sym_kernel", n=10000, m=m))
        if m != 11:
            continue
        rows.append(timed(
            "terms_sympanel", lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                x, s, gs, signs, thr, sym="panel"),
            "fused_phi_terms_sympanel_kernel", n=10000, m=m))
        for world, rank in ((1, 0), (2, 0), (2, 1)):
            rows.append(timed(
                "terms_sym_chunk",
                lambda: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                    x, s, gs, signs, thr, world, rank),
                "fused_phi_terms_sym_chunk_kernel", n=10000, m=m,
                world=world, rank=rank))
    mean, cov, x0, _ = aniso_mvn_workload(10240)
    x = torch.tensor(x0, device=device)
    model = st.MultivariateNormal(torch.tensor(mean, dtype=torch.float32),
                                  torch.tensor(cov, dtype=torch.float32))
    p_hess = st.GaussianRBFKernel(
        x, st.ScaleMethod.HESSIAN, model).compute_scale_pure(x)
    s = sweep_inputs(10240, 11, 0.0, 165, device)[1]
    rows.append(timed(
        "phi_rbf_hessian",
        lambda: cuda_phi.phi_rbf_cuda(x, s, p_hess, psd=False),
        "phi_rbf", n=10240, m=11))
    x, s, g, _ = sweep_inputs(1500, 2, 0.0, 165, device)
    p = g * torch.eye(2, device=device)
    eig = (p.diagonal(), torch.eye(2, device=device))
    rows.append(timed(
        "phi_rbf_median",
        lambda: cuda_phi.phi_rbf_cuda(x, s, p, psd=True, eig=eig),
        "phi_rbf", n=1500, m=2))
    # The wide triangles at their main paths' shapes (chip_smoke.py phase
    # 43c's): K2 and K4 (world 1) at the flat BLR's (10000, 123), K8/K9 and
    # K10/K11 (world 1) at the hierarchical BLR's (10000, 124) with its two
    # terms, on grid inputs.
    n = WIDE_BIG_N
    x, s, g, thr = grid_inputs(n, WIDE_D, 0.0, 631, device)
    rows.append(timed(
        "wide main K2", lambda: cuda_phi.phi_rbf_fused_cuda(
            x, s, g, thr, sym=True),
        "fused_phi_counts_sym_kernel", n=n, m=WIDE_D))
    rows.append(timed(
        "wide main K4 world=1", lambda: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
            x, s, g, thr, 1, 0),
        "fused_phi_counts_sym_chunk_kernel", n=n, m=WIDE_D))
    x, s, g, thr = grid_inputs(n, WIDE_D + 1, 0.0, 632, device)
    gs = [g, torch.full_like(g, 0.1)]
    rows.append(timed(
        "wide main K8/K9", lambda: cuda_phi.phi_rbf_terms_fused_cuda(
            x, s, gs, signs, thr, sym=True),
        "fused_phi_terms_sym_kernel", n=n, m=WIDE_D + 1, terms=2))
    rows.append(timed(
        "wide main K10/K11 world=1",
        lambda: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
            x, s, gs, signs, thr, 1, 0),
        "fused_phi_terms_sym_chunk_kernel", n=n, m=WIDE_D + 1, terms=2))
    # The wide instances (m > 64) at chip_smoke.py phase 43a's shapes and
    # inputs; a chunk row's call runs every rank of its world.
    for case in wide_cases(device):
        rows.append(timed(f"wide {case.label}", case.kern, case.kernel,
                          n=case.n, n_t=case.n_t or case.n, m=case.m,
                          terms=len(case.terms) if case.terms else 1))
    # K14's wide term groups and K15's wide sweep at phase 44a's shapes and
    # inputs, and at phase 44b's, the paths' (10240, 123).
    x, s, g, thr = grid_inputs(WIDE_P_BIG_N, WIDE_D, 0.0, 449, device)
    shapes = [(f"K14 wide ({WIDE_P_BIG_N}, {WIDE_D}) iso+1",
               cuda_phi.ANISO_WIDE_KERNEL, WIDE_P_BIG_N, WIDE_D, "iso+1",
               x, s, g, thr),
              (f"K15 wide ({WIDE_P_BIG_N}, {WIDE_D}) indefinite",
               cuda_phi.PHI_RBF_WIDE_KERNEL, WIDE_P_BIG_N, WIDE_D,
               ("indefinite", wide_p_ps("indefinite", WIDE_D, 1, 448, g,
                                        device)[0]), x, s, g, thr)]
    for label, kernel, n, m, spec, x, s, g, thr in (wide_p_cases(device)
                                                    + shapes):
        kern, _, plain = wide_p_call(kernel, x, s, g, thr, spec)
        rows.append(timed(f"wide {label}", kern, kernel, plain=plain, n=n,
                          m=m))
    # The panels' wide instances (phase 45a), each beside the full-width
    # triangle on the same inputs (K5's rows run every rank of the world).
    for label, kernel, n, m, terms, kern, tri, _, _ in wide_panel_cases(
            device):
        row = timed(f"wide panel {label}", kern, kernel, n=n, m=m,
                    terms=len(terms) if terms else 1)
        if tri is not None:
            row["full_width_ms"] = time_ms(tri, reps=20, warmup=3)
        rows.append(row)
    # The bfloat16 instances (phase 46a) beside the float32 instance and
    # the bf16 plain version on the same inputs.
    for label, kernel, n, m, n_t, kern, kern32, plain, _ in bf16_cases(
            device):
        row = timed(f"bf16 {label}", kern, kernel, plain=plain, n=n, m=m,
                    n_t=n_t or n)
        row["float32_instance_ms"] = time_ms(kern32, reps=20, warmup=3)
        rows.append(row)
    return rows


#: SASS opcode classes counted per loop by --sass.
SASS_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX"),
    "mufu": ("MUFU",),
    "cmp_sel": ("FSETP", "ISETP", "FSEL", "SEL", "PLOP3", "FSET", "ISET"),
    "int": ("IADD3", "IMAD", "LEA", "LOP3", "SHF", "IABS", "VIADD", "IMNMX",
            "MOV", "S2R", "CS2R", "I2F", "F2I"),
    "shared": ("LDS", "STS"),
    "shuffle": ("SHFL",),
    "global": ("LDG", "STG", "RED", "ATOM", "LD", "ST"),
    "barrier": ("BAR", "WARPSYNC", "BSSY", "BSYNC"),
    "branch": ("BRA", "EXIT", "RET"),
    "tensor": ("HMMA",),
}


def sass_loops(text, function, pairs_per=None, pair_class="mufu"):
    """Every loop (each backward branch) of ``function`` in ``cuobjdump
    --dump-sass`` output ``text``: its address range, its instructions and
    how many fall in each class of SASS_CLASSES (a predicate guard does not
    change an instruction's class). With ``pairs_per`` (instructions of
    ``pair_class`` a pair: special-function ones by default), also the
    loop's pairs, its count of that class over ``pairs_per``, and its
    instructions a pair."""
    import re

    lines, name = [], None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            continue
        if name == function:
            lines.append(line)
    insts = []
    for line in lines:
        hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if hit:
            insts.append((int(hit.group(1), 16), hit.group(2).strip()))
    loops = []
    for addr, branch in insts:
        code = re.sub(r"^@!?U?P\w+\s+", "", branch)
        hit = re.match(r"BRA\b.*?(0x[0-9a-f]+)", code)
        if not hit or int(hit.group(1), 16) > addr:
            continue
        start = int(hit.group(1), 16)
        body = [op for a, op in insts if start <= a <= addr]
        classes = dict.fromkeys(SASS_CLASSES, 0)
        for op in body:
            code = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0]
            for key, codes in SASS_CLASSES.items():
                classes[key] += code in codes
        loop = {"start": hex(start), "end": hex(addr),
                "instructions": len(body), **classes}
        if pairs_per and classes[pair_class]:
            loop["pairs"] = classes[pair_class] / pairs_per
            loop["per_pair"] = len(body) / loop["pairs"]
        loops.append(loop)
    return loops


#: The instances --sass reads: (label, kernel name, its template arguments
#: as mangled, the pair's instructions of a class: MUFU a pair, or (class,
#: count)). Path A's single-RBF panel instance <MM=2, exact, T=3> and path
#: B's terms panel instance <MM=11, exact, T=3, two terms> (in a tree
#: without a compile-time T, or term count, the one of the same MM, exact);
#: the count kernel's (K16's port) instances of the median's passes: m = 2
#: binned with 5 search steps (T = 16-31) and predicated at T <= 3, m = 11
#: binned (in a tree without the designs, its 32-threshold instance at
#: m = 2), with 5 FP32 instructions a pair for sq by differences at m = 2
#: and 15 by the Gram identity at m = 11; the one-pass anisotropic kernel's
#: (K14's port) instance of the anisotropic posterior, <MM=11, exact, one
#: isotropic term, T=3> (in a tree without runtime-m instances, <11,1,3>),
#: two ex2 a pair; the terms triangle kernel's (K8/K9's port) instance of
#: the hierarchical BLR, <MM=11, exact, T=3, two terms> (in a tree with the
#: one-row-a-thread body, <11,1,0>: its row pass holds the pairs' ex2),
#: two ex2 a pair; K15's instance of the HESSIAN cell, m = 11 exact, the
#: triangle kernel (phi_rbf_sym) or the square one, one ex2 a pair; K2's
#: instance of the flagship, <MM=2, exact, T=3> on the micro-tile body (in
#: a tree with the one-row-a-thread body, <2,1>), one ex2 a pair; K1's
#: instance of the flat BLR, <MM=50, exact, T=3> on the tensor cores (in a
#: tree with the one-row-a-thread body, <50,1>), one ex2 a pair; the terms
#: square kernel's (K6/K7's port) instances of the hierarchical BLR at
#: n = 1500 and of the flat BLR's width, <MM=11 or 50, exact, T=3, two
#: terms> on the tensor cores (in a tree with the one-row-a-thread body,
#: <11,1> and <50,1>), two ex2 a pair.
SASS_INSTANCES = (
    ("counts_sympanel<2,1,3>", "fused_phi_counts_sympanel_kernel",
     ("ILi2ELb1ELi3E", "ILi2ELb1EE"), 1),
    ("terms_sympanel<11,1,3,2>", "fused_phi_terms_sympanel_kernel",
     ("ILi11ELb1ELi3ELi2E", "ILi11ELb1EE"), 2),
    ("count_le<2,1,0,1,5>", "count_le_cross_kernel",
     ("ILi2ELb1ELb0ELb1ELi5E", "ILi2ELb1ELb0ELi32E"), ("fp32", 5)),
    ("count_le<2,1,0,0,3>", "count_le_cross_kernel",
     ("ILi2ELb1ELb0ELb0ELi3E",), ("fp32", 5)),
    ("count_le<11,1,1,1,5>", "count_le_cross_kernel",
     ("ILi11ELb1ELb1ELb1ELi5E", "ILi11ELb1ELb1ELi32E"), ("fp32", 15)),
    ("aniso_terms_sym<11,1,1,3>", "fused_phi_aniso_terms_sym_kernel",
     ("ILi11ELb1ELi1ELi3E", "ILi11ELi1ELi3E"), 2),
    ("terms_sym<11,1,3,2>", "fused_phi_terms_sym_kernel",
     ("ILi11ELb1ELi3ELi2E", "ILi11ELb1ELb0E"), 2),
    ("phi_rbf_sym<11,1>", "phi_rbf_sym_kernel", ("ILi11ELb1E",), 1),
    ("phi_rbf_square<11,1>", "phi_rbf_square_kernel", ("ILi11ELb1E",), 1),
    ("counts_sym<2,1,3>", "fused_phi_counts_sym_kernel",
     ("ILi2ELb1ELi3E", "ILi2ELb1EE"), 1),
    ("counts_square<50,1,3>", "fused_phi_counts_square_kernel",
     ("ILi50ELb1ELi3E", "ILi50ELb1EE"), 1),
    ("terms_square<11,1,3,2>", "fused_phi_terms_square_kernel",
     ("ILi11ELb1ELi3ELi2E", "ILi11ELb1EE"), 2),
    ("terms_square<50,1,3,2>", "fused_phi_terms_square_kernel",
     ("ILi50ELb1ELi3ELi2E", "ILi50ELb1EE"), 2),
)


def panel_sass(out_dir):
    """The loops of the panel instances paths A and B launch (see the
    module's docstring)."""
    import re

    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils.cuda_build import find_nvcc, library_path

    cuda_phi.load_library()
    lib = library_path(cuda_phi.LIBRARY, cuda_phi.SOURCES)
    cuobjdump = Path(find_nvcc() or "/usr/local/cuda/bin/nvcc").with_name(
        "cuobjdump")
    text = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    names = re.findall(r"Function : (\S+)", text)
    out, listing = {}, []
    for label, kernel, args, per in SASS_INSTANCES:
        inst = next((f for a in args for f in names if kernel + a in f), None)
        if inst is None:
            out[label] = None  # a tree without this instance
            continue
        cls, per = per if isinstance(per, tuple) else ("mufu", per)
        out[label] = {"function": inst,
                      "loops": sass_loops(text, inst, pairs_per=per,
                                          pair_class=cls)}
        body = text[text.index(f"Function : {inst}"):]
        nxt = body.find("Function : ", 1)
        listing.append(body if nxt < 0 else body[:nxt])
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "panel_sass.txt").write_text("\n".join(listing))
    return out


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def square_crossover_main(args) -> int:
    """--square-crossover: square_crossover in this tree (and with --forced
    in the two forced copies), JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "square_crossover": square_crossover(torch.device("cuda"))}
    if args.forced:
        result["forced"] = forced_crossover()
    out = Path(args.out or "chiprun_out/square_crossover.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))
    return 0


#: The parent header of the earlier wide designs: csrc/wide_tri.cuh's text
#: (wide_pair_body over 64 x 64 tile pairs, a block each: the design K2/K4,
#: K8-K11, K14's groups, the panels, K2's, K3's and K15's bf16 instances
#: and lastly K15's float32 wide sweep ran before they moved to
#: wide_tri_sm90.cuh's and bf16_tri_sm90.cuh's bodies), with what the
#: package's headers held for it alone (kWideTile, kWideK, kWideLdK and the
#: bf16 operand helpers). parent_csrc writes it into a copy of csrc/, where
#: the parents of --wide-breakdown, --bf16, --aniso-wide, --wide-panel,
#: --square-wide, --square-bf16 and --fixed-p-wide build on it.
WIDE_TRI_PARENT_HEADER = r"""// The upper-triangle sweep's body past kMaxM (m > 64), shared by the wide
// kernels of K15 (phi_rbf.cu, its bfloat16 instance at any m too) and the
// panels' wide instances (fused_phi_panel.cu). The float32 triangle
// kernels (K2/K4, K8-K11) and K14's term groups run wide_tri_sm90.cuh's
// body past kMaxM instead, and K2's and K3's bfloat16 instances
// bf16_tri_sm90.cuh's at any m. The bodies
// below it hold a row of m coordinates, scores and sums in registers
// (micro_tile.cuh, counts_sym.cuh, terms_sym.cuh); past m = 64 they would
// spill, so this one holds nothing sized by m and runs on the tensor
// cores.
//
// One block (4 warps) works through one tile pair (I, J) of kWideTile = 64
// particles a side, the block's WideSpot: for the triangle kernels tile
// t0 + blockIdx.x of the upper triangle's linear tile list (t0 = 0 for the
// whole triangle, a rank's first tile for a chunk; tri_spot), for the
// panel kernels a tile pair of one panel (fused_phi_panel.cu's
// panel_spot). The spot also says where each direction flushes.
//
//   1. Gram tile G = X_I X_J^T (64 x 64; warp w rows 16w..16w+15 of I
//      against the 64 columns of J) in 3xTF32 mma.sync m16n8k8 over slices
//      of kWideK coordinates, each slice of both tiles staged as TF32 pairs
//      in shared memory;
//   2. sq = max(0, |x_i|^2 + |x_j|^2 - 2 G) (the self pair pinned to 0, as
//      the plain version pins it; WideForm below gives K15's forms), the
//      pair's weights and its counts, ONCE a pair, into shared memory as
//      TF32 pairs: W (k_c) and, for terms, a second tile (w). On the
//      diagonal tile only j >= i is kept (the self pair included), the rest
//      gets weight 0 and no count;
//   3. the row sums of the D weight over J and its column sums over I;
//   4. both contractions on the tensor cores, 64 columns of the operands
//      at a time (the scores' columns with k_c, then the coordinates' with
//      w): row i of I takes W [S_J | X_J], column j of J takes
//      W^T [S_I | X_I], W^T reaching the A operand by reading W's shared
//      tile transposed. D comes from the sums: D_i += rowsum_i x_i - (W X_J)_i,
//      D_j += colsum_j x_j - (W^T X_I)_j, as the plain version forms it at
//      these widths (ops/phi._pair_block);
//   5. each chunk is flushed with float32 atomics into the spot's zeroed
//      [KS | D] planes, the (2m, n) accumulator for the triangles, as the
//      narrower bodies flush.
//
// The conventions are the narrower bodies': each self pair enters both
// directions (k = 1 exactly: the wrapper subtracts s_i once), D is
// unscaled for one RBF (the wrapper multiplies it by 2 gamma) and weighted
// by w for terms, and the counts receive U, the upper count with the
// diagonal (the wrapper forms 2U - n). kT = 0 (with T = 0) counts nothing;
// T = 0 with kT > 0 counts nothing either.
//
// Shared memory (dynamic): 9216 floats for the Gram slices or the
// contraction's records, 8704 for each weight tile, 256 for norms and
// sums: 72.7 KB for one RBF, 107.5 KB for terms, at any m. Registers: the
// warp's 16 x 64 Gram values (64 a thread) during the Gram tile, 32
// accumulators during a contraction.
//
// kBf16 (the bfloat16 opt-in: K15's bf16 instance, at any m; K2's and
// K3's ran it until bf16_tri_sm90.cuh, and chip_profile.py --bf16 still
// times it as their parent design): the Gram operands, the weights and the
// contraction's records
// rounded to bf16, each product one TF32 pass (square_mma.cuh,
// operand_split and mma_pass); the norms stay those of the float32
// coordinates (or the caller's q), the self pair is pinned as above, and
// D_i = rowsum_i x_i - (W X_J)_i takes the float32 x_i beside the rounded
// X_J, as the JAX kernels' epilogue forms rowsum x - KX from the float32
// coordinates (pallas_phi.py:636-640, :707, :956-960).
//
// kAsym (with kBf16: K15's bf16 instance): bf16(x_i) . bf16(y_j) is not
// bf16(x_j) . bf16(y_i), as x_i^T (P_sym/2) x_j is in float32, so one
// weight tile cannot serve both directions: the rows of I take the JAX
// kernel's k(i <- j) from G = X_I Y_J^T and the columns of J k(j <- i)
// from G' = Y_I X_J^T, a second Gram tile (in the registers and the
// shared slices that 3xTF32's small parts take otherwise) and a second
// weight tile (107.5 KB).

#pragma once

#include <cuda_bf16.h>

#include "micro_tile.cuh"
#include "square_mma.cuh"

namespace svgd {

// ---------------------------------------------------------------------------
// What the package's headers held for this body (and the parents built
// beside it) alone: the tile (sweep_common.cuh), the Gram slices and the
// bf16 operand helpers (square_mma.cuh).
// ---------------------------------------------------------------------------

constexpr int kWideTile = 64;
constexpr int kWideK = 32;                // coordinates of one Gram slice
constexpr int kWideLdK = kWideK + 4;      // slice rows' stride (4 mod 32)

// The bfloat16 operand opt-in (the JAX package's dot_dtype='bfloat16') of
// the Gram-form body of wide_tri.cuh (K15's bf16 instance). The JAX kernels
// round their dot operands to bf16 (round to nearest, ties to even) and
// accumulate the products in float32. Here the same function runs as ONE
// TF32 pass on operands pre-rounded to bf16, in the 3xTF32 bodies' own
// fragment layouts: a bf16 value is exact in TF32 (8 of TF32's 11
// significant bits) and the product of two is exact in float32, so the
// pass computes what a bf16 mma.sync computes, and the bodies need no
// second set of fragment layouts. The pass is a third of 3xTF32's tensor
// work, at TF32's rate (half of bf16's): simple first, fast later.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// An operand's TF32 pair: (tf32(v), tf32(v - big)), or under kBf16
// (bf16(v), 0), the small product of which the pass leaves out.
template <bool kBf16>
__device__ __forceinline__ void operand_split(float v, uint32_t& big,
                                              uint32_t& small) {
  if constexpr (kBf16) {
    big = __float_as_uint(bf16_round(v));
    small = 0u;
  } else {
    tf32_split(v, big, small);
  }
}

// d += a b: 3xTF32, or under kBf16 the one pass of the rounded operands.
template <bool kBf16>
__device__ __forceinline__ void mma_pass(float (&d)[4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const float* rec_big,
                                         const float* rec_small, int off0,
                                         int off1) {
  if constexpr (kBf16) {
    mma_tf32(d, ab, __float_as_uint(rec_big[off0]),
             __float_as_uint(rec_big[off1]));
  } else {
    mma_3xtf32(d, ab, as, rec_big, rec_small, off0, off1);
  }
}

// A fragment of TF32 pairs from one weight a pair: (g, t) <- source 2t,
// (g, t + 4) <- source 2t + 1, rows g and g + 8 (v: the pairs (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)); under kBf16 the weights
// rounded to bf16, as the JAX kernels round k before the contraction.
template <bool kBf16 = false>
__device__ __forceinline__ void weight_fragment(const float (&v)[4],
                                                uint32_t (&big)[4],
                                                uint32_t (&small)[4]) {
  operand_split<kBf16>(v[0], big[0], small[0]);
  operand_split<kBf16>(v[2], big[1], small[1]);
  operand_split<kBf16>(v[1], big[2], small[2]);
  operand_split<kBf16>(v[3], big[3], small[3]);
}


constexpr int kWideTriThreads = 128;        // 4 warps of 16 rows
constexpr int kWideLdW = kWideTile + 4;     // weight tiles' stride
constexpr int kWideTriCols = 64;            // operand columns of a chunk
constexpr int kWideTriLdR = kWideTriCols + 4;

struct WideTri {
  // floats: the union of the Gram slices ([2 tiles][64][kWideLdK], big and
  // small) and the records ([64][kWideTriLdR], big and small)
  static constexpr int kSlices = 4 * kWideTile * kWideLdK;
  static constexpr int kRecords = 2 * kWideTile * kWideTriLdR;
  static constexpr int kUnion = kSlices > kRecords ? kSlices : kRecords;
  static constexpr int kWeight = 2 * kWideTile * kWideLdW;  // big, small
  static constexpr int kSums = 4 * kWideTile;  // norms and sums of I, J

  static constexpr size_t smem_bytes(int weights) {
    return sizeof(float) * (kUnion + weights * kWeight + kSums);
  }
};

// The Gram tile's operands and the form of sq. The default is the
// Euclidean form: G = X_I X_J^T, the norms |x|^2 of the coordinates, sq
// clamped at 0. K15's fixed-P form (the JAX kernel's, pallas_phi.py:116)
// pairs X_I with Y_J, the rows of Y = X_c (P_sym/2), so G_ij = x_i^T
// (P_sym/2) x_j = G_ji and one weight tile serves both directions; its norms
// are q_i = x_i . y_i, so sq = q_i + q_j - 2 G = d^T P d, clamped only for a
// P taken as positive semidefinite. The contraction takes the coordinates
// either way. `phi` false leaves the contraction out (no kernel of the
// library sets it since K14's groups left this body; chip_profile.py
// --aniso-wide builds their earlier kernel, whose Euclidean group with no
// isotropic term only counted, against it). `pin` false (K15's bf16
// instance) forms the self pair's sq like any other pair's and halves its
// weights, exactly, so that it enters once over both directions: the
// square sweep's self pair, as the JAX kernel forms it (there the bf16
// Gram moves it off 0 visibly); the triangles pin it to sq = 0 and their
// wrappers take its second entry out.
struct WideForm {
  const float* y = nullptr;  // J's Gram operand (null: the coordinates)
  const float* q = nullptr;  // the norms (null: |x|^2 of the coordinates)
  bool clamp = true;         // sq = max(sq, 0)
  bool phi = true;           // the contraction and its flush
  bool pin = true;           // the self pair's sq = 0
};

// WideSpot (a block's tile pair and where it flushes) lives in
// sweep_common.cuh, beside the bf16 triangle body that still takes it.

// The triangles' spot: tile pair t of the upper triangle of nb tiles, both
// directions into the (2m, n) accumulator.
__device__ __forceinline__ WideSpot tri_spot(long long t, int nb, int n,
                                             float* acc) {
  int bi, bj;
  decode_upper_pair(t, nb, &bi, &bj);
  return WideSpot{bi * kWideTile, bj * kWideTile, bi == bj, acc, acc, 0, 0,
                  n};
}

// The body (see the top of the file) on the block's tile pair ``spot``.
// kT thresholds (3, or kMaxT for a runtime T, or 0 for none);
// weights(sq, k_c, w) the pair's weights: one tile of them where W is
// OneRbf (k_c = w), two otherwise. Composed kernels' constants in shared
// memory (AnyTerms) must be stored before the call: the body's first
// barrier comes before its first pair.
template <int kT, bool kBf16, bool kAsym, class W>
__device__ __forceinline__ void wide_pair_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const W& weights, const float* __restrict__ thr, int n, int m, int T,
    const WideSpot& spot, unsigned long long* __restrict__ counts,
    const WideForm& form) {
  static_assert(!kAsym || (kBf16 && !kTwoBands<W>),
                "the second Gram tile takes the small parts' room");
  constexpr int NW = kTwoBands<W> || kAsym ? 2 : 1;
  constexpr int S = kWideTile;
  extern __shared__ __align__(16) float sh[];
  float* un = sh;                              // slices or records
  float* wt = sh + WideTri::kUnion;            // [NW][big | small][S][LdW]
  float* norm = wt + NW * WideTri::kWeight;    // [I | J]
  float* sums = norm + 2 * S;                  // [rows of I | columns of J]

  const int i0 = spot.i0;
  const int j0 = spot.j0;
  const bool diag = spot.diag;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  float th[kT > 0 ? kT : 1];
#pragma unroll
  for (int q = 0; q < kT; ++q) th[q] = thr[q < T ? q : 0];

  // The norms of the 64 + 64 particles: the caller's, or the squared
  // norms, 4 threads each.
  if (form.q != nullptr) {
    for (int p = tid; p < 2 * S; p += kWideTriThreads) {
      const int part = p < S ? i0 + p : j0 + p - S;
      norm[p] = part < n ? form.q[part] : 0.0f;
    }
  } else {
    for (int e = tid; e < 2 * S * 4; e += kWideTriThreads) {
      const int p = e >> 2;
      const int part = p < S ? i0 + p : j0 + p - S;
      float q = 0.0f;
      if (part < n) {
        for (int k = e & 3; k < m; k += 4) {
          const float v = coords[static_cast<size_t>(part) * m + k];
          q = fmaf(v, v, q);
        }
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if ((e & 3) == 0) norm[p] = q;
    }
  }
  const float* gram_j = form.y != nullptr ? form.y : coords;

  // 1. The Gram tile: slices [I | J][64][kWideLdK], big then small (under
  // kAsym G's operands X_I, Y_J, then G''s, Y_I, X_J).
  float gb[8][4];
  float gs[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gb[c][q] = 0.0f;
      gs[c][q] = 0.0f;
    }
  }
  constexpr int kTileK = S * kWideLdK;      // floats of one tile's slice
  float* sl_big = un;
  float* sl_small = un + 2 * kTileK;
#pragma unroll 1
  for (int k0 = 0; k0 < m; k0 += kWideK) {
    const int kn = min(kWideK, m - k0);
    __syncthreads();  // the union is free
    for (int e = tid; e < 2 * S * kWideK; e += kWideTriThreads) {
      const int r = e / kWideK;  // 0..127: I's rows, then J's
      const int k = e - r * kWideK;
      const int part = r < S ? i0 + r : j0 + r - S;
      const float* src = r < S ? coords : gram_j;
      const bool in = part < n && k < kn;
      const size_t at = static_cast<size_t>(part) * m + k0 + k;
      const float v = in ? src[at] : 0.0f;
      uint32_t hi, lo;
      operand_split<kBf16>(v, hi, lo);
      if constexpr (kAsym) {
        const float* other = r < S ? gram_j : coords;
        lo = __float_as_uint(bf16_round(in ? other[at] : 0.0f));
      }
      sl_big[r * kWideLdK + k] = __uint_as_float(hi);
      sl_small[r * kWideLdK + k] = __uint_as_float(lo);
    }
    __syncthreads();  // the slices are complete
#pragma unroll
    for (int ks = 0; ks < kWideK / 8; ++ks) {
      if (8 * ks < kn) {
        const int ar = (16 * warp + g) * kWideLdK + 8 * ks + t;
        const uint32_t ab[4] = {
            __float_as_uint(sl_big[ar]),
            __float_as_uint(sl_big[ar + 8 * kWideLdK]),
            __float_as_uint(sl_big[ar + 4]),
            __float_as_uint(sl_big[ar + 8 * kWideLdK + 4])};
        const uint32_t as[4] = {
            __float_as_uint(sl_small[ar]),
            __float_as_uint(sl_small[ar + 8 * kWideLdK]),
            __float_as_uint(sl_small[ar + 4]),
            __float_as_uint(sl_small[ar + 8 * kWideLdK + 4])};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int br = kTileK + (8 * c + g) * kWideLdK + 8 * ks + t;
          const uint32_t bb0 = __float_as_uint(sl_big[br]);
          const uint32_t bb1 = __float_as_uint(sl_big[br + 4]);
          if constexpr (kAsym) {
            mma_tf32(gs[c], as, __float_as_uint(sl_small[br]),
                     __float_as_uint(sl_small[br + 4]));
          } else if constexpr (!kBf16) {
            mma_tf32(gs[c], as, bb0, bb1);
            mma_tf32(gs[c], ab, __float_as_uint(sl_small[br]),
                     __float_as_uint(sl_small[br + 4]));
          }
          mma_tf32(gb[c], ab, bb0, bb1);
        }
      }
    }
  }

  // 2. sq, the weights and the counts, once a pair; the weights into the
  // tiles W[il][jl] (row il of I, column jl of J).
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int q = 0; q < kMaxT; ++q) cnt[q] = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int il = 16 * warp + g + (q >> 1) * 8;
      const int jl = 8 * c + 2 * t + (q & 1);
      const bool ok = i0 + il < n && j0 + jl < n && (!diag || jl >= il);
      const float nij = __fadd_rn(norm[il], norm[S + jl]);
      float sq = kAsym ? __fsub_rn(nij, 2.0f * gb[c][q])
                       : __fsub_rn(nij, 2.0f * (gb[c][q] + gs[c][q]));
      if (form.clamp) sq = fmaxf(sq, 0.0f);
      const bool self = diag && il == jl;
      if (self && form.pin) sq = 0.0f;
      // The unpinned self pair's weights enter each direction at half.
      const float half = self && !form.pin ? 0.5f : 1.0f;
      float a, b;
      weights(sq, a, b);
      if constexpr (kAsym) {  // the columns' weight, k(j <- i), from G'
        float sq2 = __fsub_rn(nij, 2.0f * gs[c][q]);
        if (form.clamp) sq2 = fmaxf(sq2, 0.0f);
        float a2;
        weights(sq2, b, a2);
      }
      count_pair_fixed<kT, true>(sq, th, ok, cnt);
      uint32_t hi, lo;
      operand_split<kBf16>(ok ? a : 0.0f, hi, lo);
      wt[il * kWideLdW + jl] = half * __uint_as_float(hi);
      wt[S * kWideLdW + il * kWideLdW + jl] = half * __uint_as_float(lo);
      if constexpr (NW == 2) {
        float* w1 = wt + WideTri::kWeight;
        operand_split<kBf16>(ok ? b : 0.0f, hi, lo);
        w1[il * kWideLdW + jl] = half * __uint_as_float(hi);
        w1[S * kWideLdW + il * kWideLdW + jl] = half * __uint_as_float(lo);
      }
    }
  }
  flush_counts(cnt, T, counts);
  if (!form.phi) return;  // uniform over the block: no barrier is skipped
  __syncthreads();        // the weight tiles are complete

  // 3. The D weight's row sums (threads 0-63, row tid of I) and column sums
  // (threads 64-127, column tid - 64 of J), from its TF32 pairs (under
  // kAsym the rows' from the first tile, the columns' from the second).
  {
    const float* wd_big =
        wt + (kAsym ? (tid < S ? 0 : 1) : NW - 1) * WideTri::kWeight;
    const float* wd_small = wd_big + S * kWideLdW;
    const int p = tid & (S - 1);
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) {
      // Rows walk their columns rotated by p, so that the 32 lanes of a
      // warp read 32 distinct banks.
      const int at = tid < S ? p * kWideLdW + ((s + p) & (S - 1))
                             : s * kWideLdW + p;
      sum += wd_big[at] + wd_small[at];
    }
    sums[tid] = sum;
  }

  // 4-5. The contractions, chunk by chunk: the scores' columns c0 .. c0 +
  // 63 with k_c, then the coordinates' with w.
  const int nch = (m + kWideTriCols - 1) / kWideTriCols;
  float* rec_big = un;
  float* rec_small = un + S * kWideTriLdR;
#pragma unroll 1
  for (int ch = 0; ch < 2 * nch; ++ch) {
    const bool xband = ch >= nch;
    const int c0 = (xband ? ch - nch : ch) * kWideTriCols;
    const int cn = min(kWideTriCols, m - c0);
    const float* src = xband ? coords : scores;
#pragma unroll 1
    for (int dir = 0; dir < 2; ++dir) {
      const int tile = kAsym ? dir : (xband ? NW - 1 : 0);
      const float* w_big = wt + tile * WideTri::kWeight;
      const float* w_small = w_big + S * kWideLdW;
      // dir 0: the rows of I take W [S_J | X_J]; dir 1: the columns of J
      // take W^T [S_I | X_I].
      const int p0 = dir == 0 ? j0 : i0;  // the operand tile
      const int o0 = dir == 0 ? i0 : j0;  // the output tile
      __syncthreads();  // the union is free (and the sums are stored)
      for (int e = tid; e < S * kWideTriCols; e += kWideTriThreads) {
        const int p = e / kWideTriCols;
        const int c = e - p * kWideTriCols;
        const float v = p0 + p < n && c < cn
                            ? src[static_cast<size_t>(p0 + p) * m + c0 + c]
                            : 0.0f;
        uint32_t hi, lo;
        operand_split<kBf16>(v, hi, lo);
        rec_big[p * kWideTriLdR + c] = __uint_as_float(hi);
        rec_small[p * kWideTriLdR + c] = __uint_as_float(lo);
      }
      __syncthreads();  // the records are complete
      float out[8][4];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[b][q] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < S / 8; ++ks) {
        // A: rows 16 warp + g (+ 8) of W (dir 0) or of W^T (dir 1),
        // columns 8 ks + t (+ 4).
        const int ra = 16 * warp + g;
        const int ka = 8 * ks + t;
        int at[4];
        if (dir == 0) {
          at[0] = ra * kWideLdW + ka;
          at[1] = (ra + 8) * kWideLdW + ka;
          at[2] = ra * kWideLdW + ka + 4;
          at[3] = (ra + 8) * kWideLdW + ka + 4;
        } else {
          at[0] = ka * kWideLdW + ra;
          at[1] = ka * kWideLdW + ra + 8;
          at[2] = (ka + 4) * kWideLdW + ra;
          at[3] = (ka + 4) * kWideLdW + ra + 8;
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ab[q] = __float_as_uint(w_big[at[q]]);
          as[q] = __float_as_uint(w_small[at[q]]);
        }
        const int bk = ka * kWideTriLdR + g;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (8 * b < cn) {
            mma_pass<kBf16>(out[b], ab, as, rec_big, rec_small, bk + 8 * b,
                            bk + 4 * kWideTriLdR + 8 * b);
          }
        }
      }
      // Flush: row (dir 0) or column (dir 1) o0 + ol, operand column
      // c0 + cl, into KS (scores) or D = sum x - W X (coordinates), at the
      // spot's planes of that direction.
      float* dst = dir == 0 ? spot.out0 : spot.out1;
      const int base = dir == 0 ? spot.base0 : spot.base1;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ol = 16 * warp + g + (q >> 1) * 8;
          const int cl = 8 * b + 2 * t + (q & 1);
          const int o = o0 + ol;
          if (o < n && cl < cn) {
            const int k = c0 + cl;
            if (xband) {
              const float x = coords[static_cast<size_t>(o) * m + k];
              atomicAdd(
                  dst + static_cast<size_t>(m + k) * spot.ld + (o - base),
                  fmaf(sums[dir * S + ol], x, -out[b][q]));
            } else {
              atomicAdd(dst + static_cast<size_t>(k) * spot.ld + (o - base),
                        out[b][q]);
            }
          }
        }
      }
    }
  }
}

// The triangle sweeps' body: tile t0 + blockIdx.x of the upper triangle of
// nb tiles, into the (2m, n) accumulator acc (see wide_pair_body).
template <int kT, bool kBf16 = false, bool kAsym = false, class W>
__device__ __forceinline__ void wide_tri_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const W& weights, const float* __restrict__ thr, int n, int m, int T,
    int nb, long long t0, float* __restrict__ acc,
    unsigned long long* __restrict__ counts, const WideForm& form = {}) {
  wide_pair_body<kT, kBf16, kAsym>(
      coords, scores, weights, thr, n, m, T,
      tri_spot(t0 + static_cast<long long>(blockIdx.x), nb, n, acc), counts,
      form);
}

// Allow a kernel on the wide body with `weights` weight tiles its dynamic
// shared memory, where that passes the default 48 KB. A refusal also fails
// the launch, which the entry's cudaGetLastError() reports.
template <class Kernel>
inline cudaError_t wide_tri_prepare(Kernel* kernel, int weights) {
  const size_t smem = WideTri::smem_bytes(weights);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace svgd
"""


def parent_csrc(dest):
    """A fresh copy of csrc/ under ``dest`` with the parent header
    wide_tri.cuh (WIDE_TRI_PARENT_HEADER) beside the package's headers."""
    dest = Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "svgdcpp_tpu_torch" / "csrc", dest)
    (dest / "wide_tri.cuh").write_text(WIDE_TRI_PARENT_HEADER)
    return dest


#: --wide-breakdown's harness: the wide triangle bodies on one RBF
#: (``BODY`` 0: wide_tri.cuh's wide_pair_body over tiles of 64, the
#: parent design of K2's wide instance; 1: wide_tri_sm90.cuh's body,
#: K2/K4's and K8-K11's, also with two terms), built from a copy of csrc/
#: (parent_csrc) whose header a variant rewrote. Not a kernel of the
#: package.
WIDE_BREAKDOWN_SOURCE = r"""
#include "wide_tri.cuh"
#include "wide_tri_sm90.cuh"
using namespace svgd;
template <int NT>
__global__ void __launch_bounds__(BODY ? kWideSymThreads : kWideTriThreads)
    sweep(const float* __restrict__ x, const float* __restrict__ s,
          const float* __restrict__ gamma, const float* __restrict__ thr,
          int n, int m, int nb, long long count, float* __restrict__ acc,
          unsigned long long* __restrict__ counts) {
  if constexpr (BODY == 0) {
    wide_tri_body<3>(x, s, OneRbf{-gamma[0] * kLog2e}, thr, n, m, 3, nb, 0LL,
                     acc, counts);
  } else if constexpr (NT == 0) {
    wide_tri_sm90_body<3>(x, s, OneRbf{-gamma[0] * kLog2e}, thr, n, m, 3,
                          nb, 0LL, count, acc, counts);
  } else {
    TermSigns sg{};
    sg.s[0] = 1.0f;
    sg.s[1] = 1.0f;
    wide_tri_sm90_body<3>(x, s, FixedTerms<2>(gamma, sg), thr, n, m, 3, nb,
                          0LL, count, acc, counts);
  }
}
template <int NT>
int go(const float* x, const float* s, const float* gamma, const float* thr,
       int n, int m, float* acc, long long* counts, cudaStream_t st) {
  auto* k = &sweep<NT>;
  const int tile = BODY ? kWideSymTile : kWideTile;
  const int nb = (n + tile - 1) / tile;
  const long long pairs = upper_pairs(n, tile);
  unsigned int blocks = static_cast<unsigned int>(pairs);
  size_t smem = WideTri::smem_bytes(1);
  if constexpr (BODY) {
    blocks = wide_sym_prepare<NT != 0>(k, pairs);
    smem = WideSym<NT != 0>::kSmemBytes;
  } else {
    wide_tri_prepare(k, 1);
  }
  k<<<blocks, BODY ? kWideSymThreads : kWideTriThreads, smem, st>>>(
      x, s, gamma, thr, n, m, nb, pairs, acc,
      reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
// The mma.sync rate of the wide bodies' products: every warp of 132
// blocks of `warps` warps issues `iters` x 8 independent m16n8k8 TF32
// products from registers.
__global__ void mma_rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x ^ 5u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) mma_tf32(d[c], a, b0, 11u);
  }
  float z = 0.0f;
  for (int c = 0; c < 8; ++c) z += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (z == 1234.5f) out[0] = z;
}
extern "C" int breakdown_mma_rate(int warps, int iters, float* out,
                                  void* stream) {
  mma_rate<<<132, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int breakdown_sweep(int terms, const float* x, const float* s,
                               const float* gamma, const float* thr, int n,
                               int m, float* acc, long long* counts,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return terms ? go<2>(x, s, gamma, thr, n, m, acc, counts, st)
               : go<0>(x, s, gamma, thr, n, m, acc, counts, st);
}
"""

_KEEP_G = ("    if (z == 1234.5f) counts[0] = 7;\n    return;\n  }\n")
#: The variants of wide_pair_body (csrc/wide_tri.cuh): (old, new) rewrites
#: of the header, each timing what is left when a part is taken out.
WIDE_PAIR_VARIANTS = {
    "full": [],
    "no flush atomics": [
        ("              atomicAdd(\n                  dst + static_cast<size_t>"
         "(m + k) * spot.ld + (o - base),",
         "              if (__float_as_uint(x) == 0x7fbadbadu) atomicAdd(\n"
         "                  dst + static_cast<size_t>(m + k) * spot.ld + "
         "(o - base),"),
        ("              atomicAdd(dst + static_cast<size_t>(k) * spot.ld + "
         "(o - base),",
         "              if (__float_as_uint(out[b][q]) == 0x7fbadbadu)\n"
         "              atomicAdd(dst + static_cast<size_t>(k) * spot.ld + "
         "(o - base),")],
    "no contraction": [("  if (!form.phi) return;", "  return;")],
    "norms and Gram only": [
        ("  // 2. sq, the weights and the counts, once a pair; the weights",
         "  {\n    float z = 0.0f;\n    for (int c = 0; c < 8; ++c)\n"
         "      for (int q = 0; q < 4; ++q) z += gb[c][q] + gs[c][q];\n"
         + _KEEP_G + "  // 2. sq, the weights and the counts, once a pair; "
         "the weights")],
    "norms and Gram staging only": [
        ("    __syncthreads();  // the slices are complete\n",
         "    __syncthreads();  // the slices are complete\n    continue;\n"),
        ("  // 2. sq, the weights and the counts, once a pair; the weights",
         "  {\n    float z = gb[0][0] + gs[0][0];\n" + _KEEP_G
         + "  // 2. sq, the weights and the counts, once a pair; the weights")],
    "norms only": [
        ("  const float* gram_j = form.y != nullptr ? form.y : coords;\n",
         "  const float* gram_j = form.y != nullptr ? form.y : coords;\n"
         "  __syncthreads();\n  if (norm[tid] == 1234.5f) counts[0] = 7;\n"
         "  return;\n")],
    "no record staging": [
        ("      for (int e = tid; e < S * kWideTriCols; e += kWideTriThreads)",
         "      for (int e = tid; e < 0; e += kWideTriThreads)")],
}

_FAKE_MMA = ("{0}[0] += __uint_as_float(as[h][0] ^ bb0 ^ ab[h][1] ^ bs0);\n"
             "            {0}[1] += __uint_as_float(as[h][2] ^ bb1 ^ ab[h][3] "
             "^ bs1);")
#: The variants of wide_tri_sm90_body (csrc/wide_tri_sm90.cuh).
WIDE_SYM_VARIANTS = {
    "full": [],
    "no flush atomics": [
        ("                atomicAdd(acc + static_cast<size_t>(col) * n + o, "
         "v);",
         "                if (__float_as_uint(v) == 0x7fbadbadu)\n"
         "                atomicAdd(acc + static_cast<size_t>(col) * n + o, "
         "v);")],
    "no contraction": [
        ("      const float* slot1 = slot0 + L::kSlot;\n      // 3.",
         "      const float* slot1 = slot0 + L::kSlot;\n      continue;\n"
         "      // 3.")],
    "contraction without mma": [
        ("mma_3x(out[h][b], ab[h], as[h], bb0, bs0, bb1, bs1);",
         _FAKE_MMA.format("out[h][b]"))],
    "no Gram mma": [
        ("mma_3x(acc_g[h][c], ab[h], as[h], bb0, bs0, bb1, bs1);",
         _FAKE_MMA.format("acc_g[h][c]"))],
    "one mma a product (timing only)": [
        ("  mma_tf32(d, as, bb0, bb1);\n  mma_tf32(d, ab, bs0, bs1);\n", "")],
    "rounded split (cvt.rna.tf32)": [
        ("  big = __float_as_uint(x) & 0xffffe000u;\n"
         "  small = __float_as_uint(x - __uint_as_float(big));\n",
         "  tf32_split(x, big, small);\n")],
}

#: --wide-breakdown's shapes: the parent body at K2's main path (10000,
#: 123); the new body at the width the wrappers hand it there (124, m
#: padded to 4), one RBF and two terms; and, for where the new body should
#: begin, m = 33, 50 and 64 (run at their padded widths 36, 52, 64) beside
#: the library's narrower instances at the same m.
WIDE_BREAKDOWN_N = 10000
WIDE_BEGIN_MS = (33, 50, 64)


def wide_breakdown_copy(dest, body, rewrites):
    """A copy of csrc/ under ``dest`` with ``rewrites`` applied to the
    body's header and the harness source written beside it."""
    dest = parent_csrc(dest)
    header = dest / ("wide_tri_sm90.cuh" if body else "wide_tri.cuh")
    text = header.read_text()
    for old, new in rewrites:
        if text.count(old) != 1:
            raise RuntimeError(f"wide_breakdown_copy: {header.name} holds "
                               f"{text.count(old)} copies of {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    (dest / "breakdown.cu").write_text(
        f"#define BODY {body}\n" + WIDE_BREAKDOWN_SOURCE)
    return dest


def wide_breakdown(device):
    """--wide-breakdown: each variant of each wide triangle body, built in
    a copy under _verify/wide_breakdown/ (no switch in the sources) and
    timed with CUDA events (median of 3 runs of 10 launches after 3); then
    the new body at m = 33, 50, 64 beside the library's K2 and K8/K9 there
    (kernel-only us, the profiler's events)."""
    import ctypes

    import torch

    from chip_smoke import kernel_us
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    base = ROOT / "_verify" / "wide_breakdown"
    jobs = [(body, name, rewrites)
            for body, table in ((0, WIDE_PAIR_VARIANTS),
                                (1, WIDE_SYM_VARIANTS))
            for name, rewrites in table.items()]
    procs = []
    for idx, (body, name, rewrites) in enumerate(jobs):
        dest = wide_breakdown_copy(base / f"v{idx}", body, rewrites)
        cmd = [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
               str(dest / "libbreakdown.so"), str(dest / "breakdown.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    spills = []
    for (body, name, _), proc in zip(jobs, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"wide breakdown build {body}/{name}:\n{out}")
        spills.append(re.findall(r"(\d+) bytes spill stores", out))

    def inputs(n, m, width, seed):
        gen = torch.Generator().manual_seed(seed)
        x = torch.randn(n, m, generator=gen)
        x = x - x.mean(dim=0)
        s = torch.randn(n, m, generator=gen)
        pad = (0, width - m)
        return (torch.nn.functional.pad(x, pad).contiguous().to(device),
                torch.nn.functional.pad(s, pad).contiguous().to(device))

    def timed(lib, terms, n, m, width):
        x, s = inputs(n, m, width, n + m)
        gamma = torch.tensor([0.5 / m, 0.25 / m], device=device)
        thr = torch.tensor([1.5 * m, 2.0 * m, 2.5 * m], device=device)
        acc = torch.zeros((2 * width, n), device=device)
        counts = torch.zeros(3, dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = lib.breakdown_sweep(terms, x.data_ptr(), s.data_ptr(),
                                     gamma.data_ptr(), thr.data_ptr(), n,
                                     width, acc.data_ptr(),
                                     counts.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"breakdown_sweep returned {rc}")
        for _ in range(3):
            call()
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 10)
        return sorted(runs)[1]

    rows = []
    n = WIDE_BREAKDOWN_N
    for idx, ((body, name, _), spill) in enumerate(zip(jobs, spills)):
        lib = ctypes.CDLL(str(base / f"v{idx}" / "libbreakdown.so"))
        lib.breakdown_sweep.argtypes = ([ctypes.c_int]
                                        + [ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 2
                                        + [ctypes.c_void_p] * 3)
        shapes = ([(0, 123, 123)] if body == 0
                  else [(0, 123, 124)] + ([(1, 124, 124)] if name == "full"
                                          else []))
        if body == 1 and name == "full":
            shapes += [(terms, m, -(-m // 4) * 4) for m in WIDE_BEGIN_MS
                       for terms in (0, 1)]
        for terms, m, width in shapes:
            row = {"body": "wide_pair_body" if body == 0
                   else "wide_tri_sm90_body", "variant": name, "n": n,
                   "m": m, "width": width, "terms": 2 if terms else 1,
                   "ms": timed(lib, terms, n, m, width),
                   "spill_bytes": [int(b) for b in spill]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    # mma.sync's own rate: TF32 m16n8k8 products from registers.
    lib = ctypes.CDLL(str(base / "v0" / "libbreakdown.so"))
    lib.breakdown_mma_rate.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    sink = torch.zeros(1, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    for warps in (8, 16, 32):
        iters = 4096
        lib.breakdown_mma_rate(warps, iters, sink.data_ptr(), stream)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.breakdown_mma_rate(warps, iters, sink.data_ptr(), stream)
        end.record()
        end.synchronize()
        if rc:
            raise RuntimeError(f"breakdown_mma_rate returned {rc}")
        ms = start.elapsed_time(end)
        flops = 132 * warps * iters * 8 * (16 * 8 * 8 * 2)
        row = {"body": "mma.sync m16n8k8 tf32", "warps_per_sm": warps,
               "ms": ms, "tflops": flops / ms / 1e9}
        rows.append(row)
        print(json.dumps(row), flush=True)
    # The library's narrower instances at the same m (kernel-only).
    for m in WIDE_BEGIN_MS:
        x, s = inputs(n, m, m, n + m)
        gamma = torch.tensor(0.5 / m, device=device)
        thr = torch.tensor([1.5 * m, 2.0 * m, 2.5 * m], device=device)
        gs = [gamma, torch.tensor(0.25 / m, device=device)]
        for name, fn, kernel in (
                ("K2", lambda: cuda_phi.phi_rbf_fused_cuda(
                    x, s, gamma, thr, sym=True),
                 "fused_phi_counts_sym_kernel"),
                ("K8/K9", lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                    x, s, gs, (1.0, 1.0), thr, sym=True),
                 "fused_phi_terms_sym_kernel")):
            us = kernel_us(fn, kernel)
            row = {"body": "library", "variant": name, "n": n, "m": m,
                   "ms": None if us is None else us / 1e3}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def wide_breakdown_main(args) -> int:
    """--wide-breakdown: wide_breakdown's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "wide_breakdown": wide_breakdown(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/wide_breakdown.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


#: --bf16's harness: K2's and K3's bf16 instances on their bodies, built
#: from a copy of csrc/ whose header a variant rewrote. The parent's design
#: (wide_tri.cuh's wide_pair_body with kBf16: 64 x 64 tile pairs, a block
#: each, over the triangle or a panel's tile pairs, whose spot is a copy of
#: fused_phi_panel.cu's panel_spot) and bf16_tri_sm90.cuh's body (the pack
#: kernel, then the persistent sweep). Not a kernel of the package.
BF16_BREAKDOWN_SOURCE = r"""
#include "bf16_tri_sm90.cuh"
#include "wide_tri.cuh"
using namespace svgd;
__device__ bool parent_spot(int x, int p, int nb, int w, int n, int m,
                            float* panels, WideSpot* spot) {
  const int n_off = nb * (nb - 1) / 2;
  int bi, bj;
  if (p < n_off) {
    decode_upper_pair(p, nb - 1, &bi, &bj);
    ++bj;
  } else {
    bi = bj = p - n_off;
  }
  const int tw = w / kWideTile;
  int a, b;
  if (bi == bj) {
    if (x >= tw * (tw + 1) / 2) return false;
    decode_upper_pair(x, tw, &a, &b);
  } else {
    a = x / tw;
    b = x - a * tw;
  }
  spot->i0 = bi * w + a * kWideTile;
  spot->j0 = bj * w + b * kWideTile;
  if (spot->i0 >= n || spot->j0 >= n) return false;
  spot->diag = bi == bj && a == b;
  const size_t plane = static_cast<size_t>(2) * m * w;
  spot->out0 = panels + static_cast<size_t>(p) * 2 * plane;
  spot->out1 = spot->out0 + plane;
  spot->base0 = bi * w;
  spot->base1 = bj * w;
  spot->ld = w;
  return true;
}
__global__ void __launch_bounds__(kWideTriThreads)
    parent_tri(const float* x, const float* s, const float* gamma,
               const float* thr, int n, int m, int nb, float* acc,
               unsigned long long* counts) {
  wide_tri_body<3, true>(x, s, OneRbf{-gamma[0] * kLog2e}, thr, n, m, 3, nb,
                         0LL, acc, counts);
}
__global__ void __launch_bounds__(kWideTriThreads)
    parent_panel(const float* x, const float* s, const float* gamma,
                 const float* thr, int n, int m, int nb, int w,
                 float* panels, unsigned long long* counts) {
  WideSpot spot;
  if (!parent_spot(blockIdx.x, blockIdx.y, nb, w, n, m, panels, &spot)) {
    return;
  }
  wide_pair_body<3, true, false>(x, s, OneRbf{-gamma[0] * kLog2e}, thr, n,
                                 m, 3, spot, counts, WideForm{});
}
__global__ void __launch_bounds__(kBf16Threads, 1)
    new_tri(Bf16Operands ops, const float* gamma, const float* thr, int n,
            int m, int nb, long long items, float* acc,
            unsigned long long* counts) {
  bf16_tri_body<3>(ops, -gamma[0] * kLog2e, thr, n, m, 3, items,
                   Bf16TriWork{nb, n, acc}, counts);
}
__global__ void __launch_bounds__(kBf16Threads, 1)
    new_panel(Bf16Operands ops, const float* gamma, const float* thr, int n,
              int m, long long items, Bf16PanelWork wk,
              unsigned long long* counts) {
  bf16_tri_body<3>(ops, -gamma[0] * kLog2e, thr, n, m, 3, items, wk,
                   counts);
}
extern "C" int bd_parent(int panel, const float* x, const float* s,
                         const float* gamma, const float* thr, int n, int m,
                         int nb, int w, float* out, long long* counts,
                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const size_t smem = WideTri::smem_bytes(1);
  if (panel) {
    wide_tri_prepare(&parent_panel, 1);
    const int tw = w / kWideTile;
    parent_panel<<<dim3(tw * tw, nb * (nb + 1) / 2), kWideTriThreads, smem,
                   st>>>(x, s, gamma, thr, n, m, nb, w, out, c);
  } else {
    wide_tri_prepare(&parent_tri, 1);
    const int nbt = (n + kWideTile - 1) / kWideTile;
    parent_tri<<<static_cast<unsigned int>(upper_pairs(n, kWideTile)),
                 kWideTriThreads, smem, st>>>(x, s, gamma, thr, n, m, nbt,
                                              out, c);
  }
  return static_cast<int>(cudaGetLastError());
}
extern "C" int bd_new(int panel, int sweep, const float* x, const float* s,
                      const float* gamma, const float* thr, int n, int m,
                      int nb, int w, void* work, float* out,
                      long long* counts, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const Bf16Operands ops = sweep == 1 ? bf16_operands(work, n, m, false)
                                      : bf16_tri_pack(x, s, n, m, work, st);
  if (sweep < 0) return static_cast<int>(cudaGetLastError());
  if (panel) {
    const int tw = w / kBf16Tile;
    const long long off = static_cast<long long>(nb) * (nb - 1) / 2 * tw * tw;
    const long long items = off + static_cast<long long>(nb) * tw * (tw + 1) / 2;
    const Bf16PanelWork wk{nb, tw, w, n, out};
    new_panel<<<bf16_tri_prepare(&new_panel, items), kBf16Threads,
                Bf16Tri::kSmemBytes, st>>>(ops, gamma, thr, n, m, items, wk,
                                           c);
  } else {
    const long long items = upper_pairs(n, kBf16Tile);
    new_tri<<<bf16_tri_prepare(&new_tri, items), kBf16Threads,
              Bf16Tri::kSmemBytes, st>>>(ops, gamma, thr, n, m,
                                         (n + kBf16Tile - 1) / kBf16Tile,
                                         items, out, c);
  }
  return static_cast<int>(cudaGetLastError());
}
// The mma.sync rate of the new body's products: every warp of 132 blocks
// of `warps` warps issues `iters` x 8 independent bf16 m16n8k16 products
// from registers.
__global__ void bf16_mma_rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x ^ 5u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) mma_bf16(d[c], a, b0, 11u);
  }
  float z = 0.0f;
  for (int c = 0; c < 8; ++c) z += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (z == 1234.5f) out[0] = z;
}
extern "C" int bd_mma_rate(int warps, int iters, float* out, void* stream) {
  bf16_mma_rate<<<132, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""

#: The variants of bf16_tri_sm90.cuh's body: (old, new) rewrites of the
#: header, each timing what is left when a part is taken out (the parent's
#: are WIDE_PAIR_VARIANTS, rewrites of wide_tri.cuh).
_BF16_SINK = (
    "      {\n        float z = 0.0f;\n#pragma unroll\n"
    "        for (int c = 0; c < 16; ++c) {\n#pragma unroll\n"
    "          for (int e = 0; e < 4; ++e) z += acc[c][e];\n        }\n"
    "        if (z == 1234.5f) counts[0] = 7;\n#pragma unroll\n"
    "        for (int kk = 0; kk < 8; ++kk) {\n#pragma unroll\n"
    "          for (int e = 0; e < 4; ++e) kf[kk][e] = 0u;\n        }\n"
    "      }\n")
_BF16_WEIGH = "        weigh_pass(std::true_type{}, std::true_type{});\n"
_BF16_NTV = ("      const int ntv = min(cw >> 3, (2 * m + 1 - c0 + 7) >> 3);\n")
BF16_VARIANTS = {
    "full": [],
    "no flush atomics": [
        ("            atomicAdd(dst + static_cast<size_t>(col) * ld + "
         "(o - base),",
         "            if (__float_as_uint(out[nt][e]) == 0x7fbadbadu)\n"
         "            atomicAdd(dst + static_cast<size_t>(col) * ld + "
         "(o - base),")],
    "no contraction": [(_BF16_NTV, "      const int ntv = 0;\n")],
    # The other staging design, consumers rounding float32 slots, stages
    # twice the bytes: its lower bound, every copy issued twice (the
    # conversion at each fragment load left out).
    "every copy twice": [
        ("          cp_async16_shared(\n"
         "              dst + 16u * kBf16Producers * i,",
         "          for (int twice = 0; twice < 2; ++twice)\n"
         "          cp_async16_shared(\n"
         "              dst + 16u * kBf16Producers * i,")],
    "staging, Gram and weights": [
        (_BF16_NTV, "      const int ntv = 0;\n"),
        ("      const int ntv = 0;\n", "      const int ntv = 0;\n")],
    "staging and Gram only": [
        (_BF16_NTV, "      const int ntv = 0;\n"),
        (_BF16_WEIGH, _BF16_SINK)],
    "staging only": [
        (_BF16_NTV, "      const int ntv = 0;\n"),
        (_BF16_WEIGH, _BF16_SINK),
        ("          const int kv = min(sl >> 4, (m - s * sl + 15) >> 4);\n",
         "          const int kv = 0;\n")],
}
del BF16_VARIANTS["staging, Gram and weights"]

#: --bf16's shapes: the four of the parts (K2 at the flagship's (10000, 2)
#: and at a9a's (10000, 123); K3 at phase 46b's forced panel (32768, 2) and
#: at (10000, 123)), and the ladder at n = 4096.
BF16_PART_SHAPES = (("K2", 10000, 2), ("K2", 10000, 123), ("K3", 32768, 2),
                    ("K3", 10000, 123))
BF16_LADDER_N = 4096
BF16_LADDER_MS = (2, 11, 16, 17, 65, 123, 256)


def bf16_breakdown_copy(dest, parent, rewrites):
    """A copy of csrc/ under ``dest`` with ``rewrites`` applied to the
    parent's header (wide_tri.cuh) or the new body's (bf16_tri_sm90.cuh),
    and the harness source beside it."""
    dest = parent_csrc(dest)
    header = dest / ("wide_tri.cuh" if parent else "bf16_tri_sm90.cuh")
    text = header.read_text()
    for old, new in rewrites:
        if text.count(old) != 1:
            raise RuntimeError(f"bf16_breakdown_copy: {header.name} holds "
                               f"{text.count(old)} copies of {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    (dest / "breakdown.cu").write_text(BF16_BREAKDOWN_SOURCE)
    return dest


def bf16_breakdown(device):
    """--bf16: K2's and K3's bf16 instances, the parent's body
    (wide_pair_body with kBf16) and the new one (bf16_tri_sm90.cuh), each
    variant built in a copy under _verify/bf16_breakdown/ (no switch in the
    sources) and timed with CUDA events (median of 3 runs of 10 launches
    after 3; the new body's time is its pack kernel's and its sweep's):
    both bodies' parts at BF16_PART_SHAPES, both on the ladder
    (BF16_LADDER_N, BF16_LADDER_MS), the pack kernel alone, bf16
    mma.sync's own rate; then, kernel-only (the profiler's events) in the
    package's library, the bf16 instances and the float32 K2 at (10000, 2)
    and the float32 wide triangle at (10000, 123)."""
    import ctypes

    import torch

    from chip_smoke import kernel_us
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops import sym_plan
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    base = ROOT / "_verify" / "bf16_breakdown"
    jobs = ([(True, name, rw) for name, rw in WIDE_PAIR_VARIANTS.items()]
            + [(False, name, rw) for name, rw in BF16_VARIANTS.items()])
    procs = []
    for idx, (parent, name, rewrites) in enumerate(jobs):
        dest = bf16_breakdown_copy(base / f"v{idx}", parent, rewrites)
        cmd = [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
               str(dest / "libbreakdown.so"), str(dest / "breakdown.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    libs, spills = [], []
    for idx, ((parent, name, _), proc) in enumerate(zip(jobs, procs)):
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"bf16 breakdown build {name}:\n{out}")
        spills.append([int(b) for b in
                       re.findall(r"(\d+) bytes spill stores", out)])
        lib = ctypes.CDLL(str(base / f"v{idx}" / "libbreakdown.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bd_parent.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr] * 3
        lib.bd_new.argtypes = [i32] * 2 + [ptr] * 4 + [i32] * 4 + [ptr] * 4
        lib.bd_mma_rate.argtypes = [i32, i32, ptr, ptr]
        libs.append(lib)

    def inputs(n, m, seed):
        gen = torch.Generator().manual_seed(seed)
        x = torch.randn(n, m, generator=gen)
        x = (x - x.mean(dim=0)).contiguous().to(device)
        s = torch.randn(n, m, generator=gen).contiguous().to(device)
        gamma = torch.tensor([0.5 / m], device=device)
        thr = torch.tensor([1.5 * m, 2.0 * m, 2.5 * m], device=device)
        return x, s, gamma, thr

    def events(call):
        for _ in range(3):
            call()
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 10)
        return sorted(runs)[1]

    stream = torch.cuda.current_stream().cuda_stream

    def timed(lib, parent, kernel, n, m, sweep=0):
        """ms of one call: the parent's sweep, or the new body's pack and
        sweep (sweep 0), its sweep alone (1) or its pack alone (-1)."""
        x, s, gamma, thr = inputs(n, m, n + m)
        counts = torch.zeros(3, dtype=torch.int64, device=device)
        panel = kernel == "K3"
        nb, w, _ = sym_plan.card_panel_plan(n, bf16=not parent)
        num_p = nb * (nb + 1) // 2
        out = torch.zeros((num_p, 2, 2 * m, w) if panel and parent
                          else (2 * m if parent else 2 * m + 1, n),
                          device=device)
        work = torch.empty(sym_plan.bf16_work_bytes(n, m), dtype=torch.uint8,
                           device=device)
        if not parent and sweep == 1:  # the operands, packed once
            lib.bd_new(int(panel), -1, x.data_ptr(), s.data_ptr(),
                       gamma.data_ptr(), thr.data_ptr(), n, m, nb, w,
                       work.data_ptr(), out.data_ptr(), counts.data_ptr(),
                       stream)

        def call():
            if parent:
                rc = lib.bd_parent(int(panel), x.data_ptr(), s.data_ptr(),
                                   gamma.data_ptr(), thr.data_ptr(), n, m,
                                   nb, w, out.data_ptr(), counts.data_ptr(),
                                   stream)
            else:
                rc = lib.bd_new(int(panel), sweep, x.data_ptr(),
                                s.data_ptr(), gamma.data_ptr(),
                                thr.data_ptr(), n, m, nb, w, work.data_ptr(),
                                out.data_ptr(), counts.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"bf16 breakdown launch returned {rc}")
        return events(call)

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for idx, (parent, name, _) in enumerate(jobs):
        body = "wide_pair_body (kBf16)" if parent else "bf16_tri_sm90_body"
        for kernel, n, m in BF16_PART_SHAPES:
            emit({"body": body, "variant": name, "kernel": kernel, "n": n,
                  "m": m, "ms": timed(libs[idx], parent, kernel, n, m),
                  "spill_bytes": spills[idx]})
    full_parent = jobs.index((True, "full", []))
    full_new = jobs.index((False, "full", []))
    for kernel, n, m in BF16_PART_SHAPES:
        emit({"body": "bf16_tri_sm90_body", "variant": "sweep alone (operands "
              "packed before)", "kernel": kernel, "n": n, "m": m,
              "ms": timed(libs[full_new], False, kernel, n, m, sweep=1)})
        emit({"body": "bf16_tri_pack", "variant": "pack alone",
              "kernel": kernel, "n": n, "m": m,
              "ms": timed(libs[full_new], False, kernel, n, m, sweep=-1)})
    for m in BF16_LADDER_MS:
        for kernel in ("K2", "K3"):
            p_ms = timed(libs[full_parent], True, kernel, BF16_LADDER_N, m)
            n_ms = timed(libs[full_new], False, kernel, BF16_LADDER_N, m)
            emit({"ladder": kernel, "n": BF16_LADDER_N, "m": m,
                  "parent_ms": p_ms, "new_ms": n_ms,
                  "speedup": p_ms / n_ms})
    sink = torch.zeros(1, device=device)
    for warps in (8, 16, 32):
        iters = 4096
        lib = libs[full_new]
        lib.bd_mma_rate(warps, iters, sink.data_ptr(), stream)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.bd_mma_rate(warps, iters, sink.data_ptr(), stream)
        end.record()
        end.synchronize()
        if rc:
            raise RuntimeError(f"bd_mma_rate returned {rc}")
        ms = start.elapsed_time(end)
        flops = 132 * warps * iters * 8 * (16 * 8 * 16 * 2)
        emit({"body": "mma.sync m16n8k16 bf16", "warps_per_sm": warps,
              "ms": ms, "tflops": flops / ms / 1e9})
    # The package's library: the bf16 instances (pack and sweep events)
    # beside the float32 K2 and the float32 wide triangle.
    cuda_phi.load_library()
    for kernel, n, m in BF16_PART_SHAPES:
        x, s, gamma, thr = inputs(n, m, n + m)
        sym = "panel" if kernel == "K3" else True
        name = ("fused_phi_counts_sympanel_bf16" if kernel == "K3"
                else "fused_phi_counts_sym_bf16")
        fn = (lambda x=x, s=s, g=gamma[0], thr=thr, sym=sym:
              cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=sym,
                                          dot_dtype="bfloat16"))
        row = {"library": kernel + " bf16", "n": n, "m": m,
               "kernel_us": kernel_us(fn, name),
               "pack_us": kernel_us(fn, "bf16_tri_pack")}
        if kernel == "K2":
            row["float32_kernel_us"] = kernel_us(
                lambda x=x, s=s, g=gamma[0], thr=thr:
                cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True),
                "fused_phi_counts_sym_kernel")
        emit(row)
    return rows


def bf16_main(args) -> int:
    """--bf16: bf16_breakdown's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "bf16": bf16_breakdown(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/bf16_breakdown.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --float32-check's calls: the float32 instances at their PERF.md
#: main-path shapes (and the bf16 instances of K1, K2 and K15: a body a
#: PR moves is timed here beside those it leaves), (label, kernel name,
#: n, m, form) with form "square", "tri", "panel", "terms" (two terms, the
#: triangle), "chunk" (K4, world 1), "aniso" (K14's wide groups, iso + 1,
#: P as chip_smoke.wide_p_ps's "pd"), "square bf16", "tri bf16" or
#: "k15 bf16". K1 bf16's name holds its sweep's kernel alone (its pack and
#: finishing pass apart). K3 wide's name holds the whole sweep's kernel under both
#: designs (fused_phi_counts_sympanel_kernel before the panels' wide
#: entries, fused_phi_counts_sympanel_wide_kernel since).
FLOAT32_CHECK_CASES = (
    ("K1", "fused_phi_counts_square", 1000, 50, "square"),
    ("K2", "fused_phi_counts_sym_kernel", 10000, 2, "tri"),
    ("K2 wide", "fused_phi_counts_sym_kernel", 10000, 123, "tri"),
    ("K4 wide", "fused_phi_counts_sym_chunk_kernel", 10000, 123, "chunk"),
    ("K3", "fused_phi_counts_sympanel_kernel", 32768, 2, "panel"),
    ("K3 wide", "fused_phi_counts_sympanel", 10000, 123, "panel"),
    ("K8/K9", "fused_phi_terms_sym_kernel", 10000, 11, "terms"),
    ("K8/K9 wide", "fused_phi_terms_sym_kernel", 10000, 124, "terms"),
    ("K14 wide", "fused_phi_aniso_terms_wide", 10240, 123, "aniso"),
    ("K1 wide", "fused_phi_counts_square_kernel", 1000, 123, "square"),
    ("K1 bf16", "fused_phi_counts_square_bf16", 1000, 50, "square bf16"),
    ("K2 bf16", "fused_phi_counts_sym_bf16", 10000, 2, "tri bf16"),
    ("K15 bf16", "phi_rbf_wide_bf16", 10240, 123, "k15 bf16"),
)


def float32_check(device):
    """--float32-check: kernel-only us (the profiler's events, 10 calls
    after one) of FLOAT32_CHECK_CASES through the package's wrappers, on
    chip_smoke's inputs. It uses only wrappers that trees before the bf16
    triangle body have too, so that a copy of this script times an older
    tree the same way (parent, change, change, parent in one call)."""
    import torch

    from chip_smoke import inputs_for, kernel_us, wide_p_ps
    from svgdcpp_tpu_torch.ops import cuda_phi

    rows = []
    for label, name, n, m, form in FLOAT32_CHECK_CASES:
        x, s, g, thr = inputs_for(n, m, 0.0, 60 + m, device)
        if form == "terms":
            gs = [g, 0.5 * g]
            fn = (lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                x, s, gs, (1.0, 1.0), thr, sym=True))
        elif form == "chunk":
            fn = (lambda: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                x, s, g, thr, 1, 0))
        elif form == "aniso":
            ps = wide_p_ps("pd", m, 1, 445, g, device)
            lowers = cuda_phi.cholesky_factors(ps, device)
            fn = (lambda ps=ps, lowers=lowers:
                  cuda_phi.phi_rbf_aniso_terms_fused_cuda(
                      x, s, [g], (1.0,), ps, (1.0,), thr, lowers=lowers))
        elif form == "k15 bf16":
            p = torch.eye(m, device=device) * g
            fn = (lambda: cuda_phi.phi_rbf_cuda(x, s, p,
                                                dot_dtype="bfloat16"))
        else:
            sym = {"square": False, "square bf16": False, "tri": True,
                   "tri bf16": True, "panel": "panel"}[form]
            dd = "bfloat16" if form.endswith("bf16") else "float32"
            fn = (lambda sym=sym, dd=dd: cuda_phi.phi_rbf_fused_cuda(
                x, s, g, thr, sym=sym, dot_dtype=dd))
        row = {"case": label, "n": n, "m": m,
               "kernel_us": kernel_us(fn, name)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def float32_check_main(args) -> int:
    """--float32-check: float32_check's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "root": str(ROOT),
              "float32_check": float32_check(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/float32_check.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


#: --aniso-wide: the parent's K14 wide term groups (csrc/fused_phi_aniso.cu
#: before they moved to wide_tri_sm90.cuh's body: every group on
#: wide_tri.cuh's wide_tri_body, two weight tiles, tiles of 64), as that
#: file had them, under another kernel name and a C entry of their own;
#: built from a copy of csrc/ (parent_csrc's wide_tri.cuh).
ANISO_WIDE_PARENT_SOURCE = r"""
#include "wide_tri.cuh"
using namespace svgd;
template <int kT>
__global__ void __launch_bounds__(kWideTriThreads)
    parent_aniso_terms_wide_kernel(
        const float* __restrict__ coords, const float* __restrict__ z,
        const float* __restrict__ scores, const float* __restrict__ gammas,
        TermSigns iso_signs, int n_iso, AnisoSigns aniso_signs,
        const float* __restrict__ thr, int n, int m, int T, int nb,
        float* __restrict__ acc, unsigned long long* __restrict__ counts) {
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];
  const int group = static_cast<int>(blockIdx.y);
  const bool euclid = group == 0;
  if (euclid) {
    load_terms(gammas, iso_signs, n_iso, sh_g2, sh_sn, sh_sg);
  } else if (threadIdx.x == 0) {
    const float sign = aniso_signs.s[group - 1];
    sh_g2[0] = -kLog2e;
    sh_sn[0] = sign;
    sh_sg[0] = sign;
  }
  const float* rows =
      euclid ? coords : z + static_cast<size_t>(group - 1) * n * m;
  WideForm form;
  form.phi = !euclid || n_iso > 0;
  wide_tri_body<kT>(rows, scores,
                    AnyTerms{sh_g2, sh_sn, sh_sg, euclid ? n_iso : 1}, thr, n,
                    m, euclid ? T : 0, nb, 0LL,
                    acc + static_cast<size_t>(group) * 2 * m * n, counts,
                    form);
}
extern "C" int parent_aniso_wide(const float* coords, const float* z,
                                 const float* scores, const float* gammas,
                                 const float* iso_signs, int n_iso,
                                 const float* aniso_signs, int n_aniso,
                                 const float* thr, int n, int m, int T,
                                 float* acc, long long* counts,
                                 void* stream) {
  const TermSigns si = make_signs(iso_signs, n_iso);
  AnisoSigns sa{};
  for (int t = 0; t < n_aniso; ++t) sa.s[t] = aniso_signs[t];
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const long long pairs = upper_pairs(n, kWideTile);
  if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(pairs), 1 + n_aniso);
  const int nb = (n + kWideTile - 1) / kWideTile;
  const size_t smem = WideTri::smem_bytes(2);
  auto go = [&](auto* kernel) {
    wide_tri_prepare(kernel, 2);
    kernel<<<grid, kWideTriThreads, smem, s>>>(coords, z, scores, gammas, si,
                                               n_iso, sa, thr, n, m, T, nb,
                                               acc, c);
  };
  if (T == 3) {
    go(&parent_aniso_terms_wide_kernel<3>);
  } else {
    go(&parent_aniso_terms_wide_kernel<kMaxT>);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

#: --aniso-wide's shapes: the anisotropic MVN's (10240, 123) and the
#: ladder n = 4096, m = 65, 123, 256, 512, each with chip_smoke.py's
#: WIDE_P_TERMS iso+1, iso+2 and 0+1.
ANISO_WIDE_SHAPES = ((10240, 123), (4096, 65), (4096, 123), (4096, 256),
                     (4096, 512))
ANISO_WIDE_TERMS = ("iso+1", "iso+2", "0+1")


def aniso_wide(device):
    """--aniso-wide: K14's wide term groups, the parent's kernel (built
    from ANISO_WIDE_PARENT_SOURCE in a copy under _verify/aniso_wide/) and
    the package's, in one process at ANISO_WIDE_SHAPES x ANISO_WIDE_TERMS
    on chip_smoke.py's grid inputs and P (wide_p_call's): kernel-only us
    (the profiler's events, 10 calls after one; the new call's count
    kernel apart for 0 + 1), wrapper ms (CUDA events, chip_smoke.time_ms;
    the parent's wrapper is its epilogue as it stood, the Cholesky factors
    kept as the driver keeps them), the 'rbf_terms' sweep of the same
    terms (ops/phi.phi_rbf_terms, each term's closed form), and both
    results' distance from each other and from the float64 plain
    version."""
    import ctypes

    import torch

    from chip_smoke import (
        WIDE_P_TERMS,
        grid_inputs,
        kernel_us,
        time_ms,
        wide_p_ps,
    )
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_aniso_terms_fused_counts,
        phi_rbf_terms,
    )
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    dest = parent_csrc(ROOT / "_verify" / "aniso_wide")
    (dest / "parent.cu").write_text(ANISO_WIDE_PARENT_SOURCE)
    proc = subprocess.Popen(
        [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
         str(dest / "libparent.so"), str(dest / "parent.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_phi.load_library()  # built meanwhile
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the parent's K14 wide build:\n{out}")
    lib = ctypes.CDLL(str(dest / "libparent.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.parent_aniso_wide.argtypes = ([ptr] * 5 + [i32, ptr, i32, ptr]
                                      + [i32] * 3 + [ptr] * 3)
    lib.parent_aniso_wide.restype = i32
    regs = re.findall(r"Used (\d+) registers", out)

    def host(values):
        return (ctypes.c_float * max(1, len(values)))(*map(float, values))

    rows = []
    for n, m in ANISO_WIDE_SHAPES:
        x, s, g, thr = grid_inputs(n, m, 0.0, 449 if n > 4096 else 440 + m,
                                   device)
        for spec in ANISO_WIDE_TERMS:
            iso_s, an_s = WIDE_P_TERMS[spec]
            iso_g = [g, 2.0 * g][:len(iso_s)]
            ps = wide_p_ps("pd", m, len(an_s), 445, g, device)
            lowers = cuda_phi.cholesky_factors(ps, device)

            def new_call():
                return cuda_phi.phi_rbf_aniso_terms_fused_cuda(
                    x, s, iso_g, iso_s, ps, an_s, thr, lowers=lowers)

            def parent_call():
                """The parent's wrapper past 64, as it stood."""
                g32 = (torch.stack([v.reshape(()) for v in iso_g]) if iso_g
                       else torch.zeros(1, device=device))
                coords_c = (x - x.mean(dim=0)).contiguous()
                z = (coords_c.double() @ lowers).float().contiguous()
                acc = torch.zeros((1 + len(an_s), 2 * m, n), device=device)
                upper = torch.zeros(thr.shape[0], dtype=torch.int64,
                                    device=device)
                rc = lib.parent_aniso_wide(
                    coords_c.data_ptr(), z.data_ptr(), s.data_ptr(),
                    g32.data_ptr(), host(iso_s), len(iso_s), host(an_s),
                    len(an_s), thr.data_ptr(), n, m, thr.shape[0],
                    acc.data_ptr(), upper.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"parent_aniso_wide returned {rc}")
                s_total = sum(map(float, iso_s)) + sum(map(float, an_s))
                grad = torch.einsum("tkn,tlk->nl", acc[1:, m:].double(),
                                    lowers)
                phi = (acc[:, :m].sum(dim=0).T - s_total * s
                       + 2.0 * acc[0, m:].T + 2.0 * grad.float()) / n
                return phi, 2 * upper - n

            # The rbf_terms route's sweep over the same terms: the median
            # RBF's gamma I (and 2 gamma I) and each P, signs +-1.
            kparams = ([v * torch.eye(m, device=device) for v in iso_g]
                       + list(ps))
            signs = [*iso_s, *an_s]
            terms = [(1 if sg > 0 else -1, ((k, 1),))
                     for k, sg in enumerate(signs)]
            new_phi, new_cnt = new_call()
            old_phi, old_cnt = parent_call()
            ref_phi, ref_cnt = phi_rbf_aniso_terms_fused_counts(
                x.double(), s.double(), [v.double() for v in iso_g], iso_s,
                [p.double() for p in ps], an_s, thr.double())
            scale = float(ref_phi.abs().max())
            row = {
                "n": n, "m": m, "terms": spec,
                "parent_kernel_us": kernel_us(
                    parent_call, "parent_aniso_terms_wide_kernel"),
                "new_kernel_us": kernel_us(
                    new_call, cuda_phi.ANISO_WIDE_KERNEL),
                "new_count_kernel_us": (
                    None if iso_s else kernel_us(new_call,
                                                 cuda_phi.COUNT_KERNEL)),
                "parent_wrapper_ms": time_ms(parent_call, reps=20, warmup=3),
                "new_wrapper_ms": time_ms(new_call, reps=20, warmup=3),
                "rbf_terms_ms": time_ms(
                    lambda: phi_rbf_terms(x, s, kparams, terms, 1024,
                                          psd_flags=[True] * len(terms)),
                    reps=5, warmup=1),
                "new_rel_err_f64": float(
                    (new_phi.double() - ref_phi).abs().max()) / scale,
                "parent_rel_err_f64": float(
                    (old_phi.double() - ref_phi).abs().max()) / scale,
                "counts_new_parent_f64": [new_cnt.tolist(),
                                          old_cnt.tolist(),
                                          ref_cnt.tolist()],
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    return {"parent_registers": regs, "rows": rows}


def aniso_wide_main(args) -> int:
    """--aniso-wide: aniso_wide's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "aniso_wide": aniso_wide(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/aniso_wide.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --wide-panel: the parent's float32 wide panels (csrc/fused_phi_panel.cu
#: before they moved to wide_tri_sm90.cuh's body: wide_tri.cuh's
#: wide_pair_body on one 64 x 64 tile pair of a panel a block, the grid
#: (tile pairs of a panel, panels), a diagonal panel's blocks past a <= b
#: returning at once, rows of I into half 0 and columns of J into half 1 of
#: the panel's window), as that file had them, under kernel names and a C
#: entry of their own; built from a copy of csrc/ (parent_csrc's
#: wide_tri.cuh).
WIDE_PANEL_PARENT_SOURCE = r"""
#include "wide_tri.cuh"
using namespace svgd;
__device__ __forceinline__ bool parent_panel_spot(int x, int p, int p0,
                                                  int nb, int w, int n,
                                                  int m, float* panels,
                                                  WideSpot* spot) {
  int bi, bj;
  const int n_off = nb * (nb - 1) / 2;
  if (p0 + p < n_off) {
    decode_upper_pair(p0 + p, nb - 1, &bi, &bj);
    ++bj;
  } else {
    bi = bj = p0 + p - n_off;
  }
  const int tw = w / kWideTile;
  int a, b;
  if (bi == bj) {
    if (x >= tw * (tw + 1) / 2) return false;
    decode_upper_pair(x, tw, &a, &b);
  } else {
    a = x / tw;
    b = x - a * tw;
  }
  spot->i0 = bi * w + a * kWideTile;
  spot->j0 = bj * w + b * kWideTile;
  if (spot->i0 >= n || spot->j0 >= n) return false;
  spot->diag = bi == bj && a == b;
  const size_t plane = static_cast<size_t>(2) * m * w;
  spot->out0 = panels + static_cast<size_t>(p) * 2 * plane;
  spot->out1 = spot->out0 + plane;
  spot->base0 = bi * w;
  spot->base1 = bj * w;
  spot->ld = w;
  return true;
}
template <int kT>
__global__ void __launch_bounds__(kWideTriThreads)
    parent_counts_sympanel_wide_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gamma, const float* __restrict__ thr,
        int n, int m, int T, int nb, int w, int p0,
        float* __restrict__ panels, unsigned long long* __restrict__ counts) {
  WideSpot spot;
  if (!parent_panel_spot(static_cast<int>(blockIdx.x),
                         static_cast<int>(blockIdx.y), p0, nb, w, n, m,
                         panels, &spot)) {
    return;
  }
  wide_pair_body<kT, false, false>(coords, scores,
                                   OneRbf{-gamma[0] * kLog2e}, thr, n, m, T,
                                   spot, counts, WideForm{});
}
template <int kT>
__global__ void __launch_bounds__(kWideTriThreads)
    parent_terms_sympanel_wide_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gammas, TermSigns signs, int nterms,
        const float* __restrict__ thr, int n, int m, int T, int nb, int w,
        float* __restrict__ panels, unsigned long long* __restrict__ counts) {
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];
  WideSpot spot;
  if (!parent_panel_spot(static_cast<int>(blockIdx.x),
                         static_cast<int>(blockIdx.y), 0, nb, w, n, m,
                         panels, &spot)) {
    return;
  }
  load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);
  wide_pair_body<kT, false, false>(coords, scores,
                                   AnyTerms{sh_g2, sh_sn, sh_sg, nterms},
                                   thr, n, m, T, spot, counts, WideForm{});
}
// nterms 0: one RBF over panels [p0, p0 + num_p) (K3's whole list, or K5's
// chunk); else the terms kernel over the whole list (p0 = 0).
extern "C" int parent_sympanel_wide(const float* coords, const float* scores,
                                    const float* gammas, const float* signs,
                                    int nterms, const float* thr, int n,
                                    int m, int T, int nb, int w, int p0,
                                    int num_p, float* panels,
                                    long long* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const int tw = w / kWideTile;
  const dim3 grid(static_cast<unsigned int>(tw) * tw,
                  static_cast<unsigned int>(num_p));
  if (nterms == 0) {
    const size_t smem = WideTri::smem_bytes(1);
    auto go = [&](auto* kernel) {
      wide_tri_prepare(kernel, 1);
      kernel<<<grid, kWideTriThreads, smem, s>>>(coords, scores, gammas, thr,
                                                 n, m, T, nb, w, p0, panels,
                                                 c);
    };
    if (T == 3) {
      go(&parent_counts_sympanel_wide_kernel<3>);
    } else {
      go(&parent_counts_sympanel_wide_kernel<kMaxT>);
    }
  } else {
    const TermSigns sg = make_signs(signs, nterms);
    const size_t smem = WideTri::smem_bytes(2);
    auto go = [&](auto* kernel) {
      wide_tri_prepare(kernel, 2);
      kernel<<<grid, kWideTriThreads, smem, s>>>(coords, scores, gammas, sg,
                                                 nterms, thr, n, m, T, nb, w,
                                                 panels, c);
    };
    if (T == 3) {
      go(&parent_terms_sympanel_wide_kernel<3>);
    } else {
      go(&parent_terms_sympanel_wide_kernel<kMaxT>);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
"""

#: --wide-panel's calls: (label, n, m, form, world, rank, parent), form
#: "k3" (one RBF, the whole list), "k12" (two terms) or "k5" (rank's
#: chunk); each beside the wide triangle at the same shape (K2, K8/K9 or
#: K4's chunk at the same world and rank); parent False skips the parent
#: (the triangle's order against the panels' at (131072, 123)).
WIDE_PANEL_CASES = (
    ("K3", 10000, 123, "k3", 1, 0, True),
    ("K12/K13", 10000, 124, "k12", 1, 0, True),
    ("K5", 10000, 123, "k5", 1, 0, True),
    ("K5", 10000, 123, "k5", 2, 0, True),
    ("K5", 10000, 123, "k5", 2, 1, True),
    ("K3", 4096, 65, "k3", 1, 0, True),
    ("K3", 4096, 123, "k3", 1, 0, True),
    ("K3", 4096, 256, "k3", 1, 0, True),
    ("K3", 131072, 123, "k3", 1, 0, False),
)


def wide_panel(device):
    """--wide-panel: the panels' float32 wide instances, the parent's
    (built from WIDE_PANEL_PARENT_SOURCE in a copy under
    _verify/wide_panel/) and the package's, in one process at
    WIDE_PANEL_CASES on chip_smoke.py's grid inputs: kernel-only us (the
    profiler's events, 10 calls after one; 3 at 131072), wrapper ms (CUDA
    events, chip_smoke.time_ms; the parent's wrapper is the centring, the
    zeroed windows, the launch and the scatter as they stood, on its plan
    of 64-particle multiples), the window buffer's bytes, and at world 1
    each result's distance from the float64 plain version (at 131072 the
    panel's from the triangle's), with the counts."""
    import ctypes

    import torch

    from chip_smoke import grid_inputs, kernel_us, time_ms
    from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
    from svgdcpp_tpu_torch.ops.phi import (
        panel_index,
        phi_rbf_fused_counts,
        phi_rbf_fused_sym_finish,
        phi_rbf_terms_fused_counts,
        sympanel_epilogue,
        sympanel_scatter,
    )
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    dest = parent_csrc(ROOT / "_verify" / "wide_panel")
    (dest / "parent.cu").write_text(WIDE_PANEL_PARENT_SOURCE)
    proc = subprocess.Popen(
        [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
         str(dest / "libparent.so"), str(dest / "parent.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_phi.load_library()  # built meanwhile
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the parent's wide panel build:\n{out}")
    lib = ctypes.CDLL(str(dest / "libparent.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.parent_sympanel_wide.argtypes = ([ptr] * 4 + [i32, ptr] + [i32] * 7
                                         + [ptr] * 3)
    lib.parent_sympanel_wide.restype = i32
    regs = re.findall(r"Used (\d+) registers", out)
    signs = (1.0, 1.0)
    host_signs = (ctypes.c_float * 2)(*signs)

    rows = []
    for label, n, m, form, world, rank, with_parent in WIDE_PANEL_CASES:
        x, s, g, thr = grid_inputs(n, m, 0.0, 451 + m + n % 7, device)
        gs = [g, 0.5 * g]
        nb, w, _ = sym_plan.card_panel_plan(n)  # the parent's plan
        num_p = nb * (nb + 1) // 2
        p0, count = ((0, num_p) if form != "k5"
                     else sym_plan.panel_chunk(nb, world, rank))
        index = panel_index(nb, device, p0, count)  # the parent's, cached
        if form == "k3":
            def new_call():
                return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr,
                                                   sym="panel")

            def tri_call():
                return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)
            names = ("fused_phi_counts_sympanel_wide_kernel",
                     "fused_phi_counts_sym_kernel")
        elif form == "k12":
            def new_call():
                return cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs,
                                                         thr, sym="panel")

            def tri_call():
                return cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs,
                                                         thr, sym=True)
            names = ("fused_phi_terms_sympanel_wide_kernel",
                     "fused_phi_terms_sym_kernel")
        else:
            def new_call():
                return cuda_phi.phi_rbf_sympanel_chunk_cuda(x, s, g, thr,
                                                            world, rank)

            def tri_call():
                return cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, s, g, thr,
                                                             world, rank)
            names = ("fused_phi_counts_sympanel_chunk_wide_kernel",
                     "fused_phi_counts_sym_chunk_kernel")

        def parent_call():
            """The parent's wrapper past 64, as it stood: its plan, zeroed
            windows, the launch and the scatter (and, for the whole list,
            the epilogue)."""
            g32 = torch.stack([v.reshape(()) for v in
                               (gs if form == "k12" else [g])])
            coords_c = (x - x.mean(dim=0)).contiguous()
            panels = torch.zeros((count, 2, 2 * m, w), device=device)
            upper = torch.zeros(thr.shape[0], dtype=torch.int64,
                                device=device)
            rc = lib.parent_sympanel_wide(
                coords_c.data_ptr(), s.data_ptr(), g32.data_ptr(), host_signs,
                2 if form == "k12" else 0, thr.data_ptr(), n, m,
                thr.shape[0], nb, w, p0, count, panels.data_ptr(),
                upper.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent_sympanel_wide returned {rc}")
            if form == "k5":
                return sympanel_scatter(panels, index, nb, n), upper
            s_total, d_scale = ((2.0, 2.0) if form == "k12"
                                else (1.0, 2.0 * g))
            return sympanel_epilogue(panels, upper, index, n, s, s_total,
                                     d_scale)

        def phi_of(result):
            """phi and counts of a call (a chunk's raw accumulator
            finished, its counts as 2U - n)."""
            if form != "k5":
                return result
            acc, upper = result
            return phi_rbf_fused_sym_finish(acc, s, g, n), 2 * upper - n

        calls = 3 if n > 100000 else 10
        new_phi, new_cnt = phi_of(new_call())
        tri_phi, tri_cnt = phi_of(tri_call())
        row = {
            "kernel": label, "n": n, "m": m, "world": world, "rank": rank,
            "new_kernel_us": kernel_us(new_call, names[0], calls=calls),
            "triangle_kernel_us": kernel_us(tri_call, names[1], calls=calls),
            "new_wrapper_ms": time_ms(new_call, reps=calls, warmup=2),
            "triangle_wrapper_ms": time_ms(tri_call, reps=calls, warmup=2),
            "new_plan": list(sym_plan.card_panel_plan(n, None, True)[:2]),
        }
        if with_parent:
            old_phi, old_cnt = phi_of(parent_call())
            row.update({
                "parent_kernel_us": kernel_us(
                    parent_call, ("parent_counts_sympanel_wide",
                                  "parent_terms_sympanel_wide"),
                    calls=calls),
                "parent_wrapper_ms": time_ms(parent_call, reps=calls,
                                             warmup=2),
                "parent_plan": [nb, w],
                "parent_window_bytes": 4 * count * 2 * 2 * m * w,
            })
        if not with_parent:
            # No float64 sweep at this size: the panels' order against the
            # triangle's on the same inputs.
            scale = float(tri_phi.abs().max())
            row.update({
                "new_rel_diff_triangle": float(
                    (new_phi - tri_phi).abs().max()) / scale,
                "counts_new_triangle": [new_cnt.tolist(), tri_cnt.tolist()],
            })
        elif world == 1:  # a rank's share of two is no function of its own
            if form == "k12":
                ref_phi, ref_cnt = phi_rbf_terms_fused_counts(
                    x.double(), s.double(), [v.double() for v in gs], signs,
                    thr.double())
            else:
                ref_phi, ref_cnt = phi_rbf_fused_counts(
                    x.double(), s.double(), g.double(), thr.double())
            scale = float(ref_phi.abs().max())
            row.update({
                "new_rel_err_f64": float(
                    (new_phi.double() - ref_phi).abs().max()) / scale,
                "parent_rel_err_f64": float(
                    (old_phi.double() - ref_phi).abs().max()) / scale,
                "triangle_rel_err_f64": float(
                    (tri_phi.double() - ref_phi).abs().max()) / scale,
                "counts_new_parent_f64": [new_cnt.tolist(), old_cnt.tolist(),
                                          ref_cnt.tolist()],
            })
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"parent_registers": regs, "rows": rows}


def wide_panel_main(args) -> int:
    """--wide-panel: wide_panel's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "wide_panel": wide_panel(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/wide_panel.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --square-wide's and --square-bf16's parents: the wide square body that
#: csrc/square_mma.cuh held until K1's bf16 instance left it (its text
#: moved here whole: square_wide_body, SqWide, wide_square_blocks and
#: wide_square_chunks), with kBf16 = false as K1's and the terms kernel's
#: MM = 0 instances ran it and with kBf16 as K1's bf16 instance ran it: 4
#: warps of 16 target rows, tiles of 32 sources, the 2m + 1 columns in
#: 128-column chunks along the grid's z, square_chunk's plan; under kernel
#: names and C entries of their own, built from a copy of csrc/ (which
#: keeps the finishing pass; parent_csrc's wide_tri.cuh the helpers it
#: calls: operand_split, mma_pass, weight_fragment<kBf16>, kWideK and
#: kWideLdK).
SQUARE_WIDE_PARENT_SOURCE = r"""
#include "square_mma.cuh"
#include "wide_tri.cuh"
using namespace svgd;
// ---------------------------------------------------------------------------
// The Gram-form body square_wide_body, moved here from csrc/square_mma.cuh
// ---------------------------------------------------------------------------
//
// Its float32 form (kBf16 = false) ran K1's and the terms kernel's
// instances past kMaxM before square_wide_sm90.cuh's body, and its bf16
// form (kBf16) K1's bf16 instance before square_bf16_sm90.cuh's body:
// --square-wide and --square-bf16 build them as the parents.
//
// square_mma_body holds a warp's 16 target rows as A fragments (8 registers
// for each of ceil(m/8) k-steps) and 4 accumulator registers for each of
// ceil((2m + 1)/8) column blocks, and stages raw tiles of m floats a
// source: past m = 64 its registers pass 255 and its shared memory grows
// with m. square_wide_body keeps the same block (4 warps of 16 target
// rows), tile (32 sources), 3xTF32 mma.sync arithmetic, launch plan and
// finishing pass, with nothing sized by m:
//
//   * the Gram tile G = X_t X_s^T (16 x 32 a warp) runs over slices of
//     kWideK coordinates: per slice the block stages the 64 target rows'
//     and the 32 sources' coordinates as TF32 pairs in shared memory and
//     each warp reads its A and B fragments from there;
//   * the accumulator columns are cut into chunks of kWideCB column blocks
//     (128 columns), one chunk a block along the grid's z. Each chunk
//     recomputes the Gram tile and the weights of its pairs; only chunk 0
//     counts them, so each pair is counted once. At m = 123 one RBF has
//     ceil(247 / 128) = 2 chunks and two terms ceil(256 / 128) = 2: the
//     Gram tile (m-deep) is formed twice beside the two chunks' 128-column
//     contractions (PERF.md gives the cost).
//   * the chunk's records, the 32 sources' values at its 128 columns of
//     [S | X | 1] (one RBF) or [S | 0..][X | 1 | 0..] (terms), are staged
//     as TF32 pairs in the same shared memory as the Gram slices, read from
//     device memory after the Gram tile.
//
// Static shared memory: 2 x 4224 floats of records or slices and 32 source
// norms, 33.9 KB at any m. Registers: 16 x 4 accumulators, 2 x 4 x 4 Gram
// values, the weights' fragments and the counts.
//
// kBf16 (the bfloat16 opt-in, K1's bf16 instance at every m): the Gram
// slices' coordinates, the weights and the records rounded to bf16, each
// product one TF32 pass (operand_split, mma_pass); the norms stay those of
// the float32 coordinates and the finishing pass's D = rowsum x_i - KX
// takes the float32 x_i, as the JAX kernel's epilogue does
// (pallas_phi.py:429-433, :379, :707). No self pair is pinned: the square
// form has none (the JAX kernel pins none either).

constexpr int kWideCB = 16;               // column blocks of one chunk
constexpr int kWideCols = 8 * kWideCB;    // columns of one chunk
constexpr int kWideLdR = kWideCols + 4;   // records' stride (4 mod 32)

struct SqWide {
  static constexpr int kSlice = (kSqMmaRows + kSqMmaCols) * kWideLdK;
  static constexpr int kRecs = kSqMmaCols * kWideLdR;
  // floats of one half (big or small) of the shared union
  static constexpr int kHalf = kSlice > kRecs ? kSlice : kRecs;
};

// Record columns of a wide square launch at width m: [S | X | 1] for one
// RBF, [S | 0..][X | 1 | 0..] in two bands for terms; their column blocks,
// and the chunks (the grid's z) that cover them.
__host__ __device__ inline int wide_square_blocks(int m, bool two) {
  return two ? (m + 7) / 8 + (m + 1 + 7) / 8 : (2 * m + 1 + 7) / 8;
}

__host__ __device__ inline int wide_square_chunks(int m, bool two) {
  return (wide_square_blocks(m, two) + kWideCB - 1) / kWideCB;
}

// The block body past kMaxM (see above). part: this split's (n_t, 2m + 1)
// slice of the workspace; the block writes the columns of its chunk
// (blockIdx.z). Arguments as square_mma_body's.
template <int kT, bool kBf16 = false, class W>
__device__ __forceinline__ void square_wide_body(
    const float* __restrict__ targets, const float* __restrict__ sources,
    const float* __restrict__ scores, const W& weights,
    const float* __restrict__ thr, int n_t, int n_s, int m, int T, int chunk,
    float* __restrict__ part, unsigned long long* __restrict__ counts) {
  constexpr bool kTwo = kTwoBands<W>;
  __shared__ __align__(16) float sh[2 * SqWide::kHalf];
  __shared__ float norm_s[kSqMmaCols];
  float* big = sh;
  float* small = sh + SqWide::kHalf;
  // Gram slices: the block's targets [64][kWideLdK], then the sources
  // [32][kWideLdK]; records: [32][kWideLdR].
  constexpr int kSrc = kSqMmaRows * kWideLdK;

  const int nbs = (m + 7) / 8;
  const int xo = kTwo ? 8 * nbs : m;  // the record's column of x_0
  const int one = xo + m;             // the record's column of the 1
  const int b0 = static_cast<int>(blockIdx.z) * kWideCB;
  const int nbc = min(kWideCB, wide_square_blocks(m, kTwo) - b0);
  const bool counting = blockIdx.z == 0;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rb = static_cast<int>(blockIdx.x) * kSqMmaRows;
  const int j_begin = static_cast<int>(blockIdx.y) * chunk;
  const int j_end = min(n_s, j_begin + chunk);
  const int tiles = (j_end - j_begin + kSqMmaCols - 1) / kSqMmaCols;

  float th[kT];
#pragma unroll
  for (int q = 0; q < kT; ++q) th[q] = thr[q < T ? q : 0];

  // The warp's rows g and g + 8 and their squared norms (the quad's four
  // threads each sum every fourth coordinate).
  const int r0 = rb + 16 * warp + g;
  const bool ok0 = r0 < n_t;
  const bool ok1 = r0 + 8 < n_t;
  float nt0 = 0.0f;
  float nt1 = 0.0f;
  for (int k = t; k < m; k += 4) {
    const float v0 = ok0 ? targets[static_cast<size_t>(r0) * m + k] : 0.0f;
    const float v1 =
        ok1 ? targets[static_cast<size_t>(r0 + 8) * m + k] : 0.0f;
    nt0 = fmaf(v0, v0, nt0);
    nt1 = fmaf(v1, v1, nt1);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    nt0 += __shfl_xor_sync(0xffffffffu, nt0, off);
    nt1 += __shfl_xor_sync(0xffffffffu, nt1, off);
  }

  float acc[kWideCB][4];
#pragma unroll
  for (int b = 0; b < kWideCB; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[b][q] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int q = 0; q < kMaxT; ++q) cnt[q] = 0u;

#pragma unroll 1
  for (int c = 0; c < tiles; ++c) {
    const int j0 = j_begin + c * kSqMmaCols;
    // Gram tile: gb = big * big, gs = big * small + small * big.
    float gb[4][4];
    float gs[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gb[nb][q] = 0.0f;
        gs[nb][q] = 0.0f;
      }
    }
    // The sources' squared norms, 4 threads a source, summed over slices.
    const int js = tid >> 2;
    const bool js_ok = j0 + js < n_s;
    float qn = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < m; k0 += kWideK) {
      const int kn = min(kWideK, m - k0);
      __syncthreads();  // the shared union is free
      for (int e = tid; e < (kSqMmaRows + kSqMmaCols) * kWideK;
           e += kSqMmaThreads) {
        const int r = e / kWideK;
        const int k = e - r * kWideK;
        float v = 0.0f;
        if (k < kn) {
          if (r < kSqMmaRows) {
            if (rb + r < n_t) {
              v = targets[static_cast<size_t>(rb + r) * m + k0 + k];
            }
          } else if (j0 + r - kSqMmaRows < n_s) {
            v = sources[static_cast<size_t>(j0 + r - kSqMmaRows) * m + k0 +
                        k];
          }
        }
        uint32_t hi, lo;
        operand_split<kBf16>(v, hi, lo);
        big[r * kWideLdK + k] = __uint_as_float(hi);
        small[r * kWideLdK + k] = __uint_as_float(lo);
      }
      if (js_ok) {
        for (int k = k0 + (tid & 3); k < k0 + kn; k += 4) {
          const float v = sources[static_cast<size_t>(j0 + js) * m + k];
          qn = fmaf(v, v, qn);
        }
      }
      __syncthreads();  // the slices are complete
#pragma unroll
      for (int ks = 0; ks < kWideK / 8; ++ks) {
        if (8 * ks < kn) {
          const int ar = (16 * warp + g) * kWideLdK + 8 * ks + t;
          const uint32_t ab[4] = {
              __float_as_uint(big[ar]),
              __float_as_uint(big[ar + 8 * kWideLdK]),
              __float_as_uint(big[ar + 4]),
              __float_as_uint(big[ar + 8 * kWideLdK + 4])};
          const uint32_t as[4] = {
              __float_as_uint(small[ar]),
              __float_as_uint(small[ar + 8 * kWideLdK]),
              __float_as_uint(small[ar + 4]),
              __float_as_uint(small[ar + 8 * kWideLdK + 4])};
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int br = kSrc + (8 * nb + g) * kWideLdK + 8 * ks + t;
            const uint32_t bb0 = __float_as_uint(big[br]);
            const uint32_t bb1 = __float_as_uint(big[br + 4]);
            if constexpr (!kBf16) {
              mma_tf32(gs[nb], as, bb0, bb1);
              mma_tf32(gs[nb], ab, __float_as_uint(small[br]),
                       __float_as_uint(small[br + 4]));
            }
            mma_tf32(gb[nb], ab, bb0, bb1);
          }
        }
      }
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
    if ((tid & 3) == 0) norm_s[js] = qn;
    __syncthreads();  // the slices are consumed; the norms are stored

    // The chunk's records: column 8 b0 + cq of each source's record.
    for (int e = tid; e < kSqMmaCols * kWideCols; e += kSqMmaThreads) {
      const int j = e / kWideCols;
      const int cq = e - j * kWideCols;
      const int q = 8 * b0 + cq;
      const size_t row = static_cast<size_t>(j0 + j) * m;
      float v = 0.0f;
      if (j0 + j < n_s) {
        if (q < m) {
          v = scores[row + q];
        } else if (q >= xo && q < one) {
          v = sources[row + q - xo];
        } else if (q == one) {
          v = 1.0f;
        }
      }
      uint32_t hi, lo;
      operand_split<kBf16>(v, hi, lo);
      big[j * kWideLdR + cq] = __uint_as_float(hi);
      small[j * kWideLdR + cq] = __uint_as_float(lo);
    }
    __syncthreads();  // the records are complete

#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int jl = 8 * nb + 2 * t;  // sources jl, jl + 1 of the fragment
      const float ns0 = norm_s[jl];
      const float ns1 = norm_s[jl + 1];
      const bool c0 = j0 + jl < n_s;
      const bool c1 = j0 + jl + 1 < n_s;
      float kc[4], kw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float gr = gb[nb][q] + gs[nb][q];
        const float nt = q < 2 ? nt0 : nt1;
        const float ns = q & 1 ? ns1 : ns0;
        const float sq =
            fmaxf(__fsub_rn(__fadd_rn(nt, ns), 2.0f * gr), 0.0f);
        const bool cq = q & 1 ? c1 : c0;
        float a, b;
        weights(sq, a, b);
        kc[q] = cq ? a : 0.0f;
        kw[q] = cq ? b : 0.0f;
        if (counting) {
          const bool ok = (q < 2 ? ok0 : ok1) && cq;
          count_pair_fixed<kT, true>(sq, th, ok, cnt);
        }
      }
      uint32_t k_big[4], k_small[4], w_big[4], w_small[4];
      weight_fragment<kBf16>(kc, k_big, k_small);
      if constexpr (kTwo) weight_fragment<kBf16>(kw, w_big, w_small);
      const int bk = jl * kWideLdR + g;
#pragma unroll
      for (int b = 0; b < kWideCB; ++b) {
        if (b < nbc) {
          uint32_t ab[4], as[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool use_w = kTwo && b0 + b >= nbs;
            ab[q] = use_w ? w_big[q] : k_big[q];
            as[q] = use_w ? w_small[q] : k_small[q];
          }
          mma_pass<kBf16>(acc[b], ab, as, big, small, bk + 8 * b,
                          bk + kWideLdR + 8 * b);
        }
      }
    }
  }

  // The chunk's columns of the split's partial [KS | KX | rowsum], mapped
  // as square_mma_body maps its columns.
  const int wd = 2 * m + 1;
#pragma unroll
  for (int b = 0; b < kWideCB; ++b) {
    if (b < nbc) {
      const int bg = b0 + b;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + (q >> 1) * 8;
        const int cr = 8 * bg + 2 * t + (q & 1);
        int col = cr;
        bool keep = cr < wd;
        if constexpr (kTwo) {
          col = bg < nbs ? cr : m + (cr - xo);
          keep = bg < nbs ? cr < m : cr - xo <= m;
        }
        if (row < n_t && keep) {
          part[static_cast<size_t>(row) * wd + col] = acc[b][q];
        }
      }
    }
  }
  if (counting) flush_counts(cnt, T, counts);
}

template <int kT>
__global__ void __launch_bounds__(kSqMmaThreads)
    parent_counts_square_wide_kernel(
        const float* __restrict__ targets, const float* __restrict__ sources,
        const float* __restrict__ scores, const float* __restrict__ gamma,
        const float* __restrict__ thr, int n_t, int n_s, int m, int T,
        int chunk, float* __restrict__ work,
        unsigned long long* __restrict__ counts) {
  const OneRbf weights{-gamma[0] * kLog2e};
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * (2 * m + 1);
  square_wide_body<kT>(targets, sources, scores, weights, thr, n_t, n_s, m,
                       T, chunk, part, counts);
}
template <int kT>
__global__ void __launch_bounds__(kSqMmaThreads, 1)
    parent_terms_square_wide_kernel(
        const float* __restrict__ targets, const float* __restrict__ sources,
        const float* __restrict__ scores, const float* __restrict__ gammas,
        TermSigns signs, const float* __restrict__ thr, int n_t, int n_s,
        int m, int T, int chunk, float* __restrict__ work,
        unsigned long long* __restrict__ counts) {
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * (2 * m + 1);
  square_wide_body<kT>(targets, sources, scores,
                       FixedTerms<2>(gammas, signs), thr, n_t, n_s, m, T,
                       chunk, part, counts);
}
__global__ void parent_square_wide_finish_kernel(
    const float* __restrict__ work, int splits, int n_t, int m,
    const float* __restrict__ gamma, int terms,
    const float* __restrict__ targets, int n_s, float* __restrict__ phi) {
  square_finish(work, splits, n_t, m, 1, terms ? 2.0f : 2.0f * gamma[0],
                targets, n_s, phi);
}
extern "C" int parent_square_splits(int n_t, int n_s) {
  int splits = 0;
  square_chunk(n_t, n_s, true, &splits);
  return splits;
}
// nterms 0: K1 (gammas[0] its gamma); 2: the terms kernel's two terms.
extern "C" int parent_square_wide(const float* targets, const float* sources,
                                  const float* scores, const float* gammas,
                                  const float* signs, int nterms,
                                  const float* thr, int n_t, int n_s, int m,
                                  int T, float* phi, long long* counts,
                                  float* work, void* stream) {
  int splits = 0;
  const int chunk = square_chunk(n_t, n_s, true, &splits);
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const bool terms = nterms == 2;
  const dim3 grid((n_t + kSqMmaRows - 1) / kSqMmaRows, splits,
                  wide_square_chunks(m, terms));
  if (terms) {
    const TermSigns sg = make_signs(signs, 2);
    if (T == 3) {
      parent_terms_square_wide_kernel<3><<<grid, kSqMmaThreads, 0, s>>>(
          targets, sources, scores, gammas, sg, thr, n_t, n_s, m, T, chunk,
          work, c);
    } else {
      parent_terms_square_wide_kernel<kMaxT><<<grid, kSqMmaThreads, 0, s>>>(
          targets, sources, scores, gammas, sg, thr, n_t, n_s, m, T, chunk,
          work, c);
    }
  } else if (T == 3) {
    parent_counts_square_wide_kernel<3><<<grid, kSqMmaThreads, 0, s>>>(
        targets, sources, scores, gammas, thr, n_t, n_s, m, T, chunk, work,
        c);
  } else {
    parent_counts_square_wide_kernel<kMaxT><<<grid, kSqMmaThreads, 0, s>>>(
        targets, sources, scores, gammas, thr, n_t, n_s, m, T, chunk, work,
        c);
  }
  const long long outs = static_cast<long long>(n_t) * m;
  parent_square_wide_finish_kernel<<<
      static_cast<unsigned int>((outs + kSqFinishThreads - 1) /
                                kSqFinishThreads),
      kSqFinishThreads, 0, s>>>(work, splits, n_t, m, gammas, terms ? 1 : 0,
                                targets, n_s, phi);
  return static_cast<int>(cudaGetLastError());
}
// K1's bf16 instance as it ran before square_bf16_sm90.cuh: the body with
// kBf16, the parent's entry (any alignment, the tensor-core plan).
template <int kT>
__global__ void __launch_bounds__(kSqMmaThreads)
    parent_counts_square_bf16_kernel(
        const float* __restrict__ targets, const float* __restrict__ sources,
        const float* __restrict__ scores, const float* __restrict__ gamma,
        const float* __restrict__ thr, int n_t, int n_s, int m, int T,
        int chunk, float* __restrict__ work,
        unsigned long long* __restrict__ counts) {
  const OneRbf weights{-gamma[0] * kLog2e};
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * (2 * m + 1);
  square_wide_body<kT, true>(targets, sources, scores, weights, thr, n_t,
                             n_s, m, T, chunk, part, counts);
}
extern "C" int parent_square_bf16(const float* targets, const float* sources,
                                  const float* scores, const float* gamma,
                                  const float* thr, int n_t, int n_s, int m,
                                  int T, float* phi, long long* counts,
                                  float* work, void* stream) {
  int splits = 0;
  const int chunk = square_chunk(n_t, n_s, true, &splits);
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const dim3 grid((n_t + kSqMmaRows - 1) / kSqMmaRows, splits,
                  wide_square_chunks(m, false));
  if (T == 3) {
    parent_counts_square_bf16_kernel<3><<<grid, kSqMmaThreads, 0, s>>>(
        targets, sources, scores, gamma, thr, n_t, n_s, m, T, chunk, work,
        c);
  } else {
    parent_counts_square_bf16_kernel<kMaxT><<<grid, kSqMmaThreads, 0, s>>>(
        targets, sources, scores, gamma, thr, n_t, n_s, m, T, chunk, work,
        c);
  }
  const long long outs = static_cast<long long>(n_t) * m;
  parent_square_wide_finish_kernel<<<
      static_cast<unsigned int>((outs + kSqFinishThreads - 1) /
                                kSqFinishThreads),
      kSqFinishThreads, 0, s>>>(work, splits, n_t, m, gamma, 0, targets,
                                n_s, phi);
  return static_cast<int>(cudaGetLastError());
}
"""

#: --square-wide's shapes: (label, n_t, n_s, m, terms, offset), terms None
#: for K1 and 2 for the terms kernel with two terms, the grid inputs about
#: offset; K1 at the flat BLR's (1000, 123) (also about 100, chip_smoke.py
#: phase 43a's input), the terms kernel at the small hierarchical BLR's
#: (1500, 124) and at (1500, 123), the ladder m = 65, 256, 512, K1's cross
#: form at 10000 x 10000 and the square form at 2047 particles (the largest
#: n the card's rule sends to it past 64).
SQUARE_WIDE_SHAPES = (
    ("K1", 1000, 1000, 123, None, 0.0), ("K1", 1000, 1000, 123, None, 100.0),
    ("K1", 1000, 1000, 65, None, 0.0), ("K1", 1000, 1000, 256, None, 0.0),
    ("K1", 1000, 1000, 512, None, 0.0), ("K6/K7", 1500, 1500, 124, 2, 0.0),
    ("K6/K7", 1500, 1500, 123, 2, 0.0), ("K6/K7", 1500, 1500, 65, 2, 0.0),
    ("K6/K7", 1500, 1500, 256, 2, 0.0), ("K6/K7", 1500, 1500, 512, 2, 0.0),
    ("K1 cross", 10000, 10000, 123, None, 0.0),
    ("K1", 2047, 2047, 123, None, 0.0), ("K6/K7", 2047, 2047, 124, 2, 0.0),
)


def square_wide(device):
    """--square-wide: the float32 wide square body, the parent's (built
    from SQUARE_WIDE_PARENT_SOURCE in a copy under _verify/square_wide/)
    and the package's, in one process at SQUARE_WIDE_SHAPES on
    chip_smoke.py's grid inputs: kernel-only us of the sweep and of the
    finishing pass apart (the profiler's events, 10 calls after one),
    wrapper ms (CUDA events, chip_smoke.time_ms; the parent's wrapper is
    the centring, the workspace and the launch as they stood), the
    workspace's bytes, and both results' distance from the float64 plain
    version, with their counts."""
    import ctypes

    import torch

    from chip_smoke import grid_inputs, kernel_us, time_ms
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_cross_fused_counts,
        phi_rbf_terms_cross_fused_counts,
    )
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    dest = parent_csrc(ROOT / "_verify" / "square_wide")
    (dest / "parent.cu").write_text(SQUARE_WIDE_PARENT_SOURCE)
    proc = subprocess.Popen(
        [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
         str(dest / "libparent.so"), str(dest / "parent.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_phi.load_library()  # built meanwhile
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the parent's wide square build:\n{out}")
    lib = ctypes.CDLL(str(dest / "libparent.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.parent_square_wide.argtypes = ([ptr] * 5 + [i32, ptr] + [i32] * 4
                                       + [ptr] * 4)
    lib.parent_square_wide.restype = i32
    lib.parent_square_splits.argtypes = [i32, i32]
    lib.parent_square_splits.restype = i32
    regs = re.findall(r"Used (\d+) registers", out)

    rows = []
    for label, n_t, n_s, m, terms, offset in SQUARE_WIDE_SHAPES:
        x, s, g, thr = grid_inputs(n_s, m, offset, 470 + m + n_s, device)
        xt = (x if n_t == n_s and "cross" not in label
              else grid_inputs(n_t, m, offset, 480 + m, device)[0])
        gs = [g, 0.5 * g] if terms else [g]
        signs = (1.0, 1.0)
        if terms:
            def new_call():
                return cuda_phi.phi_rbf_terms_fused_cuda_cross(
                    xt, x, s, gs, signs, thr)
            name = cuda_phi.TERMS_SQUARE_KERNEL
            parent_name = "parent_terms_square_wide_kernel"
        else:
            def new_call():
                return cuda_phi.phi_rbf_fused_cuda_cross(xt, x, s, g, thr)
            name = cuda_phi.SQUARE_KERNEL
            parent_name = "parent_counts_square_wide_kernel"
        host_signs = (ctypes.c_float * 2)(*signs)
        splits = lib.parent_square_splits(n_t, n_s)

        def parent_call():
            """The parent's wrapper past 64, as it stood."""
            g32 = torch.stack([v.reshape(()) for v in gs])
            center = x.mean(dim=0)
            tgt_c = (xt - center).contiguous()
            src_c = (x - center).contiguous()
            phi = torch.empty((n_t, m), device=device)
            counts = torch.zeros(thr.shape[0], dtype=torch.int64,
                                 device=device)
            work = torch.empty((splits, n_t, 2 * m + 1), device=device)
            rc = lib.parent_square_wide(
                tgt_c.data_ptr(), src_c.data_ptr(), s.data_ptr(),
                g32.data_ptr(), host_signs, terms or 0, thr.data_ptr(), n_t,
                n_s, m, thr.shape[0], phi.data_ptr(), counts.data_ptr(),
                work.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent_square_wide returned {rc}")
            return phi, counts

        new_phi, new_cnt = new_call()
        old_phi, old_cnt = parent_call()
        if terms:
            ref_phi, ref_cnt = phi_rbf_terms_cross_fused_counts(
                xt.double(), x.double(), s.double(),
                [v.double() for v in gs], signs, thr.double())
        else:
            ref_phi, ref_cnt = phi_rbf_cross_fused_counts(
                xt.double(), x.double(), s.double(), g.double(),
                thr.double())
        scale = float(ref_phi.abs().max())
        from svgdcpp_tpu_torch.ops import sym_plan
        width = sym_plan.wide_row_width(m)
        new_splits = sym_plan.square_splits(n_t, n_s, m)
        row = {
            "kernel": label, "n_t": n_t, "n_s": n_s, "m": m,
            "offset": offset,
            "parent_kernel_us": kernel_us(parent_call, parent_name),
            "parent_finish_us": kernel_us(parent_call,
                                          "parent_square_wide_finish"),
            "new_kernel_us": kernel_us(new_call, name + "_kernel"),
            "new_finish_us": kernel_us(new_call, name + "_finish"),
            "parent_wrapper_ms": time_ms(parent_call, reps=20, warmup=3),
            "new_wrapper_ms": time_ms(new_call, reps=20, warmup=3),
            "parent_splits": splits, "new_splits": new_splits,
            "parent_work_bytes": 4 * splits * n_t * (2 * m + 1),
            "new_work_bytes": 4 * new_splits * n_t * (2 * width + 1),
            "new_rel_err_f64": float(
                (new_phi.double() - ref_phi).abs().max()) / scale,
            "parent_rel_err_f64": float(
                (old_phi.double() - ref_phi).abs().max()) / scale,
            "counts_new_parent_f64": [new_cnt.tolist(), old_cnt.tolist(),
                                      ref_cnt.tolist()],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"parent_registers": regs, "rows": rows}


def square_wide_main(args) -> int:
    """--square-wide: square_wide's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "square_wide": square_wide(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/square_wide.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --square-bf16's shapes: (form, n_t, n_s, m); the cross form's targets
#: are its sources' first n_t, as a two-rank mesh's rank 0 holds them. The
#: cross form at the flagship under a one-rank mesh (10000 x 10000, 2) and
#: at a two-rank mesh's rows (5000 x 10000, 2), the square form at the
#: flat BLR's (1000, 50), at a9a's width (1000, 123) and at (1000, 2), and
#: the cross form at (10000 x 10000, 123).
SQUARE_BF16_SHAPES = (
    ("cross", 10000, 10000, 2), ("cross", 5000, 10000, 2),
    ("square", 1000, 1000, 50), ("square", 1000, 1000, 123),
    ("square", 1000, 1000, 2), ("cross", 10000, 10000, 123),
)


def square_bf16(device):
    """--square-bf16: K1's bfloat16 instance, the parent's (square_wide_body
    with kBf16, built from SQUARE_WIDE_PARENT_SOURCE in a copy under
    _verify/square_bf16/) and the package's (square_bf16_sm90.cuh's body),
    in one process at SQUARE_BF16_SHAPES on chip_smoke.py's inputs:
    kernel-only us (the profiler's events, 10 calls after one) of the
    pack, the norms' sums, the sweep and the finishing pass apart and of
    all four (BF16_SQUARE_NAMES), and of every kernel that the bf16
    launcher runs from the centred operands (``launcher_us``, which holds
    the names to the launches); the sweep and the finishing pass of the
    parent (which formed the norms and rounded the operands inside its
    sweep) and of the float32 instance; wrapper ms (CUDA events,
    chip_smoke.time_ms; the parent's wrapper is the centring, the workspace
    and the launch as they stood); both results' distance from the bf16
    and the float32 plain versions (a share of max |phi|) with their
    counts' largest difference; the split counts, the workspace's bytes,
    the dynamic shared memory, and each build's registers and spill (the
    parent's static shared memory is 33,920 B)."""
    import ctypes

    import torch

    from chip_smoke import (BF16_SQUARE_NAMES, inputs_for, kernel_us,
                            ptxas_summary, time_ms)
    from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
    from svgdcpp_tpu_torch.ops.phi import phi_rbf_cross_fused_counts
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    bf16 = "bfloat16"
    dest = parent_csrc(ROOT / "_verify" / "square_bf16")
    (dest / "parent.cu").write_text(SQUARE_WIDE_PARENT_SOURCE)
    proc = subprocess.Popen(
        [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
         str(dest / "libparent.so"), str(dest / "parent.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_phi.load_library()  # built meanwhile
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the parent's square build:\n{out}")
    lib = ctypes.CDLL(str(dest / "libparent.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.parent_square_bf16.argtypes = [ptr] * 5 + [i32] * 4 + [ptr] * 4
    lib.parent_square_bf16.restype = i32
    lib.parent_square_splits.argtypes = [i32, i32]
    lib.parent_square_splits.restype = i32
    builds = {
        "parent": {k: v for k, v in ptxas_summary(out).items()
                   if "parent_counts_square_bf16" in k},
        "new": {k: v for k, v in ptxas_summary(
            cuda_phi.build_log_path().read_text()).items()
            if k.startswith(("counts_square_bf16", "square_bf16_pack"))},
    }
    print(json.dumps(builds), flush=True)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    rows = []
    for form, n_t, n_s, m in SQUARE_BF16_SHAPES:
        x, s, g, thr = inputs_for(n_s, m, 0.0, 470 + m + n_t, device)
        xt = x if form == "square" else x[:n_t].contiguous()

        def new_call(dd=bf16):
            if form == "square":
                return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False,
                                                   dot_dtype=dd)
            return cuda_phi.phi_rbf_fused_cuda_cross(xt, x, s, g, thr,
                                                     dot_dtype=dd)

        splits = lib.parent_square_splits(n_t, n_s)

        def parent_call():
            """The parent's bf16 wrapper, as it stood."""
            center = x.mean(dim=0)
            tgt_c = (xt - center).contiguous()
            src_c = (x - center).contiguous()
            phi = torch.empty((n_t, m), device=device)
            counts = torch.zeros(thr.shape[0], dtype=torch.int64,
                                 device=device)
            work = torch.empty((splits, n_t, 2 * m + 1), device=device)
            rc = lib.parent_square_bf16(
                tgt_c.data_ptr(), src_c.data_ptr(), s.data_ptr(),
                g.reshape(1).data_ptr(), thr.data_ptr(), n_t, n_s, m,
                thr.shape[0], phi.data_ptr(), counts.data_ptr(),
                work.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent_square_bf16 returned {rc}")
            return phi, counts

        got = {"new": new_call(), "parent": parent_call()}
        want16 = phi_rbf_cross_fused_counts(xt, x, s, g, thr, dot_dtype=bf16)
        want32 = phi_rbf_cross_fused_counts(xt, x, s, g, thr)
        torch.cuda.synchronize()
        new_splits = sym_plan.square_splits(n_t, n_s, m, bf16=True)
        plan = sym_plan.square_bf16_plan(m)
        row = {"form": form, "n_t": n_t, "n_s": n_s, "m": m,
               "tiles": plan.tiles, "chunks": plan.chunks,
               "splits": new_splits, "parent_splits": splits,
               "work_bytes": sym_plan.square_bf16_work(
                   n_t, n_s, m, form == "square").bytes,
               "parent_work_bytes": 4 * splits * n_t * (2 * m + 1),
               "smem_bytes": plan.smem}
        for name, names in (("pack", BF16_SQUARE_NAMES[0]),
                            ("sum", BF16_SQUARE_NAMES[1]),
                            ("sweep", "fused_phi_counts_square_bf16_kernel"),
                            ("finish", "fused_phi_counts_square_finish"),
                            ("total", BF16_SQUARE_NAMES)):
            row[f"new_{name}_us"] = kernel_us(new_call, names)
        g_dev, thr_dev = cuda_phi._device_operands(x, s, [g], thr)
        center = x.mean(dim=0)
        src_c = (x - center).contiguous()
        tgt_c = src_c if form == "square" else (xt - center).contiguous()
        row["new_launcher_us"] = kernel_us(
            lambda: cuda_phi._square_bf16_launch(
                tgt_c, src_c, s, g_dev, thr_dev, form == "square",
                torch.float32), "")
        row["parent_sweep_us"] = kernel_us(parent_call,
                                           "parent_counts_square_bf16")
        row["parent_finish_us"] = kernel_us(parent_call,
                                            "parent_square_wide_finish")
        f32 = lambda: new_call("float32")  # noqa: E731
        row["float32_sweep_us"] = kernel_us(f32,
                                            "fused_phi_counts_square_kernel")
        row["float32_finish_us"] = kernel_us(f32,
                                             "fused_phi_counts_square_finish")
        for name, fn in (("new", new_call), ("parent", parent_call),
                         ("float32", f32)):
            row[f"{name}_wrapper_ms"] = time_ms(fn, reps=20, warmup=3)
        for name, (phi, cnt) in got.items():
            row[f"{name}_rel_bf16_plain"] = rel(phi, want16[0])
            row[f"{name}_rel_float32_plain"] = rel(phi, want32[0])
            row[f"{name}_count_diff"] = int((cnt - want16[1]).abs().max())
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"builds": builds, "rows": rows}


def square_bf16_main(args) -> int:
    """--square-bf16: square_bf16's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "square_bf16": square_bf16(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/square_bf16.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --wrapper-ab's child: K1's bf16 instance through the package's public
#: wrappers at SQUARE_BF16_SHAPES (chip_smoke.time_ms, CUDA events, the
#: median of 50 calls) and the flat BLR driver under the bf16 opt-in (N =
#: 1000, d = 50, chip_smoke.py phase 46b's configuration, ms a step by the
#: host clock over 100 steps after a run of 20), one JSON line. It uses
#: only what the trees before and after K1's bf16 redesign share.
WRAPPER_AB_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd
dev = torch.device("cuda")
shapes = json.loads(sys.argv[1])
out = {}
for form, n_t, n_s, m in shapes:
    x, s, g, thr = cs.inputs_for(n_s, m, 0.0, 470 + m + n_t, dev)
    xt = x[:n_t].contiguous()
    if form == "square":
        fn = lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=False,
                                                 dot_dtype="bfloat16")
    else:
        fn = lambda: cuda_phi.phi_rbf_fused_cuda_cross(
            xt, x, s, g, thr, dot_dtype="bfloat16")
    out[f"{form} {n_t} x {n_s}, {m}"] = cs.time_ms(fn, reps=50, warmup=5)
feats, labels, xb = blr_workload(1000, 50)
for steps in (20, 100):
    svgd = build_blr_svgd(torch.tensor(xb, device=dev), feats, labels,
                          num_iterations=steps, fused_dot_dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svgd.run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
out["flat BLR bf16 ms a step"] = ms
print(json.dumps(out), flush=True)
"""


#: --wrapper-ab's child under --ab-family k15: K15 through the package's
#: public wrapper ``cuda_phi.phi_rbf_cuda`` at WRAPPER_AB_K15_SHAPES on
#: --fixed-p-wide's inputs: ms a call between CUDA events
#: (chip_smoke.time_ms, the median of 50 calls), host us a call (200 calls
#: with no synchronisation between them, by the host clock: "host_us" up
#: to the last call's return, "wall_us" up to the card's end), and the
#: device operations one call launches and, under the profiler, a call's
#: host us, its operators' self host us (the 12 largest) and what is left
#: outside them (the entries' ctypes calls, Python) (torch.profiler over 5
#: calls), one JSON line. It uses only what the trees before and after K15's
#: redesign share.
WRAPPER_AB_K15_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from svgdcpp_tpu_torch.ops import cuda_phi
dev = torch.device("cuda")
out = {}
for n, m, kind, dd in json.loads(sys.argv[1]):
    make = cs.grid_inputs if m > 4 else cs.sweep_inputs
    x, s, g, thr = make(n, m, 0.0, 449 + m, dev)
    p = cs.wide_p_ps(kind, m, 1, 448, g, dev)[0]
    psd = kind != "indefinite"
    fn = lambda: cuda_phi.phi_rbf_cuda(x, s, p, psd=psd, dot_dtype=dd)
    ms = cs.time_ms(fn, reps=50, warmup=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / 200
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e6 / 200
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            with torch.profiler.record_function("k15_wrapper"):
                fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops[e.name] = ops.get(e.name, 0) + 1
    cpu = {a.key: (a.cpu_time_total if a.key == "k15_wrapper"
                   else a.self_cpu_time_total) / 5
           for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CPU}
    whole = cpu.pop("k15_wrapper", 0.0)
    top = sorted(cpu.items(), key=lambda kv: -kv[1])[:12]
    out[f"{dd} ({n}, {m}) {kind}"] = {
        "ms": ms, "host_us": host, "wall_us": wall,
        "device_ops_per_call": sum(ops.values()) / 5,
        "device_ops": {k: v / 5 for k, v in sorted(ops.items())},
        "profiled_cpu_us": whole,
        "profiled_cpu_us_outside_aten": whole - sum(cpu.values()),
        "top_self_cpu_us": dict(top)}
print(json.dumps(out), flush=True)
"""

#: --ab-family k15's shapes, (n, m, P as chip_smoke.wide_p_ps names it,
#: dot_dtype): phase 46a's (1500, 2) and the main path's (10240, 123) for
#: the bf16 instance, (10240, 123) for the float32 wide one, and (1500, 2)
#: in float32 (the triangle with sym_eigen, the same code in both trees)
#: as the control of the host's drift between processes.
WRAPPER_AB_K15_SHAPES = (
    (1500, 2, "gamma_i", "bfloat16"),
    (1500, 2, "gamma_i", "float32"),
    (10240, 123, "indefinite", "bfloat16"),
    (10240, 123, "indefinite", "float32"),
)


def wrapper_ab(parent: Path, family: str = "k1") -> dict:
    """--wrapper-ab DIR: WRAPPER_AB_CHILD (``family`` "k1") or
    WRAPPER_AB_K15_CHILD ("k15") in the tree DIR (the parent's checkout),
    in this one, in this one and in DIR, one process each, so that the
    public wrappers (and, for "k1", the flat BLR step) of two trees are
    compared on one card; each tree builds its library on its first
    run."""
    runs = []
    child, shapes = ((WRAPPER_AB_K15_CHILD, WRAPPER_AB_K15_SHAPES)
                     if family == "k15"
                     else (WRAPPER_AB_CHILD, SQUARE_BF16_SHAPES))
    shapes = json.dumps(shapes)
    for label, tree in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", child, shapes], cwd=tree,
            capture_output=True, text=True, timeout=1800)
        if proc.returncode:
            raise RuntimeError(f"--wrapper-ab in {tree}:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        row = {"tree": label, **json.loads(proc.stdout.strip()
                                           .splitlines()[-1])}
        runs.append(row)
        print(json.dumps(row), flush=True)
    return {"runs": runs}


def wrapper_ab_main(args) -> int:
    """--wrapper-ab: wrapper_ab's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "family": args.ab_family,
              "wrapper_ab": wrapper_ab(Path(args.wrapper_ab),
                                       args.ab_family)}
    suffix = "_k15" if args.ab_family == "k15" else ""
    out = Path(args.out or f"chiprun_out/wrapper_ab{suffix}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --mid-width's ladder: K2 (T = 3) and K8/K9 with two and three terms
#: at n = MID_WIDTH_N and the float32 triangles' mid widths, the ones the
#: micro-tile body does not serve up to m = 64, with m = 65 beside them
#: (the wide body in both trees); then the small launches, where the wide
#: body's one persistent block an SM has few tile pairs to share: whole
#: triangles at n = 2048 (SYM_MIN_N, 136 pairs of 128-tiles) and 4096, and
#: the chunks of a world of MID_WIDTH_WORLD ranks at n = MID_WIDTH_N
#: (about 800 pairs a rank), at MID_WIDTH_SMALL_MS.
MID_WIDTH_N = 10000
MID_WIDTH_MS = (9, 10, 12, 13, 16, 17, 24, 31, 32, 33, 50, 54, 55, 64, 65)
MID_WIDTH_SMALL_N = (2048, 4096)
MID_WIDTH_SMALL_MS = (9, 33, 64)
MID_WIDTH_WORLD = 4

#: --mid-width's child, run in one tree (its cwd): each (n, m) shape on
#: chip_smoke.grid_inputs, K2 and K8/K9 with two terms (1, 1) and three
#: (1, -0.5, 1) through the public wrappers with sym=True, and each chunk
#: width's K4 and K10/K11 (two terms) over every rank of the world, one
#: launch a rank: kernel-only us (chip_smoke.kernel_us: the profiler's
#: events of the kernel over 10 calls; for the chunks the world's launches
#: of one call summed), the wrapper's ms (chip_smoke.time_ms, the median of
#: 20 calls; the chunks' every rank), phi's distance from the float64
#: plain version (relative to its max |phi|; the chunks summed and
#: finished as the engine does) and the counts' difference from it; with
#: the tree's library build seconds and the ptxas lines of its triangle
#: instances. It uses only what the trees before and after the mid widths
#: moved share.
MID_WIDTH_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops.phi import (phi_rbf_fused_counts,
                                       phi_rbf_fused_sym_finish,
                                       phi_rbf_terms_fused_counts,
                                       phi_rbf_terms_fused_sym_finish)
dev = torch.device("cuda")
cfg = json.loads(sys.argv[1])
t0 = time.perf_counter()
cuda_phi.load_library()
build_s = time.perf_counter() - t0
log = cuda_phi.build_log_path()
ptxas = cs.ptxas_summary(log.read_text() if log.exists() else "")
rows = []
def held(phi, cnt, want):
    torch.cuda.synchronize()
    return {"phi_rel_err": float((phi.double() - want[0]).abs().max()
                                 / want[0].abs().max()),
            "count_diff": int((cnt - want[1]).abs().max()),
            "finite": bool(phi.isfinite().all())}
for n, m in cfg["shapes"]:
    x, s, g, thr = cs.grid_inputs(n, m, 0.0, 480 + m, dev)
    x64, s64, thr64 = x.double(), s.double(), thr.double()
    cases = [("K2", None, [g])]
    cases.append(("K8/K9 two terms", (1.0, 1.0), [g, 0.5 * g]))
    cases.append(("K8/K9 three terms", (1.0, -0.5, 1.0),
                  [g, 0.5 * g, 2.0 * g]))
    for label, signs, gs in cases:
        if signs is None:
            fn = lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True)
            name = "fused_phi_counts_sym_kernel"
            want = phi_rbf_fused_counts(x64, s64, g.double(), thr64)
        else:
            fn = lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                x, s, gs, signs, thr, sym=True)
            name = "fused_phi_terms_sym_kernel"
            want = phi_rbf_terms_fused_counts(
                x64, s64, [v.double() for v in gs], signs, thr64)
        got = held(*fn(), want)
        us = cs.kernel_us(fn, name)
        ms = cs.time_ms(fn, reps=20, warmup=3)
        rows.append({"kernel": label, "n": n, "m": m, "world": None,
                     "kernel_us": us, "wrapper_ms": ms, **got})
n, world = cfg["n"], cfg["world"]
for m in cfg["chunk_ms"]:
    x, s, g, thr = cs.grid_inputs(n, m, 0.0, 480 + m, dev)
    x64, s64, thr64 = x.double(), s.double(), thr.double()
    gs, signs = [g, 0.5 * g], (1.0, 1.0)
    for label, one, finish, name, want in (
            ("K4", lambda w, r: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                x, s, g, thr, w, r),
             lambda acc: phi_rbf_fused_sym_finish(acc, s, g, n),
             "fused_phi_counts_sym_chunk_kernel",
             phi_rbf_fused_counts(x64, s64, g.double(), thr64)),
            ("K10/K11 two terms",
             lambda w, r: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                 x, s, gs, signs, thr, w, r),
             lambda acc: phi_rbf_terms_fused_sym_finish(acc, s, signs, n),
             "fused_phi_terms_sym_chunk_kernel",
             phi_rbf_terms_fused_counts(x64, s64, [v.double() for v in gs],
                                        signs, thr64))):
        got = held(*cs.ranks_summed(one, world, n, finish), want)
        ranks = lambda: [one(world, r) for r in range(world)]
        us = cs.kernel_us(ranks, name)
        ms = cs.time_ms(ranks, reps=20, warmup=3)
        rows.append({"kernel": label, "n": n, "m": m, "world": world,
                     "kernel_us": us, "wrapper_ms": ms, **got})
tri = {k: v for k, v in ptxas.items()
       if k.split("<")[0] in ("counts_sym", "counts_sym_chunk", "terms_sym",
                              "terms_sym_chunk")}
print(json.dumps({"build_s": build_s, "ptxas": tri, "rows": rows}),
      flush=True)
"""


def mid_width(parent: Path) -> dict:
    """--mid-width DIR: MID_WIDTH_CHILD in the tree DIR (the parent's
    checkout, whose csrc/ it builds), in this one, in this one and in DIR,
    one process each (parent, change, change, parent), so that the float32
    triangles' instances at the mid widths are timed in both trees on one
    card; then, for each kernel and shape, the parent's and the change's
    kernel-only us side by side (each the mean of its tree's two runs) and
    their ratio."""
    runs = []
    shapes = ([(MID_WIDTH_N, m) for m in MID_WIDTH_MS]
              + [(n, m) for n in MID_WIDTH_SMALL_N
                 for m in MID_WIDTH_SMALL_MS])
    cfg = json.dumps({"shapes": shapes, "n": MID_WIDTH_N,
                      "world": MID_WIDTH_WORLD,
                      "chunk_ms": list(MID_WIDTH_SMALL_MS)})
    for label, tree in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", MID_WIDTH_CHILD, cfg], cwd=tree,
            capture_output=True, text=True, timeout=1800)
        if proc.returncode:
            raise RuntimeError(f"--mid-width in {tree}:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        run = {"tree": label, **json.loads(proc.stdout.strip()
                                           .splitlines()[-1])}
        runs.append(run)
        print(json.dumps({"tree": label, "build_s": run["build_s"],
                          "ptxas": run["ptxas"]}), flush=True)
        for row in run["rows"]:
            print(json.dumps({"tree": label, **row}), flush=True)
    ladder = []
    for i, row in enumerate(runs[0]["rows"]):
        def mean(tree):
            us = [r["rows"][i]["kernel_us"] for r in runs
                  if r["tree"] == tree]
            return None if None in us else sum(us) / len(us)
        p_us, c_us = mean("parent"), mean("change")
        step = {"kernel": row["kernel"], "n": row["n"], "m": row["m"],
                "world": row["world"], "parent_us": p_us, "change_us": c_us,
                "change_over_parent": (None if not p_us or c_us is None
                                       else c_us / p_us)}
        ladder.append(step)
        print(json.dumps(step), flush=True)
    return {"runs": runs, "ladder": ladder}


#: --mid-width's form ladder: (n, m) shapes at which the full-width
#: triangle, the square form and, where the JAX rule picks it, the panel
#: form are timed, one RBF and two terms; m = 33-36 share the wide body's
#: two 32-column slices, the square body's MM = 64 instance serves 33-64.
#: At m = 9-16 the JAX rule keeps the triangle up to n = 32,768-49,152
#: and takes the panel from 32,768-65,536 (both forms, one RBF and two
#: terms), so those widths are timed at 65,536 and 131,072.
MID_FORM_SHAPES = (tuple((n, m) for n in (10000, 32768)
                         for m in (17, 32, 33, 36, 40, 48, 54, 64))
                   + tuple((n, m) for n in (65536, 131072)
                           for m in (9, 12, 16)))


def mid_width_forms(device):
    """--mid-width's forms (this tree only): at MID_FORM_SHAPES on
    chip_smoke.grid_inputs, K2 against K1's square form and K8/K9 against
    K6/K7's (two terms), each kernel-only (chip_smoke.kernel_us over 3
    calls; the square forms' finishing pass included), and the panel
    form where the JAX rule (sym_plan.jax_resolve_sym) picks it; with
    both rules' picks. A trace that holds other than one event a call of
    the kernel (two for the square form) is taken again."""
    import chip_smoke as cs
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.sym_plan import jax_resolve_sym

    rows = []
    for n, m in MID_FORM_SHAPES:
        x, s, g, thr = cs.grid_inputs(n, m, 0.0, 490 + m, device)
        for terms in (None, 2):
            jax_rule = jax_resolve_sym(n, m, terms)
            forms = (True, False) + (("panel",) if jax_rule == "panel"
                                     else ())
            us = {}
            for form in forms:
                if terms is None:
                    kernel = {True: cuda_phi.SYM_KERNEL,
                              False: cuda_phi.SQUARE_KERNEL,
                              "panel": cuda_phi.SYMPANEL_KERNEL}[form]

                    def fn(form=form):
                        return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr,
                                                           sym=form)
                else:
                    kernel = {True: cuda_phi.TERMS_SYM_KERNEL,
                              False: cuda_phi.TERMS_SQUARE_KERNEL,
                              "panel": cuda_phi.TERMS_SYMPANEL_KERNEL}[form]

                    def fn(form=form):
                        return cuda_phi.phi_rbf_terms_fused_cuda(
                            x, s, [g, 0.5 * g], (1.0, 1.0), thr, sym=form)
                us[repr(form)] = cs.kernel_us(
                    fn, kernel, calls=3, per_call=2 if form is False else 1)
            row = {"n": n, "m": m, "terms": terms or 1, "kernel_us": us,
                   "jax_rule": jax_rule,
                   "card_rule": cuda_phi.resolve_sym(None, n, m, terms)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def mid_width_main(args) -> int:
    """--mid-width: mid_width's rows (with a parent tree) and
    mid_width_forms', JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card}
    if args.mid_width is not True:
        result["mid_width"] = mid_width(Path(args.mid_width))
    result["forms"] = mid_width_forms(torch.device("cuda"))
    out = Path(args.out or "chiprun_out/mid_width.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --mid-p's readings at n = MID_P_N: K15 and K14 at the widths the change
#: moves to wide_tri_sm90.cuh's body (m = 9, 10 and 12-64), with m = 11
#: (unmoved: the micro widths' bodies in both trees) and m = 65 (the wide
#: body in both trees) as controls; then the one-pass ladder, K14's
#: one-pass kernel against the wide groups for one isotropic and one
#: anisotropic term at MID_P_LADDER_MS and MID_P_LADDER_NS.
MID_P_N = 10240
MID_P_MS = (9, 10, 12, 16, 17, 24, 32, 33, 50, 54, 64, 11, 65)
MID_P_LADDER_MS = (9, 10, 12, 16, 17, 24, 32)
MID_P_LADDER_NS = (2048, 10240, 32768)

#: --mid-p's child, run in one tree (its cwd), through what both trees
#: share (the public wrappers, chip_smoke's grid_inputs, wide_p_ps and
#: time_ms). Each case on grid inputs: K15 with P positive definite and its
#: decomposition given (as a driver keeps a CONSTANT P's or hands a
#: MEDIAN's), and with an indefinite P and none (a HESSIAN scale: the
#: parent decomposes it on the card each call, sym_eigen); K14 with
#: iso + 1, iso + 2 (a negative sign) and 0 + 1 (its counts through K16's
#: self form) on the route the tree picks, the Cholesky factors given, and
#: iso + 1 with the term groups forced (the parent's ONE_PASS_MAX_M or the
#: change's sym_plan rule patched in cuda_phi). The ladder times iso + 1 on
#: the tree's route, with the groups forced and with the one-pass kernel
#: forced (refused where the library has no instance for the width).
#: Readings: kernel-only us (the profiler's events over 10 calls whose
#: names hold any of the port's kernel names below, summed, with the names
#: seen), the wrapper's ms (chip_smoke.time_ms, the median of 20), phi's
#: distance from the float64 plain version (relative to max |phi|; in the
#: ladder at n = 2048 only) and the counts' difference from it; with the
#: tree's build seconds and the ptxas lines of K14's and K15's instances.
MID_P_CHILD = r"""
import json, os, re, sys, tempfile, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops.phi import (phi_rbf_aniso_terms_fused_counts,
                                       phi_rbf_blocked)
NAMES = ("phi_rbf_", "sym_eigen", "fused_phi_aniso", "count_le")
TERMS = {"iso+1": ((1.0,), (1.0,)), "iso+2": ((1.0,), (1.0, -0.5)),
         "0+1": ((), (1.0,))}
dev = torch.device("cuda")
cfg = json.loads(sys.argv[1])
t0 = time.perf_counter()
cuda_phi.load_library()
build_s = time.perf_counter() - t0
log = cuda_phi.build_log_path()
ptxas = cs.ptxas_summary(log.read_text() if log.exists() else "")
RULE = getattr(cuda_phi, "aniso_one_pass", None)
LIMIT = getattr(cuda_phi, "ONE_PASS_MAX_M", None)
rows = []

def device_us(fn, calls=10):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
    hits = [ev for ev in events
            if ev.get("ph") == "X" and ev.get("cat") == "kernel"
            and any(nm in ev.get("name", "") for nm in NAMES)]
    names = sorted({re.search(r"\w*(?:" + "|".join(NAMES) + r")\w*",
                              ev["name"]).group(0) for ev in hits})
    return (sum(float(ev["dur"]) for ev in hits) / calls if hits else None,
            names)

def forced(kind):
    # "groups": no one-pass kernel; "one_pass": one anisotropic term in
    # one pass; None: the tree's own rule.
    if RULE is not None:
        cuda_phi.aniso_one_pass = {
            "groups": lambda m, k: False,
            "one_pass": lambda m, k: k == 1}.get(kind, RULE)
    else:
        cuda_phi.ONE_PASS_MAX_M = {"groups": 0, "one_pass": 10**9}.get(
            kind, LIMIT)

def reading(label, n, m, fn, want, check):
    row = {"kernel": label, "n": n, "m": m}
    try:
        cuda_phi.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
    except RuntimeError as err:
        row["refused"] = str(err).splitlines()[0][:200]
        rows.append(row)
        print(json.dumps(row), flush=True)
        return
    row["launches"] = {k: v for k, v in cuda_phi.launch_counts.items() if v}
    phi = got[0] if isinstance(got, tuple) else got
    row["finite"] = bool(phi.isfinite().all())
    if check:
        ref = want()
        ref_phi = ref[0] if isinstance(ref, tuple) else ref
        row["phi_rel_err"] = float((phi.double() - ref_phi).abs().max()
                                   / ref_phi.abs().max())
        if isinstance(ref, tuple):
            row["count_diff"] = int((got[1] - ref[1]).abs().max())
    row["kernel_us"], row["kernel_names"] = device_us(fn)
    row["wrapper_ms"] = cs.time_ms(fn, reps=20, warmup=3)
    rows.append(row)
    print(json.dumps(row), flush=True)

def k14(x, s, g, thr, spec):
    iso_s, an_s = TERMS[spec]
    m = x.shape[1]
    iso_g = [g, 2.0 * g][:len(iso_s)]
    ps = cs.wide_p_ps("pd", m, len(an_s), 445, g, dev)
    lowers = cuda_phi.cholesky_factors(ps, dev)
    fn = lambda: cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        x, s, iso_g, iso_s, ps, an_s, thr, lowers=lowers)
    want = lambda: phi_rbf_aniso_terms_fused_counts(
        x.double(), s.double(), [v.double() for v in iso_g], iso_s,
        [p.double() for p in ps], an_s, thr.double())
    return fn, want

n = cfg["n"]
for m in cfg["ms"]:
    x, s, g, thr = cs.grid_inputs(n, m, 0.0, 470 + m, dev)
    p = cs.wide_p_ps("pd", m, 1, 446, g, dev)[0]
    eig = torch.linalg.eigh(0.5 * (p + p.T).double())
    reading("K15 P given", n, m,
            lambda: cuda_phi.phi_rbf_cuda(x, s, p, psd=True, eig=eig),
            lambda: phi_rbf_blocked(x.double(), s.double(), p.double()),
            True)
    q = cs.wide_p_ps("indefinite", m, 1, 447, g, dev)[0]
    reading("K15 HESSIAN-style", n, m,
            lambda: cuda_phi.phi_rbf_cuda(x, s, q, psd=False),
            lambda: phi_rbf_blocked(x.double(), s.double(), q.double(),
                                    psd=False), True)
    for spec in TERMS:
        fn, want = k14(x, s, g, thr, spec)
        reading(f"K14 {spec}", n, m, fn, want, True)
    forced("groups")
    fn, want = k14(x, s, g, thr, "iso+1")
    reading("K14 iso+1 groups forced", n, m, fn, want, True)
    forced(None)
for ln in cfg["ladder_ns"]:
    for m in cfg["ladder_ms"]:
        x, s, g, thr = cs.grid_inputs(ln, m, 0.0, 480 + m, dev)
        for kind in (None, "groups", "one_pass"):
            forced(kind)
            fn, want = k14(x, s, g, thr, "iso+1")
            reading(f"ladder iso+1 {kind or 'route'}", ln, m, fn, want,
                    ln == 2048)
        forced(None)
inst = {k: v for k, v in ptxas.items()
        if k.split("<")[0] in ("rbf_square", "rbf_sym", "rbf_wide",
                               "aniso_terms_sym", "aniso_terms_groups",
                               "aniso_wide_groups", "aniso_wide_iso")}
print(json.dumps({"build_s": build_s, "ptxas": inst, "rows": rows}),
      flush=True)
"""


def mid_p(parent: Path) -> dict:
    """--mid-p DIR: MID_P_CHILD in the tree DIR (the parent's checkout,
    which builds its own csrc/), in this one, in this one and in DIR, one
    process each (parent, change, change, parent); then, for each reading,
    the parent's and the change's kernel-only us and wrapper ms side by
    side (each the mean of its tree's two runs), their ratio, the kernels
    each tree ran and its largest distance from float64."""
    cfg = json.dumps({"n": MID_P_N, "ms": list(MID_P_MS),
                      "ladder_ms": list(MID_P_LADDER_MS),
                      "ladder_ns": list(MID_P_LADDER_NS)})
    runs = []
    for label, tree in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", MID_P_CHILD, cfg], cwd=tree,
            capture_output=True, text=True, timeout=2400)
        if proc.returncode:
            raise RuntimeError(f"--mid-p in {tree}:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        run = {"tree": label, **json.loads(proc.stdout.strip()
                                           .splitlines()[-1])}
        runs.append(run)
        print(json.dumps({"tree": label, "build_s": run["build_s"],
                          "ptxas": run["ptxas"]}), flush=True)
    table = []
    for i, row in enumerate(runs[0]["rows"]):
        def mean(tree, key):
            vals = [r["rows"][i].get(key) for r in runs if r["tree"] == tree]
            return None if None in vals else sum(vals) / len(vals)
        step = {"kernel": row["kernel"], "n": row["n"], "m": row["m"]}
        for key in ("kernel_us", "wrapper_ms"):
            p_val, c_val = mean("parent", key), mean("change", key)
            step[f"parent_{key}"], step[f"change_{key}"] = p_val, c_val
            step[f"{key}_change_over_parent"] = (
                None if not p_val or c_val is None else c_val / p_val)
        for tree in ("parent", "change"):
            mine = [r["rows"][i] for r in runs if r["tree"] == tree]
            step[f"{tree}_names"] = mine[0].get("kernel_names",
                                                mine[0].get("refused"))
            errs = [r.get("phi_rel_err") for r in mine]
            step[f"{tree}_phi_rel_err"] = (None if None in errs
                                           else max(errs))
        table.append(step)
        print(json.dumps(step), flush=True)
    return {"runs": runs, "table": table}


def mid_p_main(args) -> int:
    """--mid-p: mid_p's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "mid_p": mid_p(Path(args.mid_p))}
    out = Path(args.out or "chiprun_out/mid_p.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --mid-panel's readings: K3 (T = 3), K5 at world 1 and K12/K13 (two
#: terms) with the panel forced at MID_PANEL_NS x MID_PANEL_MS (the widths
#: whose float32 panels the change moves: m = 11 for K3/K5 to the
#: micro-tile body, the mid widths to the wide entries; K12/K13 at m = 11
#: unmoved, a control), and m = 11 also at MID_PANEL_M11_NS; then the d = 11
#: switch, K3 (the panel, auto's form from 45,057 particles) against K2
#: (the full-width triangle) at m = 11 and MID_PANEL_SWITCH_NS. phi's
#: distance from float64 at n = MID_PANEL_CHECK_N only.
MID_PANEL_MS = (9, 10, 11, 12, 16, 17, 32, 33, 54, 64)
MID_PANEL_NS = (10000, 32768)
MID_PANEL_M11_NS = (65536, 131072)
MID_PANEL_SWITCH_NS = (32768, 45056, 65536, 131072, 262144)
MID_PANEL_CHECK_N = 10000

#: --mid-panel's child, run in one tree (its cwd), through what both trees
#: share (the public wrappers; chip_smoke's grid_inputs, kernel_us and
#: time_ms): each reading on grid inputs, kernel-only us (chip_smoke.
#: kernel_us over 3 calls, one event a call of the named kernel), the
#: wrapper's ms (chip_smoke.time_ms, the median of 5), phi's distance from
#: the float64 plain version (relative to its max |phi|) and the counts'
#: difference from it where checked, and the launch counter that moved;
#: with the tree's build seconds and the ptxas lines of its panel
#: instances.
MID_PANEL_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops.phi import (phi_rbf_fused_counts,
                                       phi_rbf_fused_sym_finish,
                                       phi_rbf_terms_fused_counts)
dev = torch.device("cuda")
cfg = json.loads(sys.argv[1])
t0 = time.perf_counter()
cuda_phi.load_library()
build_s = time.perf_counter() - t0
log = cuda_phi.build_log_path()
ptxas = cs.ptxas_summary(log.read_text() if log.exists() else "")
rows = []

def reading(label, n, m, fn, name, want):
    cuda_phi.reset_launch_counts()
    got = fn()
    torch.cuda.synchronize()
    row = {"kernel": label, "n": n, "m": m,
           "launches": {k: v for k, v in cuda_phi.launch_counts.items()
                        if v}}
    if want is not None:
        ref = want()
        row["phi_rel_err"] = float((got[0].double() - ref[0]).abs().max()
                                   / ref[0].abs().max())
        row["count_diff"] = int((got[1] - ref[1]).abs().max())
    row["kernel_us"] = cs.kernel_us(fn, name, calls=3, per_call=1)
    row["wrapper_ms"] = cs.time_ms(fn, reps=5, warmup=1)
    rows.append(row)
    print(json.dumps(row), flush=True)

def panels(n, m, check):
    x, s, g, thr = cs.grid_inputs(n, m, 0.0, 520 + m, dev)
    x64, s64, thr64 = x.double(), s.double(), thr.double()
    one = (lambda: phi_rbf_fused_counts(x64, s64, g.double(), thr64)
           ) if check else None
    reading("K3", n, m,
            lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym="panel"),
            "fused_phi_counts_sympanel", one)

    def k5():
        acc, upper = cuda_phi.phi_rbf_sympanel_chunk_cuda(x, s, g, thr, 1, 0)
        return phi_rbf_fused_sym_finish(acc, s, g, n), 2 * upper - n
    reading("K5 world 1", n, m, k5, "fused_phi_counts_sympanel_chunk", one)
    gs, signs = [g, 0.5 * g], (1.0, 1.0)
    reading("K12/K13 two terms", n, m,
            lambda: cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                      sym="panel"),
            "fused_phi_terms_sympanel",
            (lambda: phi_rbf_terms_fused_counts(
                x64, s64, [v.double() for v in gs], signs, thr64))
            if check else None)

for n in cfg["ns"]:
    for m in cfg["ms"]:
        panels(n, m, n == cfg["check_n"])
for n in cfg["m11_ns"]:
    panels(n, 11, False)
for n in cfg["switch_ns"]:
    x, s, g, thr = cs.grid_inputs(n, 11, 0.0, 530, dev)
    reading("switch K3 panel", n, 11,
            lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym="panel"),
            "fused_phi_counts_sympanel", None)
    reading("switch K2 triangle", n, 11,
            lambda: cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True),
            "fused_phi_counts_sym_kernel", None)
inst = {k: v for k, v in ptxas.items() if "sympanel" in k}
print(json.dumps({"build_s": build_s, "ptxas": inst, "rows": rows}),
      flush=True)
"""


def mid_panel(parent: Path) -> dict:
    """--mid-panel DIR: MID_PANEL_CHILD in the tree DIR (the parent's
    checkout, which builds its own csrc/), in this one, in this one and in
    DIR, one process each (parent, change, change, parent); then, for each
    reading, the parent's and the change's kernel-only us and wrapper ms
    side by side (each the mean of its tree's two runs), their ratio and
    each tree's largest distance from float64."""
    cfg = json.dumps({"ns": list(MID_PANEL_NS), "ms": list(MID_PANEL_MS),
                      "m11_ns": list(MID_PANEL_M11_NS),
                      "switch_ns": list(MID_PANEL_SWITCH_NS),
                      "check_n": MID_PANEL_CHECK_N})
    runs = []
    for label, tree in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", MID_PANEL_CHILD, cfg], cwd=tree,
            capture_output=True, text=True, timeout=2400)
        if proc.returncode:
            raise RuntimeError(f"--mid-panel in {tree}:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        run = {"tree": label, **json.loads(proc.stdout.strip()
                                           .splitlines()[-1])}
        runs.append(run)
        print(json.dumps({"tree": label, "build_s": run["build_s"],
                          "ptxas": run["ptxas"]}), flush=True)
    table = []
    for i, row in enumerate(runs[0]["rows"]):
        def mean(tree, key):
            vals = [r["rows"][i].get(key) for r in runs if r["tree"] == tree]
            return None if None in vals else sum(vals) / len(vals)
        step = {"kernel": row["kernel"], "n": row["n"], "m": row["m"]}
        for key in ("kernel_us", "wrapper_ms"):
            p_val, c_val = mean("parent", key), mean("change", key)
            step[f"parent_{key}"], step[f"change_{key}"] = p_val, c_val
            step[f"{key}_change_over_parent"] = (
                None if not p_val or c_val is None else c_val / p_val)
        for tree in ("parent", "change"):
            mine = [r["rows"][i] for r in runs if r["tree"] == tree]
            errs = [r.get("phi_rel_err") for r in mine]
            step[f"{tree}_phi_rel_err"] = (None if None in errs
                                           else max(errs))
            cnts = [r.get("count_diff") for r in mine]
            step[f"{tree}_count_diff"] = (None if None in cnts
                                          else max(cnts))
        table.append(step)
        print(json.dumps(step), flush=True)
    return {"runs": runs, "table": table}


def mid_panel_main(args) -> int:
    """--mid-panel: mid_panel's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "mid_panel": mid_panel(Path(args.mid_panel))}
    out = Path(args.out or "chiprun_out/mid_panel.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --micro-groups' readings: K14's term groups at the micro widths
#: MICRO_GROUPS_MS (the change moves them from terms_sym.cuh's
#: one-row-a-thread body to micro_tile.cuh's triangle body) at
#: MICRO_GROUPS_NS for each of MICRO_GROUPS_SETS (two or more anisotropic
#: terms, or none beside one: the term groups in both trees), then iso + 1
#: with the term groups forced against the one-pass kernel (the one-pass
#: rule at the micro widths); phi's distance from float64 at
#: MICRO_GROUPS_CHECK_N only.
MICRO_GROUPS_MS = (2, 5, 8, 11)
MICRO_GROUPS_NS = (2048, 10240, 32768)
MICRO_GROUPS_SETS = {"iso+2": ((1.0,), (1.0, -0.5)),
                     "iso+3": ((1.0,), (1.0, 0.5, -0.3)),
                     "iso+7": ((1.0,), (1.0, 0.5, -0.3, 0.8, 0.4, -0.2,
                                        0.6)),
                     "0+2": ((), (1.0, 0.5)),
                     "2iso+2": ((1.0, -0.5), (1.0, 0.5)),
                     "iso+1": ((1.0,), (1.0,))}
MICRO_GROUPS_CHECK_N = 2048

#: --micro-groups' child, run in one tree (its cwd), through what both trees
#: share (the public wrapper with the Cholesky factors given, chip_smoke's
#: grid_inputs, wide_p_ps and time_ms): each reading on grid inputs, T = 3,
#: kernel-only us (the profiler's events over 10 calls whose names hold
#: "fused_phi_aniso" or "count_le", summed, with the names seen: the
#: parent's groups count inside group 0, the change's with no isotropic
#: term through K16), the wrapper's ms (the median of 20), phi's distance
#: from the float64 plain version (relative to max |phi|) and the counts'
#: difference from it at MICRO_GROUPS_CHECK_N; with the tree's build
#: seconds and the ptxas lines of K14's instances. iso + 1 runs with the
#: groups forced (cuda_phi.aniso_one_pass patched to refuse) and on the
#: one-pass kernel (the route).
MICRO_GROUPS_CHILD = r"""
import json, os, re, sys, tempfile, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops.phi import phi_rbf_aniso_terms_fused_counts
NAMES = ("fused_phi_aniso", "count_le")
dev = torch.device("cuda")
cfg = json.loads(sys.argv[1])
t0 = time.perf_counter()
cuda_phi.load_library()
build_s = time.perf_counter() - t0
log = cuda_phi.build_log_path()
ptxas = cs.ptxas_summary(log.read_text() if log.exists() else "")
RULE = cuda_phi.aniso_one_pass
rows = []

def device_us(fn, calls=10):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
    hits = [ev for ev in events
            if ev.get("ph") == "X" and ev.get("cat") == "kernel"
            and any(nm in ev.get("name", "") for nm in NAMES)]
    names = sorted({re.search(r"\w*(?:" + "|".join(NAMES) + r")\w*",
                              ev["name"]).group(0) for ev in hits})
    return (sum(float(ev["dur"]) for ev in hits) / calls if hits else None,
            names, len(hits) / calls)

def reading(label, n, m, fn, want):
    row = {"kernel": label, "n": n, "m": m}
    cuda_phi.reset_launch_counts()
    got = fn()
    torch.cuda.synchronize()
    row["launches"] = {k: v for k, v in cuda_phi.launch_counts.items() if v}
    row["finite"] = bool(got[0].isfinite().all())
    if want is not None:
        ref = want()
        row["phi_rel_err"] = float((got[0].double() - ref[0]).abs().max()
                                   / ref[0].abs().max())
        row["count_diff"] = int((got[1] - ref[1]).abs().max())
    row["kernel_us"], row["kernel_names"], row["events_per_call"] = (
        device_us(fn))
    row["wrapper_ms"] = cs.time_ms(fn, reps=20, warmup=3)
    rows.append(row)
    print(json.dumps(row), flush=True)

for n in cfg["ns"]:
    for m in cfg["ms"]:
        x, s, g, thr = cs.grid_inputs(n, m, 0.0, 530 + m, dev)
        for spec, (iso_s, an_s) in cfg["sets"].items():
            iso_g = [g, 2.0 * g][:len(iso_s)]
            ps = cs.wide_p_ps("pd", m, len(an_s), 531, g, dev)
            lowers = cuda_phi.cholesky_factors(ps, dev)
            fn = lambda: cuda_phi.phi_rbf_aniso_terms_fused_cuda(
                x, s, iso_g, iso_s, ps, an_s, thr, lowers=lowers)
            want = (lambda: phi_rbf_aniso_terms_fused_counts(
                x.double(), s.double(), [v.double() for v in iso_g], iso_s,
                [p.double() for p in ps], an_s, thr.double())
                ) if n == cfg["check_n"] else None
            kinds = ("groups", "one_pass") if len(an_s) == 1 else (None,)
            for kind in kinds:
                cuda_phi.aniso_one_pass = (
                    (lambda mm, k: False) if kind == "groups" else RULE)
                reading(f"K14 {spec}" + (f" {kind}" if kind else ""), n, m,
                        fn, want)
            cuda_phi.aniso_one_pass = RULE
inst = {k: v for k, v in ptxas.items() if k.startswith("aniso_terms_")}
print(json.dumps({"build_s": build_s, "ptxas": inst, "rows": rows}),
      flush=True)
"""

#: --micro-groups' second reading, in this tree only: group 0 of one
#: isotropic term swept in the anisotropic groups' launch (the group along
#: the grid's z, its compares in every group, one launch), the first design
#: of the change, which at m = 11 spilled 8 B (kT = 3) on an H100, against
#: the package's two launches (group 0 alone with its counts, then the
#: anisotropic groups with none). Built from a copy of csrc/ (parent_csrc)
#: under its own kernel name and a C entry of its own; n_iso = 1 only.
MICRO_GROUPS_COMBINED_SOURCE = r"""
#include "micro_tile.cuh"
using namespace svgd;
template <int MM, bool kExact, int kT>
__global__ void __launch_bounds__(MicroTri<MM>::kThreads)
    combined_micro_groups_kernel(
        const float* __restrict__ coords, const float* __restrict__ z,
        const float* __restrict__ scores, const float* __restrict__ gamma,
        const float* __restrict__ thr, int n, int m_arg, int T, int nb,
        float* __restrict__ acc, unsigned long long* __restrict__ counts) {
  const int m = kExact ? MM : m_arg;
  const int group = static_cast<int>(blockIdx.z);
  const bool euclid = group == 0;
  const float* rows =
      euclid ? coords : z + static_cast<size_t>(group - 1) * n * m;
  const OneRbf weights{euclid ? -gamma[0] * kLog2e : -kLog2e};
  micro_tri_body<MM, kExact, kT>(rows, scores, weights, thr, n, m,
                                 euclid ? T : 0, nb, 0LL,
                                 acc + static_cast<size_t>(group) * 2 * m * n,
                                 counts);
}
template <int MM, bool kExact>
int combined_launch(const float* coords, const float* z, const float* scores,
                    const float* gamma, int n_aniso, const float* thr, int n,
                    int m, int T, float* acc, unsigned long long* c,
                    cudaStream_t s) {
  using P = MicroTri<MM>;
  const long long pairs = upper_pairs(n, P::kSide);
  const int nb = (n + P::kSide - 1) / P::kSide;
  const dim3 grid(static_cast<unsigned int>(pairs),
                  tri_splits<MM>(pairs * (1 + n_aniso)), 1 + n_aniso);
  if (T == 3) {
    combined_micro_groups_kernel<MM, kExact, 3><<<grid, P::kThreads, 0, s>>>(
        coords, z, scores, gamma, thr, n, m, T, nb, acc, c);
  } else {
    combined_micro_groups_kernel<MM, kExact, kMaxT>
        <<<grid, P::kThreads, 0, s>>>(coords, z, scores, gamma, thr, n, m, T,
                                      nb, acc, c);
  }
  return static_cast<int>(cudaGetLastError());
}
extern "C" int combined_aniso_micro(const float* coords, const float* z,
                                    const float* scores, const float* gamma,
                                    int n_aniso, const float* thr, int n,
                                    int m, int T, float* acc,
                                    long long* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define COMBINED(MM_, EX_)                                                 \
  return combined_launch<MM_, EX_>(coords, z, scores, gamma, n_aniso, thr,  \
                                   n, m, T, acc, c, s)
  SVGD_DISPATCH_MICRO_2_11(m, COMBINED)
#undef COMBINED
  return static_cast<int>(cudaErrorInvalidValue);
}
"""
MICRO_GROUPS_COMBINED_NS = (10240, 32768)
MICRO_GROUPS_COMBINED_SETS = ("iso+2", "iso+7")


def micro_groups_combined(device):
    """MICRO_GROUPS_COMBINED_SOURCE's one-launch groups against the
    package's public wrapper at MICRO_GROUPS_MS x MICRO_GROUPS_COMBINED_NS
    for MICRO_GROUPS_COMBINED_SETS, grid inputs, T = 3, in one process:
    kernel-only us of each (chip_smoke.kernel_us over 10 calls: the
    combined kernel's one event, the package's two), both wrappers' ms and
    the combined result's distance from the package's (phi relative to its
    max |phi|, the counts' difference), with the variant's registers and
    spill."""
    import ctypes

    import torch

    from chip_smoke import (
        grid_inputs,
        kernel_us,
        ptxas_summary,
        time_ms,
        wide_p_ps,
    )
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import aniso_groups_finish
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    dest = parent_csrc(ROOT / "_verify" / "micro_groups")
    (dest / "combined.cu").write_text(MICRO_GROUPS_COMBINED_SOURCE)
    proc = subprocess.Popen(
        [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
         str(dest / "libcombined.so"), str(dest / "combined.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_phi.load_library()  # built meanwhile
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the combined groups' build:\n{out}")
    regs, name, spill = {}, None, "?"
    for line in out.splitlines():
        hit = re.search(r"combined_micro_groups_kernelILi(\d+)ELb([01])ELi"
                        r"(\d+)E", line)
        if hit and "Compiling entry" in line:
            name = f"combined<{hit.group(1)},{hit.group(2)},{hit.group(3)}>"
        hit = re.search(r"(\d+) bytes spill stores", line)
        if hit:
            spill = hit.group(1)
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            regs[name] = f"{hit.group(1)} regs, {spill} B spill"
            name, spill = None, "?"
    lib = ctypes.CDLL(str(dest / "libcombined.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.combined_aniso_micro.argtypes = ([ptr] * 4 + [i32, ptr] + [i32] * 3
                                         + [ptr] * 3)
    lib.combined_aniso_micro.restype = i32
    rows = []
    for n in MICRO_GROUPS_COMBINED_NS:
        for m in MICRO_GROUPS_MS:
            x, s, g, thr = grid_inputs(n, m, 0.0, 530 + m, device)
            for spec in MICRO_GROUPS_COMBINED_SETS:
                iso_s, an_s = MICRO_GROUPS_SETS[spec]
                ps = wide_p_ps("pd", m, len(an_s), 531, g, device)
                lowers = cuda_phi.cholesky_factors(ps, device)

                def package():
                    return cuda_phi.phi_rbf_aniso_terms_fused_cuda(
                        x, s, [g], iso_s, ps, an_s, thr, lowers=lowers)

                def combined():
                    xc = (x - x.mean(dim=0)).contiguous()
                    z = (xc.double() @ lowers).float().contiguous()
                    acc = torch.zeros((1 + len(an_s), 2 * m, n),
                                      device=device)
                    upper = torch.zeros(thr.shape[0], dtype=torch.int64,
                                        device=device)
                    rc = lib.combined_aniso_micro(
                        xc.data_ptr(), z.data_ptr(), s.data_ptr(),
                        g.reshape(1).data_ptr(), len(an_s), thr.data_ptr(),
                        n, m, thr.shape[0], acc.data_ptr(),
                        upper.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"combined_aniso_micro: {rc}")
                    return (aniso_groups_finish(acc, s, g, iso_s, an_s,
                                                lowers, n), 2 * upper - n)
                got, ref = combined(), package()
                row = {
                    "n": n, "m": m, "terms": spec,
                    "combined_kernel_us": kernel_us(
                        combined, "combined_micro_groups_kernel",
                        per_call=1),
                    "package_kernel_us": kernel_us(
                        package, "fused_phi_aniso_terms_micro_", per_call=2),
                    "combined_wrapper_ms": time_ms(combined, reps=20,
                                                   warmup=3),
                    "package_wrapper_ms": time_ms(package, reps=20,
                                                  warmup=3),
                    "phi_rel_diff": float((got[0] - ref[0]).abs().max()
                                          / ref[0].abs().max()),
                    "count_diff": int((got[1] - ref[1]).abs().max()),
                }
                rows.append(row)
                print(json.dumps(row), flush=True)
    return {"combined_ptxas": regs, "rows": rows}


def micro_groups(parent: Path) -> dict:
    """--micro-groups DIR: MICRO_GROUPS_CHILD in the tree DIR (the parent's
    checkout, which builds its own csrc/), in this one, in this one and in
    DIR, one process each (parent, change, change, parent); then, for each
    reading, the parent's and the change's kernel-only us and wrapper ms
    side by side (each the mean of its tree's two runs), their ratio, the
    kernels each tree ran and its largest distance from float64; then
    micro_groups_combined in this process."""
    import torch

    cfg = json.dumps({"ns": list(MICRO_GROUPS_NS),
                      "ms": list(MICRO_GROUPS_MS),
                      "sets": MICRO_GROUPS_SETS,
                      "check_n": MICRO_GROUPS_CHECK_N})
    runs = []
    for label, tree in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", MICRO_GROUPS_CHILD, cfg], cwd=tree,
            capture_output=True, text=True, timeout=2400)
        if proc.returncode:
            raise RuntimeError(f"--micro-groups in {tree}:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        run = {"tree": label, **json.loads(proc.stdout.strip()
                                           .splitlines()[-1])}
        runs.append(run)
        print(json.dumps({"tree": label, "build_s": run["build_s"],
                          "ptxas": run["ptxas"]}), flush=True)
    table = []
    for i, row in enumerate(runs[0]["rows"]):
        def mean(tree, key):
            vals = [r["rows"][i].get(key) for r in runs if r["tree"] == tree]
            return None if None in vals else sum(vals) / len(vals)
        step = {"kernel": row["kernel"], "n": row["n"], "m": row["m"]}
        for key in ("kernel_us", "wrapper_ms"):
            p_val, c_val = mean("parent", key), mean("change", key)
            step[f"parent_{key}"], step[f"change_{key}"] = p_val, c_val
            step[f"{key}_change_over_parent"] = (
                None if not p_val or c_val is None else c_val / p_val)
        for tree in ("parent", "change"):
            mine = [r["rows"][i] for r in runs if r["tree"] == tree]
            step[f"{tree}_names"] = mine[0].get("kernel_names")
            errs = [r.get("phi_rel_err") for r in mine]
            step[f"{tree}_phi_rel_err"] = (None if None in errs
                                           else max(errs))
            cnts = [r.get("count_diff") for r in mine]
            step[f"{tree}_count_diff"] = (None if None in cnts
                                          else max(cnts))
        table.append(step)
        print(json.dumps(step), flush=True)
    combined = micro_groups_combined(torch.device("cuda"))
    return {"runs": runs, "table": table, "combined": combined}


def micro_groups_main(args) -> int:
    """--micro-groups: micro_groups' rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card,
              "micro_groups": micro_groups(Path(args.micro_groups))}
    out = Path(args.out or "chiprun_out/micro_groups.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


def bf16_parity(device):
    """--bf16-parity: how far K1's bf16 result moves with the order of the
    sums that form sq. The flat BLR driver (N = 1000, d = 50, the bf16
    opt-in, chip_smoke.py phase 46b's run) for COMPARE_STEPS steps; each
    call of the sweep is replayed in plain torch on the card with sq from
    q_i + q_j - 2 G as the bf16 plain version forms it, then with one sum
    in another order: q in K2's pack's order (bf16_tri_pack: a lane's
    fused multiply-adds over coordinates lane, lane + 32, ..., then a
    butterfly over the warp), the Gram's dot in reverse coordinate order,
    or the Gram in float64 rounded once. Per call and variant: the
    distance of phi from the bf16 plain version's (a share of max |phi|,
    chip_smoke.py's BF16_GATE is 1e-3) and the weights k whose bf16
    rounding moved; the kernel's own distance beside them."""
    import torch

    import chip_smoke as cs
    import svgdcpp_tpu_torch.svgd as driver_module
    from svgdcpp_tpu_torch.ops.pairwise import sq_matmul
    from svgdcpp_tpu_torch.ops.phi import LOG2E, round_bf16
    from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

    def plain_q(c):
        return torch.sum(c * c, dim=1)

    def warp_q(c):
        n, m = c.shape
        acc = torch.zeros((n, 32), dtype=torch.float64, device=c.device)
        for k0 in range(0, m, 32):
            v = torch.zeros((n, 32), dtype=torch.float64, device=c.device)
            v[:, :min(32, m - k0)] = c[:, k0:k0 + 32].double()
            acc = (v * v + acc).float().double()  # one fused rounding
        acc = acc.float()
        lane = torch.arange(32, device=c.device)
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lane ^ off]
        return acc[:, 0]

    def seq_gram(a, b, order):
        acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32,
                          device=a.device)
        for c in order:
            acc = acc + a[:, c:c + 1] * b[None, :, c]
        return acc

    variants = {
        "plain": (plain_q, lambda a, b: sq_matmul(a, b.T)),
        "pack_q": (warp_q, lambda a, b: sq_matmul(a, b.T)),
        "gram_reversed": (plain_q, lambda a, b: seq_gram(
            a, b, range(a.shape[1] - 1, -1, -1))),
        "gram_exact": (plain_q, lambda a, b: (a.double() @ b.double().T)
                       .float()),
    }

    def replay(x, s, g, q_fn, gram_fn):
        center = x.mean(dim=0)
        t = x - center
        q = q_fn(t)
        ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        b = round_bf16(torch.cat([s, t, ones], dim=1))
        gram = gram_fn(round_bf16(t), round_bf16(t))
        sq = torch.clamp_min(q[:, None] + q[None, :] - 2.0 * gram, 0.0)
        k = round_bf16(torch.exp2(-(g * LOG2E) * sq))
        a = sq_matmul(k, b)
        m = x.shape[1]
        d = a[:, m:2 * m] - a[:, 2 * m, None] * t
        return (a[:, :m] - 2.0 * g * d) / x.shape[0], k

    feats, labels, xb = blr_workload(1000, 50)
    svgd = build_blr_svgd(torch.tensor(xb, device=device), feats, labels,
                          num_iterations=cs.COMPARE_STEPS,
                          fused_dot_dtype="bfloat16")
    with cs.CallGate(driver_module, "phi_rbf_fused_cuda") as gate:
        svgd.run()
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    rows, worst = [], {}
    for idx, (args, kwargs, out) in enumerate(gate.calls):
        x, s, g = (torch.as_tensor(v, dtype=torch.float32, device=device)
                   for v in args[:3])
        want = cs.bf16_plain("phi_rbf_fused_cuda")(*args, **kwargs)[0]
        row = {"call": idx, "kernel": rel(out[0], want)}
        k0 = None
        for name, (q_fn, gram_fn) in variants.items():
            phi, k = replay(x, s, g, q_fn, gram_fn)
            k0 = k if k0 is None else k0
            row[name] = rel(phi, want)
            row[f"{name}_k_moved"] = int((k != k0).sum())
        rows.append(row)
        print(json.dumps(row), flush=True)
        for key, v in row.items():
            if key != "call":
                worst[key] = max(worst.get(key, 0), v)
    print("worst", json.dumps(worst), flush=True)
    return {"calls": rows, "worst": worst}


def bf16_parity_main(args) -> int:
    """--bf16-parity: bf16_parity's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "bf16_parity": bf16_parity(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/bf16_parity.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


#: --square-wide-breakdown's harness: the float32 wide square body
#: (csrc/square_wide_sm90.cuh) under kernels of its own, K1's one RBF and
#: the terms' FixedTerms<2> and AnyTerms at T = 3 and 8, launched on the
#: package's plan without the finishing pass; built from a copy of csrc/
#: whose header a variant rewrote. Not a kernel of the package.
SQUARE_WIDE_BREAKDOWN_SOURCE = r"""
#include "square_wide_sm90.cuh"
using namespace svgd;
template <int kT>
__global__ void __launch_bounds__(kSqWideThreads)
    bk_k1(const float* __restrict__ targets, const float* __restrict__ sources,
          const float* __restrict__ scores, const float* __restrict__ gammas,
          TermSigns sg, int nterms, const float* __restrict__ thr, int n_t,
          int n_s, int w, int T, int chunk, float* __restrict__ work,
          unsigned long long* __restrict__ counts) {
  const OneRbf weights{-gammas[0] * kLog2e};
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * (2 * w + 1);
  square_wide_sm90_body<kT>(targets, sources, scores, weights, thr, n_t, n_s,
                            w, T, chunk, part, counts);
}
template <int kT>
__global__ void __launch_bounds__(kSqWideThreads, 1)
    bk_terms(const float* __restrict__ targets,
             const float* __restrict__ sources,
             const float* __restrict__ scores,
             const float* __restrict__ gammas, TermSigns sg, int nterms,
             const float* __restrict__ thr, int n_t, int n_s, int w, int T,
             int chunk, float* __restrict__ work,
             unsigned long long* __restrict__ counts) {
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * (2 * w + 1);
  square_wide_sm90_body<kT>(targets, sources, scores,
                            FixedTerms<2>(gammas, sg), thr, n_t, n_s, w, T,
                            chunk, part, counts);
}
template <int kT>
__global__ void __launch_bounds__(kSqWideThreads, 1)
    bk_any(const float* __restrict__ targets,
           const float* __restrict__ sources,
           const float* __restrict__ scores,
           const float* __restrict__ gammas, TermSigns sg, int nterms,
           const float* __restrict__ thr, int n_t, int n_s, int w, int T,
           int chunk, float* __restrict__ work,
           unsigned long long* __restrict__ counts) {
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];
  load_terms(gammas, sg, nterms, sh_g2, sh_sn, sh_sg);
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * (2 * w + 1);
  square_wide_sm90_body<kT>(targets, sources, scores,
                            AnyTerms{sh_g2, sh_sn, sh_sg, nterms}, thr, n_t,
                            n_s, w, T, chunk, part, counts);
}
using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, TermSigns, int, const float*, int, int,
                        int, int, int, float*, unsigned long long*);
// form 0: one RBF, 1: two terms (FixedTerms<2>), 2: any count (AnyTerms).
extern "C" int bk_run(int form, int t8, const float* targets,
                      const float* sources, const float* scores,
                      const float* gammas, const float* thr, int n_t,
                      int n_s, int w, int T, float* work, long long* counts,
                      void* stream) {
  const Kernel kernels[3][2] = {{bk_k1<3>, bk_k1<kMaxT>},
                                {bk_terms<3>, bk_terms<kMaxT>},
                                {bk_any<3>, bk_any<kMaxT>}};
  int splits = 0;
  const int chunk = sq_wide_chunk(n_t, n_s, w, &splits);
  const SqWidePlan p = sq_wide_plan(w, form != 0);
  const dim3 grid((n_t + p.rows - 1) / p.rows, splits, p.passes);
  const float sv[2] = {1.0f, 1.0f};
  const TermSigns sg = make_signs(sv, 2);
  const Kernel kernel = kernels[form][t8];
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       p.smem);
  kernel<<<grid, kSqWideThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      targets, sources, scores, gammas, sg, 2, thr, n_t, n_s, w, T, chunk,
      work, reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int bk_splits(int n_t, int n_s, int w) {
  int splits = 0;
  sq_wide_chunk(n_t, n_s, w, &splits);
  return splits;
}
"""

#: --square-wide-breakdown's variants of square_wide_sm90.cuh, (old, new)
#: rewrites: the body as it is; its operands split by truncation (the
#: float32 wide triangle's split_tf32) in place of the rounded split; every
#: mma.sync under a guard of its block's validity (the form whose fences
#: the body avoids); the Gram k-steps unrolled by two; and, one at a time,
#: the contraction's products, the Gram tile's products and the copies
#: taken out (results wrong; times only).
SQUARE_WIDE_VARIANTS = {
    "body": [],
    "truncated split": [
        ("big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "big = __float_as_uint(x) & 0xffffe000u;")],
    "guarded mma": [
        ("mma_3x(acc[i], kb, ks, bb0, bs0, bb1, bs1);",
         "if (i < nbw) mma_3x(acc[i], kb, ks, bb0, bs0, bb1, bs1);"),
        ("mma_3x(acc[i], ab, as, bb0, bs0, bb1, bs1);",
         "if (i < nbw) mma_3x(acc[i], ab, as, bb0, bs0, bb1, bs1);"),
        ("mma_tf32(acc_g[b], as, bb[b][0], bb[b][1]);",
         "if (b < gcb) mma_tf32(acc_g[b], as, bb[b][0], bb[b][1]);"),
        ("mma_tf32(acc_g[b], ab, bs[b][0], bs[b][1]);",
         "if (b < gcb) mma_tf32(acc_g[b], ab, bs[b][0], bs[b][1]);"),
        ("mma_tf32(acc_g[b], ab, bb[b][0], bb[b][1]);",
         "if (b < gcb) mma_tf32(acc_g[b], ab, bb[b][0], bb[b][1]);")],
    "gram unrolled by two": [
        ("#pragma unroll 1\n        for (int ks = 0; 8 * ks < kn; ++ks)",
         "#pragma unroll 2\n        for (int ks = 0; 8 * ks < kn; ++ks)")],
    "no contraction mma": [
        ("mma_3x(acc[i], kb, ks, bb0, bs0, bb1, bs1);",
         "acc[i][0] += __uint_as_float(bb0 ^ bs1 ^ kb[0] ^ ks[1]);"),
        ("mma_3x(acc[i], ab, as, bb0, bs0, bb1, bs1);",
         "acc[i][0] += __uint_as_float(bb0 ^ bs1 ^ ab[0] ^ as[1]);")],
    "no gram mma": [
        ("mma_tf32(acc_g[b], as, bb[b][0], bb[b][1]);",
         "acc_g[b][0] += __uint_as_float(bb[b][0] ^ as[1]);"),
        ("mma_tf32(acc_g[b], ab, bs[b][0], bs[b][1]);",
         "acc_g[b][1] += __uint_as_float(bs[b][0] ^ ab[1]);"),
        ("mma_tf32(acc_g[b], ab, bb[b][0], bb[b][1]);",
         "acc_g[b][2] += __uint_as_float(bb[b][1] ^ ab[2]);")],
    "no copies": [
        ("if (q + S - 1 < total) issue(q + S - 1);", ""),
        ("if (q < total) issue(q);", "")],
}

#: --square-wide-breakdown's calls: (label, n, m, form), form 0 K1 (one
#: RBF), 1 the terms kernel with two terms; the grid inputs about 100 at
#: (1000, 123), where the split's rounding shows.
SQUARE_WIDE_BREAKDOWN_CASES = (("K1", 1000, 123, 0), ("K1", 10000, 123, 0),
                               ("K6/K7", 1500, 124, 1), ("K1", 1000, 256, 0),
                               ("K1", 1000, 512, 0))


def square_wide_breakdown(device):
    """--square-wide-breakdown: each of SQUARE_WIDE_VARIANTS built in a
    copy under _verify/square_wide_breakdown/ (all at once), its kernels'
    registers and spill from ptxas, and its kernel-only us (CUDA events
    over 30 launches after 3; 5 at n = 10,000) at
    SQUARE_WIDE_BREAKDOWN_CASES, with K1's phi (the workspace finished in
    float64) against the float64 plain version for the body and the
    truncated split."""
    import ctypes

    import torch

    from chip_smoke import grid_inputs
    from svgdcpp_tpu_torch.ops.phi import phi_rbf_fused_counts
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    procs = {}
    for name, rewrites in SQUARE_WIDE_VARIANTS.items():
        dest = ROOT / "_verify" / "square_wide_breakdown" / re.sub(
            r"\W+", "_", name)
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(ROOT / "svgdcpp_tpu_torch" / "csrc", dest)
        header = dest / "square_wide_sm90.cuh"
        text = header.read_text()
        for old, new in rewrites:
            if not text.count(old):
                raise RuntimeError(f"square_wide_breakdown: {name}: no "
                                   f"{old!r} in {header.name}")
            text = text.replace(old, new)
        header.write_text(text)
        (dest / "breakdown.cu").write_text(SQUARE_WIDE_BREAKDOWN_SOURCE)
        procs[name] = (dest, subprocess.Popen(
            [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
             str(dest / "libbreakdown.so"), str(dest / "breakdown.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (dest, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"square_wide_breakdown: {name}:\n{out}")
        ptxas[name] = {
            f"{k}<{t}>": f"{regs} regs, {spill} B spill"
            for k, t, spill, regs in re.findall(
                r"Compiling entry function '_Z\d+(bk_\w+?)ILi(\d+)E.*?"
                r"(\d+) bytes spill stores.*?Used (\d+) registers", out,
                re.S)}
        lib = ctypes.CDLL(str(dest / "libbreakdown.so"))
        lib.bk_run.argtypes = [i32, i32] + [ptr] * 5 + [i32] * 4 + [ptr] * 3
        lib.bk_run.restype = i32
        lib.bk_splits.argtypes = [i32] * 3
        libs[name] = lib
        print(json.dumps({"variant": name, "ptxas": ptxas[name]}), flush=True)

    rows = []
    for label, n, m, form in SQUARE_WIDE_BREAKDOWN_CASES:
        offset = 100.0 if (n, m) == (1000, 123) else 0.0
        w = -(-m // 4) * 4
        x, s, g, thr = grid_inputs(n, m, offset, 470 + m + n, device)
        pad = (0, w - m)
        xc = torch.nn.functional.pad(x - x.mean(dim=0), pad).contiguous()
        sc = torch.nn.functional.pad(s, pad).contiguous()
        gs = torch.stack([g.reshape(()), 0.5 * g.reshape(())])
        splits = libs["body"].bk_splits(n, n, w)
        work = torch.zeros((splits, n, 2 * w + 1), device=device)
        counts = torch.zeros(thr.shape[0], dtype=torch.int64, device=device)
        ref = None if form else phi_rbf_fused_counts(
            x.double(), s.double(), g.double(), thr.double())[0]
        row = {"kernel": label, "n": n, "m": m, "offset": offset,
               "splits": splits, "kernel_us": {}, "rel_err_f64": {}}
        for name, lib in libs.items():
            def call():
                rc = lib.bk_run(form, 0, xc.data_ptr(), xc.data_ptr(),
                                sc.data_ptr(), gs.data_ptr(), thr.data_ptr(),
                                n, n, w, thr.shape[0], work.data_ptr(),
                                counts.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: bk_run returned {rc}")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            reps = 5 if n >= 10000 else 30
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            row["kernel_us"][name] = 1000.0 * start.elapsed_time(end) / reps
            if ref is not None and name in ("body", "truncated split"):
                work.zero_()
                call()
                acc = work.double().sum(dim=0)
                d = acc[:, 2 * w:] * xc.double() - acc[:, w:2 * w]
                phi = (acc[:, :w] + 2.0 * float(g) * d)[:, :m] / n
                row["rel_err_f64"][name] = float(
                    (phi - ref).abs().max() / ref.abs().max())
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"ptxas": ptxas, "rows": rows}


def square_wide_breakdown_main(args) -> int:
    """--square-wide-breakdown: square_wide_breakdown's rows, JSON to
    --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "square_wide_breakdown": square_wide_breakdown(
                  torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/square_wide_breakdown.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


def wide_drift(device):
    """The float32 routes' distance from float64 at a9a's width (d = 123)
    and N = 10,000 over chip_smoke.py phase 43c's COMPARE_STEPS steps, and
    what makes it:

      * hierarchical BLR (m = 124, median RBF + 0.1 I, Adam lr 5e-2) on the
        plain route ``fused_terms`` in float64 and in float32 and on the
        kernel route ``fused_terms_cuda`` in float32, a step at a time:
        each step's median and fallbacks, and each float32 run's max
        |dcoords| from float64 with the row and column where it lies;
      * every sweep call of the float64 run replayed in float32 on the same
        inputs, through the plain version and through the kernel (the
        triangle): max |dphi| from float64, the largest over the columns of
        a column's max |dphi| over that column's RMS, and the counts'
        largest distance from float64's;
      * the 1e-3 gates of phase 43c across seeds: the one-rank NCCL engine
        (fused_sym="full") against the driver and the driver against a
        second run of itself, for MVN d = 123 (wide_mvn seeds 490-494) and
        the hierarchical BLR (workload seeds 0-2), beside each float32
        route's distance from the float64 plain route."""
    import torch

    import svgdcpp_tpu_torch.svgd as driver_module
    from chip_smoke import (
        COMPARE_STEPS,
        WIDE_BIG_N,
        WIDE_D,
        free_port,
        wide_mvn,
    )
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.parallel import initialize_distributed
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_blr_svgd,
        build_mvn_svgd,
        build_sharded_hier_svgd,
        build_sharded_mvn_svgd,
    )

    n, d, steps = WIDE_BIG_N, WIDE_D, COMPARE_STEPS

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())

    def hier(x0, feats, labels, dtype, impl):
        return build_blr_svgd(torch.tensor(x0, dtype=dtype, device=device),
                              feats, labels, hierarchical=True,
                              phi_impl=impl, num_iterations=steps)

    def stepped(svgd):
        traj = []
        for _ in range(steps):
            svgd.step()
            traj.append((svgd.store.value.double().clone(),
                         float(svgd._scale_aux[0]["med"]),
                         svgd.median_fallbacks))
        return traj

    feats, labels, x0 = blr_workload(n, d, hierarchical=True)
    plain = driver_module.phi_rbf_terms_fused_counts
    calls = []

    def recorder(coords, scores, gammas, signs, thresholds, row_tile=1024):
        out = plain(coords, scores, gammas, signs, thresholds, row_tile)
        calls.append((coords.clone(), scores.clone(),
                      [torch.as_tensor(g).clone() for g in gammas],
                      [float(sg) for sg in signs],
                      torch.as_tensor(thresholds).clone(), out))
        return out

    driver_module.phi_rbf_terms_fused_counts = recorder
    try:
        traj64 = stepped(hier(x0, feats, labels, torch.float64,
                              "fused_terms"))
    finally:
        driver_module.phi_rbf_terms_fused_counts = plain
    result = {"hier": {"n": n, "m": d + 1, "steps": steps,
                       "float64_median": [t[1] for t in traj64],
                       "float64_fallbacks": traj64[-1][2]}}
    for name, dtype, impl in (("float32_plain", torch.float32, "fused_terms"),
                              ("float32_kernel", torch.float32,
                               "fused_terms_cuda")):
        svgd = hier(x0, feats, labels, dtype, impl)
        traj = stepped(svgd)
        rows = []
        for (c, med, falls), (c64, med64, _) in zip(traj, traj64):
            diff = (c - c64).abs()
            flat = int(diff.argmax())
            rows.append({"max_abs": float(diff.max()),
                         "row": flat // diff.shape[1],
                         "column": flat % diff.shape[1],
                         "median_rel": abs(med - med64) / med64,
                         "fallbacks": falls})
        run_final = hier(x0, feats, labels, dtype, impl).run()
        result["hier"][name] = {
            "form": svgd.fused_sym_form, "per_step": rows,
            "run_vs_step_max_abs": dist(run_final, traj[-1][0])}
        print(f"wide drift hier {name}: final {rows[-1]}", flush=True)
    replay = []
    for coords, scores, gammas, signs, thr, (phi64, cnt64) in calls:
        args32 = (coords.float(), scores.float(), [g.float() for g in gammas],
                  signs, thr.float())
        rms = phi64.pow(2).mean(dim=0).sqrt()
        row = {}
        for name, (phi, cnt) in (
                ("plain", plain(*args32)),
                ("kernel", cuda_phi.phi_rbf_terms_fused_cuda(*args32,
                                                             sym=True))):
            err = (phi.double() - phi64).abs()
            col_rel = err.max(dim=0).values / rms
            row[name] = {"max_abs": float(err.max()),
                         "column_of_max_abs": int(err.max(dim=0).values
                                                  .argmax()),
                         "max_column_rel": float(col_rel.max()),
                         "column_of_max_rel": int(col_rel.argmax()),
                         "count_diff": int((cnt - cnt64).abs().max())}
        row["phi_abs_max"] = float(phi64.abs().max())
        row["gammas"] = [float(g) for g in gammas]
        replay.append(row)
    result["hier"]["replay"] = replay
    print(f"wide drift hier replay: step 1 {replay[0]}, last {replay[-1]}",
          flush=True)

    group = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                                   device=device)
    gates = []
    for seed in range(490, 495):
        mean, cov, xm = wide_mvn(n, d, seed)

        def mvn(dtype, impl="auto", mean=mean, cov=cov, xm=xm):
            return build_mvn_svgd(torch.tensor(xm, dtype=dtype,
                                               device=device), mean, cov,
                                  phi_impl=impl,
                                  num_iterations=steps).run()
        first, second = mvn(torch.float32), mvn(torch.float32)
        eng = build_sharded_mvn_svgd(xm, mean, cov, group,
                                     fused_sym="full").run(xm, steps)
        ref = mvn(torch.float64, "fused")
        gates.append({"target": "mvn", "seed": seed,
                      "engine_vs_driver": dist(eng, first),
                      "driver_vs_driver": dist(second, first),
                      "driver_vs_float64_plain": dist(first, ref),
                      "engine_vs_float64_plain": dist(eng, ref)})
        print(f"wide drift gate {gates[-1]}", flush=True)
    for seed in range(3):
        feats, labels, xh = blr_workload(n, d, hierarchical=True, seed=seed)
        first = hier(xh, feats, labels, torch.float32, "auto").run()
        second = hier(xh, feats, labels, torch.float32, "auto").run()
        eng = build_sharded_hier_svgd(xh, feats, labels, group,
                                      fused_sym="full").run(xh, steps)
        ref = hier(xh, feats, labels, torch.float64, "fused_terms").run()
        plain32 = hier(xh, feats, labels, torch.float32,
                       "fused_terms").run()
        gates.append({"target": "hier", "seed": seed,
                      "engine_vs_driver": dist(eng, first),
                      "driver_vs_driver": dist(second, first),
                      "driver_vs_float64_plain": dist(first, ref),
                      "engine_vs_float64_plain": dist(eng, ref),
                      "float32_plain_vs_float64_plain": dist(plain32, ref)})
        print(f"wide drift gate {gates[-1]}", flush=True)
    torch.distributed.destroy_process_group()
    result["gates"] = gates
    return result


def wide_drift_main(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "wide_drift": wide_drift(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/wide_drift.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result["wide_drift"]["gates"], indent=1))
    return 0


#: --fixed-p-wide's parent: K15's two wide kernels as csrc/phi_rbf.cu held
#: them on wide_pair_body (parent_csrc's wide_tri.cuh) before they moved to
#: wide_tri_sm90.cuh's body (float32, m > 64) and bf16_tri_sm90.cuh's
#: (bfloat16, any m): one block of 4 warps a 64 x 64 tile pair of the upper
#: triangle, the float32 one 3xTF32 with one weight tile (72.7 KB), the
#: bf16 one a TF32 pass on bf16-rounded values with both Gram and weight
#: tiles (kAsym, 107.5 KB), both into (2m, n) [KS | D]; under names and a C
#: entry of their own.
FIXED_P_WIDE_PARENT_SOURCE = r"""
#include "wide_tri.cuh"
using namespace svgd;
__global__ void __launch_bounds__(kWideTriThreads)
    parent_phi_rbf_wide_kernel(const float* __restrict__ coords,
                               const float* __restrict__ y,
                               const float* __restrict__ q,
                               const float* __restrict__ scores, int n,
                               int m, int psd, int nb,
                               float* __restrict__ out) {
  WideForm form;
  form.y = y;
  form.q = q;
  form.clamp = psd != 0;
  wide_tri_body<0>(coords, scores, OneRbf{-kLog2e}, nullptr, n, m, 0, nb,
                   0LL, out, nullptr, form);
}
__global__ void __launch_bounds__(kWideTriThreads)
    parent_phi_rbf_wide_bf16_kernel(const float* __restrict__ coords,
                                    const float* __restrict__ y,
                                    const float* __restrict__ q,
                                    const float* __restrict__ scores, int n,
                                    int m, int psd, int nb,
                                    float* __restrict__ out) {
  WideForm form;
  form.y = y;
  form.q = q;
  form.clamp = psd != 0;
  form.pin = false;
  wide_tri_body<0, true, true>(coords, scores, OneRbf{-kLog2e}, nullptr, n,
                               m, 0, nb, 0LL, out, nullptr, form);
}
extern "C" int parent_phi_rbf_wide(int bf16, const float* coords,
                                   const float* y, const float* q,
                                   const float* scores, int n, int m, int psd,
                                   float* out, void* stream) {
  auto* kernel = bf16 ? &parent_phi_rbf_wide_bf16_kernel
                      : &parent_phi_rbf_wide_kernel;
  const int weights = bf16 ? 2 : 1;
  const long long pairs = upper_pairs(n, kWideTile);
  const int nb = (n + kWideTile - 1) / kWideTile;
  const cudaError_t err = wide_tri_prepare(kernel, weights);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(pairs), kWideTriThreads,
           WideTri::smem_bytes(weights), static_cast<cudaStream_t>(stream)>>>(
      coords, y, q, scores, n, m, psd, nb, out);
  return static_cast<int>(cudaGetLastError());
}
"""

#: --fixed-p-wide's shapes: (n, m, P's kind, instances). The HESSIAN
#: route's (10240, 123) with an indefinite P (phase 44b), the ladder at
#: n = 4096 with a positive definite P (phase 44a's widths), and phase
#: 46a's (1500, 2) for the bf16 instance with a median's gamma I; and
#: n = 10000 and 10007 at m = 123 (phase 46a's edge: the accumulator's
#: columns n floats apart, on 32-byte boundaries at n = 10000 and 10240
#: only).
FIXED_P_WIDE_SHAPES = (
    (10240, 123, "indefinite", ("float32", "bfloat16")),
    (10000, 123, "indefinite", ("float32", "bfloat16")),
    (10007, 123, "indefinite", ("float32", "bfloat16")),
    (4096, 65, "pd", ("float32", "bfloat16")),
    (4096, 123, "pd", ("float32", "bfloat16")),
    (4096, 256, "pd", ("float32", "bfloat16")),
    (4096, 512, "pd", ("float32", "bfloat16")),
    (1500, 2, "gamma_i", ("bfloat16",)),
)


def fixed_p_wide(device):
    """--fixed-p-wide: K15's two wide instances, the parent's
    (FIXED_P_WIDE_PARENT_SOURCE, built in a copy under _verify/fixed_p_wide/
    in this process) and the package's, at FIXED_P_WIDE_SHAPES on
    chip_smoke.py's inputs (grid inputs past m = 4): kernel-only us (the
    profiler's events, 10 calls after one; the bf16 instance's pack kernel
    counted), taken parent, new, new, parent; wrapper ms (CUDA events,
    chip_smoke.time_ms; the parent's wrapper is the operands, the (2m, n)
    buffer, the launch and the epilogue as they stood); each result's
    distance from its plain version (float32: phi_rbf_gram in float64;
    bf16: phi_rbf_gram(..., 'bfloat16') on the card), a share of max
    |phi|; beside them K2's float32 wide and bf16 instances at the same
    shapes, kernel-only and wrapper; and both builds' registers and
    spill."""
    import ctypes

    import torch

    from chip_smoke import (grid_inputs, kernel_us, ptxas_summary,
                            sweep_inputs, time_ms, wide_p_ps)
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import gram_operands, phi_rbf_gram
    from svgdcpp_tpu_torch.utils.cuda_build import ARCH_FLAGS, find_nvcc

    dest = parent_csrc(ROOT / "_verify" / "fixed_p_wide")
    (dest / "parent.cu").write_text(FIXED_P_WIDE_PARENT_SOURCE)
    proc = subprocess.Popen(
        [find_nvcc() or "nvcc", *ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
         str(dest / "libparent.so"), str(dest / "parent.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_phi.load_library()  # built meanwhile
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the parent's K15 wide build:\n{out}")
    lib = ctypes.CDLL(str(dest / "libparent.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.parent_phi_rbf_wide.argtypes = [i32] + [ptr] * 4 + [i32] * 3 + [
        ptr] * 2
    lib.parent_phi_rbf_wide.restype = i32
    new_build = ptxas_summary(cuda_phi.build_log_path().read_text())
    builds = {
        # The parent's two kernels (its float32 one under ptxas_summary's
        # "rbf_wide").
        "parent": ptxas_summary(out),
        "new": {k: new_build.get(k, "?")
                for k in ("rbf_wide", "rbf_wide_bf16", "bf16_tri_pack",
                          "counts_sym<0,0,3>", "counts_sym_bf16<3>")},
    }
    print(json.dumps(builds), flush=True)

    names = {("new", "float32"): "phi_rbf_wide_kernel",
             ("new", "bfloat16"): ("phi_rbf_wide_bf16", "bf16_tri_pack"),
             ("parent", "float32"): "parent_phi_rbf_wide_kernel",
             ("parent", "bfloat16"): "parent_phi_rbf_wide_bf16",
             ("k2", "float32"): "fused_phi_counts_sym_kernel",
             ("k2", "bfloat16"): ("fused_phi_counts_sym_bf16",
                                  "bf16_tri_pack")}
    rows = []
    for n, m, kind, dtypes in FIXED_P_WIDE_SHAPES:
        make = grid_inputs if m > 4 else sweep_inputs
        x, s, g, thr = make(n, m, 0.0, 449 + m, device)
        p = wide_p_ps(kind, m, 1, 448, g, device)[0]
        psd = kind != "indefinite"
        half = 0.5 * (p + p.T).double()
        for dd in dtypes:
            bf16 = dd == "bfloat16"

            def new_call(bf16=bf16):
                return cuda_phi.phi_rbf_cuda(x, s, p, psd=psd,
                                             dot_dtype=dd)

            def parent_call(bf16=bf16):
                """The parent's wrapper, as it stood."""
                coords_c = (x - x.mean(dim=0)).contiguous()
                y, q = gram_operands(coords_c, half)
                acc = torch.zeros((2 * m, n), device=device)
                rc = lib.parent_phi_rbf_wide(
                    int(bf16), coords_c.data_ptr(), y.data_ptr(),
                    q.data_ptr(), s.data_ptr(), n, m, int(psd),
                    acc.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"parent_phi_rbf_wide returned {rc}")
                grad = acc[m:].T.double() @ half
                phi = acc[:m].T + 2.0 * grad.float()
                return (phi if bf16 else phi - s) / n

            def k2_call():
                return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=True,
                                                   dot_dtype=dd)

            want = (phi_rbf_gram(x, s, half, psd=psd, dot_dtype=dd) if bf16
                    else phi_rbf_gram(x.double(), s.double(), half, psd=psd))
            got_new, got_parent = new_call(), parent_call()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            us = {}
            for who in ("parent", "new", "new", "parent"):
                fn = new_call if who == "new" else parent_call
                us.setdefault(who, []).append(
                    kernel_us(fn, names[(who, dd)]))
            row = {
                "n": n, "m": m, "P": kind, "dot_dtype": dd,
                "parent_kernel_us": us["parent"],
                "new_kernel_us": us["new"],
                "parent_wrapper_ms": time_ms(parent_call, reps=20, warmup=3),
                "new_wrapper_ms": time_ms(new_call, reps=20, warmup=3),
                "new_rel_err": float(
                    (got_new.double() - want.double()).abs().max()) / scale,
                "parent_rel_err": float(
                    (got_parent.double() - want.double()).abs().max())
                / scale,
            }
            if m > 4 or bf16:
                row["k2_kernel_us"] = kernel_us(k2_call, names[("k2", dd)])
                row["k2_wrapper_ms"] = time_ms(k2_call, reps=20, warmup=3)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return {"builds": builds, "rows": rows}


def fixed_p_wide_main(args) -> int:
    """--fixed-p-wide: fixed_p_wide's rows, JSON to --out."""
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    result = {"card": card, "torch": torch.__version__,
              "fixed_p_wide": fixed_p_wide(torch.device("cuda"))}
    out = Path(args.out or "chiprun_out/fixed_p_wide.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config",
                        choices=("mvn", "large", "hier", "generic", "blr",
                                 "aniso", "hessian", "sharded", "count",
                                 "wide"),
                        default="mvn")
    parser.add_argument("--particles", type=int, default=None,
                        help="particle count of mvn, hier, sharded or wide")
    parser.add_argument("--large", action="store_true",
                        help="also run the triangle kernel at n = 1e5 and 1e6")
    parser.add_argument("--crossover", action="store_true",
                        help="also time the full-width triangle kernels "
                             "against the panel kernels on a ladder of n")
    parser.add_argument("--sass", action="store_true",
                        help="also count the machine code of paths A's and "
                             "B's panel kernel instances, loop by loop")
    parser.add_argument("--sweeps", action="store_true",
                        help="also time K2, K4, K1 and the terms square "
                             "kernel, the terms triangle kernel over m, the "
                             "terms panel and chunk kernels and K15")
    parser.add_argument("--square-crossover", action="store_true",
                        help="only time the square kernels' two bodies "
                             "around their crossing (no driver)")
    parser.add_argument("--forced", action="store_true",
                        help="with --square-crossover, also time each body "
                             "at every m in forced copies")
    parser.add_argument("--wide-drift", action="store_true",
                        help="only measure the float32 routes' distance "
                             "from float64 at d = 123 and the engine's "
                             "gates across seeds (no driver profile)")
    parser.add_argument("--wide-breakdown", action="store_true",
                        help="only time the wide triangle bodies' variants "
                             "and where the new body should begin (no "
                             "driver profile)")
    parser.add_argument("--bf16", action="store_true",
                        help="only time K2's and K3's bf16 instances, the "
                             "parent's body and the new one, by parts and "
                             "on a ladder of m (no driver profile)")
    parser.add_argument("--aniso-wide", action="store_true",
                        help="only time K14's wide term groups, the "
                             "parent's kernel and the new one, beside the "
                             "rbf_terms sweep (no driver profile)")
    parser.add_argument("--square-wide", action="store_true",
                        help="only time the float32 wide square body (K1 "
                             "and the terms square kernel past m = 64), the "
                             "parent's and the new one (no driver profile)")
    parser.add_argument("--square-bf16", action="store_true",
                        help="only time K1's bf16 instance, the parent's "
                             "body and the new one, beside the float32 "
                             "instance (no driver profile)")
    parser.add_argument("--wrapper-ab", default=None, metavar="DIR",
                        help="only time K1's bf16 wrappers and the flat BLR "
                             "bf16 step (or, with --ab-family k15, K15's "
                             "wrapper) in the tree DIR and in this one, "
                             "DIR / here / here / DIR (no driver profile)")
    parser.add_argument("--mid-width", default=None, metavar="DIR",
                        nargs="?", const=True,
                        help="time the float32 triangles at the mid widths "
                             "(in the parent tree DIR and in this one when "
                             "DIR is given) and the forms there")
    parser.add_argument("--mid-panel", default=None, metavar="DIR",
                        help="time the panels K3/K5 and K12/K13 at m = 11 "
                             "and the mid widths in the parent tree DIR "
                             "and this one, and the d = 11 switch")
    parser.add_argument("--mid-p", default=None, metavar="DIR",
                        help="time K14's groups and K15 at the mid widths "
                             "in the parent tree DIR and this one")
    parser.add_argument("--micro-groups", default=None, metavar="DIR",
                        help="time K14's term groups at the micro widths "
                             "in the parent tree DIR and this one")
    parser.add_argument("--ab-family", choices=("k1", "k15"), default="k1",
                        help="the kernels --wrapper-ab times")
    parser.add_argument("--bf16-parity", action="store_true",
                        help="only replay the flat BLR driver's bf16 sweeps "
                             "with sq's sums in other orders (no driver "
                             "profile)")
    parser.add_argument("--square-wide-breakdown", action="store_true",
                        help="only time variants of the float32 wide square "
                             "body, each with one part changed (no driver "
                             "profile)")
    parser.add_argument("--float32-check", action="store_true",
                        help="only time the float32 instances at their "
                             "main-path shapes, kernel-only (no driver "
                             "profile)")
    parser.add_argument("--wide-panel", action="store_true",
                        help="only time the panels' float32 wide instances "
                             "against the parent's design (no driver "
                             "profile)")
    parser.add_argument("--fixed-p-wide", action="store_true",
                        help="only time K15's float32 wide and bf16 "
                             "instances against the parent's design, "
                             "beside K2's (no driver profile)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.fixed_p_wide:
        return fixed_p_wide_main(args)
    if args.wide_panel:
        return wide_panel_main(args)
    if args.bf16:
        return bf16_main(args)
    if args.aniso_wide:
        return aniso_wide_main(args)
    if args.square_wide:
        return square_wide_main(args)
    if args.square_bf16:
        return square_bf16_main(args)
    if args.bf16_parity:
        return bf16_parity_main(args)
    if args.mid_width:
        return mid_width_main(args)
    if args.mid_p:
        return mid_p_main(args)
    if args.mid_panel:
        return mid_panel_main(args)
    if args.micro_groups:
        return micro_groups_main(args)
    if args.wrapper_ab:
        return wrapper_ab_main(args)
    if args.square_wide_breakdown:
        return square_wide_breakdown_main(args)
    if args.float32_check:
        return float32_check_main(args)
    if args.wide_drift:
        return wide_drift_main(args)
    if args.wide_breakdown:
        return wide_breakdown_main(args)
    if args.forced and not args.square_crossover:
        parser.error("--forced runs with --square-crossover only")
    if args.square_crossover:
        return square_crossover_main(args)
    if args.large and args.config != "mvn":
        parser.error("--large runs with --config mvn only")
    if args.particles is not None and args.config not in ("mvn", "hier",
                                                          "sharded", "wide"):
        parser.error("--particles sets mvn's, hier's, sharded's or wide's "
                     "particle count")
    if args.out is None:
        suffix = "" if args.config == "mvn" else f"_{args.config}"
        if args.particles is not None:
            suffix += f"_{args.particles}"
        args.out = f"chiprun_out/profile{suffix}.json"

    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import svgdcpp_tpu_torch as st

    card = card_name()
    print(card)
    result = {"card": card, "config": args.config, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    if args.config == "count":
        from svgdcpp_tpu_torch.ops import cuda_phi

        cuda_phi.load_library()
        result.update(count_pass(st, torch.device("cuda")))
        if args.sass:
            result["panel_sass"] = panel_sass(Path(args.out).parent)
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        print(json.dumps(result, indent=1))
        return 0
    if args.config == "wide":
        # The flat and the hierarchical BLR at a9a's width, one after the
        # other; the profiler tables of both are printed.
        tables = []
        for cell in WIDE_CELLS:
            row = profile_cell(st, cell, args.particles)
            tables.append(f"{cell}:\n{row.pop('profiler_table')}")
            result[cell] = row
        result["profiler_table"] = "\n".join(tables)
    else:
        result.update(profile_cell(st, args.config, args.particles))
    if args.config == "sharded":
        torch.distributed.destroy_process_group()
    if args.large:
        result["large_n"] = [large_n(n, torch.device("cuda")) for n in (100_000, 1_000_000)]
    if args.config == "aniso":
        result["one_term_widths"] = aniso_widths(torch.device("cuda"))
    if args.crossover:
        result["crossover"] = crossover(torch.device("cuda"))
    if args.sweeps:
        result["sweeps"] = sweeps(st, torch.device("cuda"))
    if args.sass:
        result["panel_sass"] = panel_sass(Path(args.out).parent)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(result.pop("profiler_table"))
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
