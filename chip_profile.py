#!/usr/bin/env python3
"""Where the time of a step goes, on one CUDA GPU.

    python3 chip_profile.py [--config mvn|large|hier|blr|aniso|hessian|sharded|count]
                            [--particles N] [--large] [--crossover] [--sass]
                            [--sweeps] [--out PATH]
    python3 chip_profile.py --square-crossover [--forced] [--out PATH]

Drives one configuration of svgdcpp_tpu_torch at its full width:

  * ``mvn`` (default): the flagship, MVN d=2, N=10000, RBF with the median
    bandwidth, AdaGrad lr 0.1, route ``fused_cuda`` (triangle kernel);
  * ``large``: the same at N=262144 (path A of the large-N paths,
    utils/workloads.large_mvn_workload), where the route runs the panel
    triangle kernel;
  * ``hier``: hierarchical BLR, d=10 (m=11), N=10000, median RBF + 0.1 I,
    Adam lr 5e-2, route ``fused_terms_cuda`` (terms triangle kernel; with
    ``--particles 131072``, path B, the terms panel kernel);
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
n = 1500, m = 2 (decomposition given): wrapper ms (median of 20 calls
between CUDA events after 3 warm-up calls) and kernel-only us (the
profiler's events of the kernel over 10 calls). Run from an older tree
with this script copied in, it times that tree's kernels the same way.

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
             if any(name + "_kernel" in ev.get("name", "")
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
    else:
        hier = config == "hier"
        n, d = ((particles or 10000), 10) if hier else (1000, 50)
        feats, labels, x0 = blr_workload(n, d, hierarchical=hier)
        svgd = build_blr_svgd(torch.tensor(x0, device="cuda"), feats, labels,
                              hierarchical=hier, num_iterations=iters)
        route, kernel = (
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

    from chip_smoke import sweep_inputs
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


def kernel_us(fn, name, calls=10):
    """Mean device us of the kernels whose name holds ``name`` (the
    profiler's events) over ``calls`` calls of ``fn``, after one."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    durs = [float(ev["dur"]) for ev in events
            if ev.get("ph") == "X" and ev.get("cat") == "kernel"
            and name in ev.get("name", "")]
    return sum(durs) / calls if durs else None


def sweeps(st, device):
    """K2, K4 and K1 at their main paths' shapes, the terms triangle kernel
    over m, the terms panel and chunk kernels at m = 11, and K15 at its
    main paths' shapes (see the module's docstring)."""
    import torch

    from chip_smoke import make_svgd, sweep_inputs, time_ms
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config",
                        choices=("mvn", "large", "hier", "blr", "aniso",
                                 "hessian", "sharded", "count"),
                        default="mvn")
    parser.add_argument("--particles", type=int, default=None,
                        help="particle count of mvn, hier or sharded")
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
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.forced and not args.square_crossover:
        parser.error("--forced runs with --square-crossover only")
    if args.square_crossover:
        return square_crossover_main(args)
    if args.large and args.config != "mvn":
        parser.error("--large runs with --config mvn only")
    if args.particles is not None and args.config not in ("mvn", "hier",
                                                          "sharded"):
        parser.error("--particles sets mvn's, hier's or sharded's particle "
                     "count")
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
    svgd, sweep_kernel = make_driver(st, args.config, 1, args.particles)
    big = svgd.num_particles >= 100_000
    warm, host_steps, steps = (5, 30, 5) if big else (20, 200, 20)
    result.update(particles=svgd.num_particles, form=svgd.fused_sym_form,
                  steps={"warm_up": warm, "host": host_steps,
                         "profiled": steps, "sections": host_steps})
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
    result["profiler_table"] = prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=15
    )
    result["sections_ms_per_step"] = sections_ms(svgd, host_steps)
    result["fallbacks"] = svgd.median_fallbacks
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
