#!/usr/bin/env python3
"""Where the time of a step goes, on one CUDA GPU.

    python3 chip_profile.py [--config mvn|large|hier|blr|aniso|hessian|sharded]
                            [--particles N] [--large] [--crossover] [--sass]
                            [--out PATH]

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
    route ``fused_aniso_terms_cuda`` (the anisotropic terms kernel);
  * ``hessian``: the same target with one RBF whose scale is the HESSIAN
    one, route ``cuda`` (the fixed-P square kernel);
  * ``sharded``: the flagship on the sharded engine (examples/
    sharded_example.py's configuration, utils/workloads.
    build_sharded_mvn_svgd) on a one-rank NCCL group, N=10000: the
    triangle's chunk kernel (K4's port), the gathers and sums of the group,
    the same lag-1 median; its sections (``ShardedSVGD.section_hook``)
    add the gather of the coordinates.

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
(one RBF) from n = 32768 to 524288 and at m = 5 (the runtime-m instance)
at n = 262144, and the terms triangle kernel against the terms panel
kernel at m = 11 with two terms (the hierarchical BLR's shape) from
n = 16384 to 262144; wrapper ms, median of 5 calls between CUDA events
after one warm-up call, three thresholds.

With ``--sass`` it also reads the machine code of the single-RBF panel
kernel's instance that path A launches (m = 2, exact, T = 3; in a tree
without the fixed-T instances, the m = 2 exact one) with ``cuobjdump
--dump-sass`` from the built library, and prints every loop of it (each
backward branch): its instructions, and how many of them are FP32
arithmetic, special-function (MUFU), compares and selects, integer,
shared-memory, global, barrier and branch instructions. The listing goes
to ``chiprun_out/panel_sass.txt``.

The JSON summary goes to ``--out`` (default
``chiprun_out/profile[_<config>].json``). Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path


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
             if sweep_name + "_kernel" in ev.get("name", "")]
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


def crossover(device):
    """The full-width triangle kernels against the panel kernels on a
    ladder of n (see the module's docstring)."""
    import torch

    from chip_smoke import sweep_inputs, time_ms
    from svgdcpp_tpu_torch.ops import cuda_phi

    rows = []
    ladder = [(2, None, n) for n in (32768, 65536, 131072, 262144, 524288)]
    ladder += [(5, None, 262144)]
    ladder += [(11, (1.0, 1.0), n) for n in (16384, 32768, 65536, 131072,
                                             262144)]
    for m, signs, n in ladder:
        x, s, g, thr = sweep_inputs(n, m, 0.0, n + m, device)
        if signs is None:
            def sweep(form):
                return cuda_phi.phi_rbf_fused_cuda(x, s, g, thr, sym=form)
        else:
            gs = [g, torch.full_like(g, 0.1)]

            def sweep(form):
                return cuda_phi.phi_rbf_terms_fused_cuda(x, s, gs, signs, thr,
                                                         sym=form)
        full = time_ms(lambda: sweep(True), reps=5, warmup=1)
        panel = time_ms(lambda: sweep("panel"), reps=5, warmup=1)
        rows.append({"n": n, "m": m, "terms": len(signs) if signs else 1,
                     "full_width_ms": full, "panel_ms": panel,
                     "panel_over_full": panel / full,
                     "jax_form": cuda_phi.resolve_sym(
                         None, n, m, len(signs) if signs else None)})
    return rows


#: SASS opcode classes counted per loop by --sass.
SASS_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX"),
    "mufu": ("MUFU",),
    "cmp_sel": ("FSETP", "ISETP", "FSEL", "SEL", "PLOP3", "FSET", "ISET"),
    "int": ("IADD3", "IMAD", "LEA", "LOP3", "SHF", "IABS", "VIADD", "IMNMX",
            "MOV", "S2R", "CS2R", "I2F", "F2I"),
    "shared": ("LDS", "STS"),
    "global": ("LDG", "STG", "RED", "ATOM", "LD", "ST"),
    "barrier": ("BAR", "WARPSYNC", "BSSY", "BSYNC"),
    "branch": ("BRA", "EXIT", "RET"),
}


def panel_sass(out_dir):
    """The loops of the single-RBF panel instance path A launches (see the
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
    funcs, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            if "counts_sympanel" in name:
                funcs[name] = []
            continue
        if name in funcs:
            funcs[name].append(line)
    # The whole-list kernel at MM = 2, exact; the T = 3 instance if any.
    names = [f for f in funcs if "chunk" not in f and "ILi2ELb1E" in f]
    inst = ([f for f in names if "Li3E" in f] or names or [None])[0]
    if inst is None:
        raise RuntimeError("no single-RBF panel instance at m = 2 in the SASS")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "panel_sass.txt").write_text(
        f"Function : {inst}\n" + "\n".join(funcs[inst]))
    insts = []
    for line in funcs[inst]:
        hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if hit:
            insts.append((int(hit.group(1), 16), hit.group(2).strip()))
    loops = []
    for addr, branch in insts:
        hit = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", branch)
        if not hit or int(hit.group(1), 16) > addr:
            continue
        start = int(hit.group(1), 16)
        body = [op for a, op in insts if start <= a <= addr]
        classes = dict.fromkeys(SASS_CLASSES, 0)
        for op in body:
            code = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0]
            for key, codes in SASS_CLASSES.items():
                classes[key] += code in codes
        loops.append({"start": hex(start), "end": hex(addr),
                      "instructions": len(body), **classes})
    return {"instance": inst, "loops": loops}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config",
                        choices=("mvn", "large", "hier", "blr", "aniso",
                                 "hessian", "sharded"),
                        default="mvn")
    parser.add_argument("--particles", type=int, default=None,
                        help="particle count of mvn, hier or sharded")
    parser.add_argument("--large", action="store_true",
                        help="also run the triangle kernel at n = 1e5 and 1e6")
    parser.add_argument("--crossover", action="store_true",
                        help="also time the full-width triangle kernels "
                             "against the panel kernels on a ladder of n")
    parser.add_argument("--sass", action="store_true",
                        help="also count the machine code of path A's "
                             "panel kernel instance, loop by loop")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "config": args.config, "torch": torch.__version__,
              "cuda": torch.version.cuda}

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
    if args.crossover:
        result["crossover"] = crossover(torch.device("cuda"))
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
