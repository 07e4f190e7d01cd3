#!/usr/bin/env python3
"""Where the time of a flagship step goes, on one CUDA GPU.

    python3 chip_profile.py [--large] [--out chiprun_out/profile.json]

Drives svgdcpp_tpu_torch's flagship (MVN d=2, N=10000, RBF with the median
bandwidth, AdaGrad lr 0.1, route ``fused_cuda``) and prints:

  * host ms/step: CUDA events around 200 unprofiled steps (``run()``), after
    a 20-step warm-up;
  * the device timeline of 20 steps under ``torch.profiler``: device busy
    us/step, the union of the intervals of every kernel, memcpy and memset
    on the card (overlaps counted once), and the idle share,
    ``1 - busy / span``, where span runs from the first device event's start
    to the last one's end. Both come from the trace's device clock, so the
    profiler's host overhead widens the span, not the busy time; hence also
    ``device_idle_share_of_step``, ``1 - busy / (host ms/step)`` against
    the unprofiled step. Also the device events per step, and the triangle
    kernel's us per call;
  * sections of one step, each ended by ``torch.cuda.synchronize()`` and
    timed on the host clock over 200 steps: scores, plan, sweep, median
    post-processing, optimizer. They call the same functions as the
    driver's step, in its order; each includes one synchronize.

With ``--large`` it also runs the triangle kernel once at n = 100000 and
n = 1000000 (m=2, three thresholds, after one warm-up call, CUDA events)
against the plain torch sweep on the same inputs (host clock; it takes
about a minute at n = 1000000): phi's max |diff| / max |phi| and the count
difference.

The JSON summary goes to ``--out``. Exits non-zero without a CUDA device.
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


def device_timeline(trace_path, steps, sym_name):
    """Busy us/step, idle share, device events/step and the triangle
    kernel's mean us per call from a chrome trace of ``steps`` steps."""
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
    sym = [float(ev["dur"]) for ev in dev if sym_name in ev.get("name", "")]
    return {
        "device_busy_us_per_step": busy / steps,
        "device_span_us_per_step": span / steps,
        "device_idle_share": 1.0 - busy / span,
        "device_events_per_step": len(dev) / steps,
        "sym_kernel_calls": len(sym),
        "sym_kernel_us_per_call": sum(sym) / len(sym) if sym else None,
    }


def make_flagship(st, n, iters):
    from chip_smoke import make_svgd
    from svgdcpp_tpu_torch.utils.workloads import flagship_mvn

    mean, cov, x0 = flagship_mvn(n)
    svgd = make_svgd(st, x0, mean, cov, iters)
    if svgd._phi_impl != "fused_cuda":
        raise RuntimeError(f"flagship routed to {svgd._phi_impl!r}")
    return svgd


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
    """Host ms/step of each section of the fused step, each ended by a
    synchronize, in the driver's order (svgd.py, build_step_fn)."""
    import torch
    from torch.func import vmap

    from svgdcpp_tpu_torch.ops.cuda_phi import phi_rbf_fused_cuda
    from svgdcpp_tpu_torch.ops.median import (
        fused_lag1_plan,
        fused_median_from_counts,
    )

    state = svgd.make_state()
    coords, opt_state = state["coords"], state["opt_state"]
    aux = state["scale_aux"][0]
    mparams = state["model_params"]
    n = coords.shape[0]
    names = ("scores", "plan", "sweep", "median", "optimizer")
    totals = dict.fromkeys(names, 0.0)
    torch.cuda.synchronize()
    for _ in range(steps):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        scores = vmap(lambda x: svgd.model.grad_log_density_pure(x, mparams))(coords)
        mark()
        gamma, sel = fused_lag1_plan(aux, n, int(svgd.options.fused_bins), coords.dtype)
        mark()
        phi, counts = phi_rbf_fused_cuda(coords, scores, gamma, sel["edges"])
        mark()
        med, lo1, hi1, lo2, hi2, _ = fused_median_from_counts(
            counts, sel, n * n, coords, initialized=aux["hi1"] >= aux["lo1"],
            row_tile=svgd.options.row_tile,
        )
        mark()
        opt_state, inc = svgd.optimizer.step(opt_state, phi)
        new = coords + inc
        disp = torch.sqrt(torch.max(torch.sum((new - coords) ** 2, dim=1)))
        mark()
        aux = {"med": med, "lo1": lo1, "hi1": hi1, "lo2": lo2, "hi2": hi2,
               "disp": disp.to(aux["disp"].dtype)}
        coords = new
        for name, a, b in zip(names, marks, marks[1:]):
            totals[name] += (b - a) * 1e3
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--large", action="store_true",
                        help="also run the triangle kernel at n = 1e5 and 1e6")
    parser.add_argument("--out", default="chiprun_out/profile.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    svgd = make_flagship(st, 10000, 20)
    svgd.run()  # warm-up: builds the kernels and fills the allocator
    result["host_ms_per_step"] = host_ms_per_step(svgd, 200)

    steps = 20
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
        result.update(device_timeline(trace, steps, cuda_phi.SYM_KERNEL))
    result["device_idle_share_of_step"] = (
        1.0 - result["device_busy_us_per_step"] / (1e3 * result["host_ms_per_step"])
    )
    result["profiler_table"] = prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=15
    )
    result["sections_ms_per_step"] = sections_ms(svgd, 200)
    result["fallbacks"] = svgd.median_fallbacks
    if args.large:
        result["large_n"] = [large_n(n, torch.device("cuda")) for n in (100_000, 1_000_000)]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(result.pop("profiler_table"))
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
