#!/usr/bin/env python3
"""Smoke test of svgdcpp_tpu_torch on one CUDA GPU (an NVIDIA H100).

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``svgdcpp_tpu_torch/csrc`` and runs
six phases, one line each:

  1. device and build: the card's name and power limit, torch and CUDA
     versions, nvcc build seconds and ptxas's register report;
  2. the square kernel (fused_phi_counts_square) against its plain torch
     version on the card, float32, at six shapes including the cross form
     and the shape phase 4 gives it;
  3. the triangle kernel (fused_phi_counts_sym) against the plain version
     at n = 2048, 10000 and 10007, and both kernels' times beside the plain
     version's (CUDA events, median of 50 calls after warm-up);
  4. the main path through SVGD(...).initialize().run() at n = 1500 (the
     square kernel's range), 50 iterations;
  5. the flagship: MVN d=2, N=10000, RBF with the median bandwidth,
     AdaGrad lr 0.1, 1000 iterations through the triangle kernel; updates/s
     and the posterior's moment errors;
  6. the kernel route against the plain route ('fused') for 20 steps from
     the same x0.

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


def compare(name, got, want, n, m):
    """(max |dphi| / max |phi|, max |dphi|, max |dcounts|) with the checks:
    phi within 1e-4 relative, counts exact at m <= 4 and within n above."""
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
        check(dcnt <= n, f"{name}: counts differ by {dcnt} > n={n}")
    return rel, abs_err, dcnt


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


def make_svgd(st, x0, mean, cov, iters, phi_impl="auto", dtype=None):
    import torch

    dtype = dtype or torch.float32
    x = torch.tensor(x0, dtype=dtype, device="cuda")
    n, dim = x.shape
    model = st.MultivariateNormal(
        torch.tensor(mean, dtype=dtype), torch.tensor(cov, dtype=dtype)
    )
    kernel = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN, model)
    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=dim, num_iterations=iters, coordinate_matrix=x,
            kernel=kernel, model=model, optimizer=st.AdaGrad(dim, n, 0.1),
            phi_impl=phi_impl,
        )
    )
    return svgd.initialize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA device", file=sys.stderr)
        return 1

    import svgdcpp_tpu_torch as st
    from svgdcpp_tpu_torch.ops import cuda_phi
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_cross_fused_counts,
        phi_rbf_fused_counts,
    )
    from svgdcpp_tpu_torch.utils.cuda_build import library_path
    from svgdcpp_tpu_torch.utils.workloads import flagship_mvn

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
    src = [cuda_phi.CSRC_DIR / "fused_phi.cu"]
    log = library_path("svgd_fused_phi", src)
    log = log.with_name(log.name + ".log")
    ptxas = [
        ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
        if "registers" in ln
    ]
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
        x, s, g, thr = sweep_inputs(n, m, off, 10 + idx, dev)
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
    finals = {}
    for impl, dtype in (("fused_cuda", torch.float32), ("fused", torch.float32),
                        ("fused", torch.float64)):
        s6 = make_svgd(st, x0, mean, cov, 20, phi_impl=impl, dtype=dtype)
        finals[(impl, dtype)] = s6.run().double()
    ref = finals[("fused", torch.float64)]
    diff = float((finals[("fused_cuda", torch.float32)]
                  - finals[("fused", torch.float32)]).abs().max())
    floor = {
        impl: float((finals[(impl, torch.float32)] - ref).abs().max())
        for impl in ("fused_cuda", "fused")
    }
    check(diff <= 1e-3, f"fused_cuda vs fused coords differ by {diff:.3e}")
    print(f"phase 6 fused_cuda vs fused n=10000 20 steps: ok "
          f"coords_max_abs_diff={diff:.3e} "
          f"vs_float64_plain={json.dumps(floor)}")

    source = "svgdcpp_tpu_torch/csrc/fused_phi.cu"
    print(json.dumps({"kernels": [
        {"name": cuda_phi.SQUARE_KERNEL, "route": "cuda", "source": source,
         "replaces": "svgdcpp_tpu/ops/pallas_phi.py:365",
         "launches": main_square[cuda_phi.SQUARE_KERNEL],
         "max_abs_err": square_err,
         "ms": times[1500]["square"], "plain_ms": times[1500]["plain"]},
        {"name": cuda_phi.SYM_KERNEL, "route": "cuda", "source": source,
         "replaces": "svgdcpp_tpu/ops/pallas_phi.py:546",
         "launches": main_sym[cuda_phi.SYM_KERNEL], "max_abs_err": sym_err,
         "ms": times[10000]["sym"], "plain_ms": times[10000]["plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
