#!/usr/bin/env python3
"""Smoke test of svgdcpp_tpu_torch on one CUDA GPU (an NVIDIA H100).

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``svgdcpp_tpu_torch/csrc`` and runs
thirteen phases, one line each (several for phases 2, 3, 7, 8 and 9):

  1. device and build: the card's name and power limit, torch and CUDA
     versions, nvcc build seconds and ptxas's registers and spill bytes of
     every kernel instance;
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
     the same x0;
  7. the composed-kernel kernels (fused_phi_terms_square, _sym) against
     their plain version: square and cross at m = 2 and 11 with two and
     three terms, including (1500, 11), the shape phase 10 gives it;
     triangle at n = 2048, 10000, 10007 and 32768 (m = 11);
  8. the single-term kernels at m = 11 and 50 (and runtime-m instances),
     including (1000, 50), the flat-BLR shape;
  9. times, kernel against plain: terms-sym (10000, 11) and (32768, 11),
     terms-square (1500, 11), K1 (1000, 50) and (1000, 11), K2 (10000, 11)
     and (10000, 50);
 10. the hierarchical-BLR main path (median RBF + 0.1 I, Adam) at n = 1500,
     50 iterations: auto picks fused_terms_cuda, 50 terms-square launches;
 11. hierarchical BLR at full width: N = 10000, d = 10 (m = 11), 1000
     iterations, 1000 terms-sym launches; updates/s and training accuracy;
 12. flat BLR at full width: N = 1000, d = 50, 1000 iterations (the bench
     runs 4000; cut for time), 1000 K1 launches at m = 50;
 13. the hierarchical kernel route against the plain route ('fused_terms')
     for 20 steps at N = 10000.

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
    named kernel<MM,exact> (sweep_common.cuh), e.g. counts_square<50,1>."""
    import re

    out, name = {}, None
    spill = "?"
    for line in log_text.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            inst = re.search(
                r"(?<=\d)fused_phi_(\w+?)_kernelILi(\d+)ELb([01])E",
                hit.group(1),
            )
            name = (f"{inst.group(1)}<{inst.group(2)},{inst.group(3)}>"
                    if inst else hit.group(1))
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
    from svgdcpp_tpu_torch.ops.phi import (
        phi_rbf_terms_cross_fused_counts,
        phi_rbf_terms_fused_counts,
    )
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_blr_svgd,
        flagship_mvn,
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

    # -- phase 8: K1/K2 at m = 11 and 50 vs plain -----------------------
    # (1000, 50) is the flat-BLR shape; m = 13, 20, 37 run the runtime-m
    # instances (MM = 16, 32, 64).
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
    want = {k: 0 for k in main_terms_sq}
    want[cuda_phi.TERMS_SQUARE_KERNEL] = 50
    check(main_terms_sq == want,
          f"hier n=1500, 50 steps: launches {main_terms_sq}, want {want}")
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
    want = {k: 0 for k in main_terms_sym}
    want[cuda_phi.TERMS_SYM_KERNEL] = segments * seg_len
    check(main_terms_sym == want,
          f"hier N=10000, 1000 steps: launches {main_terms_sym}, want {want}")
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
    want = {k: 0 for k in main_blr}
    want[cuda_phi.SQUARE_KERNEL] = segments * seg_len
    check(main_blr == want,
          f"flat BLR, 1000 steps: launches {main_blr}, want {want}")
    acc = blr_accuracy(out.cpu().numpy(), feats, labels)
    rate = 1000 * (segments - 1) * seg_len / timed_s
    print(f"phase 12 flat BLR N=1000 d=50 1000 iters (the bench runs 4000; "
          f"cut for time): ok route=fused_cuda launches={json.dumps(main_blr)} "
          f"fallbacks={svgd.median_fallbacks} updates_per_s={rate:.6g} "
          f"timed_s={timed_s:.4f} train_accuracy={acc:.4f}")

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

    def main_path(phase, n, m, launches, ms, plain_ms):
        return {"phase": phase, "n": n, "m": m, "launches": launches,
                "ms": ms, "plain_ms": plain_ms}

    # Each entry's launches, ms and plain_ms are those of its first main
    # path; main_paths lists every main path that runs the kernel, with the
    # times at that path's shape (phases 3 and 9).
    blr_square = times9[("square", 1000, 50)]
    terms_sq_t = times9[("terms_square", 1500, 11)]
    terms_sym_t = times9[("terms_sym", 10000, 11)]
    k1_paths = [
        main_path(4, 1500, 2, main_square[cuda_phi.SQUARE_KERNEL],
                  times[1500]["square"], times[1500]["plain"]),
        main_path(12, 1000, 50, main_blr[cuda_phi.SQUARE_KERNEL],
                  blr_square["kernel"], blr_square["plain"]),
    ]
    k2_paths = [main_path(5, 10000, 2, main_sym[cuda_phi.SYM_KERNEL],
                          times[10000]["sym"], times[10000]["plain"])]
    terms_sq_paths = [main_path(
        10, 1500, 11, main_terms_sq[cuda_phi.TERMS_SQUARE_KERNEL],
        terms_sq_t["kernel"], terms_sq_t["plain"])]
    terms_sym_paths = [main_path(
        11, 10000, 11, main_terms_sym[cuda_phi.TERMS_SYM_KERNEL],
        terms_sym_t["kernel"], terms_sym_t["plain"])]

    def entry(name, source, replaces, err, paths):
        first = paths[0]
        return {"name": name, "route": "cuda",
                "source": f"svgdcpp_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": first["launches"],
                "max_abs_err": err, "ms": first["ms"],
                "plain_ms": first["plain_ms"], "main_paths": paths}

    pallas = "svgdcpp_tpu/ops/pallas_phi.py"
    print(json.dumps({"kernels": [
        entry(cuda_phi.SQUARE_KERNEL, "fused_phi.cu", f"{pallas}:365",
              square_err, k1_paths),
        entry(cuda_phi.SYM_KERNEL, "fused_phi.cu", f"{pallas}:546",
              sym_err, k2_paths),
        entry(cuda_phi.TERMS_SQUARE_KERNEL, "fused_phi_terms.cu",
              f"{pallas}:1963 {pallas}:1908", terms_sq_err, terms_sq_paths),
        entry(cuda_phi.TERMS_SYM_KERNEL, "fused_phi_terms.cu",
              f"{pallas}:2299 {pallas}:2240", terms_sym_err, terms_sym_paths),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
