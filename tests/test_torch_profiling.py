"""svgdcpp_tpu_torch.utils.profiling on the CPU: the step timer and the
trace run here (the card's CUDA-event branch runs in chip_smoke.py), the
bounds are the ones chip_smoke.py reports."""

import importlib.util
import json
import math
from pathlib import Path

import torch

from svgdcpp_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_step_timer_on_the_cpu():
    calls = []

    def step(state):
        calls.append(1)
        return {"x": state["x"] @ state["w"], "w": state["w"]}

    state = {"x": torch.ones(4, 4), "w": torch.eye(4) * 0.5}
    assert profiling.sync(state) is state
    timing = profiling.step_timer(step, state, steps=7, warmup=2, chunk=3)
    assert timing.steps == 9 and len(calls) == 2 + 9
    assert 0.0 < timing.p50_s <= timing.p90_s
    assert timing.steps_per_s == 1.0 / timing.mean_s


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path / "t")
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::mm" in names


def test_speed_of_light_is_the_flagship_sweeps_bound():
    ms, by = profiling.sweep_bound("fused_phi_counts_sym", 10000, 2)
    assert by == "operations"
    assert profiling.speed_of_light(10000, 2) * 1e3 == ms
    # n(n+1)/2 pairs of 3m + 2 + T + 8m operations at 67 TFLOP/s.
    assert math.isclose(ms, 50005000 * 27 / 67e12 * 1e3, rel_tol=1e-12)
    assert round(ms, 5) == 0.02015
    # Other peaks scale it; a memory-bound setting takes the bytes.
    assert math.isclose(profiling.speed_of_light(10000, 2, peak_flops=67e11),
                        10 * ms / 1e3, rel_tol=1e-12)
    _, nbytes = profiling.sweep_work("fused_phi_counts_sym", 10000, 2)
    assert profiling.speed_of_light(10000, 2, peak_flops=1e30,
                                    bytes_per_s=1e9) == nbytes / 1e9


def test_chip_smoke_takes_its_bounds_from_the_package():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for name in ("bound", "sweep_bound", "square_tensor_bound",
                 "count_bound_all_pairs", "eigen_bound"):
        assert getattr(module, name) is getattr(profiling, name), name
    source = (REPO / "chip_smoke.py").read_text()
    assert "def sweep_bound" not in source and "PEAK_FP32_FLOPS =" not in source


def test_square_bounds_count_the_cross_forms_pairs():
    """A square kernel's cross form (n_t targets against n sources) counts
    n_t x n ordered pairs, reads the targets once and writes their phi;
    without n_t the bounds are the one-set form's."""
    n_t, n, m, T = 700, 1500, 123, 3
    for kernel, n_iso in (("fused_phi_counts_square", 1),
                          ("fused_phi_terms_square", 2)):
        one = profiling.sweep_work(kernel, n, m, T, n_iso=n_iso)
        assert profiling.sweep_work(kernel, n, m, T, n_iso=n_iso,
                                    n_t=None) == one
        flops, nbytes = profiling.sweep_work(kernel, n, m, T, n_iso=n_iso,
                                             n_t=n_t)
        assert flops * n == one[0] * n_t
        assert nbytes == 4 * ((n_t + 2 * n) * m + n_iso + T) + 4 * n_t * m \
            + 8 * T
    ms, by = profiling.square_tensor_bound(n, m, T, n_t=n_t)
    assert by == "tensor operations"
    assert math.isclose(ms, n_t * n * (6 * m + 2)
                        / profiling.PEAK_TF32_FLOPS * 1e3, rel_tol=1e-12)
    assert profiling.square_tensor_bound(n, m, T) == \
        profiling.square_tensor_bound(n, m, T, n_t=None)
