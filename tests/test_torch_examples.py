"""The port's examples (examples/torch_*_example.py) on the CPU against the
JAX package's examples (examples/*_example.py) from the same seed.

Each runs at a small size on the CPU and the JAX example's ``run()`` with
the same arguments: the final coordinates within 1e-4 (the larger
examples run float32 on both sides). The mvn and gmm examples also meet
tests/test_examples.py's moment checks. The port's module names differ
from the JAX examples', so one process imports both.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))

import blr_example  # noqa: E402
import gmm_example  # noqa: E402
import hierarchical_example  # noqa: E402
import large_scale_example  # noqa: E402
import mvn_example  # noqa: E402
import sharded_example  # noqa: E402
import torch_blr_example  # noqa: E402
import torch_gmm_example  # noqa: E402
import torch_hierarchical_example  # noqa: E402
import torch_large_scale_example  # noqa: E402
import torch_mvn_example  # noqa: E402
import torch_sharded_example  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4


def test_mvn_example_matches_jax_and_converges():
    x0, final, mean, cov = torch_mvn_example.run(verbose=False, device="cpu")
    _, want, _, _ = mvn_example.run(verbose=False)
    np.testing.assert_allclose(final, want, rtol=0, atol=ATOL)
    # tests/test_examples.py's moment checks
    tol = 2.0 * np.sqrt(np.diag(cov) / x0.shape[0])
    assert np.all(np.abs(final.mean(axis=0) - mean) < tol)
    assert np.all(final.std(axis=0) > 0.3 * np.sqrt(np.diag(cov)))


def test_gmm_example_matches_jax_and_covers_both_modes():
    x0, final, (mean1, _), (mean2, _) = torch_gmm_example.run(
        verbose=False, device="cpu")
    _, want, _, _ = gmm_example.run(verbose=False)
    np.testing.assert_allclose(final, want, rtol=0, atol=ATOL)
    assign = (np.linalg.norm(final - mean1, axis=1)
              < np.linalg.norm(final - mean2, axis=1))
    assert 0 < assign.sum() < len(assign)
    assert np.linalg.norm(final[assign].mean(axis=0) - mean1) < 1.5
    assert np.linalg.norm(final[~assign].mean(axis=0) - mean2) < 1.5


def test_blr_example_matches_jax():
    kw = dict(num_particles=64, num_iterations=40, dim=5, n_data=128,
              verbose=False)
    final, agreement, true_w = torch_blr_example.run(**kw, device="cpu")
    want, want_agreement, want_w = blr_example.run(**kw)
    np.testing.assert_allclose(true_w, want_w, rtol=1e-12)
    np.testing.assert_allclose(final, want, rtol=0, atol=ATOL)
    assert agreement == want_agreement and agreement > 0.8


def test_hierarchical_example_matches_jax():
    kw = dict(num_particles=48, num_iterations=40, dim=4, n_data=96,
              verbose=False)
    final, agreement, alpha, _ = torch_hierarchical_example.run(
        **kw, device="cpu")
    want, want_agreement, want_alpha, _ = hierarchical_example.run(**kw)
    np.testing.assert_allclose(final, want, rtol=0, atol=ATOL)
    assert agreement == want_agreement
    np.testing.assert_allclose(alpha, want_alpha, rtol=1e-4)


def test_large_scale_example_matches_jax():
    kw = dict(num_particles=1100, num_iterations=8, verbose=False)
    out, ksd_before, ksd_after = torch_large_scale_example.run(
        **kw, device="cpu")
    want, want_before, want_after = large_scale_example.run(**kw)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose([ksd_before, ksd_after],
                               [want_before, want_after], rtol=1e-3)
    assert ksd_after < ksd_before


def test_sharded_example_matches_jax():
    assert not dist.is_initialized()
    kw = dict(num_particles=256, num_iterations=30, verbose=False)
    x0, final, ksd0, ksd1 = torch_sharded_example.run(**kw, device="cpu")
    assert not dist.is_initialized()  # the one-rank world is gone
    want_x0, want, _, _ = sharded_example.run(**kw)
    np.testing.assert_array_equal(x0, want_x0)
    np.testing.assert_allclose(final, want, rtol=0, atol=ATOL)
    assert ksd1 < ksd0


@pytest.mark.parametrize("name", ["mvn", "gmm", "blr", "hierarchical",
                                  "large_scale", "sharded"])
def test_examples_import_only_the_port(name):
    text = (EXAMPLES / f"torch_{name}_example.py").read_text()
    assert "svgdcpp_tpu_torch" in text
    assert "import jax" not in text
    assert "svgdcpp_tpu " not in text and "svgdcpp_tpu." not in text
    assert "import svgdcpp_tpu\n" not in text
