"""Visual-regression plots for the four example workloads on
svgdcpp_tpu_torch (the PyTorch/CUDA port).

The port's counterpart of ``plot_results.py``: the same 2x2 figure, the
same colours, titles and ``quick`` cuts, drawn from
``torch_{mvn,gmm,blr,hierarchical}_example.run(device=...)``:

  * MVN      — particles onto the anchor Gaussian's contours
  * GMM      — particles split across both composed-density modes
  * BLR      — weight-space scatter (first two coordinates) vs true weights
  * hierarchical BLR — weight scatter + posterior-alpha histogram

Series identity is fixed everywhere: red = initial, blue = final; contours
and reference markers are recessive grays/black. The plotting helpers are
copies of ``plot_results.py``'s, since importing that script would import
the JAX examples. Runs on the card unless asked for the CPU:

    python examples/torch_plot_results.py [outdir] [--quick] [--device cpu]

and writes ``torch_examples_overlay.png`` (to ``examples/figures/`` by
default).
"""

import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_blr_example
import torch_gmm_example
import torch_hierarchical_example
import torch_mvn_example

C_INITIAL = "#d62728"  # red
C_FINAL = "#1f77b4"  # blue


def _density_grid(log_density, xlim, ylim, res=200):
    xs = np.linspace(*xlim, res)
    ys = np.linspace(*ylim, res)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)  # (res^2, 2)
    z = np.exp(log_density(pts)).reshape(res, res)
    return gx, gy, z


def _mvn_logpdf(mean, cov):
    inv = np.linalg.inv(cov)

    def f(pts):
        d = np.atleast_2d(pts) - mean
        return -0.5 * np.einsum("ni,ij,nj->n", d, inv, d)

    return f


def plot_overlay(ax, x0, final, log_density, title):
    lim = (
        min(x0.min(), final.min()) - 1.0,
        max(x0.max(), final.max()) + 1.0,
    )
    gx, gy, z = _density_grid(log_density, lim, lim, res=120)
    ax.contour(gx, gy, z, levels=8, cmap="Greys", alpha=0.7)
    ax.scatter(x0[:, 0], x0[:, 1], c=C_INITIAL, s=18, label="initial")
    ax.scatter(final[:, 0], final[:, 1], c=C_FINAL, s=18, label="final")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)


def plot_weight_scatter(ax, final, true_w, title):
    """Posterior weight cloud (first two coordinates) vs the generating
    weights — the d>2 analog of the density overlay."""
    ax.scatter(final[:, 0], final[:, 1], c=C_FINAL, s=12, alpha=0.5,
               label="posterior particles")
    ax.scatter([true_w[0]], [true_w[1]], c="black", marker="*", s=160,
               label="true weights", zorder=3)
    ax.set_xlabel("w[0]")
    ax.set_ylabel("w[1]")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)


def main(outdir=None, quick=False, device="cuda"):
    out = (
        Path(outdir)
        if outdir is not None
        else Path(__file__).resolve().parent / "figures"
    )
    out.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(2, 2, figsize=(11, 10))

    x0, final, mean, cov = torch_mvn_example.run(verbose=False,
                                                 device=device)
    plot_overlay(
        axes[0, 0], x0, final, _mvn_logpdf(mean, cov), "MVN (10 particles)"
    )

    x0, final, (m1, c1), (m2, c2) = torch_gmm_example.run(verbose=False,
                                                          device=device)
    f1, f2 = _mvn_logpdf(m1, c1), _mvn_logpdf(m2, c2)
    gmm_log = lambda pts: np.logaddexp(f1(pts), f2(pts))  # noqa: E731
    plot_overlay(axes[0, 1], x0, final, gmm_log, "GMM (20 particles)")

    # BLR: weight-space scatter vs the generating weights.
    blr_kw = (
        dict(num_particles=100, num_iterations=120, dim=8, n_data=256)
        if quick
        else dict(num_particles=500, num_iterations=300, dim=50, n_data=1024)
    )
    final, agreement, true_w = torch_blr_example.run(verbose=False,
                                                     device=device, **blr_kw)
    plot_weight_scatter(
        axes[1, 0], final, np.asarray(true_w),
        f"BLR d={blr_kw['dim']} (agreement {agreement:.2f})",
    )

    # Hierarchical BLR: weight scatter + posterior-alpha inset histogram.
    hier_kw = (
        dict(num_particles=100, num_iterations=120, dim=8, n_data=256)
        if quick
        else dict(num_particles=200, num_iterations=400, dim=10, n_data=512)
    )
    final_h, agreement_h, post_alpha, true_w_h = (
        torch_hierarchical_example.run(verbose=False, device=device,
                                       **hier_kw)
    )
    ax = axes[1, 1]
    plot_weight_scatter(
        ax, final_h, np.asarray(true_w_h),
        f"Hierarchical BLR (agreement {agreement_h:.2f}, "
        f"E[alpha] {post_alpha:.3f})",
    )
    inset = ax.inset_axes([0.06, 0.06, 0.36, 0.3])
    inset.hist(
        final_h[:, hier_kw["dim"]], bins=20, color=C_FINAL, alpha=0.8
    )
    inset.set_title("log alpha", fontsize=7)
    inset.tick_params(labelsize=6)

    fig.tight_layout()
    path = out / "torch_examples_overlay.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    argv = sys.argv[1:]
    device = "cuda"
    if "--device" in argv:
        at = argv.index("--device")
        device = argv[at + 1]
        del argv[at:at + 2]
    args = [a for a in argv if a != "--quick"]
    main(*args, quick="--quick" in argv, device=device)
