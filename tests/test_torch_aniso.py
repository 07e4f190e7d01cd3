"""svgdcpp_tpu_torch's anisotropic composed-kernel path against svgdcpp_tpu.

* The plain sweep phi_rbf_aniso_terms_fused_counts, reached through the
  kernel's wrapper on CPU tensors, against the f64 numpy oracle of
  tests/test_pallas.py (float64: phi within 1e-10 relative, counts equal)
  and against phi_rbf_aniso_terms_fused_pallas in interpret mode (float32:
  phi within 5e-4 relative, the JAX test's own bound against the oracle),
  at n=500, m=3, tiles 64/128: iso + 1 aniso, aniso only, iso + 3 aniso
  (the Pallas kernel's concatenated branch), a negative sign, and a
  cluster off origin. JAX's Gram-form counts are within n of the oracle's.
* K14's and K15's operands: |z_i - z_j|^2 from the Cholesky rows and
  sum_k lam_k (z_ik - z_jk)^2 from the eigen rows reproduce d^T P d in
  float64 (1e-12 relative), for an indefinite P too.
* The route 'fused_aniso_terms_cuda' on CPU tensors (its plain version)
  against the JAX package's 'fused_aniso_terms_pallas' at n=300, d=2, float32:
  after 1 step within rtol 2e-3, atol 2e-4 (the JAX package's tolerance
  between its routes); after 4 steps max |dcoords| <= 5e-3. In float64, the
  first step from x0 equals the port's 'rbf_terms' to 1e-10 (the lag-1 seed
  is x0's exact median).
* Validation and hot-swap with the JAX package's messages: a non-PD swap is
  rejected and leaves the parameters untouched, an isotropy flip rebuilds
  the step, a division composition is rejected.
* auto's rule on a CUDA device at n = 2047 / 2048 and 8 / 9 gradient
  accumulators; the accumulator limit of the CUDA route.
* The workload of scripts/check_aniso_posterior.py: the same draws.
* The one-pass kernel's plain version (one anisotropic term at m = 2 and
  11: the factor form z = x_c L with the epilogue 2 D_z L^T) against the
  oracle, the closed form and the Pallas kernel; the driver's kept
  Cholesky factor: equal to a fresh one, computed once while P stays and
  renewed after a hot-swap.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops.pallas_phi import phi_rbf_aniso_terms_fused_pallas
from svgdcpp_tpu_torch import svgd as svgd_t
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops.phi import phi_rbf_aniso_terms_fused_counts
from svgdcpp_tpu_torch.utils.workloads import (
    aniso_mvn_workload,
    build_aniso_svgd,
)

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)


def aniso_p(m, rng, scale=0.3, ridge=0.4):
    """tests/test_pallas.py's _aniso_p: A A^T + ridge I, A ~ scale N(0, 1)."""
    a = rng.normal(size=(m, m)) * scale
    return (a @ a.T + ridge * np.eye(m)).astype(np.float32)


def oracle(x, s, iso, aniso, thr):
    """float64 dense phi and counts (tests/test_pallas.py:1290-1305, for any
    number of terms): iso = [(gamma, sign)], aniso = [(P, sign)]."""
    c = np.asarray(x, np.float64)
    sc = np.asarray(s, np.float64)
    n = c.shape[0]
    d = c[:, None, :] - c[None, :, :]
    sq = (d**2).sum(-1)
    kc = np.zeros_like(sq)
    grad = np.zeros_like(c)
    for gamma, sign in iso:
        k = sign * np.exp(-gamma * sq)
        kc += k
        grad -= 2.0 * gamma * (k @ c - k.sum(1)[:, None] * c)
    for p, sign in aniso:
        p = np.asarray(p, np.float64)
        k = sign * np.exp(-np.einsum("ija,ab,ijb->ij", d, p, d))
        kc += k
        grad -= (k @ c - k.sum(1)[:, None] * c) @ (p + p.T)
    counts = np.array([(sq <= t).sum() for t in np.asarray(thr, np.float64)])
    return (kc @ sc + grad) / n, counts


def _case(name):
    rng = np.random.default_rng(42)
    n, m = 500, 3
    offset = 100.0 if name == "off_origin" else 4.0
    x = (rng.normal(size=(n, m)) * 2 + offset).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    ps = [aniso_p(m, rng) for _ in range(3)]
    iso, aniso = {
        "iso_1_aniso": ([(0.7, 1.0)], [(ps[0], 0.8)]),
        "aniso_only": ([], [(ps[0], 1.0)]),
        "iso_3_aniso": ([(0.7, 1.0)], [(ps[0], 0.8), (ps[1], 0.5),
                                       (ps[2], 0.3)]),
        "negative_sign": ([(0.7, 1.0), (0.2, -0.4)], [(ps[0], -0.3)]),
        "off_origin": ([(0.7, 1.0)], [(ps[0], 0.8)]),
    }[name]
    thr = np.array([0.0, 4.0, 30.0], np.float32)
    return x, s, iso, aniso, thr


def _port(x, s, iso, aniso, thr, dtype, factored=False):
    """The wrapper on CPU tensors: the closed form with each P, or with
    ``factored`` the factor form from cholesky_factors, as the driver
    passes its kept factors."""
    t = lambda a: torch.as_tensor(np.asarray(a, dtype))  # noqa: E731
    ps = [t(p) for p, _ in aniso]
    return cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        t(x), t(s), [t(g) for g, _ in iso], [sg for _, sg in iso], ps,
        [sg for _, sg in aniso], t(thr),
        lowers=cuda_phi.cholesky_factors(ps, "cpu") if factored else None,
    )


@pytest.mark.parametrize("name", [
    "iso_1_aniso", "aniso_only", "iso_3_aniso", "negative_sign",
    "off_origin",
])
def test_plain_sweep_vs_oracle_and_pallas_interpret(name):
    x, s, iso, aniso, thr = _case(name)
    n = x.shape[0]
    phi_ref, cnt_ref = oracle(x, s, iso, aniso, thr)
    scale = np.abs(phi_ref).max()

    phi64, cnt64 = _port(x, s, iso, aniso, thr, np.float64)
    assert phi64.dtype == torch.float64 and cnt64.dtype == torch.int64
    assert np.abs(phi64.numpy() - phi_ref).max() / scale < 1e-10
    np.testing.assert_array_equal(cnt64.numpy(), cnt_ref)

    phi32, cnt32 = _port(x, s, iso, aniso, thr, np.float32)
    assert phi32.dtype == torch.float32
    np.testing.assert_array_equal(cnt32.numpy(), cnt_ref)
    phi_j, cnt_j = phi_rbf_aniso_terms_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), tuple(jnp.float32(g) for g, _ in iso),
        tuple(sg for _, sg in iso), tuple(jnp.asarray(p) for p, _ in aniso),
        tuple(sg for _, sg in aniso), jnp.asarray(thr), tile_i=64,
        tile_j=128, interpret=True,
    )
    phi_j = np.asarray(phi_j)
    assert np.abs(phi32.numpy() - phi_j).max() / np.abs(phi_j).max() < 5e-4
    assert np.abs(np.asarray(cnt_j) - cnt_ref).max() <= n


def test_operands_reproduce_the_quadratic_form():
    rng = np.random.default_rng(3)
    n, m = 60, 5
    x = torch.from_numpy(rng.normal(size=(n, m)) * 2 + 3.0)
    x_c = x - x.mean(dim=0)
    d = (x[:, None, :] - x[None, :, :]).numpy()

    def form(p):
        return np.einsum("ija,ab,ijb->ij", d, p, d)

    pd = [aniso_p(m, rng).astype(np.float64) for _ in range(2)]
    pd[1] = pd[1] + 0.2 * rng.normal(size=(m, m))  # not symmetric, still PD
    lower = cuda_phi.cholesky_factors([torch.from_numpy(p) for p in pd],
                                      x_c.device)
    z = x_c @ lower
    assert z.dtype == torch.float64 and tuple(z.shape) == (2, n, m)
    for t, p in enumerate(pd):
        want = form(p)
        got = ((z[t][:, None] - z[t][None]) ** 2).sum(-1).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        np.testing.assert_allclose(
            (lower[t] @ lower[t].T).numpy(), 0.5 * (p + p.T), atol=1e-12
        )
    indefinite = np.diag([0.6, -0.3, 0.2, 0.05, -0.1]) + 0.1 * rng.normal(
        size=(m, m)
    )
    for p in (pd[1], indefinite):
        z, lam, v = cuda_phi.eigen_rows(x_c, torch.from_numpy(p))
        want = form(p)
        got = (((z[:, None] - z[None]) ** 2) * lam).sum(-1).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert (lam < 0).any()  # the indefinite case kept its negative part


def _driver(pkg, x0, p_aniso, impl, iters, const_op="+"):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(
        np.zeros(dim, x0.dtype), np.eye(dim, dtype=x0.dtype)
    )
    med = pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.MEDIAN, model)
    const = pkg.GaussianRBFKernel(
        x0, pkg.ScaleMethod.CONSTANT, constant_scale=p_aniso
    )
    kernel = med + const if const_op == "+" else med / const
    kw = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=pkg.AdaGrad(dim, n, 0.1),
        phi_impl=impl, **kw,
    ))


def _driver_inputs(n=300):
    rng = np.random.default_rng(42)
    x0 = rng.normal(size=(n, 2)).astype(np.float32) * 2
    return x0, aniso_p(2, rng, scale=0.2, ridge=0.15)


def test_route_vs_jax_fused_aniso_terms_pallas():
    x0, p_aniso = _driver_inputs()

    def run(pkg, impl, iters):
        svgd = _driver(pkg, x0, p_aniso, impl, iters).initialize()
        assert svgd._phi_impl == impl
        return np.asarray(svgd.run())

    np.testing.assert_allclose(
        run(st, "fused_aniso_terms_cuda", 1),
        run(sv, "fused_aniso_terms_pallas", 1), rtol=2e-3, atol=2e-4,
    )
    diff = np.abs(run(st, "fused_aniso_terms_cuda", 4)
                  - run(sv, "fused_aniso_terms_pallas", 4)).max()
    assert diff <= 5e-3, diff


def test_first_step_f64_equals_rbf_terms():
    x0, p_aniso = _driver_inputs()
    x0, p_aniso = x0.astype(np.float64), p_aniso.astype(np.float64)
    outs = {}
    for impl in ("fused_aniso_terms_cuda", "rbf_terms"):
        svgd = _driver(st, x0, p_aniso, impl, 1).initialize()
        outs[impl] = svgd.run().numpy()
        assert svgd.median_fallbacks == 0
    np.testing.assert_allclose(
        outs["fused_aniso_terms_cuda"], outs["rbf_terms"], rtol=1e-10,
        atol=1e-12,
    )


def test_validation_and_hot_swap_match_jax():
    x0, p_aniso = _driver_inputs(200)

    def jax_message(make):
        with pytest.raises(ValueError) as err:
            make()
        return str(err.value).replace(
            "fused_aniso_terms_pallas", "fused_aniso_terms_cuda"
        )

    svgd = _driver(st, x0, p_aniso, "fused_aniso_terms_cuda", 1).initialize()
    svgd_j = _driver(sv, x0, p_aniso, "fused_aniso_terms_pallas", 1).initialize()
    assert svgd._aniso_split == svgd_j._aniso_split == ((0,), (1,))
    assert svgd.run().isfinite().all()

    # a non-PD swap: rejected with the JAX message, parameters untouched
    bad = (svgd.kernel.parameters[0], -np.eye(2, dtype=np.float32))
    want = jax_message(lambda: svgd_j.update_kernel_parameters(bad))
    before = [p.clone() for p in svgd.kernel.parameters]
    step_fn = svgd._step_fn
    with pytest.raises(ValueError) as err:
        svgd.update_kernel_parameters(bad)
    assert str(err.value) == want
    for a, b in zip(svgd.kernel.parameters, before):
        assert torch.equal(a, b)
    assert svgd._step_fn is step_fn

    # an isotropy flip: accepted, the step is rebuilt without the
    # anisotropic term (the wrapper's terms-kernel dispatch), and it runs
    svgd.update_kernel_parameters(
        (svgd.kernel.parameters[0], 0.2 * np.eye(2, dtype=np.float32))
    )
    assert svgd._aniso_split == ((0, 1), ())
    assert svgd._step_fn is not step_fn
    assert svgd.run().isfinite().all()

    # a division composition: rejected with the JAX message
    div = 0.05 * np.eye(2, dtype=np.float32)
    want = jax_message(lambda: _driver(
        sv, x0, div, "fused_aniso_terms_pallas", 1, const_op="/"
    ).initialize())
    with pytest.raises(ValueError) as err:
        _driver(st, x0, div, "fused_aniso_terms_cuda", 1,
                const_op="/").initialize()
    assert str(err.value) == want


# ----------------------------------------------------------------------
# The one-pass kernel's factor form and the driver's kept factor
# ----------------------------------------------------------------------


def _one_term_case(m, offset, iso):
    rng = np.random.default_rng(70 + m)
    n = 257
    x = (rng.normal(size=(n, m)) * 1.5 + offset).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    p = aniso_p(m, rng, scale=0.2, ridge=0.15)
    thr = np.array([0.5, 4.0, 30.0], np.float32)
    return x, s, iso, [(p, 0.8)], thr


@pytest.mark.parametrize("m,offset,iso", [
    (2, 0.0, [(0.7, 1.0)]), (2, 40.0, []), (11, 3.0, [(0.1, 1.0)]),
    (11, 0.0, [(0.1, 1.0), (0.05, -0.4)]), (5, 2.0, [(0.3, 1.0)]),
])
def test_one_pass_plain_version_vs_oracle_and_pallas(m, offset, iso):
    """Given the factors, as the driver gives its kept ones, the wrapper's
    CPU branch runs the one-pass kernel's arithmetic, the factor form
    (phi_rbf_factor: z = x_c L, n phi = K s + 2 (sum_j k (z_i - z_j)) L^T,
    the kernel's in-kernel epilogue): in float64 within 1e-10 of the
    oracle and of the closed form with P (phi_rbf_cross), counts equal; in
    float32 within 5e-4 of JAX's fused_aniso_terms_pallas in interpret
    mode."""
    x, s, iso, aniso, thr = _one_term_case(m, offset, iso)
    phi_ref, cnt_ref = oracle(x, s, iso, aniso, thr)
    scale = np.abs(phi_ref).max()
    phi64, cnt64 = _port(x, s, iso, aniso, thr, np.float64, factored=True)
    assert np.abs(phi64.numpy() - phi_ref).max() / scale < 1e-10
    np.testing.assert_array_equal(cnt64.numpy(), cnt_ref)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    closed, _ = phi_rbf_aniso_terms_fused_counts(
        t(x), t(s), [t(g) for g, _ in iso], [sg for _, sg in iso],
        [t(p) for p, _ in aniso], [sg for _, sg in aniso], t(thr),
    )
    assert np.abs(phi64.numpy() - closed.numpy()).max() / scale < 1e-10
    phi32, _ = _port(x, s, iso, aniso, thr, np.float32, factored=True)
    phi_j, _ = phi_rbf_aniso_terms_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), tuple(jnp.float32(g) for g, _ in iso),
        tuple(sg for _, sg in iso), tuple(jnp.asarray(p) for p, _ in aniso),
        tuple(sg for _, sg in aniso), jnp.asarray(thr), tile_i=64,
        tile_j=128, interpret=True,
    )
    phi_j = np.asarray(phi_j)
    assert np.abs(phi32.numpy() - phi_j).max() / np.abs(phi_j).max() < 5e-4


def test_kept_factor_gives_the_fresh_factors_phi():
    """The driver keeps cholesky_factors of the step's precision (the
    state's own tensor), and the sweep from the kept factor equals the one
    from a fresh factor, and the closed form with P within 1e-5."""
    x0, p_aniso = _driver_inputs(200)
    svgd = _driver(st, x0, p_aniso, "fused_aniso_terms_cuda", 2).initialize()
    svgd.run()
    key, lowers = svgd._aniso_factor_cache
    ((p_state, sign),), = key
    assert p_state is svgd.kernel.parameters[1] and sign == 1
    np.testing.assert_array_equal(
        lowers.numpy(), cuda_phi.cholesky_factors([p_state], "cpu").numpy()
    )
    x = svgd.store.value
    s = torch.from_numpy(np.random.default_rng(5).normal(
        size=x.shape).astype(np.float32))
    thr = torch.tensor([0.5, 2.0, 8.0])
    g = [torch.tensor(0.3)]
    kept = cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        x, s, g, (1.0,), None, (1.0,), thr, lowers=lowers)
    fresh = cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        x, s, g, (1.0,), [p_state], (1.0,), thr,
        lowers=cuda_phi.cholesky_factors([p_state], "cpu"))
    for a, b in zip(kept, fresh):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    closed = cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        x, s, g, (1.0,), [p_state], (1.0,), thr)
    scale = float(closed[0].abs().max())
    assert float((kept[0] - closed[0]).abs().max()) <= 1e-5 * scale
    np.testing.assert_array_equal(kept[1].numpy(), closed[1].numpy())


def test_kept_factor_key_keeps_the_terms_apart():
    """One term P1 + P2 and two terms P1, P2 over the same slot tensors are
    different keys: each composition gets its own factors (one, then two),
    and the same composition again keeps them."""
    x0, p_aniso = _driver_inputs(50)
    svgd = _driver(st, x0, p_aniso, "fused_aniso_terms_cuda", 1)
    rng = np.random.default_rng(8)
    p1 = torch.from_numpy(aniso_p(2, rng).astype(np.float64))
    p2 = torch.from_numpy(aniso_p(2, rng).astype(np.float64))
    kparams = (None, p1, p2)
    one = svgd._aniso_factors(kparams, [[(1, 1), (2, 1)]])
    assert one.shape[0] == 1
    np.testing.assert_allclose((one[0] @ one[0].T).numpy(),
                               (p1 + p2).numpy(), rtol=1e-12)
    two = svgd._aniso_factors(kparams, [[(1, 1)], [(2, 1)]])
    assert two.shape[0] == 2
    for lower, p in zip(two, (p1, p2)):
        np.testing.assert_allclose((lower @ lower.T).numpy(), p.numpy(),
                                   rtol=1e-12)
    assert svgd._aniso_factors(kparams, [[(1, 1)], [(2, 1)]]) is two
    assert svgd._aniso_factors(kparams, [[(1, 1)], [(2, -1)]]) is not two


def test_kept_factor_is_renewed_with_a_new_precision(monkeypatch):
    """The factor is computed once while the state carries the same P (a
    second run() factors nothing), and renewed on the first step after a
    hot-swap brings a new one, as the factor of the new P."""
    calls = []
    real = svgd_t.cholesky_factors
    monkeypatch.setattr(svgd_t, "cholesky_factors",
                        lambda *a: calls.append(1) or real(*a))
    x0, p_aniso = _driver_inputs(200)
    svgd = _driver(st, x0, p_aniso, "fused_aniso_terms_cuda", 2).initialize()
    svgd.run()
    first = svgd._aniso_factor_cache
    svgd.run()
    assert svgd._aniso_factor_cache is first and len(calls) == 1
    swapped = 1.5 * p_aniso
    svgd.update_kernel_parameters((svgd.kernel.parameters[0], swapped))
    svgd.run()
    second = svgd._aniso_factor_cache
    assert second is not first and len(calls) == 2
    lower = second[1][0].double()
    np.testing.assert_allclose((lower @ lower.T).numpy(), swapped,
                               rtol=1e-6, atol=1e-7)


def _n_const_kernel(n, n_aniso):
    """median RBF + n_aniso anisotropic constant RBFs at d = 2: n_w =
    1 + n_aniso gradient accumulators."""
    rng = np.random.default_rng(n_aniso)
    x0 = rng.normal(size=(n, 2))
    model = st.MultivariateNormal(np.zeros(2), np.eye(2))
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    for _ in range(n_aniso):
        kernel = kernel + st.GaussianRBFKernel(
            x0, st.ScaleMethod.CONSTANT,
            constant_scale=aniso_p(2, rng, 0.2, 0.15).astype(np.float64),
        )
    return st.SVGD(st.SVGDOptions(
        dimension=2, num_iterations=1, coordinate_matrix=x0, kernel=kernel,
        model=model, optimizer=st.AdaGrad(2, n, 0.1), device="cpu",
    )).initialize()


@pytest.mark.parametrize("n,n_w,route", [
    (2047, 8, "rbf_terms"),
    (2048, 8, "fused_aniso_terms_cuda"),
    (2048, 9, "rbf_terms"),
])
def test_auto_rule_on_cuda(n, n_w, route):
    svgd = _n_const_kernel(n, n_w - 1)
    assert svgd._phi_impl == "rbf_terms"  # the CPU rule
    assert svgd._aniso_terms_kernel_route() is (route != "rbf_terms")
    assert svgd._auto_impl(on_cuda=True) == route


def test_accumulator_limit_of_the_cuda_route():
    svgd_t._check_aniso_split(((0,), tuple(range(1, 8))))
    svgd_t._check_aniso_split(((), tuple(range(8))))
    with pytest.raises(ValueError, match="at most 8 gradient accumulators"):
        svgd_t._check_aniso_split(((0,), tuple(range(1, 9))))
    assert cuda_phi.MAX_ANISO_TERMS == 8


def test_workload_is_the_scripts_draws():
    """aniso_mvn_workload repeats scripts/check_aniso_posterior.py:76-89
    (which needs a TPU to run) draw for draw."""
    for n in (300, 10240):
        rng = np.random.default_rng(7)
        a = rng.normal(size=(11, 11)) * 0.3
        cov = (np.eye(11) + a @ a.T).astype(np.float64)
        mean = rng.normal(size=11)
        x0 = (rng.normal(size=(n, 11)) * 2).astype(np.float32)
        b = rng.normal(size=(11, 11)) * 0.1
        p_aniso = 0.05 * np.eye(11) + b @ b.T
        got = aniso_mvn_workload(n)
        for g, w in zip(got, (mean, cov, x0, p_aniso)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert np.linalg.eigvalsh(got[3]).min() > 0
    svgd = build_aniso_svgd(torch.from_numpy(got[2][:2048]), *got[:2],
                            got[3], num_iterations=1)
    assert svgd._phi_impl == "rbf_terms"
    assert svgd._auto_impl(on_cuda=True) == "fused_aniso_terms_cuda"


@pytest.mark.parametrize("m,n_aniso,entry", [
    (2, 1, "one_pass"), (5, 1, "one_pass"), (32, 1, "groups"),
    (33, 1, "groups"), (50, 1, "groups"), (11, 2, "groups"),
])
def test_aniso_wrapper_picks_the_one_pass_kernel_up_to_32(monkeypatch, m,
                                                          n_aniso, entry):
    """On a CUDA tensor one anisotropic term where sym_plan.aniso_one_pass
    holds launches the one-pass entry, anything else the term-group one (a
    stand-in library; meta tensors stand in for the card), which takes the
    rows' padded width where its wide kernels run (m = 33: 36, 50: 52)."""
    launched = []

    class Library:
        def svgd_fused_phi_aniso_terms_sym(self, *args):
            launched.append(("one_pass", args[9]))
            return 0

        def svgd_fused_phi_aniso_terms_groups(self, *args):
            launched.append(("groups", args[10]))
            return 0

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    x = torch.empty((300, m), device="meta")
    lowers = torch.empty((n_aniso, m, m), dtype=torch.float64, device="meta")
    thr = torch.empty((3,), device="meta")
    cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        x, x, [torch.empty((), device="meta")], (1.0,), None,
        (1.0,) * n_aniso, thr, lowers=lowers)
    width = {33: 36, 50: 52}.get(m, m) if entry == "groups" else m
    assert launched == [(entry, width)]
    cuda_phi.reset_launch_counts()
