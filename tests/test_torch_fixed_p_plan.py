"""K15's wide instances on the Hopper triangle bodies, on the CPU: the
float32 one (``phi_rbf_wide``, csrc/wide_tri_sm90.cuh with the FixedPGram
form) and the bfloat16 one (``phi_rbf_wide_bf16``, csrc/bf16_tri_sm90.cuh
with kAsym), through what surrounds their kernels.

* The bf16 workspace (``sym_plan.bf16_work_bytes`` with ``gram_y``): its
  blocks q | X | R | Y at the offsets the entry's ``Bf16Operands`` takes
  (q to a 16-byte boundary, every row a multiple of 16 bytes), and
  ``cuda_phi.bf16_tri_views`` reading back what the plain version of the
  pack (``cuda_phi.bf16_tri_operands``) wrote, at n = 1, 7, 129 and
  m = 1, 2, 11, 17, 123.
* The pack's plain version against the JAX kernel's operands
  (``_phi_rbf_pallas_impl(..., dot_dtype='bfloat16')``,
  pallas_phi.py:186-199) at m = 2, 11 and 123: Y rounded to bf16 is
  exactly half of bf16(x_c P_sym), bit for bit, with the product formed
  once in float64 and rounded (the JAX kernel's float32 product rounds in
  its own order: there at most one element in 2,000 lies one bf16 step
  off); X and the record [S | X | 1] are ``phi_rbf_gram``'s rounding
  (``round_bf16``) of the centred coordinates and scores, q is
  ``gram_operands``' q.
* The float32 wrapper's padded operands (``fixed_p_wide_operands``: X_c,
  Y and S with zero columns to ``wide_row_width(m)``) and its epilogue
  (``fixed_p_wide_finish``) on the accumulator [KS | D] that the body
  forms (built here in float64: the self pair pinned to sq = 0 and entered
  in both directions) give ``phi_rbf_gram``'s phi at m = 65, 123 and 130,
  positive definite and indefinite P; the bf16 epilogue on the
  accumulator [KS | KX | rowsum] that the kAsym body forms (the columns'
  weights from Y_I X_J^T, the rows' from X_I Y_J^T, the self pair
  unpinned and entered once) gives ``phi_rbf_gram(..., 'bfloat16')``'s at
  m = 2, 11 and 123.
* The wrappers on a stand-in library (meta tensors stand in for the
  card): the bf16 entry takes the unpadded rows, the workspace of
  ``bf16_work_bytes(n, m, gram_y=True)`` and the (2m + 1, n) accumulator.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.ops import sym_plan

BF16 = "bfloat16"


def _inputs(n, m, seed, offset=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)) + offset
    s = rng.normal(size=(n, m))
    return x.astype(np.float32), s.astype(np.float32)


def _precision(m, seed, psd):
    """A positive definite or an indefinite (m, m) P, scaled by 1/m."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, m))
    if psd:
        p = (0.5 * np.eye(m) + a @ a.T / m) / m
    else:
        p = (np.diag(np.linspace(1.0, -0.3, m)) + 0.05 * a) / m
    return p.astype(np.float32)


def _half(p):
    p64 = torch.from_numpy(p).double()
    return 0.5 * (p64 + p64.T)


# ----------------------------------------------------------------------
# The workspace and the pack
# ----------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 11, 17, 123])
@pytest.mark.parametrize("n", [1, 7, 129])
def test_workspace_layout_with_y(n, m):
    """q | X | R | Y at Bf16Operands' offsets, every block on a 16-byte
    boundary; without Y the layout K2's and K3's entries take."""
    mk, rw = sym_plan.bf16_gram_width(m), sym_plan.bf16_record_width(m)
    assert mk % 8 == 0 and rw % 8 == 0  # rows of whole 16-byte segments
    q_bytes = (4 * n + 15) // 16 * 16
    want = [("q", q_bytes), ("x", 2 * n * mk), ("rec", 2 * n * rw),
            ("y", 2 * n * mk)]
    assert sym_plan.bf16_work_layout(n, m, gram_y=True) == want
    assert sym_plan.bf16_work_layout(n, m) == want[:3]
    assert sym_plan.bf16_work_bytes(n, m, gram_y=True) == sum(
        size for _, size in want)
    assert sym_plan.bf16_work_bytes(n, m) == q_bytes + 2 * n * (mk + rw)
    offsets = np.cumsum([0] + [size for _, size in want])
    assert all(off % 16 == 0 for off in offsets)

    x, s = _inputs(n, m, 900 + n + m)
    xc = torch.from_numpy(x) - torch.from_numpy(x).mean(dim=0)
    y, q = pht.gram_operands(xc, _half(_precision(m, 901, False)))
    ops = cuda_phi.bf16_tri_operands(xc, torch.from_numpy(s), y, q)
    work = torch.zeros(sym_plan.bf16_work_bytes(n, m, gram_y=True),
                       dtype=torch.uint8)
    for name, view in cuda_phi.bf16_tri_views(work, n, m,
                                              gram_y=True).items():
        view.copy_(ops[name])
    back = cuda_phi.bf16_tri_views(work, n, m, gram_y=True)
    assert sorted(back) == ["q", "rec", "x", "y"]
    for name in back:
        assert torch.equal(back[name], ops[name]), name
    # The blocks do not overlap: each view's bytes are its own.
    for name, size in want:
        start = offsets[[b for b, _ in want].index(name)]
        assert back[name].untyped_storage().data_ptr() == \
            work.untyped_storage().data_ptr()
        assert back[name].numel() * back[name].element_size() <= size
        assert (back[name].data_ptr() - work.data_ptr()) == start


@pytest.mark.parametrize("m", [2, 11, 123])
def test_pack_matches_the_jax_kernels_operands(m):
    """2 bf16(Y) = bf16(x_c P_sym) bit for bit, x_c and P as the JAX
    kernel takes them (pallas_phi.py:186-190), the product formed once in
    float64; against the JAX kernel's own float32 product within one bf16
    step at no more than one element in 2,000. X, the record and q as
    phi_rbf_gram and gram_operands form them."""
    n = 256
    x, s = _inputs(n, m, 910 + m, offset=3.0)
    p = _precision(m, 911 + m, False)
    # The JAX kernel's centring and P_sym (float32).
    c32 = np.array(jnp.asarray(x) - jnp.mean(jnp.asarray(x), axis=0))
    p_sym = np.asarray(jnp.asarray(p) + jnp.asarray(p).T)
    xc = torch.from_numpy(c32)
    y, q = pht.gram_operands(xc, _half(p))
    sc = torch.from_numpy(s)
    ops = cuda_phi.bf16_tri_operands(xc, sc, y, q)
    mk = sym_plan.bf16_gram_width(m)
    assert ops["y"].dtype == ops["x"].dtype == torch.bfloat16
    assert ops["y"].shape == ops["x"].shape == (n, mk)
    assert not ops["y"][:, m:].any() and not ops["x"][:, m:].any()

    def bf16(a):
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)

    xps64 = c32.astype(np.float64) @ p_sym.astype(np.float64)
    twice = (2.0 * ops["y"][:, :m].float()).to(torch.bfloat16)
    assert torch.equal(twice, bf16(xps64))
    xps32 = bf16(np.asarray((jnp.asarray(c32) @ jnp.asarray(p_sym))))
    off = twice.float() != xps32.float()
    assert int(off.sum()) <= max(1, n * m // 2000)
    step = (xps32.float().abs() * 2.0 ** -7).clamp_min(1e-30)
    assert bool(((twice.float() - xps32.float()).abs() <= step)[off].all())

    rnd = pht.round_bf16
    assert torch.equal(ops["x"][:, :m].float(), rnd(xc))
    rw = sym_plan.bf16_record_width(m)
    rec = ops["rec"].float()
    assert rec.shape == (n, rw)
    assert torch.equal(rec[:, :m], rnd(sc))
    assert torch.equal(rec[:, m:2 * m], rnd(xc))
    assert torch.equal(rec[:, 2 * m], torch.ones(n))
    assert not rec[:, 2 * m + 1:].any()
    assert torch.equal(ops["q"], q)
    # Without Y or q: K2's and K3's pack (q the float32 |x|^2).
    plain = cuda_phi.bf16_tri_operands(xc, sc)
    assert sorted(plain) == ["q", "rec", "x"]
    torch.testing.assert_close(plain["q"], (xc * xc).sum(dim=1))


# ----------------------------------------------------------------------
# The bodies' accumulators, the wrappers' operands and epilogues
# ----------------------------------------------------------------------


def _f32_body_acc(xk, yk, q, sk, psd):
    """The float32 body's (2 width, n) [KS | D] in float64 from the padded
    operands: sq = q_i + q_j - 2 x_i . y_j (clamped where psd), the self
    pair pinned to 0 and entered in both directions (KS gains s_i once
    more than the square sum), D = sum_j k (x_i - x_j)."""
    x, y, q, s = (t.double() for t in (xk, yk, q, sk))
    n = x.shape[0]
    form = q[:, None] + q[None, :] - 2.0 * x @ y.T
    if psd:
        form = form.clamp_min(0.0)
    form.fill_diagonal_(0.0)
    k = torch.exp(-form)
    ks = k @ s + s
    d = k.sum(dim=1, keepdim=True) * x - k @ x
    assert ks.shape == d.shape == (n, xk.shape[1])
    return torch.cat([ks, d], dim=1).T


def _bf16_body_acc(ops, m, n, psd):
    """The kAsym bf16 body's (2m + 1, n) [KS | KX | rowsum] in float64
    from the pack's operands: over the upper triangle of pairs, the rows
    of I take the weights of X_I Y_J^T (the self pair's too, unpinned),
    the columns of J those of Y_I X_J^T for j > i, each weight exp(-sq)
    rounded to bf16, times the record [S | X | 1]."""
    x = ops["x"][:, :m].float()
    y = ops["y"][:, :m].float()
    q = ops["q"]
    rec = ops["rec"][:, :2 * m + 1].double()

    def weights(a, b):
        # The Gram tile in float32, as the plain version forms it (the
        # products of bf16 values are exact; the body's sums run in the
        # tensor cores' order, which the card's gates hold).
        form = q[:, None] + q[None, :] - 2.0 * pht.sq_matmul(a, b.T)
        if psd:
            form = form.clamp_min(0.0)
        return pht.round_bf16(torch.exp(-form)).double()

    rows = torch.triu(weights(x, y))          # k(i <- j), j >= i
    cols = torch.triu(weights(y, x), 1)        # k(j <- i), j > i
    acc = rows @ rec + cols.T @ rec
    assert acc.shape == (n, 2 * m + 1)
    return acc.T


@pytest.mark.parametrize("psd", [True, False])
@pytest.mark.parametrize("m", [65, 123, 130])
def test_f32_wrapper_operands_give_the_plain_version(m, psd):
    """fixed_p_wide_operands pads X_c, Y and S to wide_row_width(m) with
    zeros; the body's accumulator over them, finished by
    fixed_p_wide_finish, is phi_rbf_gram's phi."""
    n = 150
    x, s = _inputs(n, m, 920 + m)
    half = _half(_precision(m, 921 + m, psd))
    # In float64 throughout, so that only the arithmetic's form is held.
    xt, st = torch.from_numpy(x).double(), torch.from_numpy(s).double()
    xc = xt - xt.mean(dim=0)
    y, q = pht.gram_operands(xc, half)
    xk, sk, yk, width = cuda_phi.fixed_p_wide_operands(xc, st, y)
    assert width == sym_plan.wide_row_width(m) and width % 4 == 0
    for padded, raw in ((xk, xc), (sk, st), (yk, y)):
        assert padded.shape == (n, width) and padded.is_contiguous()
        assert torch.equal(padded[:, :m], raw)
        assert not padded[:, m:].any()
    acc = _f32_body_acc(xk, yk, q, sk, psd)
    assert acc.shape == (2 * width, n)
    assert not acc[m:width].any() and not acc[width + m:].any()
    phi = cuda_phi.fixed_p_wide_finish(acc, xc, st, half, bf16=False) / n
    want = pht.phi_rbf_gram(xt, st, half, psd=psd)
    torch.testing.assert_close(phi, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("psd", [True, False])
@pytest.mark.parametrize("m", [2, 11, 123])
def test_bf16_accumulator_gives_the_plain_version(m, psd):
    """The kAsym body's accumulator from the pack's operands, finished by
    fixed_p_wide_finish (D = rowsum x - KX with the float32 x, nothing
    subtracted), is phi_rbf_gram(..., 'bfloat16')'s phi: the rows of the
    triangle and its columns, from the two rounded Gram tiles, together
    form the square sweep of the JAX kernel."""
    n = 140
    x, s = _inputs(n, m, 930 + m)
    half = _half(_precision(m, 931 + m, psd))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    xc = cuda_phi._centered32(xt).contiguous()
    y, q = pht.gram_operands(xc, half)
    ops = cuda_phi.bf16_tri_operands(xc, st, y, q)
    acc = _bf16_body_acc(ops, m, n, psd).float()
    phi = cuda_phi.fixed_p_wide_finish(acc, xc, st, half, bf16=True) / n
    want = pht.phi_rbf_gram(xt, st, half, psd=psd, dot_dtype=BF16)
    scale = float(want.abs().max())
    assert float((phi - want).abs().max()) <= 2e-5 * scale


# ----------------------------------------------------------------------
# The bf16 wrapper on a stand-in library
# ----------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 123])
def test_bf16_wrapper_hands_the_entry_its_operands(monkeypatch, m):
    """svgd_phi_rbf_wide_bf16 once, with the unpadded rows (n, m, psd),
    the workspace of bf16_work_bytes(n, m, gram_y=True) and the
    (2m + 1, n) accumulator; no svgd_sym_eigen."""
    calls, shapes = [], []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    for name in ("empty", "zeros"):
        real = getattr(torch, name)

        def spy(*size, real=real, **kw):
            one = size[0] if len(size) == 1 else size
            shapes.append(tuple(one) if isinstance(one, (tuple, list))
                          else (one,))
            return real(*size, **kw)
        monkeypatch.setattr(torch, name, spy)
    n = 3000
    x = torch.empty((n, m), device="meta")
    p = torch.empty((m, m), device="meta")
    for psd in (True, False):
        del calls[:], shapes[:]
        cuda_phi.reset_launch_counts()
        phi = cuda_phi.phi_rbf_cuda(x, x, p, psd=psd, dot_dtype=BF16)
        assert [c[0] for c in calls] == ["svgd_phi_rbf_wide_bf16"]
        assert calls[0][1][4:7] == (n, m, int(psd))
        assert (sym_plan.bf16_work_bytes(n, m, gram_y=True),) in shapes
        assert (2 * m + 1, n) in shapes
        assert tuple(phi.shape) == (n, m)
        assert cuda_phi.launch_counts[cuda_phi.PHI_RBF_WIDE_BF16_KERNEL] == 1
        assert sum(cuda_phi.launch_counts.values()) == 1
    cuda_phi.reset_launch_counts()


# ----------------------------------------------------------------------
# The retired body: gone from the package, kept as the parents' header
# ----------------------------------------------------------------------


def test_retired_body_lives_only_in_the_parents_header():
    """csrc/ holds no wide_tri.cuh and none of what only wide_pair_body
    used; chip_profile.py's WIDE_TRI_PARENT_HEADER holds them all, and
    every rewrite its breakdown modes apply finds its text exactly once
    (the copies refuse anything else)."""
    import re
    from pathlib import Path

    import chip_profile

    csrc = Path(cuda_phi.__file__).resolve().parents[1] / "csrc"
    assert not (csrc / "wide_tri.cuh").exists()
    # (count_le.cu's kWideK is a constant of its own.)
    gone = re.compile(r"wide_pair_body|wide_tri_body|kWideTile|WideTri\b|"
                      r"WideForm|wide_tri_prepare|operand_split|mma_pass|"
                      r"kWideLdK|bf16_round|wide_tri\.cuh")
    for src in sorted(csrc.iterdir()):
        hits = gone.findall(src.read_text())
        assert not hits, (src.name, sorted(set(hits)))
    header = chip_profile.WIDE_TRI_PARENT_HEADER
    for name in ("wide_pair_body", "wide_tri_body", "WideTri", "WideForm",
                 "wide_tri_prepare", "kWideTile", "kWideK", "kWideLdK",
                 "operand_split", "mma_pass", "weight_fragment"):
        assert name in header, name
    assert "struct WideSpot" not in header  # sweep_common.cuh's now
    for variants, text in (
            (chip_profile.WIDE_PAIR_VARIANTS, header),
            (chip_profile.WIDE_SYM_VARIANTS,
             (csrc / "wide_tri_sm90.cuh").read_text()),
            (chip_profile.BF16_VARIANTS,
             (csrc / "bf16_tri_sm90.cuh").read_text())):
        for label, rewrites in variants.items():
            for old, _ in rewrites:
                assert text.count(old) == 1, (label, old)
