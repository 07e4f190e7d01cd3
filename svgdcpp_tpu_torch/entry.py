"""One SVGD step of the flagship as a pure function (the counterpart of the
JAX package's ``__graft_entry__.entry``).

    fn, (state,) = entry()           # on the card
    state = fn(state)                # one step; ``state`` is not written

The flagship MVN (d = 2) at n = 1024 particles: an RBF kernel with the
median bandwidth, AdaGrad lr 0.1, x0 ~ 3 * U(-1, 1) from seed 0
(``utils/workloads.flagship_mvn``), built through ``SVGD.build_step_fn``
and ``SVGD.make_state`` as the JAX ``entry()`` builds its jittable step.

On the card ``auto`` takes ``fused_cuda`` (1024 > CUDA_FUSED_MIN_PARTICLES)
and K1's square form (1024 < SYM_MIN_N); on the CPU it takes the dense
route, as the JAX driver does there (1024 is not above
DENSE_PHI_MAX_PARTICLES). The two routes differ in their median: the
fused route uses the previous step's verified median (lag-1), the dense
route the same step's exact one.
"""

from __future__ import annotations

import torch

#: The flagship's particle count and dimension in ``entry()``.
ENTRY_PARTICLES, ENTRY_DIM = 1024, 2


def entry(device="cuda", dtype=torch.float32):
    """Return ``(fn, (state,))``: ``fn(state)`` is one SVGD step of the
    flagship at n = 1024, d = 2, returning the next state and leaving the
    tensors of ``state`` as they were. Runs on the card unless ``device``
    is ``"cpu"``; without a card the default raises ``RuntimeError``."""
    import svgdcpp_tpu_torch as st

    from .core.types import place_coords
    from .utils.workloads import FLAGSHIP_ADAGRAD_LR, flagship_mvn

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    mean, cov, x0 = flagship_mvn(ENTRY_PARTICLES, dtype=np_dtype)
    # On the device before the kernel takes its median there.
    x0 = place_coords(x0, device)

    model = st.MultivariateNormal(mean, cov)
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    optimizer = st.AdaGrad(ENTRY_DIM, ENTRY_PARTICLES, FLAGSHIP_ADAGRAD_LR)
    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=ENTRY_DIM,
            num_iterations=1,
            coordinate_matrix=x0,
            kernel=kernel,
            model=model,
            optimizer=optimizer,
            device=device,
        )
    )
    svgd.initialize()
    step_fn = svgd.build_step_fn()

    def fn(state):
        return step_fn(state)[0]

    return fn, (svgd.make_state(),)


__all__ = ["ENTRY_DIM", "ENTRY_PARTICLES", "entry"]

