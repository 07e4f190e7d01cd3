"""The sharded engine on torch.distributed (port of svgdcpp_tpu.parallel):
particle groups (mesh.py), ShardedSVGD in gather mode and the ring schedule
(sharded.py, ring.py), and the multi-rank dry run on the CPU
(``python -m svgdcpp_tpu_torch.parallel.dryrun 8``, dryrun.py)."""

from .mesh import (
    ParticleGroup,
    initialize_distributed,
    make_particle_group,
    make_particle_mesh,
    place_replicated,
    place_sharded,
)
from .ring import (
    ring_count_le,
    ring_median_scale,
    ring_pairwise_median,
    ring_phi_generic,
    ring_phi_rbf,
    ring_phi_rbf_terms,
)
from .sharded import (
    ShardedSVGD,
    ShardedSVGDConfig,
    resolve_sharded_sym,
    sharded_fused_sweep,
    sharded_hessian_scale,
    sharded_median_scale,
    sharded_pairwise_median,
    sym_panel_sharded_phi,
    sym_sharded_phi,
)
