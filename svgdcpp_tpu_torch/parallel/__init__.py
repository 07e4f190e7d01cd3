"""The sharded engine on torch.distributed (port of svgdcpp_tpu.parallel):
particle groups (mesh.py) and ShardedSVGD (sharded.py). The ring schedule
(parallel/ring.py of the JAX package) is not ported yet (ROADMAP.md item
11)."""

from .mesh import (
    ParticleGroup,
    initialize_distributed,
    make_particle_group,
    make_particle_mesh,
    place_replicated,
    place_sharded,
)
from .sharded import (
    ShardedSVGD,
    ShardedSVGDConfig,
    sharded_hessian_scale,
    sharded_median_scale,
    sharded_pairwise_median,
    sym_panel_sharded_phi,
    sym_sharded_phi,
)
