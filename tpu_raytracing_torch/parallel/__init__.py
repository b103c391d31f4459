"""Multi-GPU rendering: device meshes, sharded render steps, distributed driver."""
from .mesh import (  # noqa: F401
    dryrun_step, init_render_group, make_render_mesh,
    make_sharded_accum_step, make_sharded_step,
    render_accumulated_distributed, render_distributed, shard_sum,
)
