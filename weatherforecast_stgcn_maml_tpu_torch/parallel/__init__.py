"""Parallel layer: rank meshes, the data-parallel, node-sharded and GSPMD
meta steps (`meta_dp.py`, `meta_sp.py`, `meta_gspmd.py`, `spatial.py`),
multi-process initialisation (`distributed.py`), the region-fleet
partition over hosts (`fleet.py`) and the region fleet's lanes over ranks
(`fleet_mesh.py`).

Only the mesh and the dp step are imported here (the JAX package's
exports that are ported): ops/fused_gcn_shard.py imports parallel.mesh,
and parallel.spatial imports it back.
"""

from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_mesh_2d,
    shard_task_batch,
    shard_task_batch_2d,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import (  # noqa: F401
    make_parallel_meta_step,
)
