"""Device meshes, the FSDP sharding rule, and the camera-sharded pipeline
step, over `torch.distributed` (port of `rt3d/parallel`).

The reference's only parallel axis is two camera streams processed
sequentially on one GPU (`SURVEY.md` §2.3). Here camera streams can shard
over the ranks of a process group (a block of cameras per rank, one GPU
each), with one all-gather of the compact padded object buffers and
workspace voxels before a replicated fusion; and training scales with dp
(batch) x fsdp (parameter) sharding through FSDP2. Every function here
needs an initialized process group (`torch.distributed.init_process_group`),
but `fsdp_placements`, which only reads shapes.
"""

from rt3d_torch.parallel.mesh import fsdp_placements, make_mesh  # noqa: F401
from rt3d_torch.parallel.multicam import make_sharded_step  # noqa: F401
