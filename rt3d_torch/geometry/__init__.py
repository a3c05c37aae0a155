"""rt3d_torch.geometry (PyTorch port of rt3d.geometry): fixed-capacity
point-cloud ops on padded ``(points (N, 3) f32, valid (N,) bool)`` buffers."""

from rt3d_torch.geometry.ops import (  # noqa: F401
    PointBuffer,
    aabb_mask,
    backproject_depth_grid,
    compact_points,
    masked_centroid,
    rigid_transform,
    voxel_downsample,
    voxel_downsample_masks,
)
from rt3d_torch.geometry.sor import sor_inlier_mask, sor_filter  # noqa: F401
from rt3d_torch.geometry.subtract import subtract_min_dist  # noqa: F401
from rt3d_torch.geometry.fusion import fuse_centroid  # noqa: F401
from rt3d_torch.geometry.voxel_sets import (  # noqa: F401
    VoxelAccumulator,
    accumulate_voxels,
    extract_accumulated,
    subtract_voxel_sets,
)
from rt3d_torch.geometry.image import (  # noqa: F401
    dilate_mask,
    erode_mask,
    random_subsample,
)
