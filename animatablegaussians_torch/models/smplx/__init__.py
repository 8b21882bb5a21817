from .body_model import FLAME, MANO, SMPL, SMPLH, SMPLX, SMPLXData
from .lbs import (batch_rigid_transform, batch_rodrigues, blend_shapes,
                  find_dynamic_lmk_idx_and_bcoords, lbs, vertices2joints,
                  vertices2landmarks)
from .vertex_ids import VERTEX_IDS, extra_joints_indices

__all__ = ["FLAME", "MANO", "SMPL", "SMPLH", "SMPLX", "SMPLXData",
           "VERTEX_IDS", "batch_rigid_transform", "batch_rodrigues",
           "blend_shapes", "extra_joints_indices",
           "find_dynamic_lmk_idx_and_bcoords", "lbs", "vertices2joints",
           "vertices2landmarks"]
