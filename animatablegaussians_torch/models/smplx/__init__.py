from .body_model import SMPLX, SMPLXData
from .lbs import batch_rigid_transform, blend_shapes, lbs

__all__ = ["SMPLX", "SMPLXData", "batch_rigid_transform", "blend_shapes",
           "lbs"]
