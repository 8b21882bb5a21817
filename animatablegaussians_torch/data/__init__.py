from .mv_rgb_dataset import (MvRgbDatasetActorsHQ, MvRgbDatasetAvatarReX,
                             MvRgbDatasetBase, MvRgbDatasetTHuman4,
                             get_dataset_class)
from .pose_dataset import PoseDataset

__all__ = ["MvRgbDatasetBase", "MvRgbDatasetAvatarReX",
           "MvRgbDatasetTHuman4", "MvRgbDatasetActorsHQ",
           "get_dataset_class", "PoseDataset"]
