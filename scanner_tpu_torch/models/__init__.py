# Importing registers the model ops.  Only the pose family (PoseDetect)
# is ported so far; detection, face and segmentation are not.
from . import pose  # noqa: F401
from .convert import load_npz, load_params, torch_state
from .pose import (PoseDetect, VideoPoseNet, heatmaps_to_keypoints,
                   init_params, make_train_step)

__all__ = ["PoseDetect", "VideoPoseNet", "heatmaps_to_keypoints",
           "init_params", "make_train_step", "load_npz", "load_params",
           "torch_state", "pose"]
