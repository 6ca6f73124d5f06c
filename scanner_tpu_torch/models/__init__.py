# Importing registers the model ops: PoseDetect, ObjectDetect,
# FaceDetect, FaceEmbedding, InstanceSegment, OpenPose and SamEmbed.
from . import detection, face, openpose, pose, sam, segmentation  # noqa: F401
from .convert import load_npz, load_params, torch_state
from .detection import ObjectDetect, unpack_detections
from .face import FaceDetect, FaceEmbedding
from .infer import DataParallelApply
from .openpose import OpenPose, assemble_people, unpack_pose
from .pose import (PoseDetect, VideoPoseNet, heatmaps_to_keypoints,
                   init_params, make_train_step)
from .sam import SamEmbed
from .segmentation import InstanceSegment, paste_masks, unpack_instances

__all__ = ["PoseDetect", "VideoPoseNet", "heatmaps_to_keypoints",
           "init_params", "make_train_step", "load_npz", "load_params",
           "torch_state", "pose", "detection", "face", "segmentation",
           "ObjectDetect", "FaceDetect", "FaceEmbedding", "InstanceSegment",
           "DataParallelApply", "unpack_detections", "unpack_instances",
           "paste_masks", "openpose", "OpenPose", "unpack_pose",
           "assemble_people", "sam", "SamEmbed"]
