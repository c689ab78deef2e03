"""Core containers, copied from the reference package: point clouds, groups
of frames, video frames and patches."""

from .pointset import PointSet
from .gof import GroupOfFrames
from .image import Image, Video
from .patch import Patch
