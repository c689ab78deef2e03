"""Core containers, copied from the reference package: video frames and
patches."""

from .image import Image, Video
from .patch import Patch
