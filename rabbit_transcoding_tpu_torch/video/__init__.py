from .base import VideoDecoder, VideoEncoder, VideoEncoderParams
from . import rbv
