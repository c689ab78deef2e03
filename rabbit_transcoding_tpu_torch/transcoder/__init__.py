"""The live transcoder and its batched multi-stream form, with the
reference's JAX-free host types a caller needs around it (V3C reader and
writer, parameters, enums), so that code driving the port names only this
package."""

from rabbit_transcoding_tpu.bitstream import V3CReader, V3CWriter
from rabbit_transcoding_tpu.transcoder.params import TranscoderParameters
from rabbit_transcoding_tpu.utils.enums import ColorFormat, VideoType

from .multistream import MultiStreamTranscoder
from .transcoder import Transcoder

__all__ = ["ColorFormat", "MultiStreamTranscoder", "Transcoder",
           "TranscoderParameters", "V3CReader", "V3CWriter", "VideoType"]
