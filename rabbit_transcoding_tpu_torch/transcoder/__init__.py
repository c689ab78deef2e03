"""The live transcoder and its batched multi-stream form, with the
host types a caller needs around it (V3C reader and writer, parameters,
enums; the port's own copies of the reference's), so that code driving the port names only this
package."""

from ..bitstream import V3CReader, V3CWriter
from ..utils.enums import ColorFormat, VideoType
from .multistream import MultiStreamTranscoder
from .params import TranscoderParameters
from .transcoder import Transcoder

__all__ = ["ColorFormat", "MultiStreamTranscoder", "Transcoder",
           "TranscoderParameters", "V3CReader", "V3CWriter", "VideoType"]
