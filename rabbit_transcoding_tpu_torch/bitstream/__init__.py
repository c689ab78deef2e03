from .bitio import BitReader, BitWriter, BitstreamStat
from .hls import AtlasHLS, Context
from .reader import V3CReader
from .writer import V3CWriter
from .video_bitstream import VideoBitstream
