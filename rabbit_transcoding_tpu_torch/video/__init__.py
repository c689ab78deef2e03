"""The video codecs: RBV (``rbv.py``), the in-tree HEVC subsets, the
external app codecs and the factory (``base.py``).

The factory's names and ``rbv`` load on first use (PEP 562), so that the
host-only modules here (``hevc_probe``, ``hevc_ipcm``, ``hevc_intra``,
``shvc``, ``codec_group``) import without torch.
"""

import importlib

_FACTORY = ("VideoDecoder", "VideoEncoder", "VideoEncoderParams")


def __getattr__(name: str):
    if name in _FACTORY:
        return getattr(importlib.import_module(".base", __name__), name)
    if name == "rbv":
        return importlib.import_module(".rbv", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
