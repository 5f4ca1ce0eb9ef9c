from . import cg, gridding, irgnm, operators, phantom, recon, stream
from .recon import Reconstructor
from .stream import FrameStream, LatencyReport, stream_movie

__all__ = ["cg", "gridding", "irgnm", "operators", "phantom", "recon",
           "stream", "Reconstructor", "FrameStream", "LatencyReport",
           "stream_movie"]
