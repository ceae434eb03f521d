"""TACZ container for the port: wire format, writer and reader.

One-shot helpers: :func:`write`, :func:`read`, :func:`read_roi`; single
tensors: :func:`encode_tensor`, :func:`decode_tensor`.
"""
from .format import TACZ_VERSION
from .frontier import (Frontier, FrontierPoint, Target, TargetUnsatisfiable,
                       parse_target)
from .reader import (WHOLE_LEVEL, ROILevel, TACZReader, open_snapshot,
                     probe_index_crc, read, read_roi)
from .tensor import decode_tensor, encode_tensor
from .writer import TACZWriter, pack_level, write

__all__ = ["TACZ_VERSION", "WHOLE_LEVEL", "Frontier", "FrontierPoint",
           "ROILevel", "TACZReader", "TACZWriter", "Target",
           "TargetUnsatisfiable", "decode_tensor", "encode_tensor",
           "open_snapshot", "pack_level", "parse_target", "probe_index_crc",
           "read", "read_roi", "write"]
