"""TACZ container for the port: wire format, writer and reader.

One-shot helpers: :func:`write`, :func:`read`, :func:`read_roi`; single
tensors: :func:`encode_tensor`, :func:`decode_tensor`.  Multi-part
snapshots (a directory of ``part-XXXX.tacz`` files bound by a CRC'd
``manifest.json``): :func:`write_multipart`, :class:`ParallelTACZWriter`,
and :func:`open_snapshot`, which opens either kind
(:class:`MultiPartReader` for a directory).  Variant sets (several
eb-variant snapshots under one CRC'd ``variants.json``):
:func:`is_variant_set`, :func:`load_catalog`, :func:`select_variant`.
"""
from .format import TACZ_VERSION
from .frontier import (Frontier, FrontierPoint, Target, TargetUnsatisfiable,
                       parse_target)
from .parallel import MultiPartReader, ParallelTACZWriter, write_multipart
from .reader import (WHOLE_LEVEL, ROILevel, TACZReader, open_snapshot,
                     probe_index_crc, read, read_roi)
from .tensor import decode_tensor, encode_tensor
from .variants import is_variant_set, load_catalog, select_variant
from .writer import TACZWriter, pack_level, write

__all__ = ["TACZ_VERSION", "WHOLE_LEVEL", "Frontier", "FrontierPoint",
           "MultiPartReader", "ParallelTACZWriter", "ROILevel",
           "TACZReader", "TACZWriter", "Target", "TargetUnsatisfiable",
           "decode_tensor", "encode_tensor", "is_variant_set",
           "load_catalog", "open_snapshot", "pack_level", "parse_target",
           "probe_index_crc", "read", "read_roi", "select_variant", "write",
           "write_multipart"]
