"""Distributed frame-batch pipeline: whole-file batch codec, mesh-sharded
cores with a ring halo exchange, and multi-host orchestration
(SURVEY §2 N1-N6)."""

from . import multihost
from .pipeline import batch_decode, batch_encode, batch_repair, plan_frames
from .sharded import (
    make_mesh, overlap_add_sharded, pad_to_multiple, sharded_p0_decode,
    sharded_p0_encode, sharded_p1_decode, sharded_p1_encode,
    sharded_p2_decode, sharded_p2_encode,
)

__all__ = [
    "batch_decode", "batch_encode", "batch_repair", "make_mesh", "multihost",
    "overlap_add_sharded", "pad_to_multiple", "plan_frames",
    "sharded_p0_decode", "sharded_p0_encode", "sharded_p1_decode",
    "sharded_p1_encode", "sharded_p2_decode", "sharded_p2_encode",
]
