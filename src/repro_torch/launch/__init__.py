"""Launch-time helpers: the device list a sharded scan spans and a
pipeline's stage devices."""
from .mesh import SCAN_AXIS, make_scan_mesh, make_stage_mesh

__all__ = ["SCAN_AXIS", "make_scan_mesh", "make_stage_mesh"]
