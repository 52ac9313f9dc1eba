"""Launch-time helpers: the device list a sharded scan spans."""
from .mesh import SCAN_AXIS, make_scan_mesh

__all__ = ["SCAN_AXIS", "make_scan_mesh"]
