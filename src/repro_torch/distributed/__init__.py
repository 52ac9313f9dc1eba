"""The sharded serving layer: key-range routing and the sharded
Coconut-LSM (:class:`ShardedCoconutLSM`), whose shards are port
``CoconutLSM`` engines on one device."""
from .router import KeyRangeRouter
from .samplesort import splitters_from_sample
from .sharded_lsm import ShardedCoconutLSM

__all__ = ["KeyRangeRouter", "ShardedCoconutLSM", "splitters_from_sample"]
