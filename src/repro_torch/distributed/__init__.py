"""The sharded layers: the static sharded Coconut-Tree (sample-sort
bulk-load over the scan mesh, distributed exact and budgeted search), and
the sharded serving layer: key-range routing and the sharded Coconut-LSM
(:class:`ShardedCoconutLSM`), whose shards are port ``CoconutLSM``
engines on one device."""
from .router import KeyRangeRouter
from .samplesort import local_topk_merge, sharded_sort, splitters_from_sample
from .sharded_index import (ShardedCoconutTree, build_sharded,
                            distributed_exact_search,
                            distributed_exact_search_batch,
                            sharded_tree_from_arrays)
from .sharded_lsm import ShardedCoconutLSM

__all__ = ["KeyRangeRouter", "ShardedCoconutLSM", "ShardedCoconutTree",
           "build_sharded", "distributed_exact_search",
           "distributed_exact_search_batch", "local_topk_merge",
           "sharded_sort", "sharded_tree_from_arrays",
           "splitters_from_sample"]
