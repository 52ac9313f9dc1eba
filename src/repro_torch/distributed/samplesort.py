"""Sample-sort over the scan mesh: the paper's external sort across shards.

The paper bulk-loads by external sort (partition -> merge, Sec. 3.1).  The
reference does it as a sample-sort over a device mesh, one ``shard_map``
body with one ``all_to_all``; here the mesh is the port's ordered tuple of
``torch.device`` (:mod:`repro_torch.launch.mesh`), one shard per entry
(entries may repeat a device), and the same steps run shard by shard:

  1. a stable local sort of each shard's keys (shard ``i`` starts with
     rows ``i*N/d .. (i+1)*N/d - 1``);
  2. ``d`` evenly spaced keys sampled from each sorted shard, the ``d*d``
     samples sorted, every ``d``-th taken: ``d - 1`` global splitters;
  3. each row's destination shard by binary search over the splitters,
     its slot the rank within its bucket; rows at slot ``>= cap``
     (``cap = int(cap_factor * N/d)``) overflow and are dropped;
  4. shard ``j`` receives its buckets from sources ``0 .. d-1`` in order
     and sorts them stably.

Every sort is stable, so equal keys keep their original row order, and
the shards laid end to end are the single-device sort of all rows.

Layout: the reference pads every shard to ``d * cap`` rows with all-ones
keys (2 d N rows in all at ``cap_factor`` 2).  Here each shard's rows are
stored unpadded, one tensor per shard on its mesh device, and no
``[d, d, cap]`` exchange buffer is built.  That is the only difference:
the splitters, the counts (with the reference's overflow sign) and each
shard's valid rows are the reference's.

:func:`splitters_from_sample` is the host twin of step 2 that the
streaming router uses to estimate its shard boundaries.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core import keys as K

__all__ = ["sharded_sort", "sample_splitters", "splitters_from_sample",
           "local_topk_merge"]


def splitters_from_sample(keys: np.ndarray, d: int) -> np.ndarray:
    """Select ``d-1`` range splitters from a key sample: sort the sample,
    take every ``len/d``-th key.

    ``keys``: ``[M, n_words]`` uint32 z-order keys (any order).
    Returns ``[d-1, n_words]`` ascending splitter keys.
    """
    keys = np.asarray(keys, np.uint32)
    if d < 2:
        return np.zeros((0, keys.shape[1]), np.uint32)
    s = keys[K.lexsort_keys_np(keys)]
    pos = (np.arange(1, d) * len(s)) // d
    return np.ascontiguousarray(s[np.minimum(pos, len(s) - 1)])


def sample_splitters(sorted_blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Step 2 of the sample-sort: the ``d - 1`` splitters of ``d`` sorted
    key blocks (``[n_loc, n_words]`` each, on any devices), on the first
    block's device.  Each block gives ``d`` keys at stride
    ``max(n_loc // d, 1)``; the ``d*d`` samples, in block order, are
    sorted and every ``d``-th is taken from the ``d``-th on."""
    d = len(sorted_blocks)
    home = sorted_blocks[0].device
    step = max(sorted_blocks[0].shape[0] // d, 1)
    flat = torch.cat([b[::step][:d].to(home) for b in sorted_blocks])
    flat = flat[K.lexsort_keys(flat)]
    return flat[d::d][:d - 1]


def _blocks(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Row blocks ``i*N/d .. (i+1)*N/d - 1`` of ``x``, block ``i`` on
    ``mesh[i]`` (a view where it already lies there)."""
    d = len(mesh)
    nl = x.shape[0] // d
    return [x[i * nl:(i + 1) * nl].to(mesh[i]) for i in range(d)]


def sort_blocks(mesh, key_blocks: Sequence[torch.Tensor],
                col_blocks: Sequence[Sequence[torch.Tensor]], *,
                cap_factor: float = 2.0):
    """The sample-sort over blocks already placed on the mesh:
    ``key_blocks[i]`` ``[n_loc, n_words]`` and the payload columns
    ``col_blocks[i]`` (each ``[n_loc, ...]``) on ``mesh[i]``.

    Returns (keys ``[d]`` of ``[n_j, n_words]``, columns ``[d]`` of lists
    of ``[n_j, ...]``, counts ``[d]`` int32 on the CPU): shard ``j`` holds
    its key range on ``mesh[j]``, sorted; ``counts[j]`` is ``n_j``, or
    ``-n_j - 1`` when rows of shard ``j``'s own block overflowed."""
    d = len(mesh)
    if d == 1:                      # degenerate mesh: plain local sort
        order = K.lexsort_keys(key_blocks[0])
        return ([key_blocks[0][order]], [[c[order] for c in col_blocks[0]]],
                torch.tensor([key_blocks[0].shape[0]], dtype=torch.int32))
    n_loc = key_blocks[0].shape[0]
    cap = int(cap_factor * n_loc)
    orders, sorted_k = [], []
    for kb in key_blocks:                                     # 1. local sort
        o = K.lexsort_keys(kb)
        orders.append(o)
        sorted_k.append(kb[o])
    splitters = sample_splitters(sorted_k)                    # 2. splitters
    starts, takes, overflow = [], [], []
    for i, sk in enumerate(sorted_k):                         # 3. buckets
        dest = K.searchsorted_keys(splitters.to(sk.device), sk, side="right")
        cnt = torch.bincount(dest, minlength=d).cpu()
        # rows are sorted, so bucket j is one run starting at starts[i][j]
        # and a row's slot is its rank in that run
        starts.append(torch.cumsum(cnt, 0) - cnt)
        takes.append(cnt.clamp(max=cap))
        overflow.append(bool((cnt > cap).any()))
    out_k, out_c, counts = [], [], []
    for j, dev in enumerate(mesh):                            # 4. exchange
        runs = [slice(int(starts[i][j]), int(starts[i][j] + takes[i][j]))
                for i in range(d)]
        rk = torch.cat([sorted_k[i][runs[i]].to(dev) for i in range(d)])
        o2 = K.lexsort_keys(rk)
        # (source block, row in it) of each received row, in final order
        src = torch.cat([torch.full((int(takes[i][j]),), i, device=dev)
                         for i in range(d)])[o2]
        loc = torch.cat([orders[i][runs[i]].to(dev) for i in range(d)])[o2]
        cols = []
        for c in range(len(col_blocks[0])):
            blk0 = col_blocks[0][c]
            out = torch.empty((rk.shape[0],) + tuple(blk0.shape[1:]),
                              dtype=blk0.dtype, device=dev)
            for i in range(d):
                at = (src == i).nonzero().squeeze(1)
                blk = col_blocks[i][c]
                out[at] = blk[loc[at].to(blk.device)].to(dev)
            cols.append(out)
        out_k.append(rk[o2])
        out_c.append(cols)
        valid = rk.shape[0]
        counts.append(-valid - 1 if overflow[j] else valid)
    return out_k, out_c, torch.tensor(counts, dtype=torch.int32)


def sharded_sort(mesh, keys: torch.Tensor, payload: torch.Tensor, *,
                 cap_factor: float = 2.0):
    """Globally sort (keys, payload) rows across the mesh's ``d`` shards.

    ``keys``: ``[N, n_words]`` int64 words (z-order keys), ``N``
    divisible by ``d``; shard ``i``'s block is rows ``i*N/d ..
    (i+1)*N/d - 1``, moved to ``mesh[i]``.  ``payload``: ``[N, ...]``
    rows carried with their keys.

    Returns (sorted_keys, sorted_payload, valid_counts): one tensor per
    shard, shard ``j`` on ``mesh[j]`` holding its range partition
    unpadded; ``valid_counts`` ``[d]`` int32, negative (``-valid - 1``) on
    a shard whose own rows overflowed the bucket capacity
    ``cap_factor * N/d``.
    """
    mesh = tuple(torch.device(m) for m in mesh)
    d = len(mesh)
    if keys.shape[0] % d:
        raise ValueError(f"N={keys.shape[0]} must divide over {d} shards")
    sk, sc, counts = sort_blocks(
        mesh, _blocks(keys, mesh), [[b] for b in _blocks(payload, mesh)],
        cap_factor=cap_factor)
    return sk, [c[0] for c in sc], counts


def local_topk_merge(mesh, dists: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard candidate (dist, id) lists into a global top-k.

    ``dists``/``ids``: ``[N]``, block ``i`` on ``mesh[i]``; each block
    keeps its ``min(k, n_loc)`` smallest, the lists are gathered to the
    first device in shard order and the ``k`` smallest taken.  Every
    selection is a stable sort, so ties go to the lowest index, as
    ``top_k`` gives them.  Returns (dists ``[k]``, ids ``[k]``) on
    ``mesh[0]``."""
    mesh = tuple(torch.device(m) for m in mesh)
    home = mesh[0]
    d_all, i_all = [], []
    for d_loc, i_loc in zip(_blocks(dists, mesh), _blocks(ids, mesh)):
        sd, si = torch.sort(d_loc, stable=True)
        kk = min(k, d_loc.shape[0])
        d_all.append(sd[:kk].to(home))
        i_all.append(i_loc[si[:kk]].to(home))
    sd, si = torch.sort(torch.cat(d_all), stable=True)
    return sd[:k], torch.cat(i_all)[si[:k]]
