"""Plain PyTorch twins of the CUDA kernels in ``csrc/``.

Each twin computes its kernel's function with the same float operations
in the same order (no fused multiply-add, which eager PyTorch never
forms), so on any device a twin and its kernel agree bit for bit.  The
wrappers route a CPU tensor here; on the card the twins are the oracle
``chip_smoke.py`` holds every kernel against.

Summation orders (shared with ``csrc/common.cuh``):

* squared ED — lane ``l`` of a 32-lane warp sums ``(x_i - q_i)**2`` for
  ``i = l, l + 32, ...`` in order; the 32 partials are then folded in
  halves (``p[i] + p[i + 16]``, then ``+ 8``, ...).  The order depends
  only on ``L``, never on the batch, the tile or the launch, so a
  (query, row) pair has the same distance bits in every code path.
* mindist — per pair, the ``w`` segment terms are added in index order,
  then scaled by ``L / w``.
* PAA — each segment summed in index order, then divided by its length.

Packed code rows (segment format v3): symbol ``j`` of a row sits MSB first
at bit ``j*b`` of the row's ``ceil(w*b/8)`` bytes and is read through the
two-byte window at byte ``j*b // 8``, with a zero byte past the row's end.
"""
from __future__ import annotations

import torch

from ..core import keys as K
from ..core import summarization as S

__all__ = ["ED_LANES", "ed_pairs", "mindist_batch_ref", "batch_euclid_ref",
           "batch_euclid_blocked_ref", "batch_euclid_gather_ref",
           "scan_verify_ref", "local_scan_topk", "mesh_scan_ref",
           "fused_build_ref", "sax_summarize_ref", "zorder_ref",
           "unpack_codes_ref", "mindist_batch_packed_ref", "pool_merge_ref"]

ED_LANES = 32
# elements per [Q, rows, L] or [Q, rows, w] intermediate: rows are taken in
# blocks so the plain versions stay within a bounded working set
_BLOCK_ELEMS = 1 << 22


def ed_pairs(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Squared ED over the last axis of broadcastable ``x`` and ``q``
    in the kernels' lane order (see the module docstring)."""
    d = x - q
    sq = d * d
    L = sq.shape[-1]
    pad = (-L) % ED_LANES
    if pad:
        sq = torch.nn.functional.pad(sq, (0, pad))
    c = sq.unflatten(-1, (-1, ED_LANES))          # [..., L/32, 32]
    acc = c[..., 0, :]
    for i in range(1, c.shape[-2]):
        acc = acc + c[..., i, :]
    off = ED_LANES // 2
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    return acc[..., 0]


def _row_block(nq: int, width: int) -> int:
    return max(1, _BLOCK_ELEMS // max(1, nq * width))


def mindist_batch_ref(q_paas: torch.Tensor, codes: torch.Tensor,
                      lower: torch.Tensor, upper: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Batched squared iSAX lower bound: q_paas ``[Q, w]`` f32, codes
    ``[N, w]`` (uint8) -> ``[Q, N]`` f32 with ``lower``/``upper`` the
    ``[2**b]`` region tables (+/-inf at the ends)."""
    nq, w = q_paas.shape
    n = codes.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=codes.device)
    q = q_paas[:, None, :]
    step = _row_block(nq, w)
    for s in range(0, n, step):
        c = codes[s:s + step].to(torch.int64)
        lb, ub = lower[c][None], upper[c][None]
        d = (lb - q).clamp_min(0.0) + (q - ub).clamp_min(0.0)   # [Q, B, w]
        sq = d * d
        acc = sq[..., 0]
        for j in range(1, w):
            acc = acc + sq[..., j]
        out[:, s:s + step] = scale * acc
    return out


def batch_euclid_ref(queries: torch.Tensor,
                     series: torch.Tensor) -> torch.Tensor:
    """Cross form: queries ``[Q, L]``, series ``[N, L]`` -> ``[Q, N]``."""
    nq, L = queries.shape
    n = series.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=series.device)
    step = _row_block(nq, L)
    for s in range(0, n, step):
        out[:, s:s + step] = ed_pairs(series[None, s:s + step],
                                      queries[:, None, :])
    return out


def batch_euclid_gather_ref(queries: torch.Tensor, series: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """Gathered form: ``out[q, c] = ED(queries[q], series[idx[q, c]])``,
    queries ``[Q, L]``, series ``[M, L]``, idx ``[Q, C]`` -> ``[Q, C]``."""
    nq, L = queries.shape
    c = idx.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=series.device)
    step = _row_block(nq, L)
    for s in range(0, c, step):
        rows = series[idx[:, s:s + step]]                       # [Q, B, L]
        out[:, s:s + step] = ed_pairs(rows, queries[:, None, :])
    return out


# The reference blocks its plain cross form in fixed row blocks so that a
# row's distance bits do not depend on how many rows share the call.  Here
# the lane order already makes them independent of the batch, so the
# blocked form is the cross form itself.
batch_euclid_blocked_ref = batch_euclid_ref


def local_scan_topk(queries: torch.Tensor, q_paas: torch.Tensor,
                    codes: torch.Tensor, raw: torch.Tensor,
                    dead: torch.Tensor, bound: torch.Tensor,
                    lower: torch.Tensor, upper: torch.Tensor, *,
                    scale: float, k: int):
    """One device's scan: the lower bound, the live mask ``md < bound[q]``
    on rows not ``dead``, ED of live pairs, and each query's top-k.

    Returns (dists ``[Q, k]`` f32 inf-padded, row indices ``[Q, k]`` int32
    with -1 where the dist is inf, live ``[Q, N]`` bool).  Ties go to the
    lowest row index (a stable sort, then the first k)."""
    md = mindist_batch_ref(q_paas, codes, lower, upper, scale)
    live = (md < bound[:, None]) & (dead == 0)[None, :]
    ed = torch.where(live, batch_euclid_ref(queries, raw),
                     torch.tensor(float("inf"), device=raw.device))
    if ed.shape[1] < k:
        ed = torch.nn.functional.pad(ed, (0, k - ed.shape[1]),
                                     value=float("inf"))
    sd, si = torch.sort(ed, dim=1, stable=True)
    d = sd[:, :k].contiguous()
    idx = torch.where(torch.isfinite(d), si[:, :k].to(torch.int32),
                      torch.tensor(-1, dtype=torch.int32, device=raw.device))
    return d, idx, live


def scan_verify_ref(queries: torch.Tensor, q_paas: torch.Tensor,
                    codes: torch.Tensor, raw: torch.Tensor,
                    lower: torch.Tensor, upper: torch.Tensor,
                    bound: torch.Tensor, dead: torch.Tensor, *,
                    scale: float, k: int):
    """Fused scan+verify: :func:`local_scan_topk` with the live mask
    reduced to counts.

    Returns (dists ``[Q, k]`` f32 inf-padded, row indices ``[Q, k]``
    int32 with -1 where the dist is inf, live counts ``[Q]`` int32, union
    int32 — rows live for any query)."""
    d, idx, live = local_scan_topk(queries, q_paas, codes, raw, dead, bound,
                                   lower, upper, scale=scale, k=k)
    counts = live.sum(dim=1).to(torch.int32)
    union = live.any(dim=0).sum().to(torch.int32)
    return d, idx, counts, union


def mesh_scan_ref(queries: torch.Tensor, q_paas: torch.Tensor,
                  codes: torch.Tensor, raw: torch.Tensor,
                  ids: torch.Tensor, ts: torch.Tensor, ts_min: torch.Tensor,
                  bound: torch.Tensor, lower: torch.Tensor,
                  upper: torch.Tensor, *, scale: float, k: int):
    """Oracle of the device-resident sharded scan: the global top-k over
    the stacked shard columns, as if every shard lived on one device.

    queries ``[Q, L]``, q_paas ``[Q, w]``, codes ``[S, cap, w]``, raw
    ``[S, cap, L]``, ids ``[S, cap]`` int32 (-1 marks padding rows), ts
    ``[S, cap]`` int32, ts_min ``[S]`` int32 per-shard visibility cut
    (INT32_MIN disables it), bound ``[Q]`` per-query strict best-so-far.
    Returns (dists ``[Q, k]`` inf-padded, global ids ``[Q, k]`` int32 with
    -1 padding, counts ``[S, Q]`` int32 — rows verified per shard per
    query).  Ties go to the lowest (shard, row)."""
    s, cap = ids.shape
    dead = (ids < 0) | (ts < ts_min[:, None])
    d, idx, live = local_scan_topk(
        queries, q_paas, codes.reshape(s * cap, codes.shape[-1]),
        raw.reshape(s * cap, raw.shape[-1]), dead.reshape(s * cap), bound,
        lower, upper, scale=scale, k=k)
    ids_f = ids.reshape(s * cap)
    out_ids = torch.where(idx >= 0, ids_f[idx.clamp_min(0).long()],
                          torch.tensor(-1, dtype=ids.dtype,
                                       device=ids.device))
    counts = live.reshape(-1, s, cap).sum(dim=2).T.to(torch.int32)
    return d, out_ids, counts.contiguous()


def sax_summarize_ref(x: torch.Tensor, bps: torch.Tensor, *,
                      segments: int):
    """Raw ``[N, L]`` f32 -> (paa ``[N, w]`` f32, codes ``[N, w]`` uint8):
    each code is the number of breakpoints <= its PAA value."""
    n = x.shape[0]
    p = torch.empty((n, segments), dtype=torch.float32, device=x.device)
    codes = torch.empty((n, segments), dtype=torch.uint8, device=x.device)
    step = _row_block(1, x.shape[1])
    for s in range(0, n, step):
        p[s:s + step] = S.paa(x[s:s + step], segments)
        codes[s:s + step] = torch.searchsorted(bps, p[s:s + step], right=True)
    return p, codes


def zorder_ref(codes: torch.Tensor, *, w: int, b: int) -> torch.Tensor:
    """SAX codes ``[N, w]`` -> z-order keys ``[N, n_words]`` int64."""
    n = codes.shape[0]
    keys = torch.empty((n, K.n_key_words(w, b)), dtype=torch.int64,
                       device=codes.device)
    step = _row_block(1, w * b)
    for s in range(0, n, step):
        keys[s:s + step] = K.interleave_codes(codes[s:s + step], w=w, b=b)
    return keys


def unpack_codes_ref(packed: torch.Tensor, *, w: int, b: int
                     ) -> torch.Tensor:
    """Packed rows ``[N, ceil(w*b/8)]`` uint8 -> codes ``[N, w]`` uint8
    (see the module docstring for the bit layout)."""
    if packed.ndim != 2 or packed.shape[1] != -(-(w * b) // 8):
        raise ValueError(f"packed rows {tuple(packed.shape)} do not hold "
                         f"w={w} symbols of b={b} bits")
    padded = torch.nn.functional.pad(packed.to(torch.int64), (0, 1))
    bit = torch.arange(w, device=packed.device) * b
    window = (padded[:, bit // 8] << 8) | padded[:, bit // 8 + 1]
    out = (window >> (16 - bit % 8 - b)) & ((1 << b) - 1)
    return out.to(torch.uint8)


def mindist_batch_packed_ref(q_paas: torch.Tensor, packed: torch.Tensor,
                             lower: torch.Tensor, upper: torch.Tensor,
                             scale: float, *, w: int, b: int
                             ) -> torch.Tensor:
    """Batched squared iSAX lower bound over packed rows: the rows are
    decoded, then bounded exactly as :func:`mindist_batch_ref` does, so
    packed == unpacked holds bit for bit."""
    return mindist_batch_ref(q_paas, unpack_codes_ref(packed, w=w, b=b),
                             lower, upper, scale)


def fused_build_ref(x: torch.Tensor, bps: torch.Tensor, *,
                    segments: int, bits: int):
    """Raw ``[N, L]`` f32 -> (paa ``[N, w]`` f32, codes ``[N, w]`` uint8,
    keys ``[N, n_words]`` int64): :func:`sax_summarize_ref` then
    :func:`zorder_ref`, the two stages the kernel fuses."""
    p, codes = sax_summarize_ref(x, bps, segments=segments)
    return p, codes, zorder_ref(codes, w=segments, b=bits)


def pool_merge_ref(md: torch.Tensor, dd: torch.Tensor, leaves: torch.Tensor,
                   leaf: int, dead, ids: torch.Tensor, best_d: torch.Tensor,
                   best_off: torch.Tensor, ext: torch.Tensor,
                   counts: torch.Tensor, row_mark: torch.Tensor,
                   leaf_mark: torch.Tensor) -> None:
    """Fold one leaf group into the per-query pools, in place (see
    ``csrc/pool_merge.cu`` for the contract and
    :func:`repro_torch.kernels.pool_merge.pool_merge` for the shapes).

    Live pairs are ``md < min(best_d[:, -1], ext)`` on rows not ``dead``;
    they add to ``counts`` and mark ``row_mark`` and ``leaf_mark``.  A
    query with a live row takes ``merge_topk``'s pool: its pool's entries
    (the first ``(inf, -1)`` pad alone) and its live rows whose id is not
    in the pool, stable-sorted by distance (NaN last), the first k,
    padded with ``(inf, -1)``."""
    nq, b = md.shape
    k = best_d.shape[1]
    j = torch.arange(b, device=md.device)
    lf = leaves[j // leaf]
    rows = lf * leaf + j % leaf
    live = md < torch.minimum(best_d[:, -1], ext)[:, None]
    if dead is not None:
        live &= dead[rows] == 0
    n_live = live.sum(1)
    counts += n_live
    qi, ji = live.nonzero(as_tuple=True)
    leaf_mark[qi, lf[ji]] = 1
    row_mark[rows[ji]] = 1
    cols = live.any(0).nonzero()[:, 0]          # rows live for some query
    if len(cols) == 0:
        return
    cand = ids[rows[cols]]
    pad = best_off == -1
    pool_ok = ~pad | (pad & (pad.cumsum(1) == 1))
    new_ok = live[:, cols] & ~(cand[None, :, None]
                               == best_off[:, None, :]).any(2)
    d = torch.cat([best_d, dd[:, cols]], 1)
    off = torch.cat([best_off, cand.expand(nq, -1)], 1)
    ok = torch.cat([pool_ok, new_ok], 1)
    # stable sorts: by distance, then the entries that take part first
    by_d = torch.sort(d, dim=1, stable=True)[1]
    by_ok = torch.sort((~ok.gather(1, by_d)).to(torch.int8), dim=1,
                       stable=True)[1]
    sel = by_d.gather(1, by_ok)[:, :k]
    keep = ok.gather(1, sel)
    upd = n_live > 0
    best_d[upd] = torch.where(keep, d.gather(1, sel), float("inf"))[upd]
    best_off[upd] = torch.where(keep, off.gather(1, sel), -1)[upd]
