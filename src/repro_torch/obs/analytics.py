"""Workload analytics: the consumer of the structured query log.

The engines *emit* telemetry; this module reads it back.  A
:class:`WorkloadAnalyzer` streams over query-log
records (the rotated ``query_log.jsonl`` chain on disk, or live probe
records via :func:`repro_torch.obs.add_probe_observer`) and aggregates the
workload profile that adaptive maintenance needs:

* **leaf heat** per partition and per shard (from the capped
  ``leaf_touches`` reports) — the admission signal for hot-leaf
  caching and median re-splitting;
* **shard-load skew** (max/mean and Gini over per-shard touch totals)
  — the trigger signal for skew-driven rebalance;
* **query-window / k / kind distributions** — the input for sizing BTP
  window partitions to the workload;
* **prune-rate and certified-gap time series** — is pruning decaying,
  is the approximate dial honest over time;
* **bit-exact totals**: ``leaves_scanned`` / ``scan_bytes`` /
  ``buffer_rows`` summed over records equal the registry's ``query.*``
  counters exactly when the log is complete (every pipeline run was
  probe-rooted and no rotation dropped records) — the
  :meth:`WorkloadAnalyzer.check_against` cross-check the CLI and CI
  run.  ``leaf_touches`` lists are capped per partition
  (``SearchStats.LEAF_TOUCH_CAP``), so *heat* is a sampled signal;
  the *totals* come from the uncapped counter fields and are exact.

CLI (writes ``WORKLOAD.json`` next to the log)::

    python -m repro_torch.obs.analytics <trace-dir> \
        [--out WORKLOAD.json] [--check-metrics metrics.json]

Sequence-number discipline: records carry a monotonic ``seq`` assigned
at append time.  The analyzer treats a repeated seq as a replay (first
occurrence wins — rotated files can overlap a re-read) and reports
holes: ``lost_before`` (oldest rotated file dropped) and ``missing``
(holes inside the surviving range).  Exact-total checks refuse to
certify a log with losses.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional

from .registry import Histogram

__all__ = ["WorkloadAnalyzer", "iter_query_log", "query_log_files",
           "gini", "EXACT_TOTALS"]

# record field -> registry counter it must sum to, bit for bit, when
# the log is complete (see module docstring for why `candidates` is
# excluded: the sharded fan-out folds buffer rows into it, the
# registry's per-run fold does not)
EXACT_TOTALS = {
    "leaves_scanned": "query.leaves_scanned_total",
    "scan_bytes": "query.scan_bytes_total",
    "buffer_rows": "query.buffer_rows_total",
}

_TOTAL_FIELDS = ("leaves_scanned", "leaves_pruned", "scan_bytes",
                 "candidates", "buffer_rows")
_TOP_LEAVES = 16        # hottest leaf ids reported per partition


def gini(values: Iterable[float]) -> float:
    """Gini coefficient of a non-negative load vector (0 = perfectly
    even, ->1 = all load on one shard).  0 for empty/zero vectors."""
    xs = sorted(float(v) for v in values)
    n = len(xs)
    total = sum(xs)
    if n == 0 or total <= 0:
        return 0.0
    acc = sum((2 * i - n + 1) * x for i, x in enumerate(xs))
    return acc / (n * total)


def query_log_files(path: str, name: str = "query_log") -> List[str]:
    """The rotated chain in chronological order: ``<name>.<max>.jsonl``
    down to ``<name>.1.jsonl``, then the live ``<name>.jsonl``.  A plain
    file path is returned as-is."""
    if os.path.isfile(path):
        return [path]
    out = []
    i = 1
    rotated = []
    while True:
        p = os.path.join(path, f"{name}.{i}.jsonl")
        if not os.path.exists(p):
            break
        rotated.append(p)
        i += 1
    out.extend(reversed(rotated))       # oldest surviving file first
    live = os.path.join(path, f"{name}.jsonl")
    if os.path.exists(live):
        out.append(live)
    return out


def iter_query_log(path: str, name: str = "query_log"
                   ) -> Iterator[dict]:
    """Stream records from a query-log file or directory, oldest first.
    Unparseable lines (a torn tail after a crash) are skipped."""
    for p in query_log_files(path, name):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue


class _Bucket:
    """One time bucket of the prune-rate / gap time series."""

    __slots__ = ("probes", "leaves_scanned", "leaves_pruned",
                 "scan_bytes", "latency_sum", "gap_max", "gap_sum",
                 "gap_n")

    def __init__(self):
        self.probes = 0
        self.leaves_scanned = 0
        self.leaves_pruned = 0
        self.scan_bytes = 0
        self.latency_sum = 0.0
        self.gap_max = 0.0
        self.gap_sum = 0.0
        self.gap_n = 0


class WorkloadAnalyzer:
    """Streaming aggregator over query-log records.

    Thread-safe: :meth:`feed` may run on probe threads (live observer
    mode) while :meth:`profile` serves an HTTP scrape.  All state is
    O(distinct leaves touched + time buckets), independent of record
    count.
    """

    def __init__(self, *, time_bucket_s: float = 1.0):
        self._lock = threading.Lock()
        self.time_bucket_s = float(time_bucket_s)
        self.records = 0
        self.dup_records = 0
        self.budget_exhausted = 0
        self.queries = 0
        self.totals: Dict[str, int] = {f: 0 for f in _TOTAL_FIELDS}
        self.kinds: Counter = Counter()
        self.k_hist: Counter = Counter()
        self.window_hist: Counter = Counter()
        self.latency = Histogram("probe.latency_ms")
        self.gap = Histogram("probe.gap_max")
        # leaf heat: partition -> Counter(leaf id -> touches); shard
        # label peeled off the "s<i>/" prefix the sharded engine adds
        self.leaf_heat: Dict[str, Counter] = {}
        self.shard_touches: Counter = Counter()
        self._series: Dict[int, _Bucket] = {}
        # seq accounting (records without a seq are live-fed: exempt)
        self._seen_seqs: set = set()
        self._seq_min: Optional[int] = None
        self._seq_max: Optional[int] = None

    # ------------------------------------------------------------------ feed
    @staticmethod
    def shard_of(part: str) -> str:
        """Shard label of a leaf_touches partition key: the sharded
        engine re-keys parts as ``s<i>/<part>``; everything else is the
        single (implicit) shard ``s0``."""
        head, sep, _ = part.partition("/")
        if sep and len(head) > 1 and head[0] == "s" \
                and head[1:].isdigit():
            return head
        return "s0"

    def feed(self, rec: dict) -> None:
        """Fold one probe record in (first occurrence of a seq wins)."""
        if not isinstance(rec, dict) or "kind" not in rec:
            return
        with self._lock:
            seq = rec.get("seq")
            if seq is not None:
                seq = int(seq)
                if seq in self._seen_seqs:
                    self.dup_records += 1
                    return
                self._seen_seqs.add(seq)
                if self._seq_min is None or seq < self._seq_min:
                    self._seq_min = seq
                if self._seq_max is None or seq > self._seq_max:
                    self._seq_max = seq
            self.records += 1
            self.queries += int(rec.get("queries", 1))
            for f in _TOTAL_FIELDS:
                self.totals[f] += int(rec.get(f, 0))
            self.kinds[str(rec.get("kind"))] += 1
            self.k_hist[int(rec.get("k", 1))] += 1
            w = rec.get("window")
            self.window_hist["none" if w is None else int(w)] += 1
            if rec.get("budget_exhausted"):
                self.budget_exhausted += 1
            lat = rec.get("latency_ms")
            if lat is not None:
                self.latency.observe(float(lat))
            gmax = rec.get("gap_max")
            if gmax is not None:
                self.gap.observe(float(gmax))
            for part, ids in (rec.get("leaf_touches") or {}).items():
                heat = self.leaf_heat.get(part)
                if heat is None:
                    heat = self.leaf_heat[part] = Counter()
                heat.update(int(i) for i in ids)
                self.shard_touches[self.shard_of(part)] += len(ids)
            t = rec.get("t")
            if t is not None:
                tb = int(float(t) / self.time_bucket_s)
                b = self._series.get(tb)
                if b is None:
                    b = self._series[tb] = _Bucket()
                b.probes += 1
                b.leaves_scanned += int(rec.get("leaves_scanned", 0))
                b.leaves_pruned += int(rec.get("leaves_pruned", 0))
                b.scan_bytes += int(rec.get("scan_bytes", 0))
                if lat is not None:
                    b.latency_sum += float(lat)
                if gmax is not None:
                    b.gap_max = max(b.gap_max, float(gmax))
                    b.gap_sum += float(gmax)
                    b.gap_n += 1

    def feed_all(self, recs: Iterable[dict]) -> "WorkloadAnalyzer":
        for rec in recs:
            self.feed(rec)
        return self

    # --------------------------------------------------------------- readout
    def seq_report(self) -> dict:
        """Rotation-loss accounting over the seqs actually seen."""
        with self._lock:
            if self._seq_min is None:
                return {"min": None, "max": None, "lost_before": 0,
                        "missing": 0, "duplicates": self.dup_records}
            spanned = self._seq_max - self._seq_min + 1
            return {"min": self._seq_min, "max": self._seq_max,
                    "lost_before": self._seq_min,
                    "missing": spanned - len(self._seen_seqs),
                    "duplicates": self.dup_records}

    def complete(self) -> bool:
        """True when no record was lost to rotation (seq 0 seen and no
        holes) — the precondition of the exact-totals certificate."""
        s = self.seq_report()
        return s["lost_before"] == 0 and s["missing"] == 0

    def profile(self) -> dict:
        """The WORKLOAD.json document."""
        seq = self.seq_report()
        with self._lock:
            scanned = self.totals["leaves_scanned"]
            pruned = self.totals["leaves_pruned"]
            touched = dict(self.shard_touches)
            shards = sorted(touched)
            loads = [touched[s] for s in shards]
            heat = {}
            for part, ctr in sorted(self.leaf_heat.items()):
                heat[part] = {
                    "shard": self.shard_of(part),
                    "touches": sum(ctr.values()),
                    "distinct_leaves": len(ctr),
                    "hottest": [[int(l), int(c)] for l, c in
                                ctr.most_common(_TOP_LEAVES)],
                }
            series = []
            for tb in sorted(self._series):
                b = self._series[tb]
                denom = b.leaves_scanned + b.leaves_pruned
                series.append({
                    "t": tb * self.time_bucket_s,
                    "probes": b.probes,
                    "leaves_scanned": b.leaves_scanned,
                    "leaves_pruned": b.leaves_pruned,
                    "scan_bytes": b.scan_bytes,
                    "prune_rate": (b.leaves_pruned / denom
                                   if denom else 0.0),
                    "latency_ms_mean": (b.latency_sum / b.probes
                                        if b.probes else 0.0),
                    "gap_max": b.gap_max if b.gap_n else None,
                    "gap_mean": (b.gap_sum / b.gap_n
                                 if b.gap_n else None),
                })
            doc = {
                "schema": 1,
                "records": self.records,
                "queries": self.queries,
                "complete": (seq["lost_before"] == 0
                             and seq["missing"] == 0),
                "seq": seq,
                "totals": dict(self.totals),
                "prune_rate": (pruned / (scanned + pruned)
                               if scanned + pruned else 0.0),
                "budget_exhausted_probes": self.budget_exhausted,
                "kinds": dict(self.kinds),
                "k_hist": {str(k): v for k, v in
                           sorted(self.k_hist.items())},
                "window_hist": {str(k): v for k, v in
                                sorted(self.window_hist.items(),
                                       key=lambda kv: str(kv[0]))},
                "latency_ms": self.latency.summary(),
                "gap_max": (self.gap.summary()
                            if self.gap.count else None),
                "leaf_heat": heat,
                "shard_load": {
                    "touches": touched,
                    "max_over_mean": (max(loads) * len(loads)
                                      / sum(loads)
                                      if loads and sum(loads) else 0.0),
                    "gini": gini(loads),
                },
            }
            doc["series"] = series
            return doc

    def check_against(self, metrics: Dict[str, float]) -> List[str]:
        """Bit-for-bit cross-check against a flat registry snapshot
        (``describe_metrics()``).  Valid only when every pipeline run in
        the process was probe-rooted (true for every search entry point)
        and the log is complete; returns a list of violations (empty ==
        exact).
        """
        errs = []
        if not self.complete():
            errs.append(f"log incomplete, totals not certifiable: "
                        f"{self.seq_report()}")
            return errs
        with self._lock:
            pairs = [("records", self.records, "query.probes_total"),
                     ("queries", self.queries, "query.queries_total")]
            for field, counter in EXACT_TOTALS.items():
                pairs.append((field, self.totals[field], counter))
        for field, have, counter in pairs:
            want = metrics.get(counter)
            if want is None:
                errs.append(f"{counter} absent from metrics snapshot")
            elif int(want) != int(have):
                errs.append(f"{field}: log total {have} != "
                            f"{counter} {int(want)}")
        return errs


def _load_metrics(path: str) -> Dict[str, float]:
    """A flat registry snapshot from disk; accepts the structured
    (bucketed) form too, flattening histogram summaries."""
    with open(path) as f:
        doc = json.load(f)
    if "counters" in doc and "histograms" in doc:
        flat: Dict[str, float] = {}
        flat.update(doc.get("counters", {}))
        flat.update(doc.get("gauges", {}))
        for name, h in doc.get("histograms", {}).items():
            for k in ("count", "sum", "p50", "p95", "p99"):
                if k in h:
                    flat[f"{name}.{k}"] = h[k]
        return flat
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analytics",
        description="Aggregate a query log into WORKLOAD.json")
    ap.add_argument("path", help="query-log directory (rotated chain) "
                                 "or a single .jsonl file")
    ap.add_argument("--out", default=None,
                    help="where to write WORKLOAD.json (default: "
                         "alongside the log)")
    ap.add_argument("--check-metrics", default=None, metavar="JSON",
                    help="flat describe_metrics() snapshot to verify "
                         "bit-for-bit totals against (exit 1 on any "
                         "mismatch)")
    ap.add_argument("--time-bucket", type=float, default=1.0,
                    help="time-series bucket width in seconds")
    args = ap.parse_args(argv)

    files = query_log_files(args.path)
    if not files:
        print(f"{args.path}: no query log found", file=sys.stderr)
        return 2
    ana = WorkloadAnalyzer(time_bucket_s=args.time_bucket)
    ana.feed_all(iter_query_log(args.path))
    prof = ana.profile()

    out = args.out
    if out is None:
        base = (os.path.dirname(args.path) or "."
                if os.path.isfile(args.path) else args.path)
        out = os.path.join(base, "WORKLOAD.json")
    with open(out, "w") as f:
        json.dump(prof, f, indent=2, sort_keys=False)
        f.write("\n")

    t = prof["totals"]
    print(f"{args.path}: {prof['records']} records "
          f"({prof['queries']} queries) across {len(files)} file(s); "
          f"leaves scanned={t['leaves_scanned']} "
          f"pruned={t['leaves_pruned']} "
          f"(prune_rate={prof['prune_rate']:.3f}) "
          f"scan_bytes={t['scan_bytes']}")
    sl = prof["shard_load"]
    if sl["touches"]:
        print(f"shard load: {sl['touches']} "
              f"max/mean={sl['max_over_mean']:.3f} "
              f"gini={sl['gini']:.3f}")
    if not prof["complete"]:
        print(f"warning: log incomplete — {prof['seq']}",
              file=sys.stderr)
    print(f"workload profile: {out}")

    if args.check_metrics:
        errs = ana.check_against(_load_metrics(args.check_metrics))
        if errs:
            for e in errs:
                print(f"check-metrics: {e}", file=sys.stderr)
            return 1
        checked = ", ".join(sorted(EXACT_TOTALS))
        print(f"check-metrics: OK — {checked} sum bit-for-bit to the "
              f"registry totals")
    return 0


if __name__ == "__main__":
    sys.exit(main())
