"""Serving launcher: batched decode loop with a streaming Coconut index.

Drives ``prefill_step`` + ``serve_step`` for --arch (the SMOKE config from
the command line; ``serve`` takes any ``ModelConfig``, so the full configs
run through it too), ingesting every generated step's hidden summary into
a Coconut-LSM and answering recency-window kNN probes — the paper's
streaming index embedded in the serving loop.  The model and the index
run on the card unless the caller passes ``device="cpu"``.

kNN probes are *micro-batched*: each decode step enqueues one probe per
step (sequence 0), and once ``--probe-batch`` probes have accumulated they
are answered together through ``search_exact_batch`` — one amortized SIMS
scan per run for the whole micro-batch.  Every flush runs ``fused_build``
on the card; every probe micro-batch runs ``mindist_batch`` and the cross
form of ``batch_euclid``.

With ``--concurrent`` inserts append to the WAL + buffer and the
background compactor does flushes and merges off-thread, so probe
micro-batches are answered against snapshots (which include the
not-yet-flushed buffer) instead of forcing a flush first.  The run reports
ingest throughput, ingest lag and p50/p99 probe latency.

With ``--data-dir`` the index is durable: an existing manifest is reopened
(decode resumes against everything a previous process committed, plus the
WAL-replayed insert tail), otherwise a fresh store is created there; a
directory that holds the other layout (sharded vs unsharded) is refused.
``--checkpoint-every`` adds step-aligned flushes and commits.

With ``--shards N`` the index is a ``ShardedCoconutLSM`` (z-order key-range
router, per-shard WAL + compactor, probes fanned out cheapest-shard-first);
``--scan-mode mesh`` answers each probe batch with one ``scan_verify``
launch a shard.  ``--cache-mb`` puts a tiered leaf cache over the durable
segments (``unpack_mindist`` on its blocks).  ``--budget-leaves`` and/or
``--deadline-ms`` run the approximate frontier drain and report the
certified gap.  ``--trace-dir``, ``--metrics-interval`` and ``--http-port``
turn on tracing with a query log, periodic registry dumps and the live
``/metrics``, ``/health`` and ``/workload`` endpoints.

Usage: PYTHONPATH=src python -m repro_torch.launch.serve --arch \
           llama3.2-1b --steps 32 --batch 4 --probe-batch 8 --concurrent \
           --data-dir /tmp/coconut-serve --checkpoint-every 16
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import ARCHS, get
from ..core.lsm import CoconutLSM
from ..core.summarization import SummaryConfig, znormalize
from ..core.tree import _device_for
from ..ingest.wal import FSYNC_POLICIES
from ..models.config import ModelConfig
from ..models.steps import make_prefill_step, make_serve_step, pad_cache
from ..models.transformer import Model
from ..obs import (QueryLog, add_probe_observer, describe_metrics,
                   enable_tracing, get_tracer, install_query_log,
                   remove_probe_observer, sample_percentile as _pctl)

__all__ = ["build_parser", "serve", "main"]

SEED = 0


def build_parser() -> argparse.ArgumentParser:
    """The reference launcher's command line, flag for flag."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--knn-window", type=int, default=64)
    ap.add_argument("--probe-batch", type=int, default=8,
                    help="micro-batch size for kNN probes (answered "
                         "together via search_exact_batch)")
    ap.add_argument("--knn-k", type=int, default=1)
    ap.add_argument("--budget-leaves", type=int, default=None,
                    help="approximate probes: cap each micro-batch's "
                         "scan at this many leaf blocks (best-first "
                         "frontier drain with a certified gap report; "
                         "default: exact search)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="approximate probes: wall-clock cutoff per "
                         "probe micro-batch in milliseconds (composes "
                         "with --budget-leaves; default: none)")
    ap.add_argument("--concurrent", action="store_true",
                    help="background compaction: inserts never flush "
                         "inline, probes run against snapshots that "
                         "include the unflushed buffer")
    ap.add_argument("--wal-fsync", choices=FSYNC_POLICIES,
                    default="commit",
                    help="WAL fsync policy when --data-dir is set "
                         "(default: commit — fsync at manifest commits)")
    ap.add_argument("--max-debt", type=int, default=4,
                    help="backpressure threshold: insert blocks once this "
                         "many flush/merge units are outstanding")
    ap.add_argument("--scan-mode", choices=("threaded", "mesh"),
                    default="threaded",
                    help="probe scan policy for --shards > 1: "
                         "'threaded' fans out per-shard pipelines; "
                         "'mesh' pins shard columns on the device and "
                         "answers each probe batch with one scan_verify "
                         "launch a shard (falls back to threaded when a "
                         "batch cannot run on the device; ignored for a "
                         "single-shard index)")
    ap.add_argument("--shards", type=int, default=1,
                    help="key-range-partition the streaming index into N "
                         "CoconutLSM shards behind a z-order router "
                         "(inserts route by interleaved key, probes fan "
                         "out cheapest-shard-first with bsf chaining)")
    ap.add_argument("--data-dir", default=None,
                    help="persist the index here: reopen if a manifest "
                         "exists, else create a new segment store (with "
                         "--shards N: one ShardDirectory of per-shard "
                         "stores under a single atomic top-level "
                         "manifest)")
    ap.add_argument("--cache-mb", type=float, default=0.0,
                    help="tiered leaf cache over the durable segment "
                         "store, in MiB (0 = off; requires --data-dir): "
                         "hot leaves promoted to device tensors, warm "
                         "leaves in a clock-evicted host cache, cold "
                         "leaves on mmap, plus a query-result cache — "
                         "cache.* metrics land in /metrics and the "
                         "final report")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="extra flush + manifest commit every N decode "
                         "steps; the WAL already covers acked inserts "
                         "between commits, so this only bounds replay "
                         "length (0 = no extra checkpoints)")
    ap.add_argument("--trace-dir", default=None,
                    help="enable per-query tracing: write a "
                         "Chrome/Perfetto trace (trace.json) plus a "
                         "rotated structured query log "
                         "(query_log.jsonl) into this directory")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="dump the unified metrics registry "
                         "(describe_metrics) as one JSON line every N "
                         "seconds during the decode loop, and once at "
                         "exit (0 = off)")
    ap.add_argument("--http-port", type=int, default=None,
                    help="serve live observability over HTTP on this "
                         "port (0 = ephemeral): /metrics (Prometheus "
                         "text exposition of the unified registry), "
                         "/health (rolling-window SLO evaluation), "
                         "/workload (live workload-analytics profile)")
    ap.add_argument("--slo-probe-p99-ms", type=float, default=500.0,
                    help="health: probe p99 over the rolling window "
                         "above this is degraded (10x it: critical)")
    ap.add_argument("--slo-max-debt", type=float, default=None,
                    help="health: compaction debt above this is "
                         "degraded (default: 2x --max-debt)")
    return ap


def _open_index(args, icfg: SummaryConfig, dev: torch.device):
    """The streaming index the flags ask for: made fresh or reopened from
    ``--data-dir``.  Returns (index, store or None, tiers or None)."""
    if args.data_dir:
        # refuse to shadow one persisted layout with the other: a
        # sharded dir holds SHARDS.json, an unsharded store MANIFEST.json
        from ..storage.store import MANIFEST_NAME, SHARDS_NAME
        has_single = os.path.exists(
            os.path.join(args.data_dir, MANIFEST_NAME))
        has_sharded = os.path.exists(
            os.path.join(args.data_dir, SHARDS_NAME))
        if args.shards > 1 and has_single:
            raise SystemExit(
                f"{args.data_dir} holds an unsharded index "
                "(MANIFEST.json); rerun without --shards or pick "
                "another --data-dir")
        if args.shards <= 1 and has_sharded:
            raise SystemExit(
                f"{args.data_dir} holds a sharded index (SHARDS.json); "
                "rerun with --shards N or pick another --data-dir")
    tiers = None
    if args.cache_mb > 0:
        if not args.data_dir:
            raise SystemExit("--cache-mb requires --data-dir (the "
                             "tiered cache sits over the durable "
                             "segment store)")
        from ..storage.tiers import TieredLeafStore
        tiers = TieredLeafStore(int(args.cache_mb * (1 << 20)))
    store = None
    if args.shards > 1:
        from ..distributed.sharded_lsm import ShardedCoconutLSM
        from ..storage import ShardDirectory
        if args.data_dir and ShardDirectory(args.data_dir).exists():
            index = ShardedCoconutLSM.open(args.data_dir,
                                           concurrent=args.concurrent,
                                           wal_fsync=args.wal_fsync,
                                           max_debt=args.max_debt,
                                           tiers=tiers,
                                           scan_mode=args.scan_mode,
                                           device=dev)
            print(f"reopened {index.describe()}: {index.n} entries in "
                  f"{len(index.runs)} runs across {index.n_shards} "
                  f"shards (clock={index.clock})")
            if index.n_shards != args.shards:
                print(f"note: --shards {args.shards} ignored — "
                      f"{args.data_dir} is partitioned into "
                      f"{index.n_shards} shards and reopening keeps the "
                      "persisted layout (re-shard via a fresh data dir)")
        else:
            index = ShardedCoconutLSM(icfg, shards=args.shards,
                                      buffer_capacity=64, leaf_size=32,
                                      mode="btp", data_dir=args.data_dir,
                                      concurrent=args.concurrent,
                                      wal_fsync=args.wal_fsync,
                                      max_debt=args.max_debt,
                                      tiers=tiers,
                                      scan_mode=args.scan_mode,
                                      device=dev)
    else:
        if args.scan_mode != "threaded":
            print("note: --scan-mode mesh ignored — the device-resident "
                  "launch shards over an index with --shards > 1")
        if args.data_dir:
            from ..storage import SegmentStore
            store = SegmentStore(args.data_dir)
        if store is not None and store.exists():
            index = CoconutLSM.open(store, concurrent=args.concurrent,
                                    wal_fsync=args.wal_fsync,
                                    max_debt=args.max_debt, tiers=tiers,
                                    device=dev)
            print(f"reopened {store.describe()}: {index.n} entries in "
                  f"{len(index.runs)} runs (clock={index.clock})")
        else:
            index = CoconutLSM(icfg, buffer_capacity=64, leaf_size=32,
                               mode="btp", store=store,
                               concurrent=args.concurrent,
                               wal_fsync=args.wal_fsync,
                               max_debt=args.max_debt, tiers=tiers,
                               device=dev)
    return index, store, tiers


def serve(cfg: ModelConfig, args: argparse.Namespace, *, device=None,
          params=None, prompt: Optional[torch.Tensor] = None,
          frontend: Optional[torch.Tensor] = None,
          on_step: Optional[Callable] = None) -> dict:
    """Run the decode loop of ``cfg`` under the parsed flags ``args``.

    ``device``: the card unless ``"cpu"`` is passed (no CUDA and no such
    request raises).  ``params``: a state dict for ``Model`` (default:
    weights drawn from seed 0).  ``prompt`` ``[B, T]`` and ``frontend``
    ``[B, P, d]``: the inputs (default: drawn on the device from a
    ``torch.Generator`` seeded 0, with ``--batch`` and ``--prompt-len``).
    ``on_step(step, logits, rows)``, where given, sees every decode
    step's logits and the rows ingested for it, and may return the next
    ``[B, 1]`` tokens in place of the argmax.

    Returns ``{"report": the report's key/values, "answers": [(probes,
    dists, ids) for every micro-batch], "wall_s": the decode loop's
    seconds}``.
    """
    dev = _device_for(None, device)
    qlog = None
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        enable_tracing()
        qlog = QueryLog(args.trace_dir)
        install_query_log(qlog)

    model = Model(cfg, device=dev, seed=SEED, params=params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab_unpadded,
                               (args.batch, args.prompt_len),
                               generator=gen, device=dev)
    B, T = prompt.shape
    batch = {"tokens": prompt.to(device=dev, dtype=torch.int64)}
    if cfg.frontend != "none":
        if frontend is None:
            frontend = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                                   generator=gen, device=dev)
        batch["frontend"] = frontend.to(dev)

    prefill = make_prefill_step(model)
    serve_step = make_serve_step(model)
    last, cache = prefill(batch)
    cache = pad_cache(model, cache, extra=args.steps + 1)
    tokens = torch.argmax(last, -1)[:, None]
    del last

    icfg = SummaryConfig(series_len=64, segments=16, bits=8)
    index, store, tiers = _open_index(args, icfg, dev)

    base = T + (cfg.frontend_tokens
                if cfg.frontend != "none" and not cfg.is_encdec else 0)

    budget = None
    if args.budget_leaves is not None or args.deadline_ms is not None:
        from ..query import Budget
        budget = Budget(max_leaves=args.budget_leaves,
                        deadline_ms=args.deadline_ms)

    # live observability endpoint: a workload analyzer fed every probe
    # record (same dict the query log persists), a rolling-window SLO
    # monitor over the registry + engine gauges, and the HTTP scrape
    # surface in front of both
    httpd = monitor = analyzer = None
    if args.http_port is not None:
        from ..obs.analytics import WorkloadAnalyzer
        from ..obs.health import HealthMonitor, Threshold
        from ..obs.httpd import ObsHTTPServer
        analyzer = WorkloadAnalyzer()
        add_probe_observer(analyzer.feed)
        debt_thresh = (args.slo_max_debt if args.slo_max_debt is not None
                       else 2.0 * args.max_debt)
        monitor = HealthMonitor(
            thresholds={
                "probe_p99_ms": Threshold(args.slo_probe_p99_ms,
                                          10.0 * args.slo_probe_p99_ms),
                "compaction_debt": Threshold(debt_thresh,
                                             8.0 * debt_thresh),
            },
            sources={"ingest_lag_rows": index.ingest_lag,
                     "compaction_debt": index.compaction_debt},
            events_dir=args.trace_dir).start()
        httpd = ObsHTTPServer(args.http_port, health=monitor,
                              analyzer=analyzer).start()
        print(f"observability: {httpd.url}/metrics "
              f"{httpd.url}/health {httpd.url}/workload")

    answers = []

    def answer_probes(pending):
        """Answer one probe micro-batch.  Synchronous engines flush first
        (their searches only see runs); concurrent snapshots already cover
        the buffer, so the probe never waits on compaction.  With a
        budget the probes run the approximate frontier drain and the
        info dict carries the per-query certified gap."""
        if not args.concurrent:
            index.flush()
        t0 = time.perf_counter()
        kw = {} if budget is None else {"budget": budget, "mode": "approx"}
        probes = np.stack(pending)
        d, off, st = index.search_exact_batch(
            probes, k=args.knn_k, window=args.knn_window, **kw)
        dt_p = time.perf_counter() - t0
        answers.append((probes, d, off))
        return d, st, dt_p

    def dump_metrics(tag: str) -> None:
        snap = {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in sorted(describe_metrics().items())}
        print(f"metrics[{tag}]: {json.dumps(snap)}")

    pending = []            # accumulated kNN probes (micro-batching)
    probe_lat = []          # seconds per micro-batch
    probes_answered = 0
    last_d = float("nan")
    st = {"partitions_touched": 0}
    rows_ingested = 0
    t0 = time.perf_counter()
    next_dump = (t0 + args.metrics_interval
                 if args.metrics_interval > 0 else None)
    for s in range(args.steps):
        logits, cache = serve_step(cache, tokens, base + s)
        tokens = torch.argmax(logits[:, -1], -1)[:, None]
        h = znormalize(logits[:, -1, :64].float()).cpu().numpy()
        if on_step is not None:
            chosen = on_step(s, logits, h)
            if chosen is not None:
                tokens = chosen.to(device=dev, dtype=torch.int64)
        index.insert(h)
        rows_ingested += len(h)
        pending.append(h[0])          # one probe per step (sequence 0)
        if args.data_dir and args.checkpoint_every \
                and (s + 1) % args.checkpoint_every == 0:
            # periodic durable checkpoint: inline flush+commit for the
            # synchronous engine, a non-blocking commit request for the
            # concurrent one (no drain stall in the decode loop)
            index.checkpoint()
        if len(pending) >= args.probe_batch:
            d, st, dt_p = answer_probes(pending)
            probe_lat.append(dt_p)
            probes_answered += len(pending)
            last_d = float(d[-1, 0])
            pending = []
        if next_dump is not None and time.perf_counter() >= next_dump:
            dump_metrics(f"step={s + 1}")
            next_dump = time.perf_counter() + args.metrics_interval
    dt = time.perf_counter() - t0
    if pending:                       # leftover partial micro-batch
        d, st, dt_p = answer_probes(pending)
        probe_lat.append(dt_p)
        probes_answered += len(pending)
        last_d = float(d[-1, 0])
    lag_at_end = index.ingest_lag()
    if monitor is not None:
        # final evaluation first (flush a last health state + any
        # pending transition event), then stop the samplers
        health_doc = monitor.evaluate()
        print(f"health[exit]: {json.dumps(health_doc['state'])} "
              + " ".join(f"{n}={c['value']}"
                         for n, c in health_doc["checks"].items()))
        monitor.stop()
    if httpd is not None:
        httpd.stop()
    if analyzer is not None:
        remove_probe_observer(analyzer.feed)
        if args.trace_dir:
            with open(os.path.join(args.trace_dir,
                                   "WORKLOAD.json"), "w") as f:
                json.dump(analyzer.profile(), f, indent=2)
                f.write("\n")
    if args.data_dir:
        index.flush()                 # final checkpoint: commit manifests
        print(f"checkpointed "
              f"{store.describe() if store is not None else index.describe()}")
    im = index.ingest.snapshot()
    index.close()
    qps = probes_answered / max(sum(probe_lat), 1e-9)
    mode = "concurrent" if args.concurrent else "inline"
    shard_note = (f" shards touched={st.get('shards_touched', 1)}/"
                  f"pruned={st.get('shards_pruned', 0)}"
                  if args.shards > 1 and isinstance(st, dict) else "")
    # leaf-granular planner observability on the serving path: the last
    # probe batch's leaf accounting
    leaf_note = (f" leaves scanned={st.get('leaves_scanned', 0)}/"
                 f"pruned={st.get('leaves_pruned', 0)}"
                 if isinstance(st, dict) and "leaves_scanned" in st else "")
    # budgeted probes: the last micro-batch's certified gap — how far
    # (at most) the returned k-th distances sit above the exact ones
    gap_note = ""
    if isinstance(st, dict) and st.get("gap") is not None:
        g = np.asarray(st["gap"], np.float32)
        gap_note = (f" gap max={float(g.max()):.4f}/"
                    f"mean={float(g.mean()):.4f}"
                    f"{' budget-exhausted' if st.get('budget_exhausted') else ''}")
    print(f"arch={args.arch} [{mode}]: {args.steps} steps x {B} seqs in "
          f"{dt*1e3:.0f} ms ({args.steps*B/dt:.1f} tok/s); "
          f"index={index.n} entries/{len(index.runs)} runs; "
          f"kNN(window={args.knn_window},k={args.knn_k}) "
          f"{probes_answered} probes in {len(probe_lat)} micro-batches "
          f"of {args.probe_batch} ({qps:.1f} probes/s) last_d={last_d:.4f} "
          f"partitions={st['partitions_touched']}"
          f"{shard_note}{leaf_note}{gap_note}")
    # unified report: every key follows the registry's
    # ``subsystem.metric_unit`` convention
    report = {
        "decode.steps_total": args.steps,
        "decode.throughput_tok_s": round(args.steps * B / dt, 1),
        "probe.count_total": probes_answered,
        "probe.micro_batches_total": len(probe_lat),
        "probe.throughput_qps": round(qps, 1),
        "probe.latency_p50_ms": round(_pctl(probe_lat, 50) * 1e3, 2),
        "probe.latency_p99_ms": round(_pctl(probe_lat, 99) * 1e3, 2),
        "probe.latency_max_ms": (round(max(probe_lat) * 1e3, 2)
                                 if probe_lat else float("nan")),
        "ingest.rows_total": rows_ingested,
        "ingest.throughput_rows_s": round(rows_ingested / dt, 1),
        "ingest.lag_rows": lag_at_end,
        "ingest.bg_flushes_total": im.get("bg_flushes", 0),
        "ingest.bg_merges_total": im.get("bg_merges", 0),
        "ingest.backpressure_waits_total": im.get("backpressure_waits", 0),
        "ingest.wal_bytes_total": im.get("wal_bytes", 0),
    }
    if args.shards > 1:
        from ..obs.registry import get_registry
        _reg = get_registry()
        report["query.mesh_launches_total"] = int(
            _reg.counter("query.mesh_launches_total").value)
        report["query.mesh_fallbacks_total"] = int(
            _reg.counter("query.mesh_fallbacks_total").value)
    if tiers is not None:
        cs = tiers.stats()
        report.update({
            "cache.hits_total": cs["hits"],
            "cache.misses_total": cs["misses"],
            "cache.hit_rate": round(cs["hit_rate"], 4),
            "cache.bytes_saved_total": cs["bytes_saved"],
            "cache.result_hits_total": cs["result_hits"],
            "cache.promotions_total": cs["promotions"],
            "cache.resident_bytes": cs["resident_bytes"],
        })
    print("report: " + " ".join(f"{k}={v}" for k, v in report.items()))
    if args.metrics_interval > 0 or args.trace_dir:
        dump_metrics("exit")
    if args.trace_dir:
        trace_path = os.path.join(args.trace_dir, "trace.json")
        get_tracer().save(trace_path)
        qlog.close()
        # the registry snapshot beside the log: what the analytics CLI
        # cross-checks its bit-exact totals against (--check-metrics)
        with open(os.path.join(args.trace_dir, "metrics.json"),
                  "w") as f:
            json.dump(describe_metrics(buckets=True), f, indent=2)
            f.write("\n")
        print(f"trace: {trace_path} ({len(get_tracer().spans())} spans); "
              f"query log: {qlog.records_written} records in "
              f"{args.trace_dir}")
    return {"report": report, "answers": answers, "wall_s": dt}


def main(argv=None, *, device=None) -> dict:
    """The command line: ``--arch``'s SMOKE config through :func:`serve`
    on ``device`` (the card unless ``"cpu"`` is passed)."""
    args = build_parser().parse_args(argv)
    return serve(get(args.arch, smoke=True), args, device=device)


if __name__ == "__main__":
    main()
