"""Validate observability artifacts: traces and query logs.

Run it against a ``trace.json`` that :meth:`Tracer.save` wrote, or a
query-log directory::

    python -m repro_torch.obs.validate TRACE_DIR/trace.json
    python -m repro_torch.obs.validate --query-log TRACE_DIR

Trace mode checks the JSON object format contract (``traceEvents``
list; every event has ``name``/``ph``/``pid``/``tid``; timed events
have numeric ``ts`` and complete events a non-negative ``dur``), that
span ids are unique and every ``parent_id`` resolves to a known span,
that child spans nest inside their parent's time range, and that the
span tree actually covers the serving pipeline: ``probe`` and ``plan``
must be present, and a ``scan`` span whenever any probe actually
scanned leaves (a budget-starved run can legitimately answer from
seeds and pruning alone, touching zero leaves — no scan span then).

Query-log mode (``--query-log <dir-or-file>``) checks sequence
continuity over the rotated chain read oldest-first: every record
carries a ``seq``, seqs are strictly increasing with no duplicates and
no holes (a hole means a rotated file was dropped mid-chain or records
were lost), and every surviving line parses.  A chain whose *oldest*
records were rotated away (first seq > 0) is reported but allowed —
that is the query log's documented bounded-disk behavior, not
corruption.

Both modes exit non-zero with a reason on any violation, so a broken
exporter fails the build instead of producing an unloadable file.
"""
from __future__ import annotations

import json
import sys

REQUIRED_SPANS = ("probe", "plan")
# Perfetto tolerates ~1 us of rounding on exported timestamps.
_SLOP_US = 1.5


def validate(doc: dict) -> list:
    """Return a list of violation strings (empty == valid)."""
    errs = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not events:
        return ["traceEvents is empty"]
    spans = {}
    names = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event[{i}] not an object")
            continue
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                errs.append(f"event[{i}] missing {field!r}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event[{i}] ({ev.get('name')}): non-numeric ts")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event[{i}] ({ev.get('name')}): complete "
                            f"event needs dur >= 0, got {dur!r}")
                continue
            names.add(ev["name"])
            sid = ev.get("args", {}).get("span_id")
            if sid is not None:
                if sid in spans:
                    errs.append(f"duplicate span_id {sid}")
                spans[sid] = ev
    for sid, ev in spans.items():
        pid = ev.get("args", {}).get("parent_id")
        if pid is None:
            continue
        parent = spans.get(pid)
        if parent is None:
            errs.append(f"span {sid} ({ev['name']}): parent_id {pid} "
                        f"not in trace (dropped by the ring buffer?)")
            continue
        if ev["ts"] + _SLOP_US < parent["ts"] or \
                ev["ts"] + ev["dur"] > parent["ts"] + parent["dur"] + _SLOP_US:
            errs.append(f"span {sid} ({ev['name']}) not nested inside "
                        f"parent {pid} ({parent['name']})")
    for want in REQUIRED_SPANS:
        if want not in names:
            errs.append(f"no {want!r} span in trace — pipeline coverage "
                        f"incomplete")
    scanned = any(ev.get("args", {}).get("leaves_scanned", 0)
                  for ev in events
                  if isinstance(ev, dict) and ev.get("ph") == "X"
                  and ev.get("name") == "probe")
    if scanned and "scan" not in names:
        errs.append("probes scanned leaves but no 'scan' span in trace "
                    "— pipeline coverage incomplete")
    return errs


def validate_query_log(path: str) -> list:
    """Sequence-continuity violations for a query-log chain (empty ==
    valid).  ``path`` is a directory holding the rotated chain or one
    ``.jsonl`` file."""
    from .analytics import query_log_files
    errs = []
    files = query_log_files(path)
    if not files:
        return [f"{path}: no query log files found"]
    prev = None
    n = 0
    for p in files:
        with open(p) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # only the final line of the LIVE file may be torn (a
                # crash mid-append); anywhere else is corruption
                if p == files[-1] and i == len(lines) - 1:
                    errs.append(f"{p}: torn tail line (allowed, "
                                f"noting)")
                    continue
                errs.append(f"{p}:{i + 1}: unparseable line")
                continue
            n += 1
            seq = rec.get("seq")
            if seq is None:
                errs.append(f"{p}:{i + 1}: record missing 'seq'")
                continue
            if prev is not None:
                if seq == prev:
                    errs.append(f"{p}:{i + 1}: duplicate seq {seq}")
                elif seq < prev:
                    errs.append(f"{p}:{i + 1}: seq went backwards "
                                f"({prev} -> {seq})")
                elif seq != prev + 1:
                    errs.append(f"{p}:{i + 1}: seq hole "
                                f"({prev} -> {seq}: "
                                f"{seq - prev - 1} records lost)")
            prev = seq
    if n == 0:
        errs.append(f"{path}: no records")
    # informational only — bounded-disk rotation dropping the oldest
    # file is by design, so it must not fail the build
    return [e for e in errs if "(allowed, noting)" not in e]


def _main_query_log(path: str) -> int:
    errs = validate_query_log(path)
    if errs:
        for e in errs[:50]:
            print(f"{path}: {e}", file=sys.stderr)
        print(f"{path}: INVALID query log ({len(errs)} violations)",
              file=sys.stderr)
        return 1
    n = sum(1 for line in _iter_lines(path) if line.strip())
    print(f"{path}: OK ({n} query-log records, seq contiguous)")
    return 0


def _iter_lines(path: str):
    from .analytics import query_log_files
    for p in query_log_files(path):
        with open(p) as f:
            yield from f.read().splitlines()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--query-log":
        return _main_query_log(argv[1])
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate <trace.json>\n"
              "       python -m repro_torch.obs.validate --query-log "
              "<dir-or-file>", file=sys.stderr)
        return 2
    path = argv[0]
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"{path}: unreadable: {e}", file=sys.stderr)
        return 1
    errs = validate(doc)
    nspans = sum(1 for ev in doc.get("traceEvents", [])
                 if isinstance(ev, dict) and ev.get("ph") == "X")
    if errs:
        for e in errs[:50]:
            print(f"{path}: {e}", file=sys.stderr)
        print(f"{path}: INVALID ({len(errs)} violations, {nspans} spans)",
              file=sys.stderr)
        return 1
    print(f"{path}: OK ({nspans} spans)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
