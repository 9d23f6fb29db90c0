"""Chrome-trace / Perfetto JSON export and schema validation.

The exporter emits complete-duration events (``"ph": "X"``) with
microsecond ``ts``/``dur``, one per finished span, wrapped in the
object form ``{"traceEvents": [...]}``.  Span attributes plus
``span_id``/``parent_id`` ride in ``args`` so trace viewers and the
validation tooling can reconstruct the span tree and re-sum counter
deltas (e.g. per-wave clwb/fence attribution).

``python -m repro_torch.obs.trace <path>`` validates a trace file and
exits non-zero on schema violations: 1 for an invalid trace, 2 for a
wrong command line.

Ported from ``repro.obs.trace``, whole.  The exporter converts nothing:
every layer of the port records its span attributes as plain Python
values (ints, floats, bools, strings), so ``json.dump`` takes the event
list as it stands.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from .recorder import Recorder


def chrome_trace(recorder: Recorder) -> dict:
    """Convert a recorder's finished spans into Chrome-trace JSON."""
    events = []
    for sp in sorted(recorder.spans, key=lambda s: s.ts):
        args = {k: (int(v) if isinstance(v, bool) else v)
                for k, v in sp.attrs.items()}
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        events.append({
            "name": sp.name,
            "cat": sp.name.split(".", 1)[0],
            "ph": "X",
            "ts": sp.ts / 1000.0,   # ns -> us
            "dur": sp.dur / 1000.0,
            "pid": 1,
            "tid": sp.tid,
            "args": args,
        })
    return {"traceEvents": events}


def write_trace(path: str, recorder: Optional[Recorder] = None) -> dict:
    """Serialize ``recorder`` (default: the global one) to ``path``."""
    if recorder is None:
        from . import RECORDER
        recorder = RECORDER
    obj = chrome_trace(recorder)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return obj


_EVENT_REQUIRED = ("name", "cat", "ph", "ts", "dur", "pid", "tid", "args")


def validate_chrome_trace(obj) -> List[str]:
    """Schema check; returns a list of problems (empty == valid)."""
    errors = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top-level object must be a dict with a 'traceEvents' key"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event[{i}]: not an object")
            continue
        for key in _EVENT_REQUIRED:
            if key not in ev:
                errors.append(f"event[{i}]: missing key {key!r}")
        if ev.get("ph") != "X":
            errors.append(f"event[{i}]: ph must be 'X' "
                          f"(got {ev.get('ph')!r})")
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"event[{i}]: name must be a non-empty string")
        for key in ("ts", "dur"):
            v = ev.get(key)
            if not isinstance(v, (int, float)) or v < 0:
                errors.append(f"event[{i}]: {key} must be a non-negative "
                              f"number (got {v!r})")
        args = ev.get("args")
        if not isinstance(args, dict):
            errors.append(f"event[{i}]: args must be an object")
        elif "span_id" not in args:
            errors.append(f"event[{i}]: args missing 'span_id'")
    # parent links must resolve inside the trace
    ids = {ev["args"]["span_id"] for ev in events
           if isinstance(ev, dict) and isinstance(ev.get("args"), dict)
           and "span_id" in ev["args"]}
    for i, ev in enumerate(events):
        if not (isinstance(ev, dict) and isinstance(ev.get("args"), dict)):
            continue
        parent = ev["args"].get("parent_id")
        if parent is not None and parent not in ids:
            errors.append(f"event[{i}]: parent_id {parent} not in trace")
    return errors


def validate_trace_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable trace ({e})"]
    return validate_chrome_trace(obj)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.trace <trace.json>")
        return 2
    errors = validate_trace_file(argv[0])
    for e in errors:
        print(f"FAIL {e}")
    if not errors:
        with open(argv[0]) as f:
            n = len(json.load(f)["traceEvents"])
        print(f"OK {argv[0]}: {n} events, schema valid")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["chrome_trace", "main", "write_trace", "validate_chrome_trace",
           "validate_trace_file"]
