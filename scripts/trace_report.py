"""Per-op time table from a jax.profiler trace — the gprof flat-profile
analogue (the reference archived gprof output naming its hot functions,
profiling/v0_128x128.txt:7-9; this summarises where the GPU step's time
goes instead of hand-waving from totals).

Two modes:

- ``--capture``: run a short 1024x1024 simulation under profiling.trace
  (same hook as ``lbm_tpu --trace DIR``), then summarise the capture.
- ``TRACEDIR`` positional: summarise an existing trace directory (e.g.
  one written by ``python -m lbm_tpu ... --trace DIR``).

The profiler writes Chrome-trace JSON (plugins/profile/*/…trace.json.gz);
this aggregates complete events on the GPU's ``/device:GPU:n`` planes by
op name (self time, gprof-style) and prints the top entries, writing the
table as JSON (``-o``).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def capture(tracedir: str, iters: int) -> None:
    import numpy as np

    from lbm_tpu import jax_cache

    jax_cache.enable()
    from lbm_tpu.obstacles import generate_obstacles
    from lbm_tpu.params import Params
    from lbm_tpu.runner import run_simulation

    params = Params(nx=1024, ny=1024, max_iters=iters, reynolds_dim=10,
                    density=np.float32(0.1), accel=np.float32(0.01),
                    omega=np.float32(1.85))
    obstacles = generate_obstacles(params.nx, params.ny)
    # One untraced run first: the traced region should hold steady-state
    # execution, not the one-off program load.
    run_simulation(params, obstacles, kernel="auto")
    res = run_simulation(params, obstacles, kernel="auto",
                         trace_dir=tracedir)
    print(f"captured: compute={res.timings['compute']:.3f}s "
          f"({params.nx * params.ny * iters / res.timings['compute'] / 1e9:.2f} GLUPS)")


def summarise(tracedir: str, top: int = 25) -> dict:
    paths = sorted(glob.glob(
        os.path.join(tracedir, "**", "*.trace.json.gz"), recursive=True
    )) or sorted(glob.glob(
        os.path.join(tracedir, "**", "*.trace.json"), recursive=True
    ))
    if not paths:
        raise FileNotFoundError(f"no trace.json(.gz) under {tracedir}")
    path = paths[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])

    procs = {}
    threads = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            procs[e.get("pid")] = e.get("args", {}).get("name", "")
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = (
                e.get("args", {}).get("name", "")
            )

    tracks = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        # A device's "XLA Modules" lane is an AGGREGATE over its ops
        # (the whole executable as one span): counting it too would
        # double every second.
        if "Module" in threads.get((e.get("pid"), e.get("tid")), ""):
            continue
        tracks[(e.get("pid"), e.get("tid"))].append(e)

    agg = defaultdict(lambda: [0.0, 0.0, 0])  # self_us, total_us, count
    device_spans = []
    for (pid, _tid), evs in tracks.items():
        proc = procs.get(pid, str(pid))
        if _is_device(proc):
            # Kernels on a GPU stream never nest. Spans that overlap are
            # kernels of one CUDA graph running concurrently, so each
            # counts in full, and the device's busy time is the union.
            for e in evs:
                key = (proc, e.get("name", "?"))
                agg[key][0] += e["dur"]
                agg[key][1] += e["dur"]
                agg[key][2] += 1
                device_spans.append((e["ts"], e["ts"] + e["dur"]))
            continue
        # Host spans NEST (a dispatch span covers its callees), so a
        # flat profile reports SELF time: each span's duration minus its
        # immediate children's.
        # Parents first at equal start times (longer duration = outer).
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [event, child_us]
        for e in evs:
            while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] \
                    <= e["ts"]:
                done, child = stack.pop()
                key = (proc, done.get("name", "?"))
                agg[key][0] += max(0.0, done["dur"] - child)
                agg[key][1] += done["dur"]
                agg[key][2] += 1
            if stack:
                stack[-1][1] += e["dur"]
            stack.append([e, 0.0])
        while stack:
            done, child = stack.pop()
            key = (proc, done.get("name", "?"))
            agg[key][0] += max(0.0, done["dur"] - child)
            agg[key][1] += done["dur"]
            agg[key][2] += 1

    rows = sorted(
        ({"process": p, "op": n, "self_us": round(s, 1),
          "total_us": round(d, 1), "count": c,
          "avg_us": round(d / max(c, 1), 2)}
         for (p, n), (s, d, c) in agg.items()),
        key=lambda r: -r["self_us"],
    )
    # The gprof-flat-profile analogue is the GPU rows; host rows are
    # wrappers (fences, dispatch) and only useful as context.
    dev = [r for r in rows if _is_device(r["process"])]
    host = [r for r in rows if not _is_device(r["process"])]
    busy = _union_us(device_spans)
    window = (max(b for _, b in device_spans) - min(a for a, _ in device_spans)
              if device_spans else 0.0)
    for r in dev:
        # Concurrent kernels can take the column's sum past 100%.
        r["pct_busy"] = round(100 * r["total_us"] / busy, 2) if busy else None
    return {"trace_file": path, "device_busy_us": round(busy, 1),
            "device_window_us": round(window, 1),
            "device_idle_share": (round(1 - busy / window, 4)
                                  if window else None),
            "ops": dev[:top], "host_context": host[:8]}


def _is_device(process: str) -> bool:
    return process.startswith("/device:GPU:")


def _union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tracedir", nargs="?", default="/tmp/lbm_trace")
    ap.add_argument("--capture", action="store_true",
                    help="run a traced 1024x1024 simulation first")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("-o", "--output", default="trace_ops.json")
    args = ap.parse_args()

    if args.capture:
        capture(args.tracedir, args.iters)
    report = summarise(args.tracedir)
    from pathlib import Path
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    print(f"device busy {report['device_busy_us']} us of a "
          f"{report['device_window_us']} us window (idle share "
          f"{report['device_idle_share']})")
    print(f"{'process':<28} {'op':<40} {'total_us':>10} {'count':>7} "
          f"{'avg_us':>9} {'%busy':>6}")
    for r in report["ops"]:
        print(f"{r['process'][:27]:<28} {r['op'][:39]:<40} "
              f"{r['total_us']:>10.1f} {r['count']:>7} {r['avg_us']:>9.2f} "
              f"{(r.get('pct_busy') or 0):>6.2f}")
    return 0


if __name__ == "__main__":
    main()
