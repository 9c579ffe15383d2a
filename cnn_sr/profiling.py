"""Profiling: per-stage timing breakdown + optional XLA trace capture.

Reproduces the reference's ``profile`` mode UX: the reference creates its
CL queue with profiling enabled and accumulates per-kernel execution time
from event timestamps, dumped at teardown and ranked by profile.py
(Kernel.cpp:108-116, Context.cpp:90-96, profile.py:9-18,47-53).

On an XLA device individual "kernels" are fused XLA ops, so the
equivalent granularity is pipeline *stages* (luma extract+normalize, forward, swap,
train step, ...). ``StageProfiler`` times stages with
``block_until_ready`` walls and prints the same ranked percent breakdown.
Set ``profile_dir`` to also capture a ``jax.profiler`` trace for op-level
analysis in TensorBoard/Perfetto (the deep equivalent of the per-kernel
timestamps).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import jax


class StageProfiler:
    """Accumulates wall time per named stage; prints a ranked breakdown."""

    def __init__(self, enabled: bool = True, profile_dir: Optional[str] = None):
        self.enabled = enabled
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._trace_dir = profile_dir
        self._tracing = False

    def start_trace(self):
        if self._trace_dir and not self._tracing:
            jax.profiler.start_trace(self._trace_dir)
            self._tracing = True

    def stop_trace(self):
        if self._tracing:
            jax.profiler.stop_trace()
            self._tracing = False

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and block on its output under stage ``name``."""
        if not self.enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        out = jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        return out

    def report(self, log=print):
        """Ranked per-stage share, like profile.py's kernel breakdown."""
        if not self.enabled or not self.totals:
            return
        total = sum(self.totals.values())
        log("---- stage profile ----")
        for name, t in sorted(self.totals.items(), key=lambda kv: kv[1]):
            log(
                f"{t:8.4f}s ({t * 100 / total:5.2f}%) x{self.counts[name]:<5d} - {name}"
            )
        log(f"Total measured time: {total:.4f}s")


def op_shares(trace_dir: str):
    """Aggregate per-XLA-op device time from the newest captured trace.

    The automated analog of the reference's ranked per-kernel table
    (Kernel.cpp:108-116 accumulates cl_event times; profile.py:9-18
    ranks them) — no TensorBoard round-trip: parse the Chrome-format
    ``*.trace.json.gz`` jax.profiler writes and sum "X" duration events
    on the XLA execution lanes. Lane selection covers both backends: on
    a device pid (``/device:...``) its "XLA Ops" lanes where the trace
    has them, else its CUDA stream lanes ("Stream #N(...)", one per
    stream, as GPU traces name them); on the CPU backend the
    ``tf_XLAPjRtCpuClient`` executor threads.

    Returns ``[(op_name, total_us, count)]`` ranked by time, or ``[]``
    if no trace file is found.
    """
    import glob
    import gzip
    import json
    import os

    traces = glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.trace.json.gz"))
    if not traces:
        return []
    newest = max(traces, key=os.path.getmtime)
    with gzip.open(newest, "rt") as f:
        events = json.load(f).get("traceEvents", [])

    pid_names, tid_names = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e["pid"], e["tid"])] = e["args"]["name"]

    # device pids whose trace carries "XLA Ops" lanes: their stream
    # lanes hold the same kernels again, so only the XLA Ops lanes count
    op_lane_pids = {pid for (pid, _), lane in tid_names.items()
                    if lane.startswith("XLA Ops")}

    def is_xla_lane(e):
        proc = pid_names.get(e.get("pid"), "")
        lane = tid_names.get((e.get("pid"), e.get("tid")), "")
        if proc.startswith("/device:"):
            if e.get("pid") in op_lane_pids:
                return lane.startswith("XLA Ops")
            return lane.startswith("Stream") or lane == ""
        # CPU backend: only the PjRt client threads EXECUTE ops; the
        # tf_xla-cpu-codegen thread hosts compilation passes
        return "XLAPjRtCpuClient" in lane

    skip_prefixes = ("end: ", "ThunkExecutor", "ThreadpoolListener",
                     "EndRegion", "StartRegion")
    lanes: dict = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or not e.get("dur"):
            continue
        name = e.get("name", "")
        if name.startswith(skip_prefixes):
            continue
        if not is_xla_lane(e):
            continue
        lanes[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), float(e["dur"]), name))

    # Events on one lane nest (a `while` wrapper spans its body's convs
    # on the CPU execution threads) — charge each op its SELF time so
    # shares sum to 100% instead of double-counting control-flow spans.
    totals: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for lane_events in lanes.values():
        lane_events.sort(key=lambda r: (r[0], -r[1]))
        self_time = [dur for _, dur, _ in lane_events]
        stack: list = []  # (end_ts, index), innermost open span last
        for i, (ts, dur, _name) in enumerate(lane_events):
            while stack and ts >= stack[-1][0] - 1e-9:
                stack.pop()
            if stack:
                self_time[stack[-1][1]] -= dur
            stack.append((ts + dur, i))
        for (_, _, name), st in zip(lane_events, self_time):
            totals[name] += max(st, 0.0)
            counts[name] += 1
    return sorted(
        ((n, t, counts[n]) for n, t in totals.items()),
        key=lambda row: -row[1])


def report_op_shares(trace_dir: str, log=print, top: int = 25):
    """Print the ranked per-op device-time table (reference profile.py UX)."""
    rows = op_shares(trace_dir)
    if not rows:
        log(f"(no profiler trace found under {trace_dir})")
        return
    total = sum(t for _, t, _ in rows)
    log("---- op profile (device time) ----")
    for name, t, cnt in rows[:top]:
        log(f"{t / 1e3:9.3f}ms ({t * 100 / total:5.2f}%) x{cnt:<6d} - {name}")
    rest = rows[top:]
    if rest:
        t = sum(r[1] for r in rest)
        log(f"{t / 1e3:9.3f}ms ({t * 100 / total:5.2f}%)         - "
            f"({len(rest)} more ops)")
    log(f"Total device op time: {total / 1e3:.3f}ms")


def print_device_memory(log=print):
    """Per-device memory accounting — the analog of the reference's
    Context::print_app_memory_usage (Context.cpp:132-149)."""
    import jax

    for d in jax.local_devices():
        stats = None
        try:
            stats = d.memory_stats()
        except Exception:
            pass
        if not stats:
            log(f"[{d}] memory stats unavailable")
            continue
        in_use = stats.get("bytes_in_use", 0)
        peak = stats.get("peak_bytes_in_use", 0)
        limit = stats.get("bytes_limit", 0)
        log(
            f"[{d}] device memory: {in_use / 1e6:.1f} MB in use, "
            f"peak {peak / 1e6:.1f} MB"
            + (f", limit {limit / 1e6:.1f} MB" if limit else "")
        )
