"""Tracing / profiling utilities.

The reference narrates phases with omp_get_wtime deltas on stdout
(xtree.c:289,320,384,...) and prints a progress line every 2^20 queries
(itree.c:878).  Here:

- PhaseTimer: structured phase timing with the same narration style plus a
  machine-readable summary;
- Tracer: wraps jax.profiler for device traces of the lookup kernels;
- throughput counters (reads/sec/chip) for the pipeline.
"""

from __future__ import annotations

import contextlib
import json
import time


class PhaseTimer:
    """Named phase timers; prints `phase [dt]` like the reference and keeps a
    summary dict for logs/JSON."""

    def __init__(self, quiet: bool = False):
        self.phases: dict[str, float] = {}
        self.counts: dict[str, float] = {}
        self.quiet = quiet

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if not self.quiet:
                print(f"{name} [{dt:.3f}s]")

    def count(self, name: str, n: float):
        self.counts[name] = self.counts.get(name, 0.0) + n

    def rate(self, count_name: str, phase_name: str) -> float:
        dt = self.phases.get(phase_name, 0.0)
        return self.counts.get(count_name, 0.0) / dt if dt else 0.0

    def summary(self) -> dict:
        out = {"phases_s": dict(self.phases), "counts": dict(self.counts)}
        if "reads" in self.counts and "search" in self.phases:
            out["reads_per_sec"] = self.rate("reads", "search")
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


class Tracer:
    """jax.profiler wrapper: `with Tracer("/tmp/trace"): ...` captures a
    device trace viewable in TensorBoard/XProf."""

    def __init__(self, logdir: str | None):
        self.logdir = logdir

    def __enter__(self):
        if self.logdir:
            import jax

            jax.profiler.start_trace(self.logdir)
        return self

    def __exit__(self, *exc):
        if self.logdir:
            import jax

            jax.profiler.stop_trace()
        return False


def busy_and_gaps(events: list[tuple[str, float, float]], top: int = 10) -> dict:
    """Reduce device events (name, start_ns, duration_ns) to: (name, total
    time, count) per op name, largest total first; the busy time (union of
    the intervals); the window from first start to last end; and the `top`
    largest idle gaps as (start_ns, length_ns)."""
    per_op: dict[str, list] = {}
    for name, _, dur in events:
        acc = per_op.setdefault(name, [0.0, 0])
        acc[0] += dur
        acc[1] += 1
    spans = sorted((s, s + d) for _, s, d in events)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s - cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return {
        "top_ops": sorted(((n, t, c) for n, (t, c) in per_op.items()),
                          key=lambda x: -x[1])[:top],
        "busy_ns": busy,
        "window_ns": window,
        "idle_share": 1.0 - busy / window if window else None,
        "gaps": sorted(gaps, key=lambda g: -g[1])[:top],
    }


def _newest_trace(logdir: str):
    """ProfileData of the newest jax.profiler trace under `logdir`."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return ProfileData.from_file(max(paths, key=os.path.getmtime))


def summarize_trace(logdir: str, device_prefix: str = "/device:GPU:0",
                    top: int = 10) -> dict:
    """Summarize the newest jax.profiler trace under `logdir`: busy_and_gaps
    over the kernel events of one device's stream lines, each large gap
    labelled with the innermost host Python frames running at its midpoint
    (host and device events share the trace's clock)."""
    dev, host = [], []
    for plane in _newest_trace(logdir).planes:
        if plane.name == device_prefix:
            for line in plane.lines:
                if line.name.startswith("Stream"):
                    dev += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
        elif plane.name == "/host:CPU":
            for line in plane.lines:
                if line.name == "python":
                    host += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    out = busy_and_gaps(dev, top)
    labelled = []
    for start, length in out["gaps"]:
        mid = start + length / 2
        cover = sorted((d, n) for n, s, d in host if s <= mid <= s + d)
        labelled.append((start, length, [n for _, n in cover[:3]]))
    out["gaps"] = labelled
    out["device"] = device_prefix
    out["num_events"] = len(dev)
    return out


def device_event_counts(logdir: str, substring: str,
                        device_prefix: str = "/device:") -> dict:
    """{device plane: {event name: count}} for the events of the newest
    trace under `logdir` whose name contains `substring` (case-insensitive),
    e.g. "nccl" to see which devices ran collective kernels."""
    out: dict[str, dict[str, int]] = {}
    for plane in _newest_trace(logdir).planes:
        if not plane.name.startswith(device_prefix):
            continue
        counts = out.setdefault(plane.name, {})
        for line in plane.lines:
            for e in line.events:
                if substring.lower() in e.name.lower():
                    counts[e.name] = counts.get(e.name, 0) + 1
    return out
