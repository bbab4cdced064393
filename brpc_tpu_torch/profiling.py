"""Reading a torch.profiler trace: what the device did during labelled
host ranges.

Measurement tooling, on no measured path: `chip_smoke.py` reads the
device path's passes with it, and `collective_echo.run_cases` a
profiled mesh case's timed calls (inside each rank).
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import Counter

import torch

# Device activity in a torch.profiler chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host activity: ops, CUDA runtime and driver calls, Python frames.
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
# What `trace_summary` lists: the longest device ops, the longest idle
# gaps, and in each gap the host events with the most own time.
TOP_OPS, TOP_GAPS, TOP_HOST = 10, 3, 4


def profiler(like: torch.Tensor, with_stack: bool = False):
    """A torch.profiler over the host, and over the card when `like`
    lies on one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if like.is_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities, with_stack=with_stack)


def trace_events(prof) -> list:
    """The complete ("X") events of a finished torch.profiler run, read
    from its chrome trace (timestamps and durations in µs, host and
    device on one clock)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]


def _union(spans) -> list:
    """(start, end) spans sorted and merged where they overlap."""
    merged: list = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _clip(spans, windows) -> list:
    return [(max(a, wa), min(b, wb)) for a, b in spans for wa, wb in windows
            if a < wb and wa < b]


def trace_summary(events, window: str, per: int) -> dict:
    """What a profiled run's device did for the host ranges labelled
    `window` (record_function), from `trace_events`:

    - "device_ops": the device ops (kernels, memcpys, memsets) launched
      inside the windows (matched to their launch by the trace's
      correlation ids), the TOP_OPS longest by total time, each with its
      count and ms divided by `per` (for instance the calls);
    - "device_ops_per": all of them, counted, over `per`;
    - "busy_share": the union of their intervals, clipped to the
      windows, over the windows' length (None with no device activity);
    - "idle_gaps": the TOP_GAPS longest spans of the windows with no
      device activity, each with what the host did in it (`_host_in`);
    - "clock_shift_ms": how far the device's timestamps were moved
      forward so that no op starts before its launch (the trace's host
      and device clocks may disagree by that much).
    """
    wins = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"] == window)
    if not wins:
        raise ValueError(f"no host range labelled {window!r} in the trace")
    length = sum(b - a for a, b in wins)
    host = [e for e in events if e.get("cat") in HOST_CATS]
    launched = {e["args"]["correlation"]: e["ts"] for e in host
                if "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    lags = [e["ts"] - launched[c] for e in dev
            if (c := e.get("args", {}).get("correlation")) in launched]
    shift = max(0.0, -min(lags, default=0.0))
    dev = [dict(e, ts=e["ts"] + shift) for e in dev
           if any(a <= launched.get(e.get("args", {}).get("correlation"),
                                    e["ts"] + shift) < b for a, b in wins)]
    ops: dict = {}
    for e in dev:
        n, t = ops.get(e["name"], (0, 0.0))
        ops[e["name"]] = (n + 1, t + e["dur"])
    busy = _union(_clip(((e["ts"], e["ts"] + e["dur"]) for e in dev), wins))
    idle = []
    for wa, wb in wins:
        edges = [wa] + [x for span in busy if wa <= span[0] and span[1] <= wb
                        for x in span] + [wb]
        idle += [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    longest = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP_OPS]
    return {
        "window_ms": length / 1e3,
        "device_ops": [{"name": name[:120], "count": n / per,
                        "ms": t / per / 1e3} for name, (n, t) in longest],
        "device_ops_per": len(dev) / per,
        "busy_share": (sum(b - a for a, b in busy) / length) if dev else None,
        "idle_gaps": [{"ms": (b - a) / 1e3, "at_ms": (a - wins[0][0]) / 1e3,
                       "host": _host_in(host, a, b)}
                      for a, b in sorted(idle, key=lambda g: g[0] - g[1])
                      [:TOP_GAPS]],
        "clock_shift_ms": shift / 1e3,
    }


def _host_in(host, a, b) -> list:
    """What the host did during [a, b): each overlapping host event's
    own time there (its overlap less its children's), summed by name,
    the TOP_HOST most."""
    over = sorted((e for e in host if e["ts"] < b and a < e["ts"] + e["dur"]),
                  key=lambda e: (e.get("tid"), e["ts"], -e["dur"]))
    own: Counter = Counter()
    stack: list = []
    for e in over:
        end = e["ts"] + e["dur"]
        while stack and (stack[-1][0].get("tid") != e.get("tid")
                         or stack[-1][1] <= e["ts"]):
            stack.pop()
        o = min(b, end) - max(a, e["ts"])
        own[e["name"][:120]] += o
        if stack:
            own[stack[-1][0]["name"][:120]] -= o
        stack.append((e, end))
    return [{"name": name, "own_ms": o / 1e3}
            for name, o in own.most_common(TOP_HOST)]
