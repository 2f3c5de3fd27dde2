"""The traced run: a ``torch.profiler`` capture of the window, reduced to
what the per-layer readers and the result's ``device``/``breakdown`` read.

Kernels are split by who launched them: a kernel whose launch call lies
inside a PyTorch operator (an ``aten::`` range; the benchmark drives the
program from one thread) is PyTorch's, every other kernel is the program's
own.  The rule reads the launches, not the kernels' names.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Plain:
    """The untraced window that a traced run measures before its traced
    one, with the same mix: its maps, seconds and ``perf_counter`` spans
    (span name -> ``[(start_s, end_s)]``)."""

    maps: int
    seconds: float
    spans: dict


@dataclasses.dataclass
class Trace:
    maps: int                 # maps of the traced window
    t0: float                 # its start and end, host wall clock (s)
    t1: float
    spans: dict               # bench span name -> [(start_s, end_s)]
    kernels: list             # (name, start_s, end_s, launched by PyTorch)
    copies: list              # (name, start_s, end_s): memcpy and memset
    least_s: Optional[float]  # the map's least time on the card (roofline)
    plain: Optional[Plain] = None  # the untraced window before it

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> np.ndarray:
        """``[n, 2]``: the merged intervals of the window in which a kernel
        or copy ran."""
        iv = _merge([(s, e) for _, s, e, *_ in (*self.kernels, *self.copies)])
        return np.clip(iv, self.t0, self.t1)

    def busy_s(self) -> float:
        b = self.busy()
        return float(np.sum(b[:, 1] - b[:, 0]))


def _merge(intervals) -> np.ndarray:
    """``[n, 2]``: the union of ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


@contextlib.contextmanager
def capture(on: bool):
    """Profile the block (CPU and CUDA) when ``on``; yields a holder whose
    ``events`` are the profiler's, and whose ``t0``/``t1`` bound the block
    on the host clock."""
    holder = type("Capture", (), {})()
    holder.events = None
    if not on:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        holder.t0 = time.time()
        yield holder
        holder.t1 = time.time()
    holder.events = prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def reduce(events, t0: float, t1: float, maps: int, least_s: Optional[float],
           plain: Optional[Plain] = None) -> Trace:
    """The window's spans, kernels and copies, in seconds of the host
    clock (the profiler's timestamps are wall-clock nanoseconds)."""
    spans, aten, launches = defaultdict(list), [], {}
    device = []
    for e in events:
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        name = e.name()
        if name.startswith("bench."):
            # A benchmark span; the profiler shows it on the device's
            # timeline too, where it is no operation.
            if not _is_device(e):
                spans[name[len("bench."):]].append((s, s + d))
        elif _is_device(e):
            device.append((name, s, s + d, e.correlation_id()))
        elif name.startswith("aten::"):
            aten.append((s, s + d))
        elif "Launch" in name:
            launches[e.correlation_id()] = s
    ops = _merge(aten)

    def in_torch_op(at: float) -> bool:
        k = int(np.searchsorted(ops[:, 0], at, side="right")) - 1
        return k >= 0 and at <= ops[k, 1]

    kernels, copies = [], []
    for name, s, e, corr in device:
        low = name.lower()
        if "memcpy" in low or "memset" in low:
            copies.append((name, s, e))
            continue
        launch = launches.get(corr)
        kernels.append((name, s, e, launch is not None and in_torch_op(launch)))
    return Trace(maps=maps, t0=t0, t1=t1, spans=dict(spans), kernels=kernels,
                 copies=copies, least_s=least_s, plain=plain)


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the card's idle time
    summed by what the host was doing: the innermost benchmark span at each
    gap's midpoint (``harness`` outside every span)."""
    by_op = defaultdict(float)
    for name, s, e, *_ in (*tr.kernels, *tr.copies):
        by_op[name[:NAME_CHARS]] += e - s
    busy = tr.busy()
    gaps = defaultdict(float)
    if busy.shape[0] > 1:
        starts, ends = busy[1:, 0], busy[:-1, 1]
        names = sorted(tr.spans)
        flat = sorted((s, e, n) for n in names for s, e in tr.spans[n])
        keys = [s for s, _, _ in flat]
        for g0, g1 in zip(ends, starts):
            mid = 0.5 * (g0 + g1)
            k = bisect.bisect_right(keys, mid)
            tag = "harness"
            for s, e, n in reversed(flat[max(0, k - 8):k]):
                if s <= mid <= e:
                    tag = n
                    break
            gaps[tag] += g1 - g0
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, v] for n, v in top], "idle_gaps": [[n, v] for n, v in idle]}
