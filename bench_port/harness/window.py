"""The measured window: a closed-loop sweep.

Host spans around the calls into the program (``power_map``) and the wait
for the card (``sync``) are ``torch.profiler.record_function`` ranges, on
the profiler's clock, in the traced window; ``perf_counter`` intervals in
the untraced window that a traced run measures first (the profiler slows
the host's dispatch, so host times are read there); and nothing otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class Window:
    maps: int            # maps completed
    seconds: float       # first dispatch to the last synchronise
    failed: int
    kept: dict           # map index -> (transmitter row, map)
    reference_s: float = 0.0  # the check's reference, after the window
    setup_marks: dict = dataclasses.field(default_factory=dict)  # s from process start


class _Clock:
    __slots__ = ("out", "t")

    def __init__(self, out: list):
        self.out = out

    def __enter__(self):
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        self.out.append((self.t, time.perf_counter()))


class Spans:
    """``mode``: None (no spans), ``"profiler"`` or ``"clock"`` (kept in
    :attr:`clock`, span name -> ``[(start_s, end_s)]``)."""

    def __init__(self, mode=None):
        self.mode = mode
        self.clock = {}

    def __call__(self, name: str):
        if self.mode == "profiler":
            return torch.profiler.record_function(f"bench.{name}")
        if self.mode == "clock":
            return _Clock(self.clock.setdefault(name, []))
        return contextlib.nullcontext()


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(program, rows: torch.Tensor, seconds: float, sync_every: int, keep: int,
                uniforms: np.ndarray, span: Spans, first: int = 0) -> Window:
    """Maps of ``rows`` in turn from row ``first``, ``sync_every``
    dispatched ahead between synchronisations, until ``seconds`` have
    passed at a synchronisation.  ``keep`` maps are kept for the check, a
    uniform sample of all the window's maps (reservoir sampling on
    ``uniforms``)."""
    kept, failed, i = {}, 0, 0
    n = rows.shape[0]
    t0 = time.perf_counter()
    while True:
        for _ in range(sync_every):
            tx = rows[(first + i) % n]
            try:
                with span("power_map"):
                    out = program(tx)
            except RuntimeError:
                failed += 1
                out = None
            slot = i if i < keep else int(uniforms[i % n] * (i + 1))
            if slot < keep:
                kept[slot] = (i, tx, out)
            i += 1
        with span("sync"):
            _synchronize(program.device)
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    return Window(maps=i, seconds=t1 - t0, failed=failed,
                  kept={j: (tx, out) for j, tx, out in kept.values()})

