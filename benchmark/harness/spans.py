"""The harness's own spans on the host clock: (name, start, end) in
seconds of time.perf_counter(), kept in memory for the run."""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    def __init__(self):
        self.items: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block; `sync` (a callable) runs before the end is read,
        so device work the block queued is inside the span."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.items.append(Span(name, t0, time.perf_counter()))

    def named(self, name: str) -> list[Span]:
        return [s for s in self.items if s.name == name]

    def total(self, name: str) -> float:
        return sum(s.seconds for s in self.named(name))
