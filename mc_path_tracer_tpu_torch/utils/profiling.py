"""Profiling and observability (port of mc_path_tracer_tpu/utils/profiling.py):
scoped wall-clock timers with a global registry, ray-throughput accounting
for renders, and a device trace.

`device_trace` takes the place of the JAX package's `xla_trace`: a
torch.profiler session over CPU and CUDA activities that writes a Chrome
trace into `log_dir`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device


@dataclass
class Timings:
    """Registry of named wall-clock sections."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name:30s} {self.totals[name]*1e3:9.2f} ms  x{self.counts[name]}"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(
            {k: {"total_s": self.totals[k], "count": self.counts[k]}
             for k in self.totals}
        )


GLOBAL_TIMINGS = Timings()


def rays_per_sample(max_depth: int) -> int:
    """Traced rays per pixel-sample at depth D: 1 camera + (D-2) extension
    closest-hits and 2*(D-1) any-hits (see models/integrator.py)."""
    return 1 + max(max_depth - 2, 0) + 2 * max(max_depth - 1, 0)


@dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_depth: int
    seconds: float

    @property
    def total_rays(self) -> int:
        return self.width * self.height * self.spp * rays_per_sample(self.max_depth)

    @property
    def mrays_per_s(self) -> float:
        return self.total_rays / max(self.seconds, 1e-9) / 1e6

    def __str__(self):
        return (
            f"{self.width}x{self.height} {self.spp}spp depth{self.max_depth}: "
            f"{self.seconds:.3f}s  {self.mrays_per_s:.1f} Mrays/s"
        )


@contextlib.contextmanager
def device_trace(log_dir: str, device=DEFAULT_DEVICE):
    """Capture a CPU + CUDA trace of the block (torch.profiler) and write it
    as a Chrome trace, `log_dir`/trace.json.  The card is synchronised
    before the profiler stops, so the trace holds every kernel the block
    queued.  device="cpu" traces CPU activity only; the default, the card,
    raises without one."""
    from torch.profiler import ProfilerActivity, profile

    on_card = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
