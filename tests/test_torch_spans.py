"""The port's stage spans (utils/profiling.span / spanned) and the
benchmark's readers of them (benchmark/harness/stages.py and the metrics
shade_share.frame, intersect_share.frame, idle_outside_spans.frame,
backward_share.train, kernel_load_s).

A span records only while a torch profiler session records, on
time.time_ns(), the clock of the session's events; with no session it
records nothing and never opens a record_function range; kept spans
(set-up, the train step) keep their totals and last record in every run.
"""

from __future__ import annotations

import statistics
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, stages
from benchmark.harness import trace as htrace
from benchmark.harness.driver import LayerContext
from benchmark.harness.spans import Spans
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere
from mc_path_tracer_tpu_torch.models.scene import Scene
from mc_path_tracer_tpu_torch.ops import rng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
from mc_path_tracer_tpu_torch.parallel.render import make_train_step
from mc_path_tracer_tpu_torch.utils import profiling
from mc_path_tracer_tpu_torch.utils.profiling import GLOBAL_TIMINGS, SpanRecord, Timings, span
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000


def scene():
    """A floor and a 48-triangle sphere under a small HDR environment and
    a directional light."""
    s = Scene()
    env = (np.random.default_rng(5).uniform(0.2, 1.5, (8, 16, 3)) ** 2).astype(np.float32)
    s.set_environment_hdr(env)
    s.add_directional_light((0.3, 1.0, 0.4), color=(1.0, 0.9, 0.8), ls=2.0)
    floor = s.add_material(albedo=(0.6, 0.6, 0.6), roughness=0.8)
    p, n, uv, idx = plane(6.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    ball = s.add_material(albedo=(0.8, 0.4, 0.2), roughness=0.3, metallic=0.4)
    p, n, uv, idx = uv_sphere(0.8, center=(0, 0.8, 0), rings=4, segments=6)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=ball)
    return s


def camera(w, h):
    return PerspectiveCamera(position=np.array([0.0, 1.5, 4.0]), target=np.array([0.0, 0.6, 0.0]),
                             fov_deg=45.0, aspect=w / h).params("cpu")


def traced(fn):
    """Run fn() under the benchmark's profiler session (harness/trace.py):
    (its result, the session's events)."""
    session = htrace.Session("cpu")
    session.start()
    try:
        out = fn()
    finally:
        events = session.stop()
    return out, events


def new_records(before: int) -> list[tuple[int, SpanRecord]]:
    return [(i, r) for i, r in enumerate(GLOBAL_TIMINGS.records()) if i >= before]


# ---------------------------------------------------------------- the span layer


def test_span_edges_sit_on_the_sessions_clock():
    """A span around a matmul contains the matmul's Kineto event, and each
    edge is within 1 ms of it (the median of five tries, so a descheduled
    try cannot decide; every try must contain the event)."""
    a = torch.randn(384, 384)
    (a @ a).sum()

    def tries():
        out = []
        for i in range(5):
            with span("mcpt::clock", ident=i):
                a @ a
            out.append(GLOBAL_TIMINGS.records()[-1])
        return out

    recs, events = traced(tries)
    mms = sorted((e for e in events if e.name == "aten::mm"), key=lambda e: e.start_ns)
    assert len(mms) == len(recs) == 5
    leads, tails = [], []
    for r, e in zip(recs, mms):
        assert r.start_ns <= e.start_ns and e.end_ns <= r.end_ns, (r, e)
        leads.append(e.start_ns - r.start_ns)
        tails.append(r.end_ns - e.end_ns)
    assert statistics.median(leads) < MS and statistics.median(tails) < MS, (leads, tails)


def test_no_session_records_nothing_and_opens_no_range(monkeypatch):
    """Without a profiler session a 64x64 render records no span, and no
    span enters record_function or NVTX (each patched to raise); the kept
    set-up spans still count."""

    def refuse(*args, **kwargs):
        raise AssertionError("a span opened a profiler range")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    before = len(GLOBAL_TIMINGS.records())
    builds = GLOBAL_TIMINGS.counts["mcpt::scene.build"]
    assert not torch.autograd._profiler_enabled()
    film = tint.render(scene(), camera(64, 64), 64, 64, tint.RenderConfig(spp=1, max_depth=2),
                       key=rng.prng_key(1), device="cpu")
    film.to_uint8()
    assert len(GLOBAL_TIMINGS.records()) == before
    assert GLOBAL_TIMINGS.counts["mcpt::scene.build"] == builds + 1
    assert GLOBAL_TIMINGS.last("mcpt::scene.build").parent == -1


def test_spans_nest_with_self_time_and_launches():
    """A traced 16x8 render with sort_rays on: each span's parent is the
    span open around it (render > sample > camera, trace > closest / bounce
    > closest, anyhit > sort, finish_closest), self time is the duration
    less the children's, the one sample pass (both samples of the frame's
    one block) carries (block, first sample, samples), and each span's
    launches are the LAUNCHES counters that moved inside it."""
    sd = scene().build("cpu")
    cfg = tint.RenderConfig(spp=2, max_depth=3, sort_rays=True)
    before = len(GLOBAL_TIMINGS.records())
    plain0, sort0 = LAUNCHES["plain"], LAUNCHES["sort"]
    traced(lambda: tint.render(sd, camera(16, 8), 16, 8, cfg, key=rng.prng_key(3),
                               device="cpu").to_uint8())
    recs = dict(new_records(before))
    names = [r.name for r in recs.values()]
    assert names.count("mcpt::render") == names.count("mcpt::film") == 1
    assert names.count("mcpt::tonemap") == 1
    assert names.count("mcpt::sample") == names.count("mcpt::camera") == 1
    # per pass at depth 3: 2 closest (primary, extension) and 2 fused any-hits
    assert names.count("mcpt::closest") == names.count("mcpt::anyhit") == 2
    assert names.count("mcpt::bounce") == 2
    assert names.count("mcpt::sort") == 4 and names.count("mcpt::finish_closest") == 2
    want_parent = {"mcpt::sample": "mcpt::render", "mcpt::film": "mcpt::render",
                   "mcpt::camera": "mcpt::sample", "mcpt::trace": "mcpt::sample",
                   "mcpt::bounce": "mcpt::trace", "mcpt::anyhit": "mcpt::bounce",
                   "mcpt::sort": ("mcpt::closest", "mcpt::anyhit"),
                   "mcpt::finish_closest": "mcpt::closest",
                   "mcpt::closest": ("mcpt::trace", "mcpt::bounce")}
    thread = threading.get_native_id()
    for i, r in recs.items():
        assert r.thread == thread and r.end_ns >= r.start_ns
        if r.name in ("mcpt::render", "mcpt::tonemap"):
            assert r.parent < before
            continue
        parent = recs[r.parent]
        want = want_parent[r.name]
        assert parent.name in (want if isinstance(want, tuple) else (want,)), (r, parent)
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    assert [r.ident for r in recs.values() if r.name == "mcpt::sample"] == [(0, 0, 2)]
    # self time: the duration less the children's intervals
    spans = stages.clipped(GLOBAL_TIMINGS.records(), 0, 2**63 - 1)
    own = stages.self_ns(spans)
    for i, r in recs.items():
        kids = sum(c.end_ns - c.start_ns for c in recs.values() if c.parent == i)
        assert own[i] == (r.end_ns - r.start_ns) - kids
    # launches moved inside each span
    render = next(r for r in recs.values() if r.name == "mcpt::render")
    assert render.launches == {"plain": 4, "sort": 4}
    assert LAUNCHES["plain"] - plain0 == 5 and LAUNCHES["sort"] - sort0 == 4  # + the tone map
    for r in recs.values():
        if r.name in ("mcpt::closest", "mcpt::anyhit"):
            assert r.launches == {"plain": 1, "sort": 1}
        elif r.name == "mcpt::sort":
            assert r.launches == {"sort": 1}
        elif r.name in ("mcpt::finish_closest", "mcpt::camera", "mcpt::film"):
            assert r.launches == {}
        elif r.name == "mcpt::tonemap":
            assert r.launches == {"plain": 1}


def test_train_step_keeps_its_spans_untraced():
    """An untraced CPU train step keeps its last `mcpt::train.*` records:
    forward and backward inside the step, the backward's launches equal
    to the forward's (every dispatch replayed: one pass of both samples),
    the step's the sum."""
    sd = scene().build("cpu")
    w = h = 8
    cfg = tint.RenderConfig(spp=2, max_depth=2)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    px, py = xs.reshape(-1).float(), ys.reshape(-1).float()
    counts = {n: GLOBAL_TIMINGS.counts[f"mcpt::train.{n}"] for n in ("step", "forward", "backward")}
    before = len(GLOBAL_TIMINGS.records())
    step = make_train_step(cfg, w, h, cfg.spp)
    loss, _ = step(sd, camera(w, h), px, py, torch.full((w * h, 3), 0.5), rng.prng_key(2))
    assert torch.isfinite(loss)
    assert len(GLOBAL_TIMINGS.records()) == before
    whole, fwd, bwd = (GLOBAL_TIMINGS.last(f"mcpt::train.{n}")
                       for n in ("step", "forward", "backward"))
    for n in counts:
        assert GLOBAL_TIMINGS.counts[f"mcpt::train.{n}"] == counts[n] + 1
    assert whole.start_ns <= fwd.start_ns <= fwd.end_ns <= bwd.start_ns <= bwd.end_ns <= whole.end_ns
    assert fwd.launches == bwd.launches == {"plain": 2, "sort": 2}
    assert whole.launches == {"plain": 4, "sort": 4}
    assert 0 < fwd.seconds < whole.seconds


def test_spans_of_many_threads_keep_their_parents(monkeypatch):
    """Eight threads open nested spans at once, recording (the flag a
    session sets is forced on: a session records the threads that inherit
    its state, such as autograd's), with a short switch interval: every
    record is closed, on its own thread, and inside its parent, which is on
    the same thread."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    timings = Timings()
    n_threads, rounds = 8, 150

    def work():
        for i in range(rounds):
            with timings.span("mcpt::outer", ident=i):
                with timings.span("mcpt::inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = timings.records()
    assert len(recs) == 2 * n_threads * rounds and all(r is not None for r in recs)
    assert len({r.thread for r in recs}) == n_threads
    for r in recs:
        if r.name == "mcpt::inner":
            p = recs[r.parent]
            assert p.name == "mcpt::outer" and p.thread == r.thread
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        else:
            assert r.parent == -1
    per_thread = {}
    for r in recs:
        if r.name == "mcpt::outer":
            per_thread.setdefault(r.thread, []).append(r.ident)
    assert all(idents == list(range(rounds)) for idents in per_thread.values())
    timings.clear()
    assert timings.records() == []


# ---------------------------------------------------------------- the readers

WINDOW = (0, 1000)
MAIN, OTHER = 11, 12


def rec(name, start, end, parent=-1, thread=MAIN, launches=None):
    return SpanRecord(name, start, end, thread, parent, launches or {}, None)


# the frame's spans in a window [0, 1000] ns, by index (parent first)
FRAME = [
    rec("mcpt::render", -100, 900),
    rec("mcpt::sample", -50, 880, 0),
    rec("mcpt::camera", -50, 150, 1),       # clipped to [0, 150]: self 150
    rec("mcpt::trace", 150, 880, 1),        # self 730 - 100 - 500 = 130
    rec("mcpt::closest", 200, 300, 3),
    rec("mcpt::sort", 210, 230, 4),
    rec("mcpt::bounce", 300, 800, 3),       # self 500 - 200 = 300
    rec("mcpt::anyhit", 400, 500, 6),
    rec("mcpt::closest", 600, 700, 6),
    rec("mcpt::tonemap", 950, 1100),        # clipped to [950, 1000]
    rec("mcpt::sample", 920, 940, thread=OTHER),
    None,                                   # a span still open
]
# device: kernels [100, 300] and [500, 600], a copy [850, 870], one kernel
# after the window; idle [0, 100] + [300, 500] + [600, 850] + [870, 1000] =
# 680 ns, of which [900, 920] and [940, 950] lie outside every span
DEVICE = [
    htrace.Event("kernel", "k", 100, 300, 0),
    htrace.Event("kernel", "k", 500, 600, 0),
    htrace.Event("memcpy", "Memcpy DtoH", 850, 870, 0),
    htrace.Event("kernel", "k", 1200, 1300, 0),
]
TRAIN = [
    rec("mcpt::train.step", -500, -10),     # before the window: not read
    rec("mcpt::train.backward", -300, -20, 0),
    rec("mcpt::train.step", 0, 1000),
    rec("mcpt::train.forward", 10, 300, 2),
    rec("mcpt::train.backward", 300, 950, 2),
    rec("mcpt::sample", 400, 600, thread=OTHER),
]


def layer(work, device=()):
    events = [htrace.Event("annotation", htrace.MARKER, *WINDOW, MAIN), *device]
    return LayerContext(events=events, busy_s=None, window_s=None, spans=Spans(), work=work)


def with_records(monkeypatch, recs, totals=None):
    t = Timings()
    t._records = list(recs)
    for name, seconds in (totals or {}).items():
        t.totals[name] += seconds
        t.counts[name] += 1
    monkeypatch.setattr(profiling, "GLOBAL_TIMINGS", t)


def reader(name: str):
    return manifest.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name, records, work, device, want", [
    ("shade_share.frame", FRAME, {"pixel_samples": 1}, DEVICE, 58.0),
    ("intersect_share.frame", FRAME, {"pixel_samples": 1}, DEVICE, 30.0),
    ("idle_outside_spans.frame", FRAME, {"pixel_samples": 1}, DEVICE, 100.0 * 30 / 680),
    ("backward_share.train", TRAIN, {"steps": 1}, (), 65.0),
])
def test_reader_on_known_spans(monkeypatch, name, records, work, device, want):
    with_records(monkeypatch, records)
    assert reader(name).read(layer(work, device)) == pytest.approx(want, rel=1e-12)


def test_kernel_load_reader_sums_the_kept_loads(monkeypatch):
    with_records(monkeypatch, [], {"mcpt::kernels.load": 1.5, "mcpt::native.load": 0.25,
                                   "mcpt::scene.build": 9.0})
    assert reader("kernel_load_s").read(layer({})) == pytest.approx(1.75)
    with_records(monkeypatch, [], {"mcpt::native.load": 0.125})
    assert reader("kernel_load_s").read(layer({})) == pytest.approx(0.125)


@pytest.mark.parametrize("name", ["shade_share.frame", "intersect_share.frame",
                                  "idle_outside_spans.frame", "backward_share.train",
                                  "kernel_load_s"])
def test_reader_finds_nothing_in_a_program_without_spans(monkeypatch, name):
    """A program whose registry has no spans (the parent of this change)
    gives no reading, and no error, traced or not."""

    class Bare:   # the registry of a program without spans
        totals: dict = {}
        counts: dict = {}

    monkeypatch.setattr(profiling, "GLOBAL_TIMINGS", Bare())
    work = {"pixel_samples": 1, "steps": 1}
    assert reader(name).read(layer(work, DEVICE)) is None
    untraced = LayerContext(events=None, busy_s=None, window_s=None, spans=Spans(), work=work)
    assert reader(name).read(untraced) is None


@pytest.mark.parametrize("name", ["shade_share.frame", "intersect_share.frame",
                                  "idle_outside_spans.frame", "backward_share.train"])
def test_reader_skips_other_cells_work(monkeypatch, name):
    """A frame reader reads nothing in a train cell and the reverse."""
    with_records(monkeypatch, FRAME + TRAIN)
    other = {"steps": 1} if name.endswith(".frame") else {"pixel_samples": 1}
    assert reader(name).read(layer(other, DEVICE)) is None
