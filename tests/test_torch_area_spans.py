"""The area light's stage spans and its bounded any-hit counter
(models/integrator.trace_radiance): `mcpt::area.sample` around the light
sample on the emitters and its merge, `mcpt::area.hit` around the BRDF
ray's emitter hit and its merge, each inside its `mcpt::bounce` and
beside the bounce's dispatches, and LAUNCHES["anyhit_bounded"], the
any-hit dispatches that carry a t_max (the benchmark's config2.frame
reads them: area_share.area and PERF.md's stage table).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from mc_path_tracer_tpu_torch import configs
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.ops import rng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
from mc_path_tracer_tpu_torch.utils.profiling import GLOBAL_TIMINGS
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_spans import new_records, traced

pytestmark = pytest.mark.usefixtures("one_thread")

W = H = 16
AREA = ("mcpt::area.sample", "mcpt::area.hit")
DISPATCH = ("mcpt::closest", "mcpt::anyhit")


def built(builder):
    """A config's scene built on the CPU and its camera at W x H."""
    s, cam, _, _ = builder()
    return s.build("cpu"), dataclasses.replace(cam, aspect=W / H).params("cpu")


def render(sd, cam, trace: bool, **cfg):
    """A W x H, 1-spp, depth-3 render: (radiance, the new span records,
    the LAUNCHES counters that moved)."""
    before_recs, before = len(GLOBAL_TIMINGS.records()), dict(LAUNCHES)

    def run():
        return tint.render(sd, cam, W, H, tint.RenderConfig(spp=1, max_depth=3, **cfg),
                           key=rng.prng_key(7), device="cpu").ld

    ld = traced(run)[0] if trace else run()
    moved = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
    return ld, dict(new_records(before_recs)), moved


@pytest.fixture(scope="module")
def config2():
    return built(configs.config2_mis_area_light)


def test_area_spans_nest_inside_each_bounce(config2):
    """One `mcpt::area.sample` and one `mcpt::area.hit` per NEE bounce (2
    of each at depth 3 and 1 spp), each a child of `mcpt::bounce`, neither
    around a closest or any-hit dispatch."""
    _, recs, _ = render(*config2, trace=True)
    names = [r.name for r in recs.values()]
    assert names.count("mcpt::area.sample") == names.count("mcpt::area.hit") == 2
    assert names.count("mcpt::bounce") == 2
    for r in recs.values():
        if r.name in AREA:
            assert recs[r.parent].name == "mcpt::bounce", r
            assert r.launches == {}, r
        if r.name in DISPATCH:
            assert recs[r.parent].name not in AREA, r
    for a in (r for r in recs.values() if r.name in AREA):
        for d in (r for r in recs.values() if r.name in DISPATCH):
            assert not (a.start_ns <= d.start_ns and d.end_ns <= a.end_ns), (a, d)


@pytest.mark.parametrize("accel,extra", [
    ("auto", {}), ("brute", {}), ("dense", {}), ("auto", {"reuse_brdf_ray": True}),
])
def test_bounded_anyhits_are_counted(config2, accel, extra):
    """Each NEE bounce's shadow ray toward the area sample is one bounded
    any-hit dispatch, on every route: 2 per sample at depth 3, counted in
    its `mcpt::anyhit` span.  On the CPU every dispatch is a plain call, so
    the kernel counters `anyhit` and `closest` do not move, as before."""
    _, recs, moved = render(*config2, trace=True, accel=accel, **extra)
    assert moved["anyhit_bounded"] == 2
    assert "anyhit" not in moved and "closest" not in moved
    closest = 3 if extra else 4
    assert moved["plain"] == closest + 2
    bounded = [r for r in recs.values() if r.name == "mcpt::anyhit"]
    assert len(bounded) == 2 and all(r.launches["anyhit_bounded"] == 1 for r in bounded)


def test_spans_leave_the_radiance_bit_equal(config2):
    """The same render traced (spans recording) and untraced."""
    on, recs_on, _ = render(*config2, trace=True)
    off, recs_off, moved = render(*config2, trace=False)
    assert recs_on and not recs_off
    assert moved["anyhit_bounded"] == 2
    assert float(on.abs().sum()) > 0 and torch.equal(on, off)


def test_scene_without_an_emitter_opens_no_area_span():
    """config4's scene (13,826 triangles, an HDR environment, no emitter):
    the fused 2R any-hit carries no t_max, so neither area span opens and
    no bounded dispatch is counted."""
    _, recs, moved = render(*built(configs.config4_roughness_sweep), trace=True)
    names = [r.name for r in recs.values()]
    assert names.count("mcpt::bounce") == 2 and names.count("mcpt::anyhit") == 2
    assert not set(names) & set(AREA)
    assert "anyhit_bounded" not in moved and moved["plain"] == 4
    assert all("anyhit_bounded" not in r.launches for r in recs.values())
