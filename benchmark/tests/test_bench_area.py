"""The area-lit cell config2.frame on the CPU: the frozen config2 scene
against the port's builder, the emitter order the reference takes from
the program, reference/area_frame.py against the port at a tiny size,
each planted area fault (area_faults.py) failing that comparison, the
cell's manifest entry and its four readers on synthetic traces."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import area_faults
from benchmark.harness import area_scene, manifest, trace
from benchmark.harness.driver import Context, LayerContext
from benchmark.harness.spans import Spans
from mc_path_tracer_tpu_torch.utils.profiling import SpanRecord

ROOT = Path(__file__).resolve().parents[2]
CELL = "config2.frame"
NEW_METRICS = ("area_share.area", "kernels_per_msample.area", "idle_share.area",
               "traversal_roofline.area")
# a camera under the quad, looking up at its emitting face (config2's own
# camera does not see the emitter: no primary ray of its frame hits it)
UP = {"position": [0.0, 0.8, 3.0], "target": [0.0, 2.6, 0.0], "fov_deg": 40.0}

pytestmark = pytest.mark.usefixtures("one_thread")


def spec():
    cell = manifest.load_cell(CELL)
    return cell.scene_module().scene(cell.config)


def drive(size=32, spp=4, pixels=256, camera=None, trace_run=False, seed=2**31 + 21):
    """config2.frame's driver on the CPU at size x size and `spp`, checked
    at `pixels` pixels: (cell, outcome)."""
    cell = manifest.load_cell(CELL)
    cell.config = dict(cell.config, width=size, height=size, spp=spp)
    if camera is not None:
        cell.config["camera"] = camera
    cell.traffic = dict(cell.traffic, check_pixels=pixels)
    ctx = Context(cell=cell, seed=seed, seconds=0.01, trace=trace_run,
                  t_start=time.perf_counter(), device="cpu")
    return cell, cell.driver().run(ctx)


def test_frozen_config2_builds_the_ports_arrays():
    from mc_path_tracer_tpu_torch import configs
    from mc_path_tracer_tpu_torch.models.scene import concat_soa

    port = configs.config2_mis_area_light()[0]
    ours = area_scene.to_program(spec())
    a = concat_soa([o.bake() for o in port.objects])
    b = concat_soa([o.bake() for o in ours.objects])
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or np.array_equal(np.asarray(x), np.asarray(y)), f
    for f in ("material_albedo", "material_roughness", "material_metallic",
              "material_fresnel", "material_emissive"):
        assert np.array_equal(np.asarray(getattr(port, f)), np.asarray(getattr(ours, f))), f
    assert port.env_tex is None and ours.env_tex is None
    assert (port.env_color, port.env_ls) == (ours.env_color, ours.env_ls)
    assert not port.directional and not ours.directional
    assert a.v0.shape[0] == spec().num_triangles == 2320


def test_emitter_order_maps_the_built_scene_back():
    """Each of the built area light's triangles is the description's
    triangle at the same place of the order, and the reference refuses an
    order that is not a permutation of its emitters."""
    from benchmark.reference import area_scene as ref_area_scene

    s = spec()
    sd = area_scene.to_program(s).build("cpu")
    order = area_scene.emitter_order(sd, s)
    assert sorted(order.tolist()) == [2318, 2319]
    rows = area_scene.triangle_rows(s)
    idx = sd.lights.area.tri_idx.long()
    built = np.concatenate([sd.tris.v0[idx].numpy(), sd.tris.e1[idx].numpy(),
                            sd.tris.e2[idx].numpy()], axis=1)
    assert np.array_equal(rows[order], built)
    ref = ref_area_scene.build(s, order, "cpu")
    assert ref.emit_tri.tolist() == order.tolist()
    assert np.array_equal(ref.emit_cdf.numpy(), sd.lights.area.cdf.numpy())
    assert float(ref.total_area) == float(sd.lights.area.total_area)
    for bad in ([2318, 2318], [0, 2319], [2319]):
        with pytest.raises(ValueError, match="permutation"):
            ref_area_scene.build(s, bad, "cpu")


def test_area_work_counts_the_area_estimator():
    from benchmark.drivers import area_frames

    cfg = manifest.load_cell(CELL).config
    w = area_frames.area_work(cfg, 1)
    assert w["pixel_samples"] == 4_194_304 and w["rays"] == 25_165_824
    assert (w["rays_closest"], w["rays_anyhit"]) == (16_777_216, 8_388_608)
    assert (w["dispatches"], w["triangles"]) == (384, 2320)


def test_reference_agrees_with_the_port():
    """32 x 32 at 4 spp and depth 3 on the CPU, the cell's own camera:
    within the cell's limits (the two round alike, so every pixel agrees)."""
    _, out = drive()
    assert out.correct, out.numbers
    assert out.numbers["rad_off_share"] == 0.0 and out.numbers["u8_off_share"] == 0.0


def test_reference_agrees_where_the_camera_sees_the_emitter():
    _, out = drive(camera=UP)
    assert out.correct, out.numbers


@pytest.mark.parametrize("fault,setting", [
    ("area.unbounded", {}),
    ("area.order", {}),
    # the BRDF ray meets the emitter in a few percent of samples: 32 spp
    # give most lit pixels one such hit
    ("area.mis", {"size": 16, "spp": 32}),
    # config2's own camera sees no emitter, so primary emission only shows
    # from below the quad
    ("area.emission", {"camera": UP}),
])
def test_area_faults_fail(monkeypatch, fault, setting):
    area_faults.plant(fault, monkeypatch)
    _, out = drive(seed=2**31 + 22, **setting)
    assert not out.correct, (fault, out.numbers)


def test_manifest_loads_the_cell_and_its_metrics():
    cell = manifest.load_cell(CELL)
    assert cell.chips == 1 and cell.config_name == "config2"
    assert cell.traffic["driver"] == "area_frames"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "mrays_per_s"]
    names = [m["name"] for m in cell.per_layer]
    assert set(NEW_METRICS) <= set(names)
    assert {"scene_build_s", "kernel_load_s"} <= set(names)
    assert not {"kernels_per_msample.frame", "idle_share.frame"} & set(names)
    m = manifest.load_manifest()
    for metric in m["per_layer"]:
        if metric["name"] in NEW_METRICS:
            assert metric["workloads"] == [CELL] and metric["moves"] == "mrays_per_s"


def _ev(kind, name, s, e, thread=1):
    return trace.Event(kind, name, s, e, thread)


def _rec(name, s, e, parent=-1):
    return SpanRecord(name, s, e, 1, parent, {})


def test_readers_on_a_synthetic_trace(monkeypatch):
    """One traced frame of 1,000 ns: two kernels busy 300 ns in all, one
    closest_kernel of 100 ns; spans render > bounce > (area.sample,
    closest, area.hit)."""
    from benchmark.drivers import area_frames
    from benchmark.harness import roofline, stages

    cell = manifest.load_cell(CELL)
    events = [_ev("annotation", trace.MARKER, 0, 1000),
              _ev("kernel", "closest_kernel(float const*)", 100, 200, 0),
              _ev("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 400, 600, 0)]
    work = area_frames.area_work(cell.config, 1)
    ctx = LayerContext(events=events, busy_s=300e-9, window_s=1000e-9, spans=Spans(),
                       work=work)
    read = {n: cell.metric_reader(n).read for n in NEW_METRICS}
    assert read["kernels_per_msample.area"](ctx) == pytest.approx(2 / 4_194_304 * 1e6)
    assert read["idle_share.area"](ctx) == pytest.approx(70.0)
    least = roofline.least_seconds_bytes(roofline.traversal_bytes(
        16_777_216, 8_388_608, 384, 2320))
    assert read["traversal_roofline.area"](ctx) == pytest.approx(100 * least / 100e-9)
    recs = [_rec("mcpt::render", 0, 1000), _rec("mcpt::bounce", 50, 950, 0),
            _rec("mcpt::area.sample", 60, 160, 1), _rec("mcpt::closest", 200, 400, 1),
            _rec("mcpt::area.hit", 500, 550, 1)]
    monkeypatch.setattr(stages, "records", lambda: recs)
    assert read["area_share.area"](ctx) == pytest.approx(15.0)
    # a program without the area spans: no reading, not 0
    monkeypatch.setattr(stages, "records", lambda: recs[:2] + recs[3:4])
    assert read["area_share.area"](ctx) is None
    monkeypatch.setattr(stages, "records", lambda: [])
    assert read["area_share.area"](ctx) is None
    untraced = LayerContext(events=None, busy_s=None, window_s=None, spans=Spans(), work=work)
    assert all(read[n](untraced) is None for n in NEW_METRICS)


def test_traced_run_on_the_cpu_reads_the_area_spans():
    cell, out = drive(size=16, spp=2, pixels=64, trace_run=True)
    assert out.correct, out.numbers
    run = manifest.load_module(ROOT / "benchmark" / "run.py", "bench_run_module")
    got = run.layer_metrics(cell, out.layer)
    assert 0.0 < got["area_share.area"]["value"] < 100.0
    assert got["scene_build_s"]["value"] > 0
    assert "traversal_roofline.area" not in got     # no CUDA kernel on the CPU


def test_area_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.area_frame, benchmark.reference.area_scene; "
            "import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    tops = set(json.loads(out))
    assert not tops & {"mc_path_tracer_tpu_torch", "mc_path_tracer_tpu", "jax", "jaxlib"}


def test_area_reference_sets_tf32_off():
    import torch

    from benchmark.reference import area_frame, area_scene as ref_area_scene
    from benchmark.reference import scene as ref_scene

    s = spec()
    ref = ref_area_scene.build(s, [2319, 2318], "cpu")
    cam = ref_scene.camera(s, 8, 8, "cpu")
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        px = torch.arange(4, dtype=torch.float32)
        from benchmark.reference import rng

        keys = rng.prng_key(1).expand(4, 2)
        out = area_frame.radiance_sum(ref, cam, px, px, keys, 1, 3)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert out.shape == (4, 3) and bool(torch.isfinite(out).all())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_lane_keys_match_the_single_key_streams():
    """The reference's per-lane keys (pixels of several frames traced
    together) draw the streams reference/rng.py draws under one key."""
    import torch

    from benchmark.reference import area_frame, rng

    base = rng.seed_key(2**31 + 9)
    frames = torch.tensor([0, 0, 1, 2, 2, 7])
    pid = torch.tensor([5, 9, 5, 0, 65535, 123], dtype=torch.int32)
    keys = rng.fold_in(base, frames)
    for f in range(8):
        assert torch.equal(keys[frames == f], rng.fold_in(base, f).expand(
            int((frames == f).sum()), 2))
    got = area_frame.lane_uniforms(area_frame.fold_lanes(area_frame.fold_lanes(keys, 3), 2),
                                   pid, 10)
    for i, f in enumerate(frames.tolist()):
        want = rng.pixel_uniforms(rng.fold_in(rng.fold_in(rng.fold_in(base, f), 3), 2),
                                  pid[i:i + 1], 10)
        assert torch.equal(got[i:i + 1], want)
