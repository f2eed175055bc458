"""The harness on the CPU: the manifest and its files found by name (and
new ones placed beside them), the end-to-end arithmetic, the trace
arithmetic, the result line, the refusals, the JAX guard, the reference's
independence, and the frozen scenes against the port's builders."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import compare, guard, manifest, roofline, stats, trace
from benchmark.harness.driver import Check, Context, Outcome
from benchmark.harness.spans import Spans
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.usefixtures("one_thread")


def test_manifest_names_files_that_exist():
    m = manifest.load_manifest()
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.scene_module().scene(cell.config).num_triangles == cell.config["triangles"]
        assert hasattr(cell.driver(), "run")
        for metric in cell.per_layer:
            assert hasattr(cell.metric_reader(metric["name"]), "read")
        assert {"setup_s"} <= {x["name"] for x in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for c in m["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_new_config_mix_and_metric_are_picked_up(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = manifest.load_cell("tiny.frame", root=root)
    assert cell.config["width"] == 12 and cell.traffic["check_pixels"] == 48
    assert cell.scene_module().scene(cell.config).num_triangles == 194
    names = [m["name"] for m in cell.per_layer]
    assert "units_traced" in names and "scene_build_s" in names
    assert cell.metric_reader("units_traced").read(type("C", (), {"work": {"units": 3}})) == 3.0
    assert "mrays_per_s" in [m["name"] for m in cell.end_to_end]


def test_rate_counts_all_work_over_all_time_with_a_stall():
    frames = [1.0, 1.0, 5.0, 1.0]      # one frame stalls
    ends = np.cumsum(frames)
    rate = stats.rate_per_s(4 * 100, 0.0, float(ends[-1]))
    assert rate == pytest.approx(400 / 8.0)
    assert rate < 100 / np.median(frames)   # a median of frames would hide the stall
    assert stats.nominal_rays(1920, 1080, 4, 5) == 99_532_800
    assert stats.rays_per_sample(3) == 6


def test_p90_and_the_count_beyond_it():
    lat = [float(x) for x in range(1, 101)]
    assert stats.percentile(lat, 90) == pytest.approx(90.1)
    assert stats.beyond(lat, 90) == 10
    assert stats.percentile([3.0], 90) == 3.0


def _ev(kind, name, s, e, thread=1):
    return trace.Event(kind, name, s, e, thread)


def test_idle_share_and_gaps_on_a_synthetic_trace():
    events = [
        _ev("annotation", trace.MARKER, 0, 100),
        _ev("op", "aten::add", 0, 30), _ev("op", "aten::mul", 40, 90),
        _ev("op", "aten::empty", 45, 50),
        _ev("kernel", "k1", 10, 20, 0), _ev("kernel", "k2", 15, 25, 0),
        _ev("memcpy", "Memcpy DtoH", 60, 70, 0),
        _ev("device_annotation", trace.MARKER, 0, 100, 0),
    ]
    lo, hi = trace.window_bounds(events)
    assert (lo, hi) == (0, 100)
    busy = trace.busy_s(events, lo, hi)
    assert busy == pytest.approx(25e-9)          # [10, 25] and [60, 70]
    assert trace.idle_share(busy, 100e-9) == pytest.approx(0.75)
    assert trace.kernel_count(events) == 2
    gaps = dict((k, v) for k, v in trace.idle_gaps(events, lo, hi))
    # [0, 10) under add, [25, 60) opens under add (until 30), [70, 100) under mul
    assert gaps["aten::add"] == pytest.approx(45e-9)
    assert gaps["aten::mul"] == pytest.approx(30e-9)
    launch = _ev("runtime", "cudaLaunchKernel", 72, 80)
    gaps = dict(trace.idle_gaps([*events, launch], lo, hi))
    assert "cudaLaunchKernel" not in gaps and gaps["aten::mul"] == pytest.approx(30e-9)
    only_runtime = [e for e in events if e.kind != "op"] + [_ev("runtime", "cudaMemcpyAsync", 20, 65)]
    gaps = dict(trace.idle_gaps(only_runtime, lo, hi))
    assert gaps["cudaMemcpyAsync"] == pytest.approx(35e-9)    # [25, 60) opens inside the copy
    assert gaps[trace.IDLE_HOST] == pytest.approx(40e-9)      # [0, 10) and [70, 100)
    top = trace.top_device_ops(events)
    assert [n for n, _ in top] == ["k1", "k2", "Memcpy DtoH"]
    by_name = trace.classify
    assert by_name("closest_kernel(float const*)", True) == "kernel"
    assert by_name("Memcpy DtoH (Device -> Pinned)", True) == "memcpy"
    assert by_name(trace.MARKER, True) == "device_annotation"
    assert by_name(trace.MARKER, False) == "annotation"
    assert by_name("cudaLaunchKernel", False) == "runtime"
    assert by_name("aten::add", False) == "op"


def test_traversal_bytes_from_shapes():
    w = {"rays_closest": 10, "rays_anyhit": 20, "dispatches": 2, "triangles": 5}
    got = roofline.traversal_bytes(**w)
    assert got == 10 * 40 + 20 * 33 + 2 * 5 * 36
    assert roofline.kernel_named("closest_kernel(float const*, int)", "closest_kernel")
    assert roofline.kernel_named("void anyhit_kernel<4>(float*)", "anyhit_kernel")
    assert not roofline.kernel_named("dense_closest_kernel(float const*)", "closest_kernel")
    assert roofline.kernel_named(
        "(anonymous namespace)::closest_kernel(float const*, int, float4 const*, int)",
        "closest_kernel")
    assert not roofline.kernel_named("void at::native::elementwise_kernel<128, 2>(int)",
                                     "closest_kernel")


def test_last_line_has_the_contract_keys(monkeypatch):
    from benchmark.harness import card

    run = manifest.load_module(ROOT / "benchmark" / "run.py", "bench_run_module")

    monkeypatch.setattr(card, "device_entry", lambda count, peak: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count,
        "memory_peak_bytes": peak})
    cell = manifest.load_cell("bench.frame")
    out = Outcome(e2e={"setup_s": 3.0, "mrays_per_s": 9.5}, checks=[Check("x", 0.1, 0.2)],
                  attempted=4, failed=0, memory_peak_bytes=123)
    line = run.result_line(cell, out, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["metrics"]["mrays_per_s"] == {"value": 9.5, "unit": "Mrays/s"}
    assert line["checks"] == {"x": {"value": 0.1, "limit": 0.2}}
    assert line["correct"] is True
    out.checks.append(Check("y", float("nan"), 1.0))
    assert run.result_line(cell, out, trace=False)["correct"] is False


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "bench.frame",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "refused" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    cannot run (here it is refused for want of a card first; on the card,
    for want of the program)."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bench.frame", "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_jax_guard_compares_whole_top_level_names():
    mods = {"mc_path_tracer_tpu_torch", "mc_path_tracer_tpu_torch.models.scene", "numpy",
            "jaxtyping", "flaxen.x"}
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods | {"jax.numpy", "mc_path_tracer_tpu.ops", "flax"}) == [
        "flax", "jax.numpy", "mc_path_tracer_tpu.ops"]


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in {"benchmark", "torch", "numpy", "math", "__future__",
                                           "typing"}, (path.name, n)
                if n.startswith("benchmark."):
                    assert n.startswith("benchmark.reference"), (path.name, n)
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.frame, "
            "benchmark.reference.train, benchmark.reference.scene, benchmark.reference.preview; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"mc_path_tracer_tpu_torch", "mc_path_tracer_tpu", "jax", "jaxlib"}


@pytest.mark.parametrize("config,builder", [
    ("bench", "mc_path_tracer_tpu_torch.bench:build_bench_scene"),
    ("config4", "mc_path_tracer_tpu_torch.configs:config4_roughness_sweep"),
])
def test_frozen_scene_builds_the_ports_arrays(config, builder):
    import importlib

    from mc_path_tracer_tpu_torch.models.scene import concat_soa

    from benchmark.harness.scene import to_program

    mod, fn = builder.split(":")
    port = getattr(importlib.import_module(mod), fn)()
    port = port[0] if isinstance(port, tuple) else port
    cell_cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    spec = manifest.load_module(ROOT / "benchmark" / "configs" / f"{config}.py").scene(cell_cfg)
    ours = to_program(spec)
    a = concat_soa([o.bake() for o in port.objects])
    b = concat_soa([o.bake() for o in ours.objects])
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), f
    for f in ("material_albedo", "material_roughness", "material_metallic", "material_fresnel"):
        assert np.array_equal(np.asarray(getattr(port, f)), np.asarray(getattr(ours, f))), f
    assert np.array_equal(port.env_tex, ours.env_tex)
    assert len(port.directional) == len(ours.directional)
    for (d0, c0, s0), (d1, c1, s1) in zip(port.directional, ours.directional):
        assert np.array_equal(d0, d1) and np.array_equal(c0, c1) and s0 == s1
    assert a.v0.shape[0] == cell_cfg["triangles"]


def test_seed_keys_take_large_seeds():
    from benchmark.reference import rng

    k = rng.seed_key(2**31 + 5)
    assert k.tolist() == rng.fold_in(rng.prng_key(2**31 + 5), 0).tolist()
    assert rng.seed_key(2**33 + 1).tolist() != rng.seed_key(1).tolist()


def test_spans_and_norm_gaps():
    s = Spans()
    with s.span("a"):
        time.sleep(0.01)
    assert s.total("a") >= 0.01 and s.named("b") == []
    assert compare.norm_gap(1.1, 1.0, 0.5) == pytest.approx(0.1)
    assert compare.counted_leaves({"a": 1.0, "b": 2.0, "c": 1e-9, "d": None}) == ["a", "b"]
    assert compare.worst_leaf({"a": 1.0, "b": 2.2}, {"a": 1.0, "b": 2.0}, ["a", "b"]) == \
        pytest.approx(0.1)


def test_context_defaults_to_the_card():
    ctx = Context(cell=None, seed=1, seconds=1.0, trace=False, t_start=0.0)
    assert ctx.device == "cuda" and ctx.tf32 is False
