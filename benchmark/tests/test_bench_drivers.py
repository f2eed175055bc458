"""Each driver run end to end on the CPU at the tiny configuration's size
(everything of a run but the look for a card): sound, the comparison
with the plain reference passes; with the timed path broken underneath in
each way the cell can break, `correct` comes out false."""

from __future__ import annotations

import time

import pytest

from benchmark import faults
from benchmark.harness import manifest
from benchmark.harness.driver import Context
from benchmark.tests import tiny

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def drive(root, cell: str, trace: bool = False, seed: int = 2**31 + 11):
    c = manifest.load_cell(cell, root=root)
    ctx = Context(cell=c, seed=seed, seconds=0.01, trace=trace, t_start=time.perf_counter(),
                  device="cpu")
    return c, c.driver().run(ctx)


def test_frame_sound(root):
    _, out = drive(root, "tiny.frame")
    assert out.correct, out.numbers
    assert out.numbers["rad_off_share"] == 0.0 and out.attempted >= 1
    assert out.e2e["mrays_per_s"] > 0 and out.e2e["setup_s"] > 0


def test_frame_traced_reads_its_metrics(root):
    cell, out = drive(root, "tiny.frame", trace=True)
    assert out.correct and out.window_s > 0 and out.busy_s == 0.0
    assert cell.metric_reader("units_traced").read(out.layer) == 1.0
    assert cell.metric_reader("scene_build_s").read(out.layer) > 0
    assert cell.metric_reader("traversal_roofline.frame").read(out.layer) is None
    assert {"device_ops", "idle_gaps"} <= set(out.breakdown)


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_frame_faults_fail(root, monkeypatch, kind):
    faults.plant(f"frame.{kind}", monkeypatch)
    _, out = drive(root, "tiny.frame", seed=2**31 + 12)
    assert not out.correct, (kind, out.numbers)


def test_train_sound(root):
    _, out = drive(root, "tiny.train")
    assert out.correct, out.numbers
    assert out.e2e["train_step_s"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_train_faults_fail(root, monkeypatch, kind):
    faults.plant(f"train.{kind}", monkeypatch)
    _, out = drive(root, "tiny.train", seed=2**31 + 13)
    assert not out.correct, (kind, out.numbers)


def test_preview_sound(root):
    _, out = drive(root, "tiny.preview")
    assert out.correct, out.numbers
    assert out.e2e["preview_p90_ms"] > 0


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_preview_faults_fail(root, monkeypatch, kind):
    faults.plant(f"preview.{kind}", monkeypatch)
    _, out = drive(root, "tiny.preview", seed=2**31 + 14)
    assert not out.correct, (kind, out.numbers)


def test_frame4_sound(root):
    cell, out = drive(root, "tiny.frame4", trace=True)
    assert out.correct, out.numbers
    assert out.count == 4 and out.attempted == 1
    assert cell.metric_reader("shard_spread.frame4").read(out.layer) >= 1.0
    assert cell.metric_reader("gather_ms.frame4").read(out.layer) > 0
    assert cell.metric_reader("scene_build_s").read(out.layer) > 0


def test_frame4_without_the_exchange_fails(root, monkeypatch):
    faults.plant("frame4.exchange", monkeypatch)
    _, out = drive(root, "tiny.frame4", seed=2**31 + 15)
    assert not out.correct, out.numbers



@pytest.mark.parametrize("mix", ["frame", "train", "preview", "frame4"])
def test_traced_line_has_every_host_metric(root, mix):
    """A traced run's line carries each per-layer metric the cell reports
    that is read from the harness's spans or counters (device-trace
    metrics have nothing to read on the CPU)."""
    cell, out = drive(root, f"tiny.{mix}", trace=True, seed=2**31 + 16)
    run = manifest.load_module(tiny.ROOT / "benchmark" / "run.py", "bench_run_module")
    got = run.layer_metrics(cell, out.layer)
    want = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    assert "scene_build_s" in want and want <= set(got), got


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_on_the_card(card, seed):
    """The control, the program with TF32 matmuls on (the precision below
    the configurations' float32), fails the bench frame's check at a
    reduced size."""
    c = manifest.load_cell("bench.frame")
    c.config = dict(c.config, width=480, height=270, spp=1)
    c.traffic = dict(c.traffic, check_pixels=2048)
    ctx = Context(cell=c, seed=seed, seconds=0.01, trace=False, t_start=time.perf_counter(),
                  device=card, tf32=True)
    out = c.driver().run(ctx)
    assert not out.correct, out.numbers
