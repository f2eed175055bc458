"""The scaling twin (mc_path_tracer_tpu_torch/bench_scaling.py) on a tiny CPU
frame: tests/test_torch_multihost.py's 98-triangle scene at 16x8, 1 spp,
depth 2, over CPU meshes of 1 and 2 shards on the in-process route and
one and two gloo processes on the process route, joined through
torchrun's environment (init_distributed() with no arguments, env://).

Its keys and arithmetic are held to the JAX package's bench_scaling.py:
the per-mesh keys and comm_bytes keys of its committed SCALING_r05.json,
its rays per sample (1 + (depth - 2) + 2 * (depth - 1)), its byte census
(film f32 gathered; materials' float fields and the environment's texels,
f32, all-reduced) on the JAX package's build of the same scene, and the
efficiency t_1 / (n t_n) from the walls the twin reports, t_1 being the
same route's one-shard wall.  Every frame is
bit-equal to the one-shard frame; every gradient within 1e-5 of the
largest of the one-shard step's (only the order of the sums differs)."""

import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch

from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu_torch import bench_scaling as twin
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_multihost import host_scene

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = Path(__file__).resolve().parents[1]
FRAME = twin.Frame(width=16, height=8, spp=1, depth=2, step_spp=1,
                   scene="tests.test_torch_multihost:host_scene")
SIZES = (1, 2)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    """One run of the twin on the CPU: both routes, meshes of 1 and 2."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"   # the process route's ranks
    try:
        return twin.run(device="cpu", frame=FRAME, sizes=SIZES,
                        out_dir=tmp_path_factory.mktemp("scaling"))
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = omp


def test_keys_are_bench_scaling_keys(result):
    jax_run = json.loads((REPO / "SCALING_r05.json").read_text())
    assert [m["devices"] for m in result["per_mesh"]] == list(SIZES)
    for rec in result["per_mesh"]:
        assert set(jax_run["per_mesh"][0]) <= set(rec)
    assert set(result["comm_bytes"]) == set(jax_run["comm_bytes"])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(result)
    assert result["unit"] == "bool" and result["value"] == 1.0
    assert result["card"] == "cpu" and result["platform"] == "cpu"
    json.dumps(result)


@pytest.mark.parametrize("frame", [FRAME, twin.Frame()], ids=["tiny", "bench"])
def test_rays_per_frame_as_bench_scaling(frame):
    depth = frame.depth
    rays_per_sample = 1 + (depth - 2) + 2 * (depth - 1)   # bench_scaling.py's
    assert frame.rays() == frame.width * frame.height * frame.spp * rays_per_sample
    assert (twin.Frame().width, twin.Frame().height, twin.Frame().spp,
            twin.Frame().depth, twin.Frame().step_spp) == (1920, 1080, 4, 5, 1)


def test_comm_bytes_as_bench_scaling(result):
    """bench_scaling.py's census on the JAX package's build of the scene."""
    scene, _ = host_scene(JScene)
    sd = scene.build()
    m = sd.materials
    grad_bytes = 4 * (m.albedo.size + m.roughness.size + m.metallic.size
                      + m.fresnel.size + m.emissive.size)
    grad_bytes += 4 * sd.lights.env.tex.size
    assert result["comm_bytes"] == {
        "film_gather_per_frame": FRAME.width * FRAME.height * 3 * 4,
        "param_grad_allreduce_per_step": grad_bytes}


def test_efficiency_and_rates_from_the_walls(result):
    per_mesh, steps = result["per_mesh"], result["train_step"]
    t_1, s_1 = per_mesh[0]["wall_ms"], steps[0]["wall_ms"]
    for rec, step in zip(per_mesh, steps):
        n = rec["devices"]
        assert rec["efficiency"] == pytest.approx(t_1 / (n * rec["wall_ms"]), rel=1e-12)
        assert rec["mrays_s"] == pytest.approx(FRAME.rays() / (rec["wall_ms"] / 1e3) / 1e6,
                                               rel=1e-12)
        assert step["efficiency"] == pytest.approx(s_1 / (n * step["wall_ms"]), rel=1e-12)
        assert step["forward_ms"] + step["backward_ms"] == pytest.approx(step["wall_ms"])
        assert 0 < step["forward_ms"] < step["wall_ms"]
    procs = result["process_route"]
    for rec in procs:
        n = rec["devices"]
        assert rec["efficiency"] == pytest.approx(
            procs[0]["wall_ms"] / (n * rec["wall_ms"]), rel=1e-12)
        assert rec["step_efficiency"] == pytest.approx(
            procs[0]["step_wall_ms"] / (n * rec["step_wall_ms"]), rel=1e-12)
    assert procs[0]["efficiency"] == procs[0]["step_efficiency"] == 1.0
    assert result["vs_baseline"] == procs[-1]["efficiency"]
    assert twin.efficiency(8.0, 4, 2.5) == 0.8


def test_in_process_route_matches_one_shard(result):
    for rec in result["per_mesh"]:
        assert rec["bitequal_vs_1dev"] and rec["max_abs_diff_vs_1dev"] == 0.0
        # plain-version calls, per sample one closest and one fused any-hit
        assert [got["plain"] for got in rec["launches_per_card"]] == \
            [2 * FRAME.spp] * rec["devices"]
    for step in result["train_step"]:
        assert step["grad_gap_vs_1dev"] <= twin.GRAD_SHARD_TOL
        assert len(step["forward_launches_per_card"]) == step["devices"]
    assert result["shards_agree_all_meshes_bitequal"] and result["grads_within_tol"]


def test_process_route_joins_through_the_torchrun_environment(result):
    """One and two ranks started with RANK / LOCAL_RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT, two joined by init_distributed() alone and
    one in a group of one (gloo on the CPU)."""
    assert [rec["devices"] for rec in result["process_route"]] == list(SIZES)
    for rec in result["process_route"]:
        n = rec["devices"]
        assert rec["ok"] and rec["backend"] == "gloo"
        assert rec["bitequal_vs_1dev"] and rec["max_abs_diff_vs_1dev"] == 0.0
        assert rec["grad_gap_vs_1dev"] <= twin.GRAD_SHARD_TOL
        assert [got["plain"] for got in rec["launches_per_card"]] == [2 * FRAME.spp] * n
        assert 0 < rec["forward_ms"] < rec["step_wall_ms"]
    assert dataclasses.asdict(FRAME)["scene"] == result["frame"]["scene"]
