"""The command line, the profiling utilities and the benchmark's arithmetic
against the JAX package.

The port's argument parser has the JAX parser's options, defaults and
choices plus `--device`; `main([..., "--device", "cpu"])` at 8x6 writes
the PNG bytes that RenderEngine and Film.save_png give for the same scene,
camera and key, in every render mode and view; `--out-hdr` writes the
film's radiance_mean, and write_hdr_npy writes the JAX package's bytes.
Timings, rays_per_sample and RenderStats equal the JAX package's; the
benchmark's summary reproduces bench.py's arithmetic (bench.py:163-191) on
block times made from a seed."""

import time

import numpy as np
import pytest
import torch

from mc_path_tracer_tpu import cli as jcli
from mc_path_tracer_tpu.utils import image as jimage
from mc_path_tracer_tpu.utils import profiling as jprof
from mc_path_tracer_tpu_torch import bench as tbench
from mc_path_tracer_tpu_torch import cli as tcli
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
from mc_path_tracer_tpu_torch.models import integrator
from mc_path_tracer_tpu_torch.models.engine import RenderEngine
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, camera_params
from mc_path_tracer_tpu_torch.models.scene import Scene
from mc_path_tracer_tpu_torch.ops import rng
from mc_path_tracer_tpu_torch.utils import image as timage
from mc_path_tracer_tpu_torch.utils import profiling as tprof
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_scene import small_scene

# one torch thread per worker: the suite runs in several processes
pytestmark = pytest.mark.usefixtures("one_thread")


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_argparser_has_the_jax_options_plus_device():
    port, ref = _options(tcli.build_argparser()), _options(jcli.build_argparser())
    assert set(port) - set(ref) == {"device"}
    assert port.pop("device")[:2] == (("--device",), "cuda")
    assert port == ref


W, H = 8, 6
CASES = {   # name: extra arguments
    "path_tracer": ["--mode", "path_tracer", "--spp", "1", "--depth", "2", "--seed", "3"],
    "rasterizer": ["--mode", "rasterizer"],
    "wireframe": ["--mode", "wireframe"],
    "debug": ["--mode", "debug"],
    "heatmap": ["--mode", "path_tracer", "--spp", "1", "--depth", "2", "--view", "heatmap",
                "--exposure", "1.7"],
}


def engine_png(path, args):
    """What main writes, through RenderEngine and Film.save_png."""
    scene = tcli.demo_scene(Scene())
    scene.add_directional_light((0.4, 1.0, 0.2), ls=5.0)
    cam = PerspectiveCamera(position=np.array([0.0, 2.0, 6.0]), target=np.zeros(3),
                            fov_deg=45.0)
    film = RenderEngine().render(scene, cam, W, H, mode=args.mode,
                                 cfg=RenderConfig(spp=args.spp, max_depth=args.depth),
                                 key=rng.prng_key(args.seed), device="cpu")
    film.save_png(str(path), exposure=args.exposure, view=args.view)
    return film


@pytest.mark.parametrize("case", list(CASES))
def test_main_writes_the_engine_png(case, tmp_path, capsys):
    argv = ["--demo", "--size", f"{W}x{H}", "--device", "cpu", "--out",
            str(tmp_path / "cli.png"), *CASES[case]]
    if case == "path_tracer":
        argv += ["--out-hdr", str(tmp_path / "cli.npy")]
    assert tcli.main(argv) == 0
    assert "Mrays/s" in capsys.readouterr().out
    film = engine_png(tmp_path / "engine.png", tcli.build_argparser().parse_args(argv))
    assert (tmp_path / "cli.png").read_bytes() == (tmp_path / "engine.png").read_bytes()
    if case == "path_tracer":
        np.testing.assert_array_equal(np.load(tmp_path / "cli.npy"),
                                      film.radiance_mean().numpy())


def test_write_hdr_npy_matches_jax(tmp_path):
    """The same radiance, from a tensor and from numpy, saves to the JAX
    package's .npy bytes."""
    img = np.random.default_rng(6).uniform(0.0, 9.0, (5, 7, 3)).astype(np.float32)
    jimage.write_hdr_npy(str(tmp_path / "jax.npy"), img)
    timage.write_hdr_npy(str(tmp_path / "port.npy"), torch.from_numpy(img))
    timage.write_hdr_npy(str(tmp_path / "numpy.npy"), img.astype(np.float64))
    want = (tmp_path / "jax.npy").read_bytes()
    assert (tmp_path / "port.npy").read_bytes() == want == (tmp_path / "numpy.npy").read_bytes()


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--demo", "--size", "4x4", "--out", str(tmp_path / "x.png")])


def test_profiling_matches_jax(monkeypatch):
    """Timings (on a shared fake clock), rays_per_sample and RenderStats."""
    ticks = iter(np.arange(0.0, 100.0, 0.125))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    reports = []
    for mod in (tprof, jprof):
        t = mod.Timings()
        for name in ("build", "render", "build", "tonemap", "render", "render"):
            with t.section(name):
                pass
        reports.append((t.report(), t.as_json(), dict(t.counts)))
    assert reports[0] == reports[1]
    assert [tprof.rays_per_sample(d) for d in range(9)] == [
        jprof.rays_per_sample(d) for d in range(9)]
    for args in ((1920, 1080, 4, 5, 10.5), (64, 48, 16, 2, 0.25), (8, 8, 1, 0, 0.0)):
        a, b = tprof.RenderStats(*args), jprof.RenderStats(*args)
        assert (a.total_rays, a.mrays_per_s, str(a)) == (b.total_rays, b.mrays_per_s, str(b))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path), device="cpu"):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def bench_py(deltas, redo, n_blocks, full_frame, spp, reuse, width=1920, height=1080, depth=5):
    """bench.py:163-191, as written there."""
    deltas = list(deltas)
    med = float(np.median(deltas))
    for k, d in enumerate(deltas):
        if d > 3.0 * med:
            deltas[k] = redo[k]
    dt_block = float(np.mean(deltas))
    frame_s = float(np.sum(deltas)) if full_frame else dt_block * n_blocks
    rays_per_sample = 1 + (depth - 2) + 2 * (depth - 1)
    traced_per_sample = (2 * depth - 1) if reuse else rays_per_sample
    mrays = width * height * spp * rays_per_sample / frame_s / 1e6
    traced_mrays = width * height * spp * traced_per_sample / frame_s / 1e6
    return {"value": mrays, "vs_baseline": mrays / 100.0, "traced_mrays_s": traced_mrays,
            "rays_per_sample": {"reference": rays_per_sample, "traced": traced_per_sample},
            "frame_s": frame_s, "spp_timed": spp}


@pytest.mark.parametrize("strided, reuse", [(False, False), (True, False), (False, True)])
def test_bench_summary_reproduces_bench_py(strided, reuse):
    r = np.random.default_rng(4)
    n_blocks = 32
    blocks = tbench.timed_blocks(n_blocks, strided)
    n_timed = min(8, n_blocks)
    assert blocks == (list(range(0, n_blocks, max(1, n_blocks // n_timed)))[:n_timed]
                      if strided else list(range(n_blocks)))
    deltas = list(r.uniform(0.2, 0.5, len(blocks)))
    deltas[1], deltas[-1] = 11.4, 2.0          # a stall, and a second slow block
    redo = list(r.uniform(0.2, 0.5, len(blocks)))
    kept = list(deltas)
    for k in tbench.outliers(deltas):
        kept[k] = redo[k]
    assert tbench.outliers(deltas) == [1, len(blocks) - 1]
    got = tbench.summarize(kept, n_blocks, strided, 1920, 1080, 4, 5, reuse)
    want = bench_py(deltas, redo, n_blocks, not strided, 4, reuse)
    assert got["metric"] == "Mrays/s/chip @1080p depth-5" and got["unit"] == "Mrays/s"
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key


def test_bench_time_blocks_on_a_small_frame(monkeypatch):
    """The block loop on the CPU, with 48-pixel blocks: a 16x8 frame is
    three blocks (the last padded), timed after a warm-up."""
    monkeypatch.setattr(integrator, "PIXEL_CHUNK", 48)
    sd = small_scene(Scene).build("cpu")
    cam = camera_params(tbench.bench_camera(), 16, 8, "cpu")
    lines = []
    warmup, n_blocks, blocks, deltas = tbench.time_blocks(
        sd, cam, RenderConfig(spp=1, max_depth=2), 16, 8, strided=False, log=lines.append)
    assert warmup > 0 and n_blocks == 3 and blocks == [0, 1, 2] and min(deltas) > 0
    assert lines[0].startswith("warm-up") and lines[1].startswith("block 0/3")
