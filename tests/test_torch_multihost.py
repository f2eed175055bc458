"""Two processes joined by torch.distributed (gloo, on the CPU): each holds a
2-shard CPU mesh, so the global mesh has 4 shards split rank-major.  Each
rank renders its rows with render_sharded_global and runs one sharded
train step, whose gradients are all-reduced over both ranks; rank 0
gathers the rows with torch.distributed.all_gather.  The parent process
holds each rank's rows and the gathered frame bit-equal to a one-device
render of the port, and every rank's gradients within 1e-5 of the largest
of the one-device step's (only the order of the sum differs).

The file is its own worker: `python tests/test_torch_multihost.py <rank>
<world> <port> <out.npz>`."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
W, H, SPP, DEPTH, KEY = 16, 8, 1, 2, 3
LOCAL_SHARDS = 2
TIMEOUT_S = 120
GRAD_TOL = 1e-5


def scene_and_camera():
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
    from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere
    from mc_path_tracer_tpu_torch.models.scene import Scene

    s = Scene()
    s.set_environment_color((0.4, 0.5, 0.7), ls=1.0)
    s.add_directional_light((0.3, 1.0, 0.2), ls=2.0)
    m0 = s.add_material(albedo=(0.8, 0.3, 0.2), roughness=0.5)
    p, n, uv, idx = uv_sphere(0.8, center=(0, 0.8, 0), rings=6, segments=8)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m0)
    p, n, uv, idx = plane(6.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=s.add_material(roughness=0.9))
    cam = PerspectiveCamera(position=np.array([0.0, 1.2, 3.0]),
                            target=np.array([0.0, 0.6, 0.0]), fov_deg=50.0,
                            aspect=W / H).params("cpu")
    return s.build("cpu"), cam


def step_inputs():
    ys, xs = np.mgrid[0:H, 0:W]
    px = torch.tensor(xs.reshape(-1), dtype=torch.float32)
    py = torch.tensor(ys.reshape(-1), dtype=torch.float32)
    target = torch.from_numpy(
        np.random.default_rng(1).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32))
    return px, py, target


def flat_grads(grads):
    mat, ls, tex = grads
    return [g.numpy() for g in (*mat, ls, tex)]


def worker(rank: int, world: int, port: str, out: str) -> None:
    import torch.distributed as dist

    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from mc_path_tracer_tpu_torch.parallel.render import make_train_step, render_sharded_global

    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        mesh = make_mesh(devices=["cpu"] * LOCAL_SHARDS)
        assert (mesh.size, mesh.rank, mesh.world_size) == (LOCAL_SHARDS * world, rank, world)
        sd, cam = scene_and_camera()
        cfg = RenderConfig(spp=SPP, max_depth=DEPTH)
        rows = render_sharded_global(sd, cam, W, H, cfg, rng.prng_key(KEY), mesh)
        gathered = [torch.empty_like(rows) for _ in range(world)]
        dist.all_gather(gathered, rows)
        step = make_train_step(cfg, W, H, SPP, mesh=mesh)
        loss, grads = step(sd, cam, *step_inputs(), rng.prng_key(KEY))
        np.savez(out, rows=rows.numpy(), frame=torch.cat(gathered).numpy(),
                 loss=loss.numpy(), **{f"g{i}": g for i, g in enumerate(flat_grads(grads))})
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    """Run the two workers; every rank's saved arrays."""
    from mc_path_tracer_tpu_torch.utils import native

    tmp_path = tmp_path_factory.mktemp("multihost")

    # build the native BVH library once here, so the workers load it and do
    # not race each other's compiler
    native.load_native()
    port, world = str(_free_port()), 2
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                          if p))
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), port, str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r, out in enumerate(outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n----\n".join(logs)
    return [dict(np.load(out)) for out in outs]


def test_two_gloo_processes_render_the_one_device_frame(worker_results):
    """Each rank's rows, and the rows rank 0 gathered, bit-equal to the
    port's one-device render."""
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render
    from mc_path_tracer_tpu_torch.ops import rng

    torch.set_num_threads(1)
    sd, cam = scene_and_camera()
    single = render(sd, cam, W, H, RenderConfig(spp=SPP, max_depth=DEPTH),
                    key=rng.prng_key(KEY)).ld.reshape(-1, 3).numpy()
    rows = W * H // len(worker_results)
    for r, got in enumerate(worker_results):
        np.testing.assert_array_equal(got["rows"], single[r * rows : (r + 1) * rows])
        np.testing.assert_array_equal(got["frame"], single)


def test_two_gloo_processes_all_reduce_the_step(worker_results):
    """Every rank's loss and all-reduced gradients against the port's
    one-device train step."""
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.parallel.render import make_train_step

    torch.set_num_threads(1)
    sd, cam = scene_and_camera()
    step = make_train_step(RenderConfig(spp=SPP, max_depth=DEPTH), W, H, SPP)
    loss1, grads1 = step(sd, cam, *step_inputs(), rng.prng_key(KEY))
    grads1 = flat_grads(grads1)
    assert np.abs(grads1[0]).sum() > 0
    for got in worker_results:
        assert abs(float(got["loss"]) - float(loss1)) <= 1e-6 * abs(float(loss1))
        for i, want in enumerate(grads1):
            scale = np.abs(want).max(initial=0.0)
            gap = np.abs(got[f"g{i}"] - want).max(initial=0.0)
            assert gap <= GRAD_TOL * scale, (i, gap, scale)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
