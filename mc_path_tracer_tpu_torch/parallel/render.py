"""Row-sharded rendering and differentiable train steps over a device mesh
(port of mc_path_tracer_tpu/parallel/render.py).

The film's pixel rows are the data-parallel axis (parallel/mesh.py): each
shard path-traces its own row block with `render_tile_radiance` on its own
device against its own copy of the scene.  The forward needs no collective:
noise is keyed by pixel id (ops/rng.py), so a frame does not depend on how
its rows are split.  A train step runs each shard's forward and replayed
backward, sums the parameter gradients over the process's shards, then
all-reduces them over the process group when there is one: the all-reduce
that the transpose of JAX's shard_map inserts.  The shards of one process
are enqueued in turn from one host thread.

`render_sharded` is the multi-device PathTracer::render_image;
`render_sharded_global` is its multi-process form; `make_train_step` builds
the inverse-rendering step, one-device or sharded.  Collectives run on the
tensors' own devices: NCCL for a mesh of cards, gloo for a CPU mesh or for
several processes on one card (gloo reduces CUDA tensors itself).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from mc_path_tracer_tpu_torch.models import camera as camera_mod
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render_tile_radiance
from mc_path_tracer_tpu_torch.models.scene import SceneData
from mc_path_tracer_tpu_torch.ops import rng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh, replicated, tile_sharding


class MaterialGrads(NamedTuple):
    """The differentiable (float) slice of MaterialTable; texture-id
    bindings are int32 and held constant."""

    albedo: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    fresnel: torch.Tensor
    emissive: torch.Tensor


def scene_params(scene: SceneData):
    """(MaterialGrads, directional ls [D], env tex [H, W, 3]) of a scene:
    the parameters a train step differentiates, in the JAX step's order."""
    m = scene.materials
    return (MaterialGrads(m.albedo, m.roughness, m.metallic, m.fresnel, m.emissive),
            scene.lights.directional.ls, scene.lights.env.tex)


def with_params(scene: SceneData, params) -> SceneData:
    """`scene` with scene_params' fields replaced by `params`.  The
    environment's sampling tables stay as they are, as in the JAX step;
    its bilinear table is rebuilt from the new texels by the integrator."""
    mat_f, dir_ls, env_tex = params
    lights = scene.lights
    return scene._replace(
        materials=scene.materials._replace(**mat_f._asdict()),
        lights=lights._replace(env=lights.env._replace(tex=env_tex, packed=None),
                               directional=lights.directional._replace(ls=dir_ls)))


def _pixel_grid(width: int, height: int):
    """Every pixel's (px, py), f32, row-major."""
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width), indexing="ij")
    return xs.reshape(-1).to(torch.float32), ys.reshape(-1).to(torch.float32)


def _render_rows(scene_data, camera, width, height, cfg, key, mesh) -> torch.Tensor:
    """Radiance summed over cfg.spp samples for this process's shards' rows
    of the row-major frame, [rows, 3] on the mesh's first device."""
    if height % mesh.size != 0:
        raise ValueError(f"height {height} not divisible by mesh size {mesh.size}")
    if key is None:
        key = rng.prng_key(0)
    if not isinstance(camera, camera_mod.CameraParams):
        camera = camera.params(mesh.devices[0])
    px, py = _pixel_grid(width, height)
    shards = zip(replicated(mesh, scene_data), replicated(mesh, camera),
                 replicated(mesh, key), tile_sharding(mesh, px), tile_sharding(mesh, py))
    rows = [render_tile_radiance(sd, cam, width, height, pxs, pys, k, cfg, cfg.spp)
            for sd, cam, k, pxs, pys in shards]
    return torch.cat([r.to(mesh.devices[0]) for r in rows], dim=0)


def render_sharded(scene_data: SceneData, camera, width: int, height: int,
                   cfg: RenderConfig = RenderConfig(), key: torch.Tensor | None = None,
                   mesh=None) -> torch.Tensor:
    """Full-frame render with pixel rows sharded across the mesh's devices
    (make_mesh() by default: every card).  Returns accumulated radiance
    [H, W, 3] on the mesh's first device (divide by cfg.spp for the mean).
    Height must divide by the mesh size.  A mesh that spans processes takes
    render_sharded_global."""
    mesh = make_mesh() if mesh is None else mesh
    if mesh.world_size > 1:
        raise ValueError("render_sharded: the mesh spans processes; use render_sharded_global")
    return _render_rows(scene_data, camera, width, height, cfg, key, mesh).reshape(
        height, width, 3)


def render_sharded_global(scene_data: SceneData, camera, width: int, height: int,
                          cfg: RenderConfig = RenderConfig(),
                          key: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """Multi-process render_sharded: every process holds the scene and
    renders the rows of its own shards (rank-major, then shard-major), and
    returns them: its rows of the flat [H * W, 3] accumulation, on its first
    device, as JAX's addressable shards are.  With one process this is
    render_sharded's frame, flat."""
    mesh = make_mesh() if mesh is None else mesh
    return _render_rows(scene_data, camera, width, height, cfg, key, mesh)


def make_train_step(cfg: RenderConfig, width: int, height: int, spp: int, mesh=None,
                    replay: bool = True):
    """Inverse-rendering step: the L2 loss of the rendered pixels against a
    target, differentiated w.r.t. (MaterialGrads, directional ls, env tex).

    Returns train_step(scene, cam, px, py, target, key) -> (loss, grads):
    `scene` a SceneData, `cam` CameraParams, (px, py) [R] f32 pixel
    coordinates of a width x height film, `target` [R, 3] the wanted mean
    radiance; loss = mean((acc / spp - target) ** 2) and grads matches
    scene_params(scene).  Without a mesh the step runs on the scene's
    device.  With one, every process passes the same whole (px, py,
    target): each of its shards renders its R / mesh.size rows on its own
    device and takes its share of the loss (its rows over all rows), the
    gradients are summed over the shards and all-reduced over the mesh's
    process group, and loss and gradients come back on the first device.
    `replay=False` keeps every sample's graph alive instead of replaying it
    (for comparisons; it needs spp times the memory).
    `train_step.forward_launches` holds ops.kernels.LAUNCHES as the last
    call's forward ended (every shard's); LAUNCHES minus it are its
    backward's launches (the replayed samples')."""

    def train_step(scene: SceneData, cam, px, py, target, key):
        if mesh is None:
            device = scene.tris.v0.device
            shards = [(scene, cam, key, px, py, target)]
        else:
            device = mesh.devices[0]
            shards = list(zip(replicated(mesh, scene), replicated(mesh, cam),
                              replicated(mesh, key), tile_sharding(mesh, px),
                              tile_sharding(mesh, py), tile_sharding(mesh, target)))
        leaves, losses = [], []
        with torch.enable_grad():
            for sd, c, k, pxs, pys, tgt in shards:
                mat, ls, tex = scene_params(sd)
                own = [p.detach().requires_grad_(True) for p in (*mat, ls, tex)]
                params = (MaterialGrads(*own[:5]), own[5], own[6])
                acc = render_tile_radiance(with_params(sd, params), c, width, height,
                                           pxs, pys, k, cfg, spp, replay=replay)
                loss = torch.mean((acc / spp - tgt) ** 2)
                if mesh is not None and mesh.size > 1:
                    loss = loss * (pxs.shape[0] / px.shape[0])
                leaves.append(own)
                losses.append(loss.to(device))
            train_step.forward_launches.update(LAUNCHES)
            flat = [p for own in leaves for p in own]
            loss = sum(losses[1:], losses[0])
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        # the 7 gradients summed over this process's shards, on `device`
        summed = grads[:7]
        for i in range(7, len(grads), 7):
            summed = [a + b.to(device) for a, b in zip(summed, grads[i : i + 7])]
        loss = loss.detach()
        if mesh is not None and mesh.group is not None:
            loss, summed = _all_reduce(mesh.group, [loss, *summed])
        return loss, (MaterialGrads(*summed[:5]), summed[5], summed[6])

    train_step.forward_launches = {}
    return train_step


def _all_reduce(group, tensors: list[torch.Tensor]):
    """Sum `tensors` over the process group in one collective (packed into
    one flat buffer): (the first tensor, the list of the others)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start : start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out[0], out[1:]
