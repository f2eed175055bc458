"""Inverse-rendering train step (port of
mc_path_tracer_tpu/parallel/render.py `MaterialGrads`, `make_train_step`).

The step renders a block of pixels with every sample replayed in the
backward (models/integrator.py), takes the L2 loss against a target and
returns its gradients w.r.t. the material factors, the directional lights'
radiance scales and the environment texels, as the JAX step does with
`jax.value_and_grad`: on the scene's own device, through the same kernels
as a render.  Parameters that no path reaches get zero gradients, not
None.  Sharded rendering over several devices (`mesh`, `render_sharded`,
the gradient all-reduce) waits for ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render_tile_radiance
from mc_path_tracer_tpu_torch.models.scene import SceneData
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES


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


def make_train_step(cfg: RenderConfig, width: int, height: int, spp: int, mesh=None,
                    replay: bool = True):
    """Inverse-rendering step: the L2 loss of the rendered pixels against a
    target, differentiated w.r.t. (MaterialGrads, directional ls, env tex).

    Returns train_step(scene, cam, px, py, target, key) -> (loss, grads):
    `scene` a SceneData, `cam` CameraParams, (px, py) [R] f32 pixel
    coordinates of a width x height film, `target` [R, 3] the wanted mean
    radiance; loss = mean((acc / spp - target) ** 2) and grads matches
    scene_params(scene).  `replay=False` keeps every sample's graph alive
    instead of replaying it (for comparisons; it needs spp times the
    memory).  `mesh` (rows sharded over devices) is not ported yet.
    `train_step.forward_launches` holds ops.kernels.LAUNCHES as the last
    call's forward ended; LAUNCHES minus it are its backward's launches
    (the replayed samples')."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): sharded train steps wait for ROADMAP Queue 1 "
            "item 10 (multi-device); pass mesh=None for a one-device step")

    def train_step(scene: SceneData, cam, px, py, target, key):
        mat, ls, tex = scene_params(scene)
        leaves = [p.detach().requires_grad_(True) for p in (*mat, ls, tex)]
        params = (MaterialGrads(*leaves[:5]), leaves[5], leaves[6])
        with torch.enable_grad():
            acc = render_tile_radiance(with_params(scene, params), cam, width, height,
                                       px, py, key, cfg, spp, replay=replay)
            loss = torch.mean((acc / spp - target) ** 2)
            train_step.forward_launches.update(LAUNCHES)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), (MaterialGrads(*grads[:5]), grads[5], grads[6])

    train_step.forward_launches = {}
    return train_step
