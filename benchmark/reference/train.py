"""The plain reference of an inverse-rendering step: the L2 loss of a
rendered frame against a target, mean((acc / spp - target) ** 2) over
every pixel and channel, its gradients in the scene's float parameters
(materials' albedo, roughness, metallic, fresnel, emissive; directional
light scales; environment texels), and the plain SGD update the traffic
applies, p <- clamp(p - lr g) on albedo, roughness and metallic.

Pixels run in chunks, each differentiated on its own: the loss is a sum
over pixels, so the chunks' gradients add to the frame's.
"""

from __future__ import annotations

import torch

from benchmark.reference import frame

UPDATED = ("albedo", "roughness", "metallic")
CHUNK = 16384


def render(scene, cam, px, py, key, spp: int, depth: int, chunk: int = CHUNK):
    """Radiance summed over `spp` samples for every pixel, [R, 3], no grad."""
    with torch.no_grad():
        return torch.cat([frame.radiance_sum(scene, cam, px[s:s + chunk], py[s:s + chunk], key,
                                             spp, depth)
                          for s in range(0, px.shape[0], chunk)])


def loss_and_grads(scene, emissive, cam, px, py, target, key, spp: int, depth: int,
                   chunk: int = CHUNK):
    """(loss, {leaf: gradient}) of one step at the scene's parameters."""
    own = {"albedo": scene.albedo, "roughness": scene.roughness, "metallic": scene.metallic,
           "fresnel": scene.fresnel, "emissive": emissive, "dir_ls": scene.dir_ls,
           "env_tex": scene.env_tex}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in own.items()}
    s = scene._replace(**{k: v for k, v in leaves.items() if k != "emissive"})
    n_el = px.shape[0] * 3
    loss = 0.0
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for c in range(0, px.shape[0], chunk):
        with torch.enable_grad():
            acc = frame.radiance_sum(s, cam, px[c:c + chunk], py[c:c + chunk], key, spp, depth)
            part = torch.sum((acc / spp - target[c:c + chunk]) ** 2) / n_el
            names = list(leaves)
            got = torch.autograd.grad(part, [leaves[k] for k in names], allow_unused=True)
        loss += float(part.detach())
        for k, g in zip(names, got):
            if g is not None:
                grads[k] += g
    return loss, grads


def sgd(scene, grads: dict, lr: float, bounds: dict):
    """The traffic's update: clamp(p - lr g, lo, hi) on UPDATED."""
    new = {k: torch.clamp(getattr(scene, k) - lr * grads[k], *bounds[k]) for k in UPDATED}
    return scene._replace(**new)
