"""The plain reference's shading and geometry: vector math, the GGX +
Lambert BRDF mixture, the power heuristic, the HDR environment's CDF,
sampling, pdf and bilinear lookup, the thin-lens camera, and brute-force
Moller-Trumbore intersection with the hit record.

Frozen copies of the formulas the port implements (in the order it
evaluates them, so that the two round alike), restricted to what the
benchmark's scenes use: untextured materials, an HDR environment and
directional lights, no area light.  Nothing here imports the port.
Intersection is brute force: every live ray against every triangle of
each object whose (padded) bounding box it enters, ties to the lowest
triangle index, which in exact arithmetic is the traversal's answer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

K_EPSILON = 1e-6
K_HUGE = 1e32
EPS = 1e-6
PI = math.pi
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
INV_2PI = 1.0 / TWO_PI
LUMINANCE = (0.299, 0.587, 0.114)
# ray x triangle pairs per chunk of the brute-force test
PAIRS = 1 << 25


# --------------------------------------------------------------------------
# vector math
# --------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v, eps: float = 1e-20):
    return v * torch.reciprocal(torch.sqrt(torch.clamp(dot(v, v), min=eps)))[..., None]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def build_onb(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def frame_to_world(local, n):
    t, b = build_onb(n)
    return normalize(t * local[..., 0:1] + n * local[..., 1:2] + b * local[..., 2:3])


def equirect_uv(d):
    u = 0.5 + torch.atan2(d[..., 2], d[..., 0]) * INV_2PI
    v = 0.5 - torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * INV_PI
    return torch.stack([u, v], dim=-1)


def equirect_dir(uv):
    phi = TWO_PI * (uv[..., 0] - 0.5)
    theta = PI * uv[..., 1]
    st = torch.sin(theta)
    return torch.stack([torch.cos(phi) * st, torch.cos(theta), torch.sin(phi) * st], dim=-1)


def power_heuristic(f_pdf, g_pdf):
    f = 1.0 * f_pdf
    g = 1.0 * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0, f * f / torch.clamp(denom, min=1e-38), 0.0)


# --------------------------------------------------------------------------
# BRDF: Cook-Torrance GGX specular + Lambert diffuse, 50/50 mixture
# --------------------------------------------------------------------------

class Material(NamedTuple):
    albedo: torch.Tensor     # [..., 3]
    roughness: torch.Tensor  # [...]
    metallic: torch.Tensor   # [...]
    fresnel: torch.Tensor    # [..., 3]

    @property
    def f0(self):
        m = self.metallic[..., None]
        return self.fresnel * (1.0 - m) + self.albedo * m


def fresnel_schlick(f0, v, h):
    v_dot_h = torch.clamp(dot(v, h), min=0.0)
    return f0 + (1.0 - f0) * torch.pow(1.0 - v_dot_h, 5.0)[..., None]


def ndf_ggx(n, h, roughness):
    a = roughness * roughness
    a2 = a * a
    n_dot_h = torch.clamp(dot(n, h), min=EPS)
    denom = torch.clamp(n_dot_h * n_dot_h * (a2 - 1.0) + 1.0, min=EPS)
    return a2 / (PI * denom * denom)


def g1(v, n, roughness):
    a = roughness * roughness
    k = a / 2.0
    n_dot_v = torch.clamp(dot(n, v), min=EPS)
    return n_dot_v / torch.clamp(n_dot_v * (1.0 - k) + k, min=EPS)


def diff_sample(n, u):
    e0, e1 = u[..., 0], u[..., 1]
    sin_theta = torch.sqrt(torch.clamp(1.0 - e0 * e0, min=0.0))
    phi = TWO_PI * e1
    local = torch.stack([sin_theta * torch.cos(phi), e0, sin_theta * torch.sin(phi)], dim=-1)
    return frame_to_world(local, n)


def diff_f(mat, n, wi, wo):
    n_dot_wi = torch.clamp(dot(n, wi), min=EPS)
    wh = normalize(wo + wi)
    f = fresnel_schlick(mat.f0, wh, wo)
    kd = (1.0 - f) * (1.0 - mat.metallic[..., None])
    return kd * mat.albedo * (n_dot_wi * INV_PI)[..., None]


def spec_sample(mat, n, wo, u):
    r = mat.roughness
    a2 = r * r * r * r
    e0, e1 = u[..., 0], u[..., 1]
    cos_theta = torch.sqrt(
        torch.clamp((1.0 - e0) / torch.clamp(e0 * (a2 - 1.0) + 1.0, min=EPS), 0.0, 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * e1
    local_h = torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)], dim=-1)
    wh = frame_to_world(local_h, n)
    return normalize(reflect(-wo, wh))


def spec_pdf(mat, n, wi, wo):
    wh = normalize(wo + wi)
    wh_dot_n = torch.clamp(dot(wh, n), min=EPS)
    wo_dot_wh = torch.clamp(dot(wo, wh), min=EPS)
    d = ndf_ggx(n, wh, mat.roughness)
    return d * wh_dot_n / torch.clamp(4.0 * wo_dot_wh, min=EPS)


def spec_f(mat, n, wi, wo):
    wh = normalize(wo + wi)
    n_dot_wi = torch.clamp(dot(n, wi), min=EPS)
    n_dot_wo = torch.clamp(dot(n, wo), min=EPS)
    d = ndf_ggx(n, wh, mat.roughness)
    g = g1(wi, n, mat.roughness) * g1(wo, n, mat.roughness)
    f = fresnel_schlick(mat.f0, wh, wo)
    return f * (d * g * n_dot_wi / torch.clamp(4.0 * n_dot_wo * n_dot_wi, min=EPS))[..., None]


def mixture_sample(mat, n, wo, u_coin, u2):
    wi_s = spec_sample(mat, n, wo, u2)
    wi_d = diff_sample(n, u2)
    return torch.where((u_coin < 0.5)[..., None], wi_s, wi_d)


def mixture_pdf(mat, n, wi, wo):
    diff = torch.full(wi.shape[:-1], INV_2PI, dtype=wi.dtype, device=wi.device)
    return 0.5 * (diff + spec_pdf(mat, n, wi, wo))


def mixture_f(mat, n, wi, wo):
    return spec_f(mat, n, wi, wo) + diff_f(mat, n, wi, wo)


# --------------------------------------------------------------------------
# HDR environment: CDF (built here from the texels), sampling, pdf, lookup
# --------------------------------------------------------------------------

class EnvDist(NamedTuple):
    marginal_cdf: torch.Tensor  # [H]
    cond_cdf: torch.Tensor      # [H, W]
    pdf_texture: torch.Tensor   # [H, W]


def env_distribution(tex: np.ndarray, device) -> EnvDist:
    """pdf = lum * sin(pi y / H) / sum; a row CDF and per-row column CDFs,
    in float32 numpy on the host."""
    tex = np.asarray(tex, np.float32)
    h = tex.shape[0]
    lum = tex @ np.asarray(LUMINANCE, np.float32)
    v = np.arange(h, dtype=np.float32) / h
    sin_theta = np.sin(np.pi * v).astype(np.float32)
    weighted = lum * sin_theta[:, None]
    denom = max(float(weighted.sum()), 1e-20)
    pdf_texture = weighted / denom
    marginal_p = pdf_texture.sum(axis=1)
    marginal_cdf = np.cumsum(marginal_p).astype(np.float32)
    cond_p = pdf_texture / np.maximum(marginal_p[:, None], 1e-20)
    cond_cdf = np.cumsum(cond_p, axis=1).astype(np.float32)
    return EnvDist(torch.from_numpy(marginal_cdf).to(device),
                   torch.from_numpy(cond_cdf).to(device),
                   torch.from_numpy(pdf_texture.astype(np.float32)).to(device))


def env_sample(dist: EnvDist, u):
    """searchsorted(side="right") in the row CDF, then in the row's column
    CDF (one broadcast compare each) -> the texel corner's direction."""
    h, w = dist.cond_cdf.shape
    y = torch.clamp((dist.marginal_cdf <= u[..., 1][..., None]).sum(dim=-1), 0, h - 1)
    x = torch.clamp((dist.cond_cdf[y] <= u[..., 0][..., None]).sum(dim=-1), 0, w - 1)
    uv = torch.stack([x.to(torch.float32) / w, y.to(torch.float32) / h], dim=-1)
    return equirect_dir(uv)


def env_pdf(dist: EnvDist, wi):
    h, w = dist.pdf_texture.shape
    uv = equirect_uv(wi)
    ix = torch.remainder(torch.round(uv[..., 0] * w).to(torch.int64), w)
    iy = torch.clamp(torch.round(uv[..., 1] * h).to(torch.int64), 0, h - 1)
    p = dist.pdf_texture[iy, ix]
    sin_theta = torch.sin(PI * uv[..., 1])
    return torch.where(sin_theta > 0.0,
                       p * (w * h) / (2.0 * PI * PI * torch.clamp(sin_theta, min=1e-20)), 0.0)


def bilinear_wrap(tex, uv):
    """Bilinear, wrap-addressed fetch, texel centres at (i + 0.5) / N."""
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    return (tex[y0i, x0i] * (1 - fx) * (1 - fy) + tex[y0i, x1i] * fx * (1 - fy)
            + tex[y1i, x0i] * (1 - fx) * fy + tex[y1i, x1i] * fx * fy)


def env_radiance(tex, wi):
    return bilinear_wrap(tex, equirect_uv(wi))


# --------------------------------------------------------------------------
# camera: NDC unprojection through inv(proj @ view), computed here in f64
# --------------------------------------------------------------------------

class Camera(NamedTuple):
    inv_view_proj: torch.Tensor  # [4, 4] f32
    width: int
    height: int


def camera(position, target, up, fov_deg, z_near, z_far, width, height, device) -> Camera:
    """glm lookAt / perspective with aspect width / height, inverted in f64
    on the host."""
    eye = np.asarray(position, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3], view[1, 3], view[2, 3] = -s @ eye, -u @ eye, f @ eye
    t = 1.0 / np.tan(float(np.deg2rad(fov_deg)) / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0] = t / (width / height)
    proj[1, 1] = t
    proj[2, 2] = (z_far + z_near) / (z_near - z_far)
    proj[2, 3] = 2.0 * z_far * z_near / (z_near - z_far)
    proj[3, 2] = -1.0
    inv_vp = np.linalg.inv(proj @ view).astype(np.float32)
    return Camera(torch.from_numpy(inv_vp).to(device), width, height)


def camera_rays(cam: Camera, px, py):
    """Pinhole rays through pixel centres (px, py) [R] f32."""
    ndc_x = 2.0 * ((px + 0.5) / cam.width) - 1.0
    ndc_y = 1.0 - 2.0 * ((py + 0.5) / cam.height)
    ones = torch.ones_like(ndc_x)
    near = torch.stack([ndc_x, ndc_y, -ones, ones], dim=-1) @ cam.inv_view_proj.T
    far = torch.stack([ndc_x, ndc_y, ones, ones], dim=-1) @ cam.inv_view_proj.T
    origin = near[:, :3] / near[:, 3:4]
    direction = normalize(far[:, :3] / far[:, 3:4] - origin)
    return origin, direction


# --------------------------------------------------------------------------
# intersection: brute-force Moller-Trumbore, culled by object boxes
# --------------------------------------------------------------------------

class Triangles(NamedTuple):
    """Triangles in object order, with each object's range and padded box."""
    v0: torch.Tensor        # [T, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor        # [T, 3] vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    material: torch.Tensor  # [T] int64
    ranges: tuple           # ((first, end), ...) per object
    box_lo: torch.Tensor    # [O, 3]
    box_hi: torch.Tensor    # [O, 3]

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def moller_trumbore(ray_o, ray_d, v0, e1, e2):
    """Backface-culled Moller-Trumbore (det >= K_EPSILON, 0 <= u, v,
    u + v <= 1, t >= 0); returns (valid, t, u, v)."""
    pvec = cross(ray_d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1.0)
    tvec = ray_o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(ray_d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = ((det >= K_EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= 0.0))
    return valid, t, u, v


def _box_mask(o, d, lo, hi):
    """Rays [R] that enter the box [lo, hi] at some t >= 0."""
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, torch.where(d >= 0, 1e-12, -1e-12))
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    return (tnear <= tfar) & (tfar >= 0.0)


def _candidates(tris: Triangles, o, d, live):
    """Per object: (first, end, ray indices that enter its box)."""
    for k, (a, b) in enumerate(tris.ranges):
        idx = torch.nonzero(live & _box_mask(o, d, tris.box_lo[k], tris.box_hi[k])).squeeze(1)
        if idx.numel():
            yield a, b, idx


def closest(tris: Triangles, o, d, live):
    """Closest hit per ray: (t [R], tri [R] int64, -1 on a miss); ties to
    the lowest triangle index."""
    r = o.shape[0]
    t_best = torch.full((r,), K_HUGE, dtype=torch.float32, device=o.device)
    best = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    for a, b, idx in _candidates(tris, o, d, live):
        v0, e1, e2 = tris.v0[a:b][None], tris.e1[a:b][None], tris.e2[a:b][None]
        step = max(1, PAIRS // (b - a))
        for s in range(0, idx.numel(), step):
            rows = idx[s:s + step]
            valid, t, _, _ = moller_trumbore(o[rows][:, None], d[rows][:, None], v0, e1, e2)
            t = torch.where(valid, t, K_HUGE)
            k = torch.argmin(t, dim=-1)
            tk = t.gather(-1, k[:, None])[:, 0]
            # objects come in index order: a strict win keeps lowest-index ties
            better = tk < t_best[rows]
            t_best[rows] = torch.where(better, tk, t_best[rows])
            best[rows] = torch.where(better, k + a, best[rows])
    return t_best, best


def occluded(tris: Triangles, o, d, live, t_max=None):
    """Some triangle hit with t <= t_max (unbounded when None) [R] bool."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for a, b, idx in _candidates(tris, o, d, live):
        v0, e1, e2 = tris.v0[a:b][None], tris.e1[a:b][None], tris.e2[a:b][None]
        step = max(1, PAIRS // (b - a))
        for s in range(0, idx.numel(), step):
            rows = idx[s:s + step]
            valid, t, _, _ = moller_trumbore(o[rows][:, None], d[rows][:, None], v0, e1, e2)
            if t_max is not None:
                valid = valid & (t <= t_max[rows][:, None])
            occ[rows] = occ[rows] | valid.any(dim=-1)
    return occ


class Hit(NamedTuple):
    hit: torch.Tensor       # [R] bool
    t: torch.Tensor         # [R]
    tri: torch.Tensor       # [R] int64, -1 on a miss
    position: torch.Tensor  # [R, 3]
    normal: torch.Tensor    # [R, 3] interpolated shading normal
    material: torch.Tensor  # [R] int64 (0 on a miss)


def intersect(tris: Triangles, o, d, live=None) -> Hit:
    """The closest hit, shaded: the winner's exact (u, v, t) again, misses
    sanitised to u = v = 0 and t = K_HUGE, the normal interpolated as
    u n1 + v n2 + (1 - u - v) n0."""
    if live is None:
        live = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    _, tri = closest(tris, o, d, live)
    hit = tri >= 0
    idx = torch.clamp(tri, min=0)
    _, t, u, v = moller_trumbore(o, d, tris.v0[idx], tris.e1[idx], tris.e2[idx])
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    t = torch.where(hit, t, K_HUGE)
    w = (1.0 - u - v)[..., None]
    uu, vv = u[..., None], v[..., None]
    n = normalize(uu * tris.n1[idx] + vv * tris.n2[idx] + w * tris.n0[idx])
    return Hit(hit=hit, t=t, tri=torch.where(hit, tri, -1), position=o + t[..., None] * d,
               normal=n, material=torch.where(hit, tris.material[idx], 0))
