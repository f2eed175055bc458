"""On-card correctness gate of the port: the twin of the JAX package's
tests_tpu.py, run on the GPU through the port only.

    python3 -m mc_path_tracer_tpu_torch.tests_tpu [--out PATH]

Each check keeps the JAX gate's name and threshold, so its JSON reads
beside TESTS_TPU_r05.json ("pallas" names the route, accel="pallas", which
takes the traversal kernel here):

  1. pallas_closest_bench / pallas_anyhit_bench: the integrator's
     accel="pallas" dispatch (csrc/traversal.cu over sorted lanes) on the
     bench scene's coherent primary and scattered bounce rays against
     intersect_brute / occluded_brute: >= 99.9% tri-id agreement, t
     allclose on agreeing lanes (closest_agreement: distinct triangles at
     equal t both count as agreeing).
  2. wide_closest_bench / wide_anyhit_bench: ops/wide_bvh.intersect_wide /
     occluded_wide on the same rays against the same oracle.
  3. dense_closest_config1: the dense kernel (accel="dense") on config1's
     64x64 camera rays against intersect_brute.
  4. golden_render_config1 / _config2 / _config3_64 / _config5_96x54:
     renders against tests/golden at the JAX gate's tolerances, config5
     also at the port's own (0.97 of pixels within rtol 1e-3, the frame
     mean within 1e-4).
     Config1's and config3's goldens were rendered from the reference's
     assets: where those are absent (configs.missing_assets) the render
     takes the stand-ins and the check is reported skipped, with the
     reason and the numbers, never passed.
  5. gradients_on_chip: autograd of a config1 8x8 trace against central
     differences in a directional light's ls and the albedo.
  6. stream_closest_500k / stream_anyhit_500k: ten 224x224 UV spheres
     (1,003,520 triangles, the TPU's HBM-streaming size) through the
     kernel route against intersect_wide, and against the brute oracle.
  7. shardmap_pallas_1dev: render_sharded on a one-card mesh against the
     unsharded render_tile_radiance, bit-equal here (the JAX gate's
     deviating-pixel metrics are reported too).

Every check records the kernel launches of the port's call under test
(ops/kernels.LAUNCHES) and fails on the card unless its kernel ran.
Writes the JSON artifact (default TESTS_TORCH_GPU.json at the checkout's
root, gitignored) with the card's name and power limit, prints a summary
and exits non-zero on any failed check.  Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mc_path_tracer_tpu_torch import configs
from mc_path_tracer_tpu_torch.bench import bench_camera, build_bench_scene, card
from mc_path_tracer_tpu_torch.device import resolve_device
from mc_path_tracer_tpu_torch.models import camera as camera_mod
from mc_path_tracer_tpu_torch.models.film import tile_order
from mc_path_tracer_tpu_torch.models.integrator import (
    RenderConfig,
    _intersect,
    _occluded,
    dispatch_route,
    render,
    render_tile_radiance,
    trace_radiance,
)
from mc_path_tracer_tpu_torch.models.primitives import uv_sphere
from mc_path_tracer_tpu_torch.models.scene import Scene
from mc_path_tracer_tpu_torch.ops import rng
from mc_path_tracer_tpu_torch.ops.intersect import intersect_brute, occluded_brute
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
from mc_path_tracer_tpu_torch.ops.math import build_onb
from mc_path_tracer_tpu_torch.ops.wide_bvh import WideBVH, intersect_wide, occluded_wide
from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh
from mc_path_tracer_tpu_torch.parallel.render import render_sharded

ARTIFACT = Path(__file__).resolve().parents[1] / "TESTS_TORCH_GPU.json"
GOLDEN_DIR = Path(__file__).resolve().parents[1] / "tests" / "golden"
# the gate's sizes (tests_tpu.py's)
GATE_RAYS = 2048          # bench primary rays, and as many bounce rays
DENSE_SIZE = 64           # config1's camera rays for the dense kernel
STREAM_SPHERES, STREAM_RINGS = 10, 224
STREAM_RAYS = 2048
SHARD_W, SHARD_H = 128, 64
# (check, config, (width, height), spp, depth, JAX metric, port share or None)
GOLDENS = (("golden_render_config1", 1, "config1", (16, 16), 8, 2, "abs", None),
           ("golden_render_config2", 2, "config2", (16, 16), 8, 3, "abs", None),
           ("golden_render_config3_64", 3, "config3_64", (64, 64), 4, 3, "rel", None),
           ("golden_render_config5_96x54", 5, "config5_96x54", (96, 54), 2, 3, "rel", 0.97))
# the port's golden tolerance (chip_smoke.py [golden]): pixels within
# rtol 1e-3 / atol 1e-5, frame mean within 1e-4
GOLDEN_RTOL, GOLDEN_ATOL, GOLDEN_MEAN_REL = 1e-3, 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def closest_agreement(name, got_t, got_id, want_t, want_id, results, need=0.999) -> bool:
    """tests_tpu.py's verdict: tri-id agreement (-1 = miss), where distinct
    triangles at (float-)equal t both count as agreeing; t allclose
    (rtol 1e-3, atol 1e-4) where the ids agree on a hit."""
    got_t, got_id, want_t, want_id = map(_np, (got_t, got_id, want_t, want_id))
    both = (got_id >= 0) & (want_id >= 0)
    same_id = got_id == want_id
    t_match = both & np.isclose(got_t, want_t, rtol=1e-3, atol=1e-4)
    frac = float(np.mean(same_id | t_match))
    t_ok = bool(np.allclose(got_t[same_id & both], want_t[same_id & both],
                            rtol=1e-3, atol=1e-4))
    ok = frac >= need and t_ok
    results[name] = {"agreement": frac, "t_allclose": t_ok,
                     "n_rays": int(got_id.shape[0]), "pass": ok}
    log(f"{name}: agreement={frac:.6f} t_allclose={t_ok} -> {'PASS' if ok else 'FAIL'}")
    return ok


def anyhit_agreement(name, got, want, results, need=0.999) -> bool:
    got, want = _np(got), _np(want)
    frac = float(np.mean(got == want))
    ok = frac >= need
    results[name] = {"agreement": frac, "n_rays": int(got.shape[0]), "pass": ok}
    log(f"{name}: agreement={frac:.6f} -> {'PASS' if ok else 'FAIL'}")
    return ok


def golden_verdict(got, want, metric: str, share_need=None) -> dict:
    """tests_tpu.py's golden metrics: "abs" (config1, config2): the share
    of pixels whose largest channel error exceeds 0.01 at most 0.02, mean
    error under 2e-3; "rel" (config3, config5): that error over
    max|want| + 1e-2, share above 0.02 at most 0.02, mean under 4e-3.
    Beside them the port's: the share of pixels within GOLDEN_RTOL /
    GOLDEN_ATOL and the frame mean's relative error, held to share_need
    and GOLDEN_MEAN_REL where share_need is given."""
    got, want = _np(got), _np(want)
    per_px = np.abs(got - want).max(axis=-1)
    if metric == "abs":
        err, dev_limit, mean_limit = per_px, 0.01, 2e-3
    else:
        err, dev_limit, mean_limit = per_px / (np.abs(want).max(axis=-1) + 1e-2), 0.02, 4e-3
    dev_frac, mean_err = float(np.mean(err > dev_limit)), float(np.mean(err))
    share = float(np.isclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL).all(axis=-1).mean())
    mean_rel = abs(float(got.mean()) - float(want.mean())) / max(abs(float(want.mean())), 1e-12)
    ok = dev_frac <= 0.02 and mean_err < mean_limit
    if share_need is not None:
        ok = ok and share >= share_need and mean_rel <= GOLDEN_MEAN_REL
    return {"deviating_px_frac": dev_frac, f"mean_{metric}_err": mean_err,
            "share_within_rtol_1e-3": share, "frame_mean_rel": mean_rel,
            "share_needed": share_need, "pass": bool(ok)}


def artifact(checks: dict, device: str, name_limit: str, elapsed_s: float) -> dict:
    """The JSON artifact: the card, every check, the check names by
    outcome ("pass" True, False, or None: skipped, with its reason), and
    the verdict: no check failed."""
    summary = {"passed": [k for k, c in checks.items() if c["pass"] is True],
               "failed": [k for k, c in checks.items() if c["pass"] is False],
               "skipped": [k for k, c in checks.items() if c["pass"] is None]}
    return {"device": device, "platform": "gpu", "card": name_limit, "torch": torch.__version__,
            "cuda": torch.version.cuda, "checks": checks, "summary": summary,
            "elapsed_s": elapsed_s, "ok": not summary["failed"]}


class _Launches:
    """The LAUNCHES added by the port's call under test (read as a
    difference, so a caller's own count runs on); on the card the check
    fails unless one of `kernels` launched."""

    def __init__(self, device: torch.device, *kernels: str):
        self.device, self.kernels, self.got = device, kernels, {}

    def __enter__(self):
        self._sync()
        self.before = dict(LAUNCHES)
        return self

    def __exit__(self, *exc):
        self._sync()
        self.got = {k: v - self.before[k] for k, v in LAUNCHES.items() if v != self.before[k]}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def record(self, check: dict) -> None:
        check["launches"] = self.got
        if self.device.type == "cuda" and not any(self.got.get(k) for k in self.kernels):
            log(f"  no launch of {self.kernels}: {self.got} -> FAIL")
            check["pass"] = False


def _camera_rays(cam_params, width, height, px, py):
    return camera_mod.gen_camera_rays(cam_params, width, height, px, py,
                                      torch.zeros((px.shape[0], 2), device=px.device))


def check_bench(device, checks) -> None:
    """Checks 1-2 on the bench scene."""
    sd = build_bench_scene().build(device)
    route = dispatch_route(sd.tris.num_triangles, device, "pallas", True)
    wide = WideBVH(sd.bvh, sd.tris.geo)
    cam = dataclasses.replace(bench_camera(), aspect=1920 / 1080).params(device)
    pxi, pyi = tile_order(1920, 1080)
    sel = np.linspace(0, pxi.shape[0] - 1, GATE_RAYS).astype(np.int64)
    px = torch.from_numpy(pxi[sel].astype(np.float32)).to(device)
    py = torch.from_numpy(pyi[sel].astype(np.float32)).to(device)
    ro, rd = _camera_rays(cam, 1920, 1080, px, py)
    hit = _intersect(sd, route, ro, rd)
    # scattered bounce rays: uniform over the hemisphere of each hit
    gen = np.random.default_rng(7)
    u = torch.from_numpy(gen.random((GATE_RAYS, 2), dtype=np.float32)).to(device)
    st = torch.sqrt(torch.clamp(1.0 - u[:, 0] ** 2, min=0.0))
    phi = 2.0 * np.pi * u[:, 1]
    n = hit.normal
    tv, bv = build_onb(n)
    bd = (st * torch.cos(phi))[:, None] * tv + (st * torch.sin(phi))[:, None] * bv \
        + u[:, 0:1] * n
    bo = hit.position + n * 0.001
    live = hit.hit[:, None]
    ro_all = torch.cat([ro, torch.where(live, bo, ro)])
    rd_all = torch.cat([rd, torch.where(live, bd, rd)])
    want = intersect_brute(sd.tris, ro_all, rd_all)
    want_id = torch.where(want.hit, want.tri_id, -1)
    for name, fn, kernel in (
        ("pallas_closest_bench", lambda: _intersect(sd, route, ro_all, rd_all), "closest"),
        ("wide_closest_bench", lambda: intersect_wide(wide, sd.tris, ro_all, rd_all), "closest"),
    ):
        with _Launches(device, kernel) as seen:
            got = fn()
        closest_agreement(name, got.t, torch.where(got.hit, got.tri_id, -1), want.t, want_id,
                          checks)
        seen.record(checks[name])

    # any-hit: shadow-style rays off the hits and the reversed directions,
    # with and without a per-ray t_max
    sh_d = torch.cat([rd_all, -rd_all])
    sh_o = torch.cat([torch.where(want.hit[:, None], want.position + want.normal * 0.01, ro_all),
                      ro_all])
    t_max = torch.cat([
        torch.full((GATE_RAYS,), 1e32, device=device),
        torch.from_numpy(gen.uniform(0.5, 20.0, GATE_RAYS).astype(np.float32)).to(device),
        torch.full((2 * GATE_RAYS,), 1e32, device=device)])
    occ_want = occluded_brute(sd.tris, sh_o, sh_d, t_max=t_max)
    for name, fn in (
        ("pallas_anyhit_bench", lambda: _occluded(sd, route, sh_o, sh_d, t_max=t_max)),
        ("wide_anyhit_bench", lambda: occluded_wide(wide, sh_o, sh_d, t_max=t_max)),
    ):
        with _Launches(device, "anyhit") as seen:
            got = fn()
        anyhit_agreement(name, got, occ_want, checks)
        seen.record(checks[name])


def check_dense(device, checks) -> None:
    """Check 3: the dense kernel on config1."""
    s1, cam1, _, _ = configs.ALL_CONFIGS[1]()
    sd1 = s1.build(device)
    cam = dataclasses.replace(cam1, aspect=1.0).params(device)
    ys, xs = torch.meshgrid(torch.arange(DENSE_SIZE, device=device),
                            torch.arange(DENSE_SIZE, device=device), indexing="ij")
    ro, rd = _camera_rays(cam, DENSE_SIZE, DENSE_SIZE, xs.reshape(-1).float(),
                          ys.reshape(-1).float())
    with _Launches(device, "dense_closest") as seen:
        got = _intersect(sd1, "dense", ro, rd)
    want = intersect_brute(sd1.tris, ro, rd)
    closest_agreement("dense_closest_config1", got.t, torch.where(got.hit, got.tri_id, -1),
                      want.t, torch.where(want.hit, want.tri_id, -1), checks)
    seen.record(checks["dense_closest_config1"])


def check_goldens(device, checks) -> None:
    """Check 4: renders against tests/golden, key 42."""
    for name, n, golden, (w, h), spp, depth, metric, share_need in GOLDENS:
        scene, cam, _, _ = configs.ALL_CONFIGS[n]()
        with _Launches(device, "closest", "dense_closest") as seen:
            img = render(scene, cam, w, h, RenderConfig(spp=spp, max_depth=depth),
                         key=rng.prng_key(42), device=device).radiance_mean()
        check = golden_verdict(img, np.load(GOLDEN_DIR / f"{golden}.npy"), metric, share_need)
        check["finite"] = bool(torch.isfinite(img).all())
        check["pass"] = check["pass"] and check["finite"]
        missing = configs.missing_assets(n)
        if missing:
            check["pass"] = None
            check["skipped"] = (f"asset golden: {golden}.npy was rendered from the reference's "
                                f"assets, absent here ({', '.join(missing)}); config{n} renders "
                                "its stand-ins, which cannot match it")
        checks[name] = check
        seen.record(check)
        verdict = {True: "PASS", False: "FAIL", None: "SKIPPED (asset golden)"}[check["pass"]]
        log(f"{name}: dev_frac={check['deviating_px_frac']:.4f} "
            f"mean_{metric}_err={check[f'mean_{metric}_err']:.3e} share within rtol 1e-3 "
            f"{check['share_within_rtol_1e-3']:.6f} -> {verdict}")


def check_gradients(device, checks) -> None:
    """Check 5: d(sum of a config1 8x8 trace)/d(ls, albedo) by autograd
    against central differences."""

    s1, cam1, _, _ = configs.ALL_CONFIGS[1]()
    sd1 = s1.build(device)
    cam = dataclasses.replace(cam1, aspect=1.0).params(device)
    ys, xs = torch.meshgrid(torch.arange(8, device=device), torch.arange(8, device=device),
                            indexing="ij")
    ro, rd = _camera_rays(cam, 8, 8, xs.reshape(-1).float(), ys.reshape(-1).float())
    key, cfg = rng.prng_key(3), RenderConfig(spp=1, max_depth=2)

    def loss(albedo, ls):
        mats = sd1.materials._replace(albedo=albedo.expand_as(sd1.materials.albedo))
        dl = sd1.lights.directional
        dl = dl._replace(ls=torch.cat([ls.reshape(1), dl.ls[1:]]))
        sd2 = sd1._replace(materials=mats, lights=sd1.lights._replace(directional=dl))
        return trace_radiance(sd2, ro, rd, key, cfg).sum()

    a0 = torch.tensor([0.8, 0.8, 0.8], device=device, requires_grad=True)
    ls0 = torch.tensor(2.0, device=device, requires_grad=True)
    with _Launches(device, "closest", "dense_closest") as seen:
        g_albedo, g_ls = torch.autograd.grad(loss(a0, ls0), (a0, ls0))
    eps = 1e-2
    with torch.no_grad():
        a, ls = a0.detach(), ls0.detach()
        fd_ls = (loss(a, ls + eps).item() - loss(a, ls - eps).item()) / (2 * eps)
        e = torch.tensor([eps, 0.0, 0.0], device=device)
        fd_a = (loss(a + e, ls).item() - loss(a - e, ls).item()) / (2 * eps)
    ls_err = abs(g_ls.item() - fd_ls) / max(abs(fd_ls), 1e-8)
    a_err = abs(g_albedo[0].item() - fd_a) / max(abs(fd_a), 1e-8)
    ok = bool(ls_err < 1e-2 and a_err < 2e-2 and abs(fd_ls) > 1e-3 and abs(fd_a) > 1e-3
              and torch.isfinite(g_albedo).all())
    checks["gradients_on_chip"] = {
        "g_ls": g_ls.item(), "fd_ls": fd_ls, "g_albedo0": g_albedo[0].item(),
        "fd_albedo0": fd_a, "rel_err_ls": ls_err, "rel_err_albedo": a_err, "pass": ok}
    log(f"gradients_on_chip: ls {g_ls.item():.4f} vs fd {fd_ls:.4f}; albedo0 "
        f"{g_albedo[0].item():.4f} vs fd {fd_a:.4f} -> {'PASS' if ok else 'FAIL'}")
    seen.record(checks["gradients_on_chip"])


def check_stream(device, checks) -> None:
    """Check 6: tests_tpu.py's big scene (STREAM_SPHERES UV spheres of
    STREAM_RINGS rings and segments) through the kernel route against
    intersect_wide (as the JAX gate) and against the brute oracle."""

    scene = Scene()
    scene.set_environment_color((0.5, 0.5, 0.5), ls=1.0)
    mb = scene.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.6)
    gen = np.random.default_rng(3)
    for _ in range(STREAM_SPHERES):
        c = gen.uniform(-6, 6, 3)
        c[1] = abs(c[1])
        p, nn, uvs, idx = uv_sphere(1.2, center=tuple(c), rings=STREAM_RINGS,
                                    segments=STREAM_RINGS)
        scene.add_mesh(p, idx, normals=nn, uvs=uvs, material_id=mb)
    sd = scene.build(device)
    route = dispatch_route(sd.tris.num_triangles, device, "pallas", True)
    wide = WideBVH(sd.bvh, sd.tris.geo)
    ro = torch.from_numpy(gen.uniform(-8, 8, (STREAM_RAYS, 3)).astype(np.float32)).to(device)
    rd = torch.from_numpy(gen.normal(size=(STREAM_RAYS, 3)).astype(np.float32)).to(device)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    with _Launches(device, "closest") as seen:
        gp = _intersect(sd, route, ro, rd)
    gw = intersect_wide(wide, sd.tris, ro, rd)
    gb = intersect_brute(sd.tris, ro, rd)
    ids = [torch.where(h.hit, h.tri_id, -1) for h in (gp, gw, gb)]
    brute = {}
    ok = closest_agreement("stream_closest_500k", gp.t, ids[0], gw.t, ids[1], checks)
    ok_b = closest_agreement("stream_closest_500k against brute", gp.t, ids[0], gb.t, ids[2],
                             brute)
    check = checks["stream_closest_500k"]
    check.update({"n_tris": sd.tris.num_triangles, "n_wide_nodes": int(sd.bvh.wide.shape[0]),
                  "wide_depth": sd.bvh.wide_depth,
                  "brute_agreement": brute["stream_closest_500k against brute"]["agreement"],
                  "pass": ok and ok_b})
    seen.record(check)
    with _Launches(device, "anyhit") as seen:
        op = _occluded(sd, route, ro, rd)
    ow = occluded_wide(wide, ro, rd)
    ob = occluded_brute(sd.tris, ro, rd)
    ok = anyhit_agreement("stream_anyhit_500k", op, ow, checks)
    ok_b = anyhit_agreement("stream_anyhit_500k against brute", op, ob, brute)
    check = checks["stream_anyhit_500k"]
    check.update({"brute_agreement": brute["stream_anyhit_500k against brute"]["agreement"],
                  "pass": ok and ok_b})
    seen.record(check)


def check_sharded(device, checks) -> None:
    """Check 7: render_sharded on a one-card mesh against the unsharded
    render of the same rows."""

    sd = build_bench_scene().build(device)
    cam = dataclasses.replace(bench_camera(), aspect=1920 / 1080).params(device)
    cfg, key = RenderConfig(spp=2, max_depth=3, accel="pallas"), rng.prng_key(11)
    with _Launches(device, "closest") as seen:
        sharded = render_sharded(sd, cam, SHARD_W, SHARD_H, cfg, key=key,
                                 mesh=make_mesh(devices=[device]))
    ys, xs = torch.meshgrid(torch.arange(SHARD_H, device=device),
                            torch.arange(SHARD_W, device=device), indexing="ij")
    plain = render_tile_radiance(sd, cam, SHARD_W, SHARD_H, xs.reshape(-1).float(),
                                 ys.reshape(-1).float(), key, cfg).reshape(SHARD_H, SHARD_W, 3)
    a, b = _np(sharded), _np(plain)
    rel = np.abs(a - b).max(axis=-1) / (np.abs(b).max(axis=-1) + 1e-3)
    dev_frac = float(np.mean(rel > 0.02))
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-6)
    equal = bool(torch.equal(sharded, plain))
    ok = bool(equal and dev_frac <= 0.02 and mean_rel < 1e-3 and np.isfinite(a).all())
    checks["shardmap_pallas_1dev"] = {"deviating_px_frac": dev_frac, "mean_rel_err": mean_rel,
                                      "bit_equal": equal, "pass": ok}
    log(f"shardmap_pallas_1dev: bit_equal={equal} dev_frac={dev_frac:.4f} "
        f"mean_rel={mean_rel:.2e} -> {'PASS' if ok else 'FAIL'}")
    seen.record(checks["shardmap_pallas_1dev"])


def run(device="cuda", name_limit: str = "", out: Path | None = ARTIFACT) -> dict:
    """Every check on `device`; returns the artifact (`name_limit`: the
    card's name and power limit), written to `out` unless None."""

    device = resolve_device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    checks: dict = {}
    t0 = time.perf_counter()
    for step in (check_bench, check_dense, check_goldens, check_gradients, check_stream,
                 check_sharded):
        step(device, checks)
        log(f"[{time.perf_counter() - t0:7.1f}s] {step.__name__} done")
    result = artifact(checks, name, name_limit, time.perf_counter() - t0)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1))
        log(f"wrote {out}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("mc_path_tracer_tpu_torch.tests_tpu",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ARTIFACT), help="the JSON artifact's path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the gate runs only on a GPU (device='cpu' is "
                           "for run() in rehearsals)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the camera's unprojection needs full f32
    name_limit = card()
    log(f"device: {torch.cuda.get_device_name(0)} ({name_limit})")
    result = run("cuda", name_limit, Path(args.out))
    log(json.dumps({"summary": result["summary"], "ok": result["ok"], "card": name_limit}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
