"""BVH traversal: the CUDA kernel's wrappers (`trace_closest`,
`trace_anyhit`), their plain PyTorch versions (`closest_plain`,
`anyhit_plain`), and a torch replay of the kernel's walk (`walk_plain`).

The kernel (csrc/traversal.cu) replaces the TPU arena traversal kernel,
mc_path_tracer_tpu/ops/pallas/traversal_kernel.py `_make_arena_kernel`.
It walks the 4-wide table of ops/bvh.collapse_wide near-first.  Contract
(see ops/intersect.py for the layouts):
  trace_closest(rays [R,8], bvh, geo [T,9])
      -> (t [R] f32, tri_id [R] i32): ties in t to the lowest index;
      K_HUGE and -1 on a miss or a dead lane.
  trace_anyhit(rays, bvh, geo) -> occ [R] bool: some triangle hit with
      t <= t_max; False on a dead lane.
`bvh` is the scene's BVHArrays: the kernel walks its `wide` table with a
per-thread stack of stack_entries(bvh.wide_depth) entries, taken from the
same record so the two cannot be paired wrongly, and a tree deeper than
MAX_STACK allows is refused.

The plain versions are the dense kernel's (ops/kernels/dense.py) too: they
are all rays x all triangles with lowest-index ties.  A wrapper runs the
plain version only because its tensors lie on the CPU; on a CUDA tensor it
launches the kernel or raises.  LAUNCHES (ops/kernels) counts the launches.
`walk_plain` is a test and counting aid, never the main path.

`sort_perm` orders a dispatch's lanes by direction octant, dead lanes
last (RenderConfig.sort_rays, models/integrator.py).
"""

from __future__ import annotations

import ctypes

import torch

from mc_path_tracer_tpu_torch.ops import intersect
from mc_path_tracer_tpu_torch.ops.bvh import EMPTY_REF, WIDE, WIDE_ROW
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, build, check_rows, launch
from mc_path_tracer_tpu_torch.ops.math import K_HUGE
from mc_path_tracer_tpu_torch.utils.profiling import spanned

# ray x triangle pairs per chunk of the plain versions: bounds their
# [chunk, T] temporaries (~64 MB each) instead of materializing R x T
PLAIN_PAIRS = 1 << 24
# per-thread stack entries the kernel accepts: 64 tree levels, 96 KB of
# shared memory per 64-thread block for closest hits (48 KB for any-hit)
MAX_STACK = 192
# csrc/traversal.cu kTfarScale: 1 + 2^-21 >= 1 + 2 gamma(3)
TFAR_SCALE = 1.0 + 2.0**-21

_P = ctypes.c_void_p
_I = ctypes.c_int
# the C entry points of csrc/traversal.cu: pointers and the stream as void*
ARGTYPES = {
    "mcpt_closest": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P],
    "mcpt_anyhit": [_P, _I, _P, _I, _P, _I, _I, _P, _P],
}


def stack_entries(depth: int) -> int:
    """Stack entries a walk of a `depth`-level wide tree needs: a node at
    level L is entered with at most 3 (L - 1) entries below it (the
    siblings left at each level above) and pushes at most 3 more."""
    return 3 * depth


def _tree(rays: torch.Tensor, bvh: intersect.BVHArrays, geo: torch.Tensor):
    """The wide table and the stack entries its walk needs, after the
    shape checks; refuses a tree deeper than the kernel's stack."""
    check_rows(("rays", rays, 8), ("nodes", bvh.wide, WIDE_ROW), ("geo", geo, 9))
    depth = bvh.wide_depth
    if depth < 1:
        raise ValueError(f"a wide tree has depth >= 1, got {depth}")
    need = stack_entries(depth)
    if need > MAX_STACK:
        raise ValueError(f"a {depth}-level tree needs {need} stack entries per ray; "
                         f"the traversal kernel holds {MAX_STACK}")
    return bvh.wide, need


def trace_closest(rays: torch.Tensor, bvh: intersect.BVHArrays, geo: torch.Tensor):
    """Closest hit per ray: (t [R] f32, tri_id [R] int32)."""
    nodes, cap = _tree(rays, bvh, geo)
    if rays.device.type == "cpu":
        return closest_plain(rays, geo)
    r = rays.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=rays.device)
    tri_id = torch.empty(r, dtype=torch.int32, device=rays.device)
    if r:
        lib = build.bind("traversal", ARGTYPES)
        with torch.cuda.device(rays.device):
            stream = torch.cuda.current_stream().cuda_stream
            launch(lib.mcpt_closest, "closest", rays.data_ptr(), r,
                   nodes.data_ptr(), nodes.shape[0], geo.data_ptr(), geo.shape[0], cap,
                   t.data_ptr(), tri_id.data_ptr(), stream)
    return t, tri_id


def trace_anyhit(rays: torch.Tensor, bvh: intersect.BVHArrays, geo: torch.Tensor):
    """Occlusion per ray: occ [R] bool (a hit with t <= t_max)."""
    nodes, cap = _tree(rays, bvh, geo)
    if rays.device.type == "cpu":
        return anyhit_plain(rays, geo)
    r = rays.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=rays.device)
    if r:
        lib = build.bind("traversal", ARGTYPES)
        with torch.cuda.device(rays.device):
            stream = torch.cuda.current_stream().cuda_stream
            launch(lib.mcpt_anyhit, "anyhit", rays.data_ptr(), r,
                   nodes.data_ptr(), nodes.shape[0], geo.data_ptr(), geo.shape[0], cap,
                   occ.data_ptr(), stream)
    return occ


@spanned("mcpt::sort")
def sort_perm(rd: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Stable permutation [R] (int64) that groups a dispatch's lanes by
    direction octant, (dx > 0) * 4 + (dy > 0) * 2 + (dz > 0), with dead
    lanes (mask False) last as bin 8: the JAX package's
    `_sort_perm(rd, mask)` (traversal_kernel.py, `_dir_bins(rd, fine=False)`
    and its global argsort).  Stability keeps the caller's tile order inside
    each bin and makes the permutation a function of the inputs alone, so a
    replayed sample meets the forward's lanes.  The TPU's block-local fine
    re-sort is left out: it lines 64-ray subgroups of a 256-ray block up
    with the arena kernel's subgroup bitmasks, which this kernel does not
    have.  Plain PyTorch on either device (one sort, no host sync)."""
    LAUNCHES["sort"] += 1
    key = ((rd[:, 0] > 0).to(torch.int32) * 4 + (rd[:, 1] > 0).to(torch.int32) * 2
           + (rd[:, 2] > 0).to(torch.int32))
    if mask is not None:
        key = torch.where(mask, key, 8)
    return torch.sort(key, stable=True).indices


def _chunks(rays: torch.Tensor, geo: torch.Tensor):
    """Ray slices of the plain versions, each tested against all
    triangles: (start, end, valid [c, T], t [c, T])."""
    step = max(1, PLAIN_PAIRS // max(geo.shape[0], 1))
    v0, e1, e2 = geo[None, :, 0:3], geo[None, :, 3:6], geo[None, :, 6:9]
    for s in range(0, rays.shape[0], step):
        c = rays[s : s + step]
        valid, t, _, _ = intersect.moller_trumbore(
            c[:, None, 0:3], c[:, None, 3:6], v0, e1, e2
        )
        yield s, s + c.shape[0], valid, t


def closest_plain(rays: torch.Tensor, geo: torch.Tensor):
    """Brute-force closest hit: every ray against every triangle
    (intersect_brute's argmin, so ties go to the lowest index), honouring
    the live column."""
    LAUNCHES["plain"] += 1
    r = rays.shape[0]
    t_out = torch.full((r,), K_HUGE, dtype=torch.float32, device=rays.device)
    id_out = torch.full((r,), -1, dtype=torch.int32, device=rays.device)
    live = rays[:, 6] > 0.5
    for s, e, valid, t in _chunks(rays, geo):
        t_masked = torch.where(valid, t, K_HUGE)
        best = torch.argmin(t_masked, dim=-1)
        t_best = t_masked.gather(-1, best[:, None])[:, 0]
        hit = (t_best < K_HUGE) & live[s:e]
        t_out[s:e] = torch.where(hit, t_best, K_HUGE)
        id_out[s:e] = torch.where(hit, best.to(torch.int32), -1)
    return t_out, id_out


def anyhit_plain(rays: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
    """Brute-force occlusion: some triangle hit with t <= t_max, on live
    lanes (occluded_brute plus the live column)."""
    LAUNCHES["plain"] += 1
    occ = torch.zeros(rays.shape[0], dtype=torch.bool, device=rays.device)
    live = rays[:, 6] > 0.5
    for s, e, valid, t in _chunks(rays, geo):
        blocked = (valid & (t <= rays[s:e, 7:8])).any(dim=-1)
        occ[s:e] = blocked & live[s:e]
    return occ


def walk_plain(rays: torch.Tensor, bvh: intersect.BVHArrays, geo: torch.Tensor,
               any_hit: bool = False):
    """The kernel's walk replayed with torch, all rays in lock step: the
    same box test (padded boxes, tfar scaled by TFAR_SCALE), the same
    child order ((tnear, slot) for closest hits, slot order for any-hit),
    the same stack discipline and pruning, and the triangle test
    (intersect.moller_trumbore: mt.cuh's early exits only drop rows it
    rejects too, tests/test_torch_walk.py).  Returns the
    kernel's output, (t, tri_id) or occ, and the counts {visits: wide nodes
    loaded, box_tests: non-empty child boxes tested, leaves: leaves entered,
    tri_tests: triangle tests, max_stack: deepest stack, steps_mean and
    steps_max: loop steps (a node or a leaf each) per live ray,
    warp_steps_mean: the mean over the kernel's warps (32 consecutive rays)
    of their longest lane's steps}."""
    nodes, cap = _tree(rays, bvh, geo)
    dev = rays.device
    n_rays = rays.shape[0]
    idx = torch.nonzero(rays[:, 6] > 0.5).squeeze(1)
    o, d, t_max = rays[idx, 0:3], rays[idx, 3:6], rays[idx, 7]
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, torch.where(d >= 0, 1e-12, -1e-12))
    n = idx.numel()
    refs = nodes[:, 24:24 + WIDE].contiguous().view(torch.int32).long()
    lo_cols = torch.tensor([[8 * a + k for k in range(WIDE)] for a in range(3)], device=dev)
    ref = torch.zeros(n, dtype=torch.long, device=dev)
    sp = torch.zeros(n, dtype=torch.long, device=dev)
    st_ref = torch.zeros((n, cap), dtype=torch.long, device=dev)
    st_t = torch.zeros((n, cap), dtype=torch.float32, device=dev)
    t_best = torch.full((n,), K_HUGE, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.long, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    steps = torch.zeros(n_rays, dtype=torch.long, device=dev)
    stats = dict(visits=0, box_tests=0, leaves=0, tri_tests=0, max_stack=0)
    while True:
        act = torch.nonzero(alive).squeeze(1)
        if not act.numel():
            break
        steps[idx[act]] += 1
        cur = ref[act]
        pop = []
        # inner nodes: four box tests, order, push all hit children but the first
        a = act[cur >= 0]
        if a.numel():
            row = nodes[ref[a]]
            c = refs[ref[a]]
            oo, ii = o[a][:, :, None], inv[a][:, :, None]
            t0 = (row[:, lo_cols] - oo) * ii
            t1 = (row[:, lo_cols + WIDE] - oo) * ii
            tnear = torch.minimum(t0, t1).amax(dim=1)
            tfar = torch.maximum(t0, t1).amin(dim=1) * TFAR_SCALE
            limit = (t_max if any_hit else t_best)[a][:, None]
            full = c != EMPTY_REF
            hit = full & (tnear <= tfar) & (tfar >= 0.0) & (tnear <= limit)
            key = torch.where(hit, tnear, float("inf"))
            by = (~hit).to(torch.int8) if any_hit else key
            perm = torch.sort(by, dim=1, stable=True).indices
            key, c = key.gather(1, perm), c.gather(1, perm)
            nh = hit.sum(dim=1)
            stats["visits"] += a.numel()
            stats["box_tests"] += int(full.sum().item())
            for j in range(WIDE - 1, 0, -1):
                m = j < nh
                rows = a[m]
                pos = sp[rows]
                st_ref[rows, pos] = c[m, j]
                st_t[rows, pos] = key[m, j]
                sp[rows] += 1
            stats["max_stack"] = max(stats["max_stack"], int(sp[a].max().item()))
            down = nh > 0
            ref[a[down]] = c[down, 0]
            pop.append(a[~down])
        # leaves: test the triangles in index order
        lf = act[cur < 0]
        if lf.numel():
            meta = ~ref[lf]
            first, count = meta >> 4, meta & 15
            stats["leaves"] += lf.numel()
            stop = torch.zeros(lf.numel(), dtype=torch.bool, device=dev)
            for k in range(int(count.max().item())):
                m = (k < count) & ~stop
                sel, tid = lf[m], first[m] + k
                stats["tri_tests"] += sel.numel()
                g = geo[tid]
                valid, t, _, _ = intersect.moller_trumbore(o[sel], d[sel], g[:, 0:3],
                                                           g[:, 3:6], g[:, 6:9])
                if any_hit:
                    blocked = valid & (t <= t_max[sel])
                    occ[sel[blocked]] = True
                    stop[torch.nonzero(m).squeeze(1)[blocked]] = True
                else:
                    tb, bb = t_best[sel], best[sel]
                    better = valid & ((t < tb) | ((t == tb) & (tid < bb)))
                    t_best[sel] = torch.where(better, t, tb)
                    best[sel] = torch.where(better, tid, bb)
            alive[lf[stop]] = False
            pop.append(lf[~stop])
        # pop the nearest entry not pruned by t_best
        p = torch.cat(pop)
        while p.numel():
            empty = sp[p] == 0
            alive[p[empty]] = False
            p = p[~empty]
            sp[p] -= 1
            e_ref, e_t = st_ref[p, sp[p]], st_t[p, sp[p]]
            ok = torch.ones_like(e_t, dtype=torch.bool) if any_hit else e_t <= t_best[p]
            ref[p[ok]] = e_ref[ok]
            p = p[~ok]
    live_steps = steps[idx].float()
    warps = torch.nn.functional.pad(steps, (0, -n_rays % 32)).view(-1, 32).amax(dim=1)
    stats.update(steps_mean=round(live_steps.mean().item(), 3) if n else 0.0,
                 steps_max=int(live_steps.max().item()) if n else 0,
                 warp_steps_mean=round(warps.float().mean().item(), 3))
    if any_hit:
        out = torch.zeros(n_rays, dtype=torch.bool, device=dev)
        out[idx] = occ
        return out, stats
    t_out = torch.full((n_rays,), K_HUGE, dtype=torch.float32, device=dev)
    id_out = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    hit = best >= 0
    t_out[idx[hit]] = t_best[hit]
    id_out[idx[hit]] = best[hit].to(torch.int32)
    return (t_out, id_out), stats
