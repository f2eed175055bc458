"""The 4-wide BVH the traversal kernel walks (ops/bvh.collapse_wide) and the
torch replay of the kernel's walk (ops/kernels/traversal.walk_plain):

  - the collapse keeps the binary tree's leaves, leaf order and triangle
    ids, reaches every triangle exactly once, and every child box holds its
    subtree's triangles;
  - the replay (near-first order, explicit lowest-index ties, the
    conservative box test, the triangle test) gives the brute-force
    answer on random rays with masked lanes and bounded t_max, within the
    stack the wrapper sizes from the tree's depth;
  - rays grazing a zero-thickness box: the binary slab test of the first
    kernel misses hits that brute force finds; the new walk does not;
  - the det-first split and early u exit of Moller-Trumbore drop only
    rows the full test rejects;
  - the wrappers refuse a tree deeper than the kernel's stack, and their
    ctypes argument lists match the C entry points.

Eager CPU torch rounds each operation once, as the kernels built with
--fmad=false do on the card, so the replay reproduces the kernel's
arithmetic."""

import ctypes
import re

import numpy as np
import pytest
import torch

from mc_path_tracer_tpu_torch import configs
from mc_path_tracer_tpu_torch.models.primitives import plane
from mc_path_tracer_tpu_torch.models.scene import Scene
from mc_path_tracer_tpu_torch.ops import bvh as tbvh
from mc_path_tracer_tpu_torch.ops import intersect as tisect
from mc_path_tracer_tpu_torch.ops.kernels import build, dense, tonemap, traversal
from mc_path_tracer_tpu_torch.ops.math import K_HUGE
from tests.test_torch_traversal import random_rays, random_tri_arrays


def _random_scene():
    bvh, tris, _ = tbvh.build_bvh(random_tri_arrays(), max_leaf=4, device="cpu")
    return bvh, tris


def _config2_scene():
    scene, _, _, _ = configs.config2_mis_area_light()
    sd = scene.build("cpu")
    return sd.bvh, sd.tris


SCENES = {"random": _random_scene, "config2": _config2_scene}


@pytest.fixture(scope="module", params=sorted(SCENES))
def built(request):
    return SCENES[request.param]()


def _children(wide: np.ndarray, row: int):
    """(slot, ref, lo [3], hi [3]) of each non-empty child of a wide row."""
    refs = wide[row, 24:28].view(np.int32)
    for k in range(tbvh.WIDE):
        if refs[k] != tbvh.EMPTY_REF:
            lo = wide[row, [k, 8 + k, 16 + k]]
            hi = wide[row, [4 + k, 12 + k, 20 + k]]
            yield k, int(refs[k]), lo, hi


def _rows_and_depth(wide: np.ndarray):
    """Every row reached from the root (with repeats, if any) and the
    deepest level."""
    rows, depth = [], 0
    todo = [(0, 1)]
    while todo:
        row, level = todo.pop()
        rows.append(row)
        depth = max(depth, level)
        todo.extend((ref, level + 1) for _, ref, _, _ in _children(wide, row) if ref >= 0)
    return rows, depth


def _slot_order_leaves(wide: np.ndarray, row: int = 0):
    """The leaves' (first, count) in depth-first slot order."""
    out = []
    for _, ref, _, _ in _children(wide, row):
        if ref >= 0:
            out.extend(_slot_order_leaves(wide, ref))
        else:
            out.append(((~ref) >> 4, (~ref) & 15))
    return out


def test_collapse_keeps_leaves_and_reaches_every_triangle_once(built):
    bvh, tris = built
    wide = bvh.wide.numpy()
    count = bvh.count.numpy()
    binary_leaves = list(zip(bvh.first.numpy()[count > 0].tolist(), count[count > 0].tolist()))
    leaves = _slot_order_leaves(wide)
    assert leaves == binary_leaves   # same leaves, in the binary tree's order
    ids = np.concatenate([np.arange(f, f + c) for f, c in leaves])
    np.testing.assert_array_equal(ids, np.arange(tris.num_triangles))
    rows, depth = _rows_and_depth(wide)
    assert sorted(rows) == list(range(wide.shape[0]))   # every row exactly once
    assert depth == bvh.wide_depth
    assert wide.shape == (wide.shape[0], tbvh.WIDE_ROW) and wide.dtype == np.float32
    # 4-wide: far fewer levels and rows than the binary tree
    assert wide.shape[0] < (bvh.num_nodes + 2) // 3


def test_collapse_child_boxes_contain_their_triangles(built):
    bvh, tris = built
    wide = bvh.wide.numpy()
    g = tris.geo.numpy()
    t_lo, t_hi = tbvh.triangle_bounds(g[:, 0:3], g[:, 3:6], g[:, 6:9])

    def subtree(ref):
        if ref < 0:
            first, cnt = (~ref) >> 4, (~ref) & 15
            return np.arange(first, first + cnt)
        return np.concatenate([subtree(r) for _, r, _, _ in _children(wide, ref)])

    checked = 0
    for row in range(wide.shape[0]):
        for _, ref, lo, hi in _children(wide, row):
            ids = subtree(ref)
            assert (lo <= t_lo[ids].min(axis=0)).all() and (hi >= t_hi[ids].max(axis=0)).all()
            # padded strictly outward: no zero-thickness box is left
            assert (lo < t_lo[ids].min(axis=0)).all() and (hi > t_hi[ids].max(axis=0)).all()
            checked += 1
    assert checked == wide.shape[0] - 1 + len(_slot_order_leaves(wide))


def _rays(n, seed, tris):
    ro, rd, mask, t_max = random_rays(n, seed)
    if tris.num_triangles > 1000:   # config2: rays from inside the box
        rng = np.random.default_rng(seed)
        ro = rng.uniform([-1.5, 0.2, -1.5], [1.5, 2.5, 1.5], (n, 3)).astype(np.float32)
    return tisect.pack_rays(*(torch.from_numpy(a) for a in (ro, rd, mask, t_max)))


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_replay_equals_brute_force(built, any_hit):
    bvh, tris = built
    rays = _rays(1500, 21, tris)
    out, stats = traversal.walk_plain(rays, bvh, tris.geo, any_hit=any_hit)
    if any_hit:
        ref = traversal.anyhit_plain(rays, tris.geo)
        assert 0 < int(ref.sum()) < int((rays[:, 6] > 0.5).sum())
        assert torch.equal(out, ref)
    else:
        t_p, id_p = traversal.closest_plain(rays, tris.geo)
        assert (id_p >= 0).sum() > 100
        assert torch.equal(out[1], id_p) and torch.equal(out[0], t_p)
    assert 0 < stats["max_stack"] <= traversal.stack_entries(bvh.wide_depth)
    assert stats["tri_tests"] < (rays[:, 6] > 0.5).sum() * tris.num_triangles / 4


def test_walk_resolves_equal_t_to_the_lowest_index():
    """Two coincident copies of a triangle in different leaves: the hit
    must name the lower index, whatever order the walk meets them in."""
    arrays = random_tri_arrays(n=200, seed=4)
    for k, v in arrays.items():
        arrays[k] = np.concatenate([v, v[:40]])   # triangles 200..239 repeat 0..39
    bvh, tris, _ = tbvh.build_bvh(arrays, max_leaf=4, device="cpu")
    g = tris.geo.numpy()
    # aim rays at the centroids of the repeated triangles, from their front
    cen = g[:, 0:3] + (g[:, 3:6] + g[:, 6:9]) / 3.0
    n = np.cross(g[:, 3:6], g[:, 6:9])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ro = (cen + 0.5 * n).astype(np.float32)
    rd = (-n).astype(np.float32)
    rays = tisect.pack_rays(torch.from_numpy(ro), torch.from_numpy(rd))
    (t, tri_id), _ = traversal.walk_plain(rays, bvh, tris.geo)
    t_p, id_p = traversal.closest_plain(rays, tris.geo)
    assert torch.equal(tri_id, id_p) and torch.equal(t, t_p)
    # some rays do meet two triangles at their closest t
    valid, t_all, _, _ = tisect.moller_trumbore(
        rays[:, None, 0:3], rays[:, None, 3:6], tris.geo[None, :, 0:3],
        tris.geo[None, :, 3:6], tris.geo[None, :, 6:9])
    ties = (valid & (t_all == t_p[:, None])).sum(dim=1)
    assert int((ties > 1).sum()) >= 40


def _plane_scene():
    s = Scene()
    s.set_environment_color((0.5, 0.5, 0.5), ls=1.0)
    p, n, uv, idx = plane(2.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=s.add_material(albedo=(0.7, 0.7, 0.7)))
    return s.build("cpu")


def _grazing_rays(n=20000, seed=5):
    """Rays from above aimed at points on the plane's four edges (x or z =
    +-1 on y = 0), where the hit and the box's side meet."""
    rng = np.random.default_rng(seed)
    along = rng.uniform(-0.99, 0.99, n).astype(np.float32)
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    on_x = rng.random(n) < 0.5
    target = np.zeros((n, 3), np.float32)
    target[:, 0] = np.where(on_x, side, along)
    target[:, 2] = np.where(on_x, along, side)
    ro = rng.uniform([-3, 0.3, -3], [3, 4, 3], (n, 3)).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return tisect.pack_rays(torch.from_numpy(ro), torch.from_numpy(rd))


def _binary_slab_hit(rays, bmin, bmax):
    """The first kernel's box test on one box, in its arithmetic."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, torch.where(d >= 0, 1e-12, -1e-12))
    t0, t1 = (bmin - o) * inv, (bmax - o) * inv
    tnear = torch.minimum(t0, t1).amax(dim=1)
    tfar = torch.maximum(t0, t1).amin(dim=1)
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear <= K_HUGE)


def test_grazing_rays_miss_the_binary_box_but_not_the_wide_walk():
    sd = _plane_scene()
    bvh, tris = sd.bvh, sd.tris
    assert bvh.num_nodes == 1 and bvh.bmin[0, 1] == bvh.bmax[0, 1]   # zero thickness in y
    rays = _grazing_rays()
    t_p, id_p = traversal.closest_plain(rays, tris.geo)
    hit = id_p >= 0
    slab = _binary_slab_hit(rays, bvh.bmin[0], bvh.bmax[0])
    lost = int((hit & ~slab).sum())
    assert lost > 0   # the fault: the triangle test hits, the box test misses
    (t, tri_id), _ = traversal.walk_plain(rays, bvh, tris.geo)
    assert torch.equal(tri_id, id_p) and torch.equal(t, t_p)
    occ, _ = traversal.walk_plain(rays, bvh, tris.geo, any_hit=True)
    assert torch.equal(occ, traversal.anyhit_plain(rays, tris.geo))


def test_early_exits_equal_the_full_test():
    """mt.cuh's det-first split and early u exit (intersect.early_exits)
    drop only rows the full test rejects, on every kind of lane: NaN rows,
    back faces, degenerate triangles, det near K_EPSILON, rays aimed at the
    u = 0 and u = 1 edges to a few ulps, and huge triangles.  Past the exits
    det >= K_EPSILON, where the kernel's 1 / det is the reference's guarded
    reciprocal, so the rows that go on round as the full test does."""
    rng = np.random.default_rng(6)
    n = 6000
    ro = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    e2 = rng.normal(size=(n, 3)).astype(np.float32)
    # targets: centroids, the u = 1 vertex and the u = 0 edge, nudged by ulps
    s = rng.uniform(0.05, 0.95, n).astype(np.float32)
    nudge = (1.0 + rng.integers(-8, 9, n) * 2.0**-23).astype(np.float32)
    target = v0 + (e1 + e2) / 3.0
    target[2500:3500] = v0[2500:3500] + e1[2500:3500] * nudge[2500:3500, None]
    target[3500:4500] = v0[3500:4500] + e2[3500:4500] * s[3500:4500, None] \
        + e1[3500:4500] * (nudge[3500:4500, None] - 1.0)
    huge = slice(4500, 5000)            # det ~ 1e36: 1 / det near subnormal
    for x in (v0, e1, e2, ro):
        x[huge] *= np.float32(1e18)
    target[huge] = v0[huge] + (e1[huge] + e2[huge]) / 3.0
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd[5000:5500] = -rd[5000:5500]      # back faces of the same targets
    e1[:200] = 0.0                      # degenerate: det = 0
    rd[200:400] = e1[200:400]           # ray in the triangle's plane: det = 0
    e1[400:450, 0] = np.nan             # NaN det
    rd[450:500, 1] = np.nan
    ro[500:550, 2] = np.nan             # NaN past the split
    e1[550:600] *= np.float32(1e-4)     # det around K_EPSILON
    e2[550:600] *= np.float32(1e-2)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ro, rd, v0, e1, e2)]
    valid, _, u, _ = tisect.moller_trumbore(*args)
    det_exit, u_exit, det, _, _ = tisect.early_exits(*args)
    assert not valid[det_exit | u_exit].any()
    assert (det[~det_exit] >= tisect.K_EPSILON).all()
    assert not valid[:550].any()
    assert det_exit[:200].all() and det_exit[400:500].all()   # det = 0 and NaN det
    # both exits fire often, and each spares some rows from the division
    assert int(det_exit.sum()) > 1000 and int(u_exit.sum()) > 200
    # every kind of lane is there: hits, back faces, and u just inside and
    # just outside [0, 1] on front faces
    front = ~torch.isnan(u) & (torch.linalg.cross(args[1], args[4]) * args[3]).sum(-1).gt(1e-6)
    assert int(valid.sum()) > 1000 and int((~front).sum()) > 1000
    for lo, hi in ((1.0, 1.0 + 1e-6), (1.0 - 1e-6, 1.0), (-1e-6, 0.0), (0.0, 1e-6)):
        assert int((front & (u > lo) & (u <= hi)).sum()) > 20, (lo, hi)
    assert int(valid[huge].sum()) > 20


@pytest.mark.parametrize("fn", [traversal.trace_closest, traversal.trace_anyhit])
@pytest.mark.parametrize("depth", [0, traversal.MAX_STACK // 3 + 1, 10_000])
def test_wrapper_rejects_a_tree_deeper_than_its_stack(fn, depth):
    bvh, tris = _random_scene()
    rays = _rays(8, 3, tris)
    with pytest.raises(ValueError):
        fn(rays, bvh._replace(wide_depth=depth), tris.geo)


def test_stack_holds_the_deepest_tree_the_wrapper_accepts():
    deepest = traversal.MAX_STACK // 3
    assert traversal.stack_entries(deepest) <= traversal.MAX_STACK
    assert traversal.stack_entries(deepest + 1) > traversal.MAX_STACK


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_signatures(source):
    text = (build.CSRC_DIR / source).read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for p in params.split(","):
            decl = " ".join(p.split()[:-1])
            if "*" in p or "cudaStream_t" in decl:
                kinds.append(ctypes.c_void_p)
            else:
                kinds.append(_C_TYPES[decl.replace("const ", "")])
        out[name] = kinds
    return out


@pytest.mark.parametrize("module, source", [(traversal, "traversal.cu"), (dense, "dense.cu"),
                                            (tonemap, "tonemap.cu")])
def test_ctypes_argument_lists_match_the_c_entry_points(module, source):
    assert _c_signatures(source) == module.ARGTYPES
