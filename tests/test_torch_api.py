"""The port's public API against the JAX package's.

A scan of every JAX module's top-level public names (and of the three
scripts with twins) fails on any name without a namesake in the port, the
entries of ROADMAP's "Do not port" list aside (NOT_PORTED below).  The
routes that closed the last gaps are held against their JAX functions on
the same numpy-seeded triangles and rays: `build_accel`, `pack_bvh` and
`build_wide` (tables equal bit for bit), `intersect_wide` /
`intersect_bvh` (hit ids exact, t within rtol 1e-5 where the ids agree:
the port recomputes the winner's exact t, the JAX walks keep theirs) and
`occluded_wide` / `occluded_bvh` (exact), on the CPU, where the kernel's
wrapper runs its plain version.  Then the env-mode constants,
`utils/gltf.compute_tangents` (exact), and the pure parts of the gate twin
(`mc_path_tracer_tpu_torch.tests_tpu`): its verdicts against tests_tpu.py's
on stand-in arrays and its JSON fields, with no card."""

import ast
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests_tpu as jgate
from mc_path_tracer_tpu.models import lights as jlights
from mc_path_tracer_tpu.ops import bvh as jbvh
from mc_path_tracer_tpu.ops import envmap as jenv
from mc_path_tracer_tpu.ops import intersect as jisect
from mc_path_tracer_tpu.ops import wide_bvh as jwide
from mc_path_tracer_tpu.utils import gltf as jgltf
from mc_path_tracer_tpu_torch import tests_tpu as gate
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models import lights as tlights
from mc_path_tracer_tpu_torch.ops import bvh as tbvh
from mc_path_tracer_tpu_torch.ops import envmap as tenv
from mc_path_tracer_tpu_torch.ops import intersect as tisect
from mc_path_tracer_tpu_torch.ops import wide_bvh as twide
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from mc_path_tracer_tpu_torch.utils import gltf as tgltf
from mc_path_tracer_tpu_torch.utils import mesh as tmesh
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_traversal import random_tri_arrays

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "mc_path_tracer_tpu"
# ROADMAP "Do not port": JAX module (path in the package) -> its names that
# have no namesake, "*" for the whole module.  The Pallas modules' kernels
# are ported into ops/kernels (KERNEL_MODULES); their names are the TPU's
# block sizes, VMEM budgets, leaf tables and A/B knobs.
NOT_PORTED = {
    "utils/compcache.py": "*",
    "ops/pallas/__init__.py": "*",
    "ops/pallas/traversal_kernel.py": "*",
    "ops/pallas/intersect_kernel.py": "*",
    "ops/pallas/tonemap_kernel.py": "*",
    "__main__.py": "*",
    "ops/wide_bvh.py": {"WIDE_UNROLL", "RESCUE_STEPS", "RESCUE_LANES"},   # _traverse_wide's
    "ops/intersect.py": {"TRAVERSE_CHUNK", "TRAVERSE_UNROLL"},             # _traverse's
    "ops/rng.py": {"bounce_key"},
    "models/integrator.py": {"sg"},
    "utils/profiling.py": {"xla_trace"},                                  # -> device_trace
    # the port's intersect_brute / occluded_brute bound their own temporaries
    "tests_tpu.py": {"brute_chunked", "occluded_brute_chunked"},
}
KERNEL_MODULES = {   # Pallas module -> (port module, its kernel wrappers)
    "ops/pallas/traversal_kernel.py": ("mc_path_tracer_tpu_torch.ops.kernels.traversal",
                                       ("trace_closest", "trace_anyhit")),
    "ops/pallas/intersect_kernel.py": ("mc_path_tracer_tpu_torch.ops.kernels.dense",
                                       ("dense_closest", "dense_anyhit")),
    "ops/pallas/tonemap_kernel.py": ("mc_path_tracer_tpu_torch.ops.kernels.tonemap",
                                     ("tonemap",)),
}
# the JAX package's scripts and their twins in the port
TWINS = {"bench.py": "mc_path_tracer_tpu_torch.bench",
         "bench_scaling.py": "mc_path_tracer_tpu_torch.bench_scaling",
         "tests_tpu.py": "mc_path_tracer_tpu_torch.tests_tpu"}


def public_names(path: Path) -> list[str]:
    """Top-level public functions, classes and assigned names of a source."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def port_module(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    return ".".join(("mc_path_tracer_tpu_torch",) + parts[:-1] if parts[-1] == "__init__"
                    else ("mc_path_tracer_tpu_torch",) + parts)


def test_every_public_name_has_a_namesake():
    sources = {str(p.relative_to(JAX_PKG)): (p, port_module(str(p.relative_to(JAX_PKG))))
               for p in sorted(JAX_PKG.rglob("*.py"))}
    sources.update({name: (REPO / name, twin) for name, twin in TWINS.items()})
    assert len(sources) > 30 and set(NOT_PORTED) <= set(sources)
    gaps = {}
    for rel, (path, module) in sources.items():
        skip = NOT_PORTED.get(rel, set())
        if skip == "*":
            continue
        port = importlib.import_module(module)
        missing = [n for n in public_names(path) if n not in skip and not hasattr(port, n)]
        if missing:
            gaps[rel] = missing
    assert not gaps, gaps
    for rel, (module, wrappers) in KERNEL_MODULES.items():
        assert NOT_PORTED[rel] == "*"
        assert all(callable(getattr(importlib.import_module(module), w)) for w in wrappers), rel


def aimed_rays(n=384, seed=21):
    """Rays from a sphere of radius 6 toward points of the triangles' cube,
    some masked, half with a finite t_max."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (6.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-2, 2, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mask = rng.random(n) < 0.85
    t_max = np.where(rng.random(n) < 0.5, rng.uniform(3.0, 8.0, n), 1e32).astype(np.float32)
    return o, d, mask, t_max


@pytest.fixture(scope="module")
def routes():
    """Both packages' accelerators over the same triangles, and the JAX
    routes' outputs on the same rays (one compiled program)."""
    arrays = random_tri_arrays(n=300, seed=17)
    jtris = jisect.TriangleSoA(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jb, jw, jt = jbvh.build_accel(jtris, max_leaf=4)
    ro, rd, mask, t_max = aimed_rays()

    @jax.jit
    def jax_routes(o, d, m, tm):
        return {"wide": (jwide.intersect_wide(jw, jt, o, d, mask=m),
                         jwide.occluded_wide(jw, o, d, mask=m, t_max=tm)),
                "bvh": (jisect.intersect_bvh(jb, jt, o, d, mask=m),
                        jisect.occluded_bvh(jb, jt, o, d, mask=m, t_max=tm))}

    want = jax.tree.map(np.asarray, jax_routes(ro, rd, mask, t_max))
    rays = tuple(torch.from_numpy(x) for x in (ro, rd, mask, t_max))
    return dict(arrays=arrays, jax=(jb, jt), want=want, rays=rays,
                port=tbvh.build_accel(arrays, max_leaf=4, device="cpu"))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_build_accel_matches_jax(routes):
    (jb, jt), (tb, tw, tt) = routes["jax"], routes["port"]
    for name in ("bmin", "bmax", "first", "count", "skip"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(_bits(tb.packed), _bits(jb.packed))
    for name in ("v0", "e1", "e2", "material_id"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
    assert isinstance(tw, twide.WideBVH) and tw.bvh is tb and tw.geo is tt.geo
    assert tw.depth == tb.wide_depth and tw.num_rows == tb.wide.shape[0]


def test_pack_bvh_and_build_wide_take_the_jax_inputs(routes):
    (jb, jt), (tb, tw, _) = routes["jax"], routes["port"]
    flat = [np.asarray(getattr(jb, k)) for k in ("bmin", "bmax", "first", "count", "skip")]
    jpacked = jisect.pack_bvh(*(jnp.asarray(x) for x in flat)).packed
    packed = tisect.pack_bvh(*flat, device="cpu")
    np.testing.assert_array_equal(_bits(packed.packed), _bits(jpacked))
    np.testing.assert_array_equal(_bits(packed.wide), _bits(tb.wide))
    assert packed.wide_depth == tb.wide_depth
    # tensors keep their device; the JAX layout's constants keep their values
    assert tisect.pack_bvh(tb.bmin, tb.bmax, tb.first, tb.count, tb.skip).wide.device == \
        tb.wide.device
    wide = twide.build_wide(*flat, np.asarray(jt.v0), np.asarray(jt.e1), np.asarray(jt.e2),
                            device="cpu")
    np.testing.assert_array_equal(_bits(wide.rows), _bits(tw.rows))
    np.testing.assert_array_equal(wide.geo.numpy(), tw.geo.numpy())
    for name in ("N_COMP", "LANES", "BRANCHING", "LEAF_TRIS"):
        assert getattr(twide, name) == getattr(jwide, name)


def _port_route(routes, kind):
    tb, tw, tt = routes["port"]
    ro, rd, mask, t_max = routes["rays"]
    if kind == "wide":
        return (twide.intersect_wide(tw, tt, ro, rd, mask=mask),
                twide.occluded_wide(tw, ro, rd, mask=mask, t_max=t_max))
    return (tisect.intersect_bvh(tb, tt, ro, rd, mask=mask),
            tisect.occluded_bvh(tb, tt, ro, rd, mask=mask, t_max=t_max))


@pytest.mark.parametrize("kind", ["wide", "bvh"])
def test_routes_match_jax(routes, kind):
    reset_launches()
    hit, occ = _port_route(routes, kind)
    assert LAUNCHES["plain"] == 2     # the kernel's plain version, on the CPU
    jhit, jocc = routes["want"][kind]
    live = routes["rays"][2].numpy()
    assert 0.2 < jhit.hit[live].mean() < 0.95 and 0.1 < jocc[live].mean() < 0.95
    got_id = hit.tri_id.numpy()
    np.testing.assert_array_equal(got_id, np.where(jhit.hit, jhit.tri_id, -1))
    np.testing.assert_array_equal(hit.hit.numpy(), jhit.hit)
    assert not hit.hit.numpy()[~live].any()
    h = jhit.hit
    np.testing.assert_allclose(hit.t.numpy()[h], jhit.t[h], rtol=1e-5)
    np.testing.assert_array_equal(occ.numpy(), jocc)


def test_routes_are_the_integrators_dispatch(routes):
    """intersect_bvh / occluded_bvh are what the integrator's "bvh" and
    "sorted" routes call: the same hits, sorted or not, and one sort_perm
    per sorted dispatch."""
    tb, _, tt = routes["port"]
    ro, rd, mask, t_max = routes["rays"]
    scene = tint.SceneData(tris=tt, bvh=tb, materials=None, lights=None)
    want = tisect.intersect_bvh(tb, tt, ro, rd, mask=mask)
    want_occ = tisect.occluded_bvh(tb, tt, ro, rd, mask=mask, t_max=t_max)
    for route in ("bvh", "sorted"):
        reset_launches()
        got = tint._intersect(scene, route, ro, rd, mask=mask)
        occ = tint._occluded(scene, route, ro, rd, mask=mask, t_max=t_max)
        assert LAUNCHES["sort"] == (2 if route == "sorted" else 0)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(occ, want_occ)
    sorted_hit = tisect.intersect_bvh(tb, tt, ro, rd, mask=mask, sort=True)
    assert torch.equal(sorted_hit.tri_id, want.tri_id)


def test_env_modes():
    assert (tenv.COLOR_MODE, tenv.HDRI_MODE) == (jenv.COLOR_MODE, jenv.HDRI_MODE)
    tex = np.random.default_rng(2).random((4, 8, 3)).astype(np.float32)
    for make_j, make_t, mode in (
        (lambda: jlights.make_env_color((0.2, 0.3, 0.4)),
         lambda: tlights.make_env_color((0.2, 0.3, 0.4), device="cpu"), tenv.COLOR_MODE),
        (lambda: jlights.make_env_hdri(tex), lambda: tlights.make_env_hdri(tex, device="cpu"),
         tenv.HDRI_MODE),
    ):
        assert tlights.env_is_hdri(make_t()) == jlights.env_is_hdri(make_j()) == \
            (mode == jenv.HDRI_MODE)


def test_compute_tangents_from_gltf():
    assert tgltf.compute_tangents is tmesh.compute_tangents
    rng = np.random.default_rng(5)
    p = rng.normal(size=(40, 3)).astype(np.float32)
    n = rng.normal(size=(40, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uv = rng.random((40, 2)).astype(np.float32)
    idx = rng.integers(0, 40, (60, 3))
    np.testing.assert_array_equal(tgltf.compute_tangents(p, n, uv, idx),
                                  np.asarray(jgltf.compute_tangents(p, n, uv, idx)))


def _stand_in(seed=3, n=4000):
    rng = np.random.default_rng(seed)
    want_id = np.where(rng.random(n) < 0.7, rng.integers(0, 500, n), -1)
    want_t = np.where(want_id >= 0, rng.uniform(0.5, 9.0, n), 1e32).astype(np.float32)
    return rng, want_t, want_id


@pytest.mark.parametrize("flips", [0, 3, 5, 40])
def test_gate_verdicts_match_tests_tpu(flips, capsys):
    """The twin's closest and any-hit verdicts give tests_tpu.py's on the
    same stand-in hits: a few flipped ids pass 99.9%, more fail; distinct
    ids at equal t agree; an off t fails the allclose."""
    rng, want_t, want_id = _stand_in()
    got_t, got_id = want_t.copy(), want_id.copy()
    flip = rng.choice(np.flatnonzero(want_id >= 0), flips, replace=False)
    got_id[flip] = want_id[flip] + 1            # distinct triangle ...
    got_t[flip[: flips // 2]] += 1.0            # ... half of them farther
    equi = np.flatnonzero((want_id >= 0) & (got_id == want_id))[:5]
    got_id[equi] = 10_000 + equi                # distinct triangles at equal t
    mine, theirs = {}, {}
    ok = gate.closest_agreement("c", got_t, got_id, want_t, want_id, mine)
    assert ok == jgate.closest_agreement("c", got_t, got_id, want_t, want_id, theirs)
    assert ok == (flips // 2 <= 4)
    assert mine["c"]["agreement"] == pytest.approx(theirs["c"]["agreement"], abs=5e-7)
    occ = want_id >= 0
    got_occ = occ.copy()
    got_occ[flip] = ~got_occ[flip]
    assert gate.anyhit_agreement("a", got_occ, occ, mine) == (
        float(np.mean(got_occ == occ)) >= 0.999)
    off = got_t.copy()
    off[np.flatnonzero((got_id == want_id) & (want_id >= 0))[0]] += 0.5
    assert not gate.closest_agreement("t", off, got_id, want_t, want_id, mine)
    assert mine["t"]["t_allclose"] is False


@pytest.mark.parametrize("metric", ["abs", "rel"])
def test_gate_golden_verdict(metric):
    """golden_verdict's metrics are tests_tpu.py's formulas; the port's
    share is held only where asked (config5)."""
    rng = np.random.default_rng(9)
    want = rng.uniform(0.05, 2.0, (16, 16, 3)).astype(np.float32)
    got = want * (1 + rng.normal(scale=2e-4, size=want.shape)).astype(np.float32)
    got[0, :3] += 0.5                                     # 3 of 256 pixels off
    per_px = np.abs(got - want).max(axis=-1)
    err = per_px if metric == "abs" else per_px / (np.abs(want).max(axis=-1) + 1e-2)
    v = gate.golden_verdict(got, want, metric)
    assert v["deviating_px_frac"] == pytest.approx(
        np.mean(err > (0.01 if metric == "abs" else 0.02)))
    assert v[f"mean_{metric}_err"] == pytest.approx(np.mean(err))
    assert v["pass"] is (v["deviating_px_frac"] <= 0.02 and v[f"mean_{metric}_err"] <
                         (2e-3 if metric == "abs" else 4e-3))
    assert gate.golden_verdict(want, want, metric, 0.97)["pass"]
    assert not gate.golden_verdict(got, want, metric, 0.999)["pass"]


def test_gate_artifact_fields():
    checks = {"a": {"agreement": 1.0, "pass": True},
              "golden_render_config1": {"pass": None, "skipped": "asset golden: ..."}}
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    out = json.loads(json.dumps(gate.artifact(checks, "NVIDIA H100 80GB HBM3", card, 1.5)))
    assert out["card"] == card and out["platform"] == "gpu" and out["ok"] is True
    assert out["summary"] == {"passed": ["a"], "failed": [], "skipped": ["golden_render_config1"]}
    assert {"device", "torch", "cuda", "checks", "elapsed_s"} <= set(out)
    checks["b"] = {"pass": False}
    assert gate.artifact(checks, "x", card, 1.0)["ok"] is False


def test_gate_counts_launches_as_a_difference():
    """A check's launches are what its call added: the count a caller
    (chip_smoke's [gate]) keeps around the whole gate runs on."""
    reset_launches()
    LAUNCHES["closest"] = 5
    with gate._Launches(torch.device("cpu"), "closest") as seen:
        LAUNCHES["closest"] += 2
        LAUNCHES["sort"] += 1
    check = {"pass": True}
    seen.record(check)
    assert check == {"pass": True, "launches": {"closest": 2, "sort": 1}}
    assert LAUNCHES["closest"] == 7
    reset_launches()


def test_gate_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="only on a GPU"):
        gate.main([])
    from mc_path_tracer_tpu_torch import configs

    assert configs.missing_assets(2) == []
    assert all(p.startswith(configs.REF_ROOT) for p in configs.missing_assets(3))
