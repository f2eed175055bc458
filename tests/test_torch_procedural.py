"""The port's procedural module against the JAX package's: one counterpart of
each test of tests/test_procedural.py, whose outputs (module strings after
LSystem.build, the stochastic rule under one seed, turtle segments,
to_mesh, bezier_eval, subdiv_open and tube_mesh) must be equal, not close,
since both run the same host numpy; and a frame of a turtle mesh against
the JAX brute-force render, at the tolerance of the 194-triangle scene
(99.2% of pixels within rtol 1e-4)."""

import jax
import numpy as np
import pytest

from mc_path_tracer_tpu.models import integrator as jint
from mc_path_tracer_tpu.models import procedural as jproc
from mc_path_tracer_tpu.models.camera import PerspectiveCamera as JCam
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models import procedural as tproc
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera as TCam
from mc_path_tracer_tpu_torch.models.primitives import plane
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import rng as trng
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TREE_RULE = "F -> F[+F]F[-F]F"


def both(build):
    """build(module) for the port's module and the JAX one."""
    return build(tproc), build(jproc)


def strings(mods):
    return "".join(str(m) for m in mods)


def assert_equal_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def assert_equal_segments(t, j):
    assert len(t.segments) == len(j.segments) > 0
    for (a0, a1, ar0, ar1), (b0, b1, br0, br1) in zip(t.segments, j.segments):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
        assert (ar0, ar1) == (br0, br1)


def test_parse_modules_with_params_equals_jax():
    t, j = both(lambda m: m.parse_modules("F(1.5)[+F]A(1,2)"))
    assert [(m.symbol, m.params) for m in t] == [(m.symbol, m.params) for m in j]
    assert [m.symbol for m in t] == ["F", "[", "+", "F", "]", "A"]
    assert t[5].params == (1.0, 2.0)


def test_algae_d0l_system_equals_jax():
    t, j = both(lambda m: m.LSystem().set_axiom("A").add_rule("A -> AB")
                .add_rule("B -> A").build(5))
    assert strings(t) == strings(j) == "ABAABABAABAAB"


def test_parametric_rule_with_condition_equals_jax():
    def build(m):
        return (m.LSystem().set_axiom("A(2)").add_rule("A(x) : x > 1 -> F(x)A(x/2)")
                .add_rule("A(x) : x <= 1 -> F(x)").build(3))

    t, j = both(build)
    assert strings(t) == strings(j) == "F(2)F(1)"
    assert [m.params for m in t] == [m.params for m in j]


@pytest.mark.parametrize("seed", [7, 11])
def test_stochastic_rule_equals_jax(seed):
    """The same seed draws the same rule choices in both packages."""
    def build(m):
        return (m.LSystem(seed=seed).set_axiom("F").add_rule("F -> F[+F] : 0.5")
                .add_rule("F -> F[-F] : 1.0").build(4))

    t, j = both(build)
    assert strings(t) == strings(j)
    assert "+" in strings(t) and "-" in strings(t)


def test_context_sensitive_rule_equals_jax():
    t, j = both(lambda m: m.LSystem().set_axiom("BAA").add_rule("B < A -> B")
                .add_rule("B -> A").build(1))
    assert strings(t) == strings(j) == "ABA"


def test_turtle_square_closes_equals_jax():
    t, j = both(lambda m: m.Turtle(step=1.0, angle=90.0).interpret("F+F+F+F"))
    assert_equal_segments(t, j)
    np.testing.assert_allclose(t.segments[-1][1], [0, 0, 0], atol=1e-6)
    assert_equal_arrays([np.asarray(p) for line in t.polylines for p in line],
                        [np.asarray(p) for line in j.polylines for p in line])


def test_turtle_push_pop_equals_jax():
    program = "F[+F]F[&F][^/F]f\"F!F|F[\\F]"
    t, j = both(lambda m: m.Turtle(step=1.0, angle=90.0).interpret(program))
    assert_equal_segments(t, j)
    np.testing.assert_allclose(t.segments[2][0], [0, 1, 0], atol=1e-6)
    assert len(t.polylines) == len(j.polylines)


def tree_mesh(m, generations=2, sides=5):
    system = m.LSystem(seed=1).set_axiom("F").add_rule(TREE_RULE)
    return m.Turtle(step=0.5, angle=25.0).interpret(system.build(generations)).to_mesh(
        sides=sides)


def test_turtle_mesh_equals_jax_and_builds():
    t, j = both(tree_mesh)
    assert_equal_arrays(t, j)
    p, n, uv, idx = t
    s = TScene()
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=s.add_material(albedo=(0.3, 0.6, 0.2)))
    assert s.build("cpu").tris.num_triangles == len(idx) == 25 * 10


def test_bezier_endpoints_and_midpoint_equal_jax():
    ctrl = np.array([[0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0]], np.float64)
    t = np.linspace(0.0, 1.0, 17)
    a, b = both(lambda m: m.bezier_eval(ctrl, t))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a[8], [0.5, 0.75, 0.0], atol=1e-12)


def test_subdiv_open_equals_jax():
    pts = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
    a, b = both(lambda m: m.subdiv_open(pts, iterations=3))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a[[0, -1]], pts[[0, -1]], atol=1e-6)


def test_tube_mesh_equals_jax():
    line = np.array([[0, 0, 0], [0, 1, 0], [0.5, 2, 0.2], [0.5, 2, 0.2]], np.float32)
    a, b = both(lambda m: m.tube_mesh(line, radius=0.1, sides=8))
    assert_equal_arrays(a, b)
    # the zero-length last segment is skipped
    assert a[0].shape[0] == 2 * 8 * 2 and a[3].shape[0] == 2 * 8 * 2


@pytest.fixture(scope="module")
def turtle_frames():
    """A frame of a two-generation turtle tree on a floor: the port (plain
    route on the CPU) and the JAX brute-force render, same key."""
    w, h, spp, depth, seed = 16, 16, 1, 3, 5
    cam = dict(position=np.array([1.5, 1.6, 3.2]), target=np.array([0.0, 1.0, 0.0]),
               fov_deg=40.0)
    p, n, uv, idx = tree_mesh(tproc)
    scenes = []
    for cls in (TScene, JScene):
        s = cls()
        s.set_environment_color((0.5, 0.55, 0.6), ls=1.0)
        s.add_directional_light((0.3, 1.0, 0.4), ls=2.5)
        floor = s.add_material(albedo=(0.6, 0.6, 0.6), roughness=0.8)
        fp, fn, fuv, fidx = plane(8.0)
        s.add_mesh(fp, fidx, normals=fn, uvs=fuv, material_id=floor)
        bark = s.add_material(albedo=(0.45, 0.3, 0.2), roughness=0.6)
        s.add_mesh(p, idx, normals=n, uvs=uv, material_id=bark)
        scenes.append(s)
    out = tint.render(scenes[0], TCam(**cam), w, h, tint.RenderConfig(spp=spp, max_depth=depth),
                      key=trng.prng_key(seed), device="cpu").ld.numpy()
    ref = np.asarray(jint.render(scenes[1], JCam(**cam), w, h,
                                 jint.RenderConfig(spp=spp, max_depth=depth, accel="brute"),
                                 key=jax.random.PRNGKey(seed)).ld)
    return out, ref


def test_turtle_mesh_render_matches_jax(turtle_frames):
    out, ref = turtle_frames
    assert out.shape == ref.shape == (16, 16, 3) and np.isfinite(out).all()
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.992, (close.mean(), np.abs(out - ref).max())
    assert out.mean() > 0.0
