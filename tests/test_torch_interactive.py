"""The interactive layer against the JAX package: FlyCamera, Arcball and
ObjectEditSession driven by the same event sequences (made from a seed)
reach the same poses, rotations and object transforms, equal to float32
rounding (both are host numpy in float64); frame_to_ansi gives the same
string; and the port's InteractiveViewer restarts accumulation when the
camera moves (8x6 pixels, one sample per pass, depth 2, on the CPU)."""

import numpy as np
import pytest

from mc_path_tracer_tpu.models import interactive as jint
from mc_path_tracer_tpu.models.primitives import uv_sphere
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu_torch.models import interactive as tint
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)

# one torch thread per worker: the suite runs in several processes
pytestmark = pytest.mark.usefixtures("one_thread")

F32 = 2.0 ** -24   # float32 rounding, relative


def assert_same(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=F32, atol=F32)


def events(seed, n=40):
    """Keys (moves and keys that move nothing) and mouse deltas."""
    r = np.random.default_rng(seed)
    keys = r.choice(list("wasdeqzx"), n)
    mouse = r.normal(0.0, 60.0, (n, 2)) * (r.random((n, 1)) < 0.7)
    return keys, mouse, r.uniform(0.01, 0.1, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_fly_camera_matches_jax(seed):
    a, b = tint.FlyCamera(), jint.FlyCamera()
    for key, (dx, dy), dt in zip(*events(seed)):
        assert a.process_keyboard(key, dt) == b.process_keyboard(key, dt)
        assert a.process_mouse(dx, dy) == b.process_mouse(dx, dy)
        assert_same(a.position, b.position)
        assert_same([a.yaw_deg, a.pitch_deg], [b.yaw_deg, b.pitch_deg])
    assert_same(a.front, b.front)
    assert_same(a.right, b.right)
    ca, cb = a.camera(aspect=1.5), b.camera(aspect=1.5)
    for field in ("position", "target", "up", "fov_deg", "aspect"):
        assert_same(getattr(ca, field), getattr(cb, field))
    a.process_mouse(0.0, 1e6)
    assert a.pitch_deg == 89.0


def drags(seed, n=12):
    return np.random.default_rng(seed).uniform(-1.4, 1.4, (n, 4))


@pytest.mark.parametrize("seed", [2, 3])
def test_arcball_matches_jax(seed):
    a, b = tint.Arcball(), jint.Arcball()
    for x0, y0, x1, y1 in drags(seed):
        assert_same(a.drag(x0, y0, x1, y1), b.drag(x0, y0, x1, y1))
    assert_same(a.drag(0.2, 0.2, 0.2, 0.2), b.rotation)   # no motion: unchanged
    assert_same(a.rotation @ a.rotation.T, np.eye(3))


def sphere_scene(scene_cls):
    s = scene_cls()
    s.set_environment_color((0.4, 0.5, 0.7), ls=1.0)
    m = s.add_material(albedo=(0.8, 0.5, 0.3), roughness=0.6)
    p, n, uv, idx = uv_sphere(1.0, rings=8, segments=12)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    s.add_directional_light((0.3, 1.0, 0.2), ls=2.0)
    return s


def test_object_edit_session_matches_jax():
    """Rotate and pan drags, with and without a camera, move the object as
    the JAX session does and bump the scene version at every edit."""
    ts, js = sphere_scene(TScene), sphere_scene(JScene)
    a, b = tint.ObjectEditSession(ts, obj_id=0), jint.ObjectEditSession(js, obj_id=0)
    cam = tint.FlyCamera(position=np.array([0.5, 1.0, 4.0])).camera()
    jcam = jint.FlyCamera(position=np.array([0.5, 1.0, 4.0])).camera()
    v0 = ts.version
    for k, (x0, y0, x1, y1) in enumerate(drags(4, 6)):
        a.rotate_drag(x0, y0, x1, y1)
        b.rotate_drag(x0, y0, x1, y1)
        a.pan_drag(x1 - x0, y1 - y0, cam if k % 2 else None)
        b.pan_drag(x1 - x0, y1 - y0, jcam if k % 2 else None)
    assert ts.version - v0 == 12
    to, jo = ts.objects[0], js.objects[0]
    assert_same(to.rotation, jo.rotation)
    assert_same(to.translation, jo.translation)
    tb, jb = ts.build("cpu"), js.build()
    np.testing.assert_allclose(tb.tris.v0.numpy(), np.asarray(jb.tris.v0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(6, 5), (7, 3)])
def test_frame_to_ansi_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3)).astype(np.uint8)
    got = tint.frame_to_ansi(img)
    assert got == jint.frame_to_ansi(img)
    assert got.count("\n") == shape[0] // 2 - 1 and "\x1b[38;2;" in got


def test_viewer_restarts_accumulation_on_a_move():
    s = sphere_scene(TScene)
    v = tint.InteractiveViewer(s, width=8, height=6, cfg=RenderConfig(spp=4, max_depth=2),
                               device="cpu")
    v.step()
    v.step()
    assert float(v.session.film.samples.max()) == 2.0
    assert v.handle_events(keys=["w"], mouse=(5.0, -3.0))       # camera moved
    v.step()
    assert float(v.session.film.samples.max()) == 1.0             # fresh accumulation
    assert not v.handle_events(keys=["z"], mouse=(0.0, 0.0))     # no-op events
    v.step()
    assert float(v.session.film.samples.max()) == 2.0
    frame = v.frame()
    assert frame.shape == (6, 8, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, v.session.film.to_uint8())
    assert tint.frame_to_ansi(frame).count("\n") == 2
