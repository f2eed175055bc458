"""PNG decoding, glTF loading and the scene editing calls of the port against
PIL and the JAX package.

The GLB comes from chip_smoke.write_textured_glb, the file the card run
loads: two nodes under a parent transform, a mesh with TANGENT (its
positions and normals in one strided buffer view) and two without, and
five embedded PNGs, one per filter type, in RGB, RGBA, palette and grey.
Loader output and scene arrays are equal, texels within 1e-6 of the JAX
package's (which decodes with PIL)."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu.utils import gltf as jgltf
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.models.scene import scene_arrays, scene_data_from_arrays
from mc_path_tracer_tpu_torch.utils import gltf as tgltf
from mc_path_tracer_tpu_torch.utils.image import read_png
from tests.test_torch_scene import _compare


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_read_png_equals_pil(filter_type, mode):
    r = np.random.default_rng(10 * filter_type + len(mode))
    h, w = 9, 13
    if mode == "P":
        data = chip_smoke.encode_png(r.integers(0, 11, (h, w)), filter_type,
                                     palette=r.integers(0, 256, (11, 3)))
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    else:
        c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
        img = r.integers(0, 256, (h, w, c)).astype(np.uint8)
        data = chip_smoke.encode_png(img if c > 1 else img[..., 0], filter_type)
        want = np.asarray(Image.open(io.BytesIO(data))).reshape(h, w, c)
        np.testing.assert_array_equal(want, img)
    got = read_png(data)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_read_png_low_bit_depth_equals_pil():
    """A 2-colour palette image that PIL writes at 1 bit per pixel."""
    buf = io.BytesIO()
    img = Image.fromarray((np.indices((7, 19)).sum(0) % 2).astype(np.uint8), "P")
    img.putpalette([10, 20, 30, 200, 100, 50])
    img.save(buf, format="PNG", bits=1)
    np.testing.assert_array_equal(read_png(buf.getvalue()),
                                  np.asarray(Image.open(buf).convert("RGB")))


def _with_header(data: bytes, **fields) -> bytes:
    """`data` with IHDR fields (depth, interlace) replaced."""
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    depth = fields.get("depth", depth)
    interlace = fields.get("interlace", interlace)
    return data[:16] + struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt,
                                   interlace) + data[29:]


@pytest.mark.parametrize("kind", ["interlaced", "16-bit", "JPEG"])
def test_undecoded_images_are_refused(kind, tmp_path):
    """What the port still refuses: an interlace method the PNG
    specification does not define, a bit depth its colour type does not
    allow (16-bit palette), and an arithmetic-coded JPEG (ROADMAP Queue 1),
    which PIL's libjpeg-turbo decodes; a glTF file with that JPEG still
    loads without textures, as in the JAX package.  Interlaced, 16-bit and
    JPEG images themselves decode: tests/test_torch_images.py."""
    png = chip_smoke.encode_png(np.zeros((4, 4, 3), np.uint8))
    if kind == "interlaced":
        with pytest.raises(ValueError, match="tile.png: malformed PNG header"):
            read_png(_with_header(png, interlace=2), "tile.png")
        return
    if kind == "16-bit":
        pal = chip_smoke.encode_png(np.zeros((4, 4), np.uint8), palette=np.zeros((2, 3)))
        with pytest.raises(ValueError, match="malformed PNG header"):
            read_png(_with_header(pal, depth=16))
        return
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    sof = buf.getvalue().index(b"\xff\xc0")
    images = chip_smoke.glb_images()
    images[0] = buf.getvalue()[: sof + 1] + b"\xc9" + buf.getvalue()[sof + 2 :]
    path = chip_smoke.write_textured_glb(tmp_path / "jpeg.glb", images)
    with pytest.raises(ValueError, match="image 0 .*SOF9 .arithmetic.*ROADMAP Queue 1"):
        tgltf.load_gltf(str(path))
    # without textures the file loads, as in the JAX package
    assert len(tgltf.load_gltf(str(path), load_textures=False).meshes) == 3


def test_load_gltf_with_jpeg_and_16_bit_textures_equals_jax(tmp_path):
    """The test GLB with a progressive 4:2:0 JPEG base colour, a 16-bit
    RGBA metallic-roughness map and an interlaced normal map: the textures
    equal the JAX package's (PIL) exactly."""
    from tests.test_torch_images import encode_png

    r = np.random.default_rng(4)
    buf = io.BytesIO()
    Image.fromarray(r.integers(0, 256, (24, 40, 3)).astype(np.uint8)).save(
        buf, "JPEG", quality=80, subsampling="4:2:0", progressive=True)
    images = chip_smoke.glb_images()
    images[0] = buf.getvalue()
    images[1] = encode_png(r.integers(0, 65536, (16, 16, 4)), 16, filter_type=4)
    images[2] = encode_png(r.integers(0, 256, (19, 21, 3)), 8, interlace=True, filter_type=3)
    path = chip_smoke.write_textured_glb(tmp_path / "formats.glb", images)
    ours, ref = tgltf.load_gltf(str(path)), jgltf.load_gltf(str(path))
    assert len(ours.textures) == len(ref.textures) == 5
    for a, b in zip(ours.textures, ref.textures):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    return chip_smoke.write_textured_glb(tmp_path_factory.mktemp("glb") / "textured.glb")


@pytest.mark.parametrize("quirk", [False, True])
def test_load_gltf_equals_jax(glb, quirk):
    got = tgltf.load_gltf(str(glb), reference_material_quirk=quirk)
    want = jgltf.load_gltf(str(glb), reference_material_quirk=quirk)
    assert len(got.meshes) == len(want.meshes) == 3
    for a, b in zip(got.meshes, want.meshes):
        assert a.name == b.name and a.material == b.material
        for f in ("positions", "normals", "uvs", "indices", "tangents"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert len(got.materials) == len(want.materials) == 3
    for a, b in zip(got.materials, want.materials):
        assert vars(a).keys() == vars(b).keys()
        for f in vars(a):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    # five images, the sphere's base colour decoded once from the cache
    assert len(got.textures) == len(want.textures) == 5
    for a, b in zip(got.textures, want.textures):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_tangent_handedness_and_world_bake(glb):
    """TANGENT w survives the bake; meshes without TANGENT get computed
    tangents; the parent scale reaches the child positions."""
    data = tgltf.load_gltf(str(glb))
    floor, ball, _ = data.meshes
    np.testing.assert_array_equal(floor.tangents[:2, 3], -1.0)
    # computed tangents are unit length, or zero at the poles, where the UV
    # gradient vanishes (the hit shading then takes a normal-aligned frame)
    norms = np.linalg.norm(ball.tangents[:, :3], axis=1)
    assert (np.isclose(norms, 1.0, atol=1e-5) | (norms == 0.0)).all() and (norms > 0).mean() > 0.99
    # the ball is scaled by 1.1 (root) x 1.2 (its node) in y around its node
    height = ball.positions[:, 1].max() - ball.positions[:, 1].min()
    np.testing.assert_allclose(height, 2 * 0.8 * 1.1 * 1.2, rtol=1e-5)


def edited(scene_cls, glb):
    s = chip_smoke.textured_scene(scene_cls, glb)
    s.apply_transform(0, translation=(0.1, 0.0, 0.0), rotation_deg=(0.0, 10.0, 0.0),
                      scale=(1.0, 1.0, 0.9))
    s.add_point_light((0.0, 3.0, 0.0), ls=2.0)
    return s


def test_scene_load_and_transforms_equal_jax(glb):
    """Scene.load, set_transform and apply_transform give the JAX scene's
    arrays, atlas and texture ids included."""
    js, ts = edited(JScene, glb), edited(TScene, glb)
    assert ts.version == js.version and ts.edit_version == js.edit_version
    assert len(ts.point_lights) == 1
    tsd = ts.build("cpu")
    ja, ta = scene_arrays(js.build()), scene_arrays(tsd)
    _compare(ta, ja, ("tris.", "bvh.", "materials.", "lights.", "atlas."))
    assert ta["atlas.data"].shape == (5, 32, 32, 3)
    assert tsd.lights.area.count == 12     # the lamp box


def test_build_cache_follows_edits(glb):
    s = chip_smoke.textured_scene(TScene, glb)
    first = s.build("cpu")
    assert s.build("cpu") is first
    s.notify(content=False)          # a camera-only edit keeps the build
    assert s.build("cpu") is first
    s.set_transform(1, translation=(0.0, 0.5, 0.0))
    moved = s.build("cpu")
    assert moved is not first
    assert not np.array_equal(moved.tris.v0.numpy(), first.tris.v0.numpy())


def test_scene_data_from_arrays_carries_a_textured_jax_scene(glb):
    ja = scene_arrays(edited(JScene, glb).build())
    sd = scene_data_from_arrays(ja, device="cpu")
    _compare(scene_arrays(sd), ja, ("tris.", "bvh.", "materials.", "lights.", "atlas."))
    assert sd.atlas.count == 5
