"""The port's viewer (``tpuray_torch.apps.rayview``) held against the JAX
package's: the keymap and the cameras of the camera methods bit for bit
(their bases at ``test_torch_camera.py``'s 1e-6: XLA's float32 ``tan``
and products differ from PyTorch's in the last bit), frames of the
controller's cameras against the JAX megakernel in Pallas interpret mode at
the megakernel parity bar of ``test_torch_megakernel.py`` (99.9% of the
stable pixels within 1e-3, mean |d| < 1e-4, under 2% chaotic), the basis
swap bit-equal to a fresh ``pack_scene``, the ``--keys`` mode on the CPU,
``serve`` driven over HTTP with a stub renderer, and ``io.encode_jpeg``
against Pillow (decoded shape; PSNR within 1 dB of Pillow's own encoding at
the same quality)."""
import io
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import tpuray
from tpuray import config as jconfig
from tpuray.apps import rayview as jrayview

import tpuray_torch as tt
from tpuray_torch.apps import rayview
from tpuray_torch.kernels import megakernel
from tpuray_torch.kernels.megakernel import pack_scene, swap_basis
from test_torch_megakernel import (_jax_checked, assert_agrees,
                                   chaotic_pixels, jax_scene_arrays)
from test_torch_render import _write_inputs

BINDINGS = "wasd _8246"
PSNR_DB = 1.0


def key_script(n=200, seed=0):
    """``n`` seeded keys that use every binding."""
    rng = np.random.default_rng(seed)
    keys = list(BINDINGS) + list(rng.choice(list(BINDINGS), n - len(BINDINGS)))
    rng.shuffle(keys)
    return "".join(keys)


def test_keymap_matches_jax():
    jctl, tctl = jrayview.CameraController(), rayview.CameraController()
    for k in key_script():
        jctl.key(k)
        tctl.key(k)
        np.testing.assert_array_equal(tctl.origin, jctl.origin)
        assert (tctl.x_rot, tctl.y_rot) == (jctl.x_rot, jctl.y_rot)
    jc, tc = jctl.camera(), tctl.camera()
    assert (tc.origin, tc.lookdir, tc.fov, tc.focal_length) == (
        jc.origin, jc.lookdir, jc.fov, jc.focal_length)
    assert rayview.MOVE_SPEED == jrayview.MOVE_SPEED
    assert rayview.ROT_SPEED == jrayview.ROT_SPEED


def test_camera_controller_matches_reference_keymap():
    """JAX's ``TestRayview`` keymap test on the port (rayinteractive.c:
    32-104): WASD moves along dir/right at 0.1, arrows rotate the spherical
    angles at 0.05, space/shift along the perspective up vector."""
    c = rayview.CameraController(origin=(0, 0, 0), x_rot=np.pi / 2,
                                 y_rot=np.pi / 2)
    np.testing.assert_allclose(c.lookdir, [0, 0, 1], atol=1e-12)
    c.key("w")
    np.testing.assert_allclose(c.origin, [0, 0, rayview.MOVE_SPEED],
                               atol=1e-12)
    c.key(" ")
    assert c.origin[1] == rayview.MOVE_SPEED
    c.key("4")
    assert c.y_rot == np.pi / 2 - rayview.ROT_SPEED
    c.key("8")
    assert c.x_rot == np.pi / 2 - rayview.ROT_SPEED
    c2 = rayview.CameraController(origin=(0, 0, 0), x_rot=np.pi / 2,
                                  y_rot=np.pi / 2)
    c2.key("a")
    np.testing.assert_allclose(c2.origin, [rayview.MOVE_SPEED, 0, 0],
                               atol=1e-12)
    c2.key("d")
    c2.key("d")
    np.testing.assert_allclose(c2.origin, [-rayview.MOVE_SPEED, 0, 0],
                               atol=1e-12)
    c3 = rayview.CameraController(origin=(0, 0, 0), x_rot=np.pi / 4,
                                  y_rot=np.pi / 2)
    c3.key(" ")
    fwd = -c3.lookdir
    right = np.cross([0.0, 1.0, 0.0], fwd)
    np.testing.assert_allclose(c3.origin,
                               np.cross(fwd, right) * rayview.MOVE_SPEED,
                               atol=1e-12)


def _camera_fields(c):
    return (c.origin, c.lookdir, c.fov, c.focal_length)


@pytest.mark.parametrize("width,height", [(64, 32), (800, 600)])
def test_camera_methods_match_jax(width, height):
    """``lookat``, ``with_spherical`` and ``moved`` give JAX's cameras bit
    for bit, and their bases agree to ``test_torch_camera.py``'s 1e-6."""
    rng = np.random.default_rng(5)
    args = ((0.8, 2.5, -8.0), (0.2, 0.0, 1.0), 75.0, 1.5)
    jcam, tcam = tpuray.Camera(*args), tt.Camera(*args)
    for _ in range(5):
        d = tuple(float(x) for x in rng.uniform(-1, 1, 3))
        x_rot, y_rot = (float(x) for x in rng.uniform(0.2, 3.0, 2))
        delta = tuple(float(x) for x in rng.uniform(-0.3, 0.3, 3))
        for jc, tc in ((jcam.lookat(d), tcam.lookat(d)),
                       (jcam.with_spherical(x_rot, y_rot),
                        tcam.with_spherical(x_rot, y_rot)),
                       (jcam.moved(delta), tcam.moved(delta))):
            assert _camera_fields(tc) == _camera_fields(jc)
            jb = tpuray.perspective_basis(jc, width, height)
            tb = tt.perspective_basis(tc, width, height, device="cpu")
            for name in ("corner", "origin", "up", "right", "w_factor",
                         "h_factor"):
                np.testing.assert_allclose(
                    getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                    rtol=1e-6, atol=1e-6, err_msg=name)
        jcam, tcam = jcam.moved(delta), tcam.moved(delta)


def test_frames_match_jax_megakernel():
    """Three frames of the controller's cameras (64x32 d2, canonical scene,
    solid assets) through the port's frame loop on the CPU and the JAX
    megakernel in interpret mode."""
    width, height, depth = 64, 32, 2
    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    tscene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    # the canonical floor uses texture 2
    jassets = tpuray.solid_assets(3, rgb=(40, 120, 200))
    tassets = tt.solid_assets(3, rgb=(40, 120, 200), device="cpu")
    np.testing.assert_array_equal(tassets.textures.numpy(),
                                  np.asarray(jassets.textures))
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=depth)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          chunk_size=0)
    jctl, tctl = jrayview.CameraController(), rayview.CameraController()
    loop = rayview.FrameLoop(tscene, tassets, cfg, tctl.camera())
    for k in "w4_":
        jctl.key(k)
        tctl.key(k)
        img = loop.frame(tctl.camera())
        port = loop.rgb.numpy()
        np.testing.assert_array_equal(
            img, tt.quantize_image(loop.rgb, width, height).numpy())
        jbasis = tpuray.perspective_basis(jctl.camera(), width, height)
        ref, dropped, _ = _jax_checked()(jscene, jassets, jbasis, jcfg)
        assert int(dropped) == 0
        ref = np.asarray(ref)
        tbasis = tt.perspective_basis(tctl.camera(), width, height,
                                      device="cpu")

        def render(basis):
            return tt.render_megakernel_reference(
                pack_scene(tscene, basis), tassets, cfg).numpy()

        bad = np.abs(port - ref).max(-1) >= 1e-3
        chaotic = (chaotic_pixels(render, tbasis, port) if bad.any()
                   else np.zeros(bad.shape, bool))
        assert_agrees(port, ref, chaotic, f"after key {k!r}")
    assert loop.engine == "megakernel" and len(loop.times) == 3


def _mesh_spec():
    spec = tt.canonical_scene_spec()
    v = np.random.default_rng(3).uniform(-2, 2, (12, 3, 3))
    spec.triangles = [tt.TriangleSpec(tuple(a), tuple(b), tuple(c),
                                      tt.PLASTIC if i % 2 else tt.GLASS)
                      for i, (a, b, c) in enumerate(v + [0.0, 1.0, 2.0])]
    return spec


@pytest.mark.parametrize("mesh", [False, True], ids=["canonical", "mesh"])
def test_swap_basis_equals_a_fresh_pack(mesh, monkeypatch):
    spec = _mesh_spec() if mesh else tt.canonical_scene_spec()
    scene = tt.build_scene(spec, "cpu")
    builds = []
    build = megakernel.build_tri_tables

    def counted(s):
        builds.append(1)
        return build(s)

    monkeypatch.setattr(megakernel, "build_tri_tables", counted)
    ctl = rayview.CameraController()
    width, height = 24, 16
    cfg = tt.RenderConfig(width=width, height=height, max_depth=2)
    loop = rayview.FrameLoop(scene, tt.solid_assets(3, device="cpu"), cfg,
                             ctl.camera())
    packed = loop.packed
    for k, row0 in zip("wd8", (0, 3, 5)):
        ctl.key(k)
        basis = tt.perspective_basis(ctl.camera(), width, height,
                                     device="cpu")
        swapped = swap_basis(packed, basis, row0)
        fresh = pack_scene(scene, basis, row0)
        assert torch.equal(swapped.buf, fresh.buf)
        assert swapped.layout == fresh.layout
        assert swapped.max_texture_id == fresh.max_texture_id
        assert swapped.tris is packed.tris          # shared, not rebuilt
        if mesh:
            for name in ("geom", "attr", "node"):
                assert torch.equal(getattr(swapped.tris, name),
                                   getattr(fresh.tris, name))
        loop.frame(ctl.camera())
    # the frame loop packed once (the fresh packs above built their own)
    assert len(builds) == 1 + 3


def test_rayview_keys_writes_frames(tmp_path, capsys):
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    frames = str(tmp_path / "frames")
    res = rayview.main(["--scene", scene_path, "--asset-dir", asset_dir,
                        "--device", "cpu", "--width", "64", "--height", "32",
                        "--depth", "1", "--keys", "w4",
                        "--frames-dir", frames])
    assert sorted(os.listdir(frames)) == ["frame_0000.png",
                                          "frame_0001.png"]
    for i, img in enumerate(res["images"]):
        np.testing.assert_array_equal(
            tt.read_png(os.path.join(frames, f"frame_{i:04d}.png")), img)
    printed = capsys.readouterr().out
    assert "engine: megakernel" in printed and "2 frames" in printed
    assert len(res["loop"].times) == 3          # the first frame + 2 keys


def test_rayview_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rayview.main(["--scene", scene_path, "--asset-dir", asset_dir,
                      "--width", "8", "--height", "8", "--keys", "w"])


def serve_in_thread(ctl, frame_u8, width, height):
    """Start ``rayview.serve`` on 127.0.0.1, an ephemeral port; returns
    (base url, stop(), thread)."""
    captured = {}

    def started(httpd, stop):
        captured.update(httpd=httpd, stop=stop,
                        port=httpd.server_address[1])

    th = threading.Thread(
        target=rayview.serve, args=(ctl, frame_u8, width, height, 0),
        kwargs={"host": "127.0.0.1", "started": started}, daemon=True)
    th.start()
    for _ in range(200):
        if "port" in captured:
            break
        time.sleep(0.05)

    def stop():
        captured["stop"].set()
        captured["httpd"].shutdown()
        th.join(timeout=10)
        assert not th.is_alive()

    return f"http://127.0.0.1:{captured['port']}", stop


def test_serve_streams_frames_and_keys_drive_camera():
    """JAX's ``--serve`` test on the port (page, /key moves the camera and
    re-renders, /frame.jpg, one /stream part, with a stub renderer), and
    the JPEG decodes in Pillow to the frame's shape."""
    Image = pytest.importorskip("PIL.Image")
    ctl = rayview.CameraController()
    calls = []

    def fake_frame():
        calls.append(tuple(ctl.origin))
        return np.full((32, 64, 3), len(calls) * 10, np.uint8)

    base, stop = serve_in_thread(ctl, fake_frame, 64, 32)
    try:
        page = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"/stream" in page and b"ArrowUp" in page
        jpg = urllib.request.urlopen(f"{base}/frame.jpg", timeout=30).read()
        assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
        with Image.open(io.BytesIO(jpg)) as im:
            assert im.size == (64, 32)
            decoded = np.asarray(im.convert("RGB")).astype(int)
        assert np.abs(decoded - 10).max() <= 2
        o0 = ctl.origin.copy()
        msg = urllib.request.urlopen(f"{base}/key?k=w", timeout=10).read()
        assert b"origin=" in msg
        assert not np.allclose(ctl.origin, o0)
        with urllib.request.urlopen(f"{base}/stream", timeout=30) as r:
            assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
            head = r.readline() + r.readline()
            assert b"--frame" in head or b"image/jpeg" in head
    finally:
        stop()
    assert len(calls) >= 2


def test_serve_raises_what_the_renderer_raised():
    def broken():
        raise ValueError("no frame")

    box = {}

    def started(httpd, stop):
        box["httpd"] = httpd

    with pytest.raises(RuntimeError, match="render thread failed"):
        rayview.serve(rayview.CameraController(), broken, 8, 8, 0,
                      host="127.0.0.1", started=started)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def jpeg_images():
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0), "cpu")
    cfg = tt.RenderConfig(width=96, height=72, max_depth=3)
    frame = tt.render_u8(scene, assets, tt.Camera((0.8, 2.5, -8.0),
                                                  (0.2, 0.0, 1.0)), cfg)
    noise = np.random.default_rng(11).integers(0, 256, (45, 70, 3),
                                               dtype=np.uint8)
    return {"frame": frame, "noise": noise}


@pytest.mark.parametrize("quality", [50, 85, 95])
@pytest.mark.parametrize("image", ["frame", "noise"])
def test_encode_jpeg_against_pillow(jpeg_images, image, quality):
    Image = pytest.importorskip("PIL.Image")
    img = jpeg_images[image]
    ours = tt.encode_jpeg(img, quality)
    assert ours[:2] == b"\xff\xd8" and ours[-2:] == b"\xff\xd9"
    with Image.open(io.BytesIO(ours)) as im:
        assert im.format == "JPEG" and im.size == (img.shape[1],
                                                   img.shape[0])
        decoded = np.asarray(im.convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    with Image.open(buf) as im:
        pil = np.asarray(im.convert("RGB"))
    assert abs(_psnr(decoded, img) - _psnr(pil, img)) <= PSNR_DB, (
        _psnr(decoded, img), _psnr(pil, img))


def test_encode_jpeg_refuses_what_it_cannot_encode():
    with pytest.raises(ValueError, match="RGB u8"):
        tt.encode_jpeg(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="0 < H, W"):
        tt.encode_jpeg(np.zeros((0, 8, 3), np.uint8))
