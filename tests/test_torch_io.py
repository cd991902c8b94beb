"""The port's host layer held against the JAX package: the scene archive
codec, scene arrays, and the PNG codec (held against Pillow).

Inputs come from ``numpy.random.default_rng(seed)`` and go through both
packages; the JAX side runs on the CPU."""
import dataclasses
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import tpuray
import tpuray_torch as tt
from tpuray_torch import io as tio

N_RANDOM_SPECS = 5


def random_spec(mod, seed: int):
    """A scene spec of the given package (``tpuray`` or ``tpuray_torch``)
    with seeded random spheres, planes, lights and triangles; both
    packages get the same numbers from the same seed."""
    rng = np.random.default_rng(seed)

    def vec(lo=-5.0, hi=5.0):
        return tuple(float(x) for x in rng.uniform(lo, hi, 3))

    def mat():
        return mod.MaterialSpec(
            rgb=vec(0.0, 1.0), ambient=float(rng.uniform()),
            diffuse=float(rng.uniform()), specular=float(rng.uniform()),
            shininess=float(rng.integers(0, 200)),
            transparent=bool(rng.integers(2)),
            dielectric=bool(rng.integers(2)), n=float(rng.uniform(1, 2)),
            reflectivity=float(rng.uniform()),
            texture_id=int(rng.integers(-1, 4)),
            texture_scale=float(rng.uniform(0, 200)))

    return mod.SceneSpec(
        spheres=[mod.SphereSpec(vec(), float(rng.uniform(0.1, 2)), mat())
                 for _ in range(rng.integers(0, 6))],
        planes=[mod.PlaneSpec(vec(-1, 1), vec(), mat())
                for _ in range(rng.integers(0, 4))],
        lights=[mod.LightSpec(vec(), float(rng.uniform(0, 1)),
                              float(rng.uniform(0, 60)), vec(0, 1))
                for _ in range(rng.integers(1, 4))],
        triangles=[mod.TriangleSpec(vec(), vec(), vec(), mat())
                   for _ in range(rng.integers(0, 9) * (seed % 2))])


def jax_scene_arrays(scene) -> dict:
    """A JAX ``Scene``'s leaves as numpy arrays under its field names."""
    out = {}
    for name, value in scene._asdict().items():
        if hasattr(value, "_asdict"):
            for k, v in value._asdict().items():
                out[f"{name}.{k}"] = np.asarray(v)
        else:
            out[name] = np.asarray(value)
    return out


SPECS = [("canonical", None)] + [("random", s) for s in range(N_RANDOM_SPECS)]


def _spec_pair(kind, seed):
    if kind == "canonical":
        return tpuray.canonical_scene_spec(), tt.canonical_scene_spec()
    return random_spec(tpuray, seed), random_spec(tt, seed)


class TestSceneArchive:
    @pytest.mark.parametrize("kind,seed", SPECS)
    def test_dumps_is_byte_equal_and_round_trips(self, kind, seed):
        jspec, tspec = _spec_pair(kind, seed)
        blob = tt.dumps_scene(tspec)
        assert blob == tpuray.dumps_scene(jspec)
        assert tt.dumps_scene(tt.loads_scene(blob)) == blob
        assert tpuray.dumps_scene(tpuray.loads_scene(blob)) == blob
        back = tt.loads_scene(blob)
        assert len(back.triangles) == len(tspec.triangles)

    def test_canonical_archive_size_and_file_round_trip(self, tmp_path):
        path = str(tmp_path / "render.map")
        tt.dump_scene(path, tt.canonical_scene_spec())
        # render.map is 723 bytes (1 + 4*96 + 1 + 2*96 + 1 + 3*48)
        assert len(open(path, "rb").read()) == 723
        spec = tt.load_scene(path)
        assert tt.dumps_scene(spec) == tpuray.dumps_scene(
            tpuray.canonical_scene_spec())


class TestSceneArrays:
    @pytest.mark.parametrize("kind,seed", SPECS)
    def test_scene_from_arrays_matches_build_scene(self, kind, seed):
        jspec, tspec = _spec_pair(kind, seed)
        arrays = jax_scene_arrays(tpuray.build_scene(jspec))
        ported = tt.scene_from_arrays(arrays, "cpu")
        built = tt.build_scene(tspec, "cpu")
        for name, ref in arrays.items():
            obj_p, obj_b = ported, built
            for part in name.split("."):
                obj_p, obj_b = getattr(obj_p, part), getattr(obj_b, part)
            assert obj_p.device.type == "cpu"
            for got in (obj_p.numpy(), obj_b.numpy()):
                assert got.dtype == ref.dtype, name
                np.testing.assert_array_equal(got, ref, err_msg=name)
        assert ported.num_triangles == len(tspec.triangles)
        assert ported.to(torch.device("cpu")).num_spheres == \
            len(tspec.spheres)


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

def _pil_png(arr: np.ndarray, mode: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return buf.getvalue()


def _pil_read(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """8-bit PNG of ``img`` [H, W, C] whose row r uses PNG filter
    ``filters[r]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), written from
    the PNG specification independently of the codec under test."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    rows = []
    for r in range(h):
        cur = x[r].reshape(-1)
        up = x[r - 1].reshape(-1) if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        t = filters[r]
        if t == 0:
            pred = np.zeros_like(cur)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = up
        elif t == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([t]) + ((cur - pred) & 255).astype(np.uint8)
                    .tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _test_image(seed: int, h: int, w: int, c: int) -> np.ndarray:
    """Smooth ramps plus noise, so that every filter has work to do."""
    rng = np.random.default_rng(seed)
    ramp = np.cumsum(rng.integers(0, 9, (h, w, c)), axis=1)
    return ((ramp + rng.integers(0, 3, (h, w, c))) % 256).astype(np.uint8)


class TestPng:
    @pytest.mark.parametrize("mode,channels", [("RGB", 3), ("RGBA", 4),
                                               ("L", 1)])
    def test_reads_what_pillow_wrote(self, tmp_path, mode, channels):
        img = _test_image(1, 37, 53, channels)
        arr = img[..., 0] if mode == "L" else img
        path = str(tmp_path / "a.png")
        with open(path, "wb") as f:
            f.write(_pil_png(arr, mode))
        np.testing.assert_array_equal(tio.decode_png(open(path, "rb")
                                                     .read()),
                                      img)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(tt.read_png(path), want)

    @pytest.mark.parametrize("channels", [1, 2, 3, 4])
    @pytest.mark.parametrize("filters", ["each", "mixed"])
    def test_every_filter_type(self, channels, filters):
        img = _test_image(2, 25, 31, channels)
        rows = ([r % 5 for r in range(img.shape[0])] if filters == "mixed"
                else None)
        for t in ([None] if rows else range(5)):
            data = _filtered_png(img, rows or [t] * img.shape[0])
            got = tio.decode_png(data)
            np.testing.assert_array_equal(got, img)
            pil = _pil_read(data)
            np.testing.assert_array_equal(
                got, pil[..., None] if channels == 1 else pil)

    def test_written_png_reads_back_in_pillow(self, tmp_path):
        img = _test_image(3, 40, 70, 3)
        path = str(tmp_path / "out.png")
        tt.write_png(path, img)
        with Image.open(path) as im:
            assert im.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(tt.read_png(path), img)

    def test_rejects_unsupported_pngs(self):
        img = _test_image(4, 8, 8, 3)
        buf = io.BytesIO()
        Image.fromarray(img).convert("P").save(buf, "PNG")
        with pytest.raises(ValueError, match="colour type 3"):
            tio.decode_png(buf.getvalue())
        buf = io.BytesIO()
        Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(buf, "PNG")
        with pytest.raises(ValueError, match="bit depth 16"):
            tio.decode_png(buf.getvalue())
        # the same image with Adam7 interlacing declared in its IHDR
        data = bytearray(tio.encode_png(img))
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        with pytest.raises(ValueError, match="interlaced"):
            tio.decode_png(bytes(data))
        with pytest.raises(ValueError, match="RGB u8"):
            tio.encode_png(img.astype(np.float32))


def test_assets_match_jax_package(tmp_path):
    want = tpuray.solid_assets(2, 8, 4, (10, 20, 30))
    got = tt.solid_assets(2, 8, 4, (10, 20, 30), device="cpu")
    np.testing.assert_array_equal(got.textures.numpy(),
                                  np.asarray(want.textures))
    np.testing.assert_array_equal(got.skybox.numpy(),
                                  np.asarray(want.skybox))
    # seeded stand-ins in the reference's layout, loaded back from PNGs
    tex, sky = tt.random_asset_arrays(0)
    assert tex.shape == (4, 64, 64, 3) and sky.shape == (96, 128, 3)
    (tmp_path / "bg").mkdir()
    for name, img in zip(tt.textures.DEFAULT_TEXTURES, tex):
        tt.write_png(str(tmp_path / name), img)
    tt.write_png(str(tmp_path / tt.textures.DEFAULT_SKYBOX), sky)
    loaded = tt.load_default_assets(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(loaded.textures.numpy(), tex)
    np.testing.assert_array_equal(loaded.skybox.numpy(), sky)
    with pytest.raises(ValueError, match="cross"):
        tt.assets_from_arrays(tex, sky[:, :100], "cpu")


def test_image_diff_stats_matches_jax_package():
    from tpuray.io import image_diff_stats as jax_stats
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    assert dataclasses.asdict(tt.image_diff_stats(a, b)) == \
        pytest.approx(dataclasses.asdict(jax_stats(a, b)))
    assert tt.image_diff_stats(a, a).psnr == 99.0
