"""The port's native I/O library (``tpuray_torch.native_lib``, built with
g++ from ``tpuray_torch/native/tpuray_native.cc``) held against the numpy +
zlib PNG codec, the port's ``sceneio`` and, where the JAX package's own
build of the same source is present (``tests/test_native.py`` builds it),
that library's bytes.  The build is module-scoped and skips with its reason
where g++ or libpng's headers are missing; the fall-back is tested in a
process that has no compiler."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tpuray import native_lib as jnative

import tpuray_torch as tt
from tpuray_torch import io as tio
from tpuray_torch import native_lib
from tpuray_torch.meshes import mesh_benchmark_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    if not native_lib.available():
        pytest.skip(native_lib.status())
    return native_lib


def _image(seed, h=33, w=41):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def test_png_round_trip_through_both_codecs(native, tmp_path):
    img = _image(7)
    ours = str(tmp_path / "native.png")
    native.write_png(ours, img)
    np.testing.assert_array_equal(native.read_png(ours), img)
    np.testing.assert_array_equal(tio.read_png(ours), img)
    numpy_png = str(tmp_path / "numpy.png")
    with open(numpy_png, "wb") as f:
        f.write(tio.encode_png(img))
    np.testing.assert_array_equal(native.read_png(numpy_png), img)
    if jnative.available():          # the JAX package's build of the source
        theirs = str(tmp_path / "jax.png")
        jnative.write_png(theirs, img)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()


def test_write_png_takes_the_native_library(native, tmp_path):
    img = _image(8, 20, 30)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tt.write_png(a, img)
    native.write_png(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(ValueError, match="RGB u8"):
        tt.write_png(a, img.astype(np.float32))


def _mesh_spec():
    return mesh_benchmark_scene(1)


@pytest.mark.parametrize("which", ["canonical", "mesh"])
def test_scene_codec_matches_sceneio(native, tmp_path, which):
    spec = tt.canonical_scene_spec() if which == "canonical" \
        else _mesh_spec()
    path = str(tmp_path / "scene.map")
    tt.dump_scene(path, spec)
    spheres, planes, lights, tris = native.scene_read(path)
    assert (len(spheres), len(planes), len(lights), len(tris)) == (
        len(spec.spheres), len(spec.planes), len(spec.lights),
        len(spec.triangles))
    back = tt.load_scene(path)
    for i, s in enumerate(back.spheres):
        np.testing.assert_array_equal(spheres["origin"][i],
                                      np.float32(s.origin))
        assert spheres["radius"][i] == np.float32(s.radius)
        assert spheres["mat"]["texture_id"][i] == s.material.texture_id
    for i, light in enumerate(back.lights):
        assert lights["intensity"][i] == np.float32(light.intensity)
    for i, t in enumerate(back.triangles[:50]):
        np.testing.assert_array_equal(tris["v1"][i], np.float32(t.v1))
    written = str(tmp_path / "native.map")
    native.scene_write(written, spheres, planes, lights, tris)
    with open(written, "rb") as f:
        assert f.read() == tt.dumps_scene(spec)


def test_falls_back_to_numpy_without_a_compiler(tmp_path):
    """No g++ (CXX names a missing program): ``available()`` is False with
    the reason, warns once, and ``write_png`` writes through numpy +
    zlib."""
    out = str(tmp_path / "x.png")
    code = (
        "import warnings, numpy as np\n"
        "from tpuray_torch import native_lib, io\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    assert not native_lib.available()\n"
        "    assert not native_lib.available()\n"
        "assert len(w) == 1 and 'not loaded' in str(w[0].message)\n"
        "print(native_lib.status())\n"
        "img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)\n"
        f"io.write_png({out!r}, img)\n"
        f"assert open({out!r}, 'rb').read() == io.encode_png(img)\n")
    env = dict(os.environ, CXX=str(tmp_path / "no-such-compiler"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "not loaded: no C++ compiler" in proc.stdout
