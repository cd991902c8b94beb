"""The port's camera held against the JAX package's: perspective basis and
primary rays, float32, at the golden, the benchmark and a ragged size."""
import dataclasses

import numpy as np
import pytest

import tpuray
import tpuray_torch as tt
from tpuray_torch.config import (GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                                 GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN)

TOL = dict(rtol=1e-6, atol=1e-6)

CAMERAS = {
    "golden": (GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
               GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL),
    # seeded random pose, narrower fov, longer focal length
    "random": tuple(
        (tuple(float(x) for x in r.uniform(-5, 5, 3)),
         tuple(float(x) for x in r.uniform(-1, 1, 3)),
         float(r.uniform(20, 120)), float(r.uniform(0.5, 2)))
        for r in [np.random.default_rng(7)])[0],
}


def _pair(name):
    args = CAMERAS[name]
    return tpuray.Camera(*args), tt.Camera(*args)


def test_golden_camera_constants_match():
    from tpuray import config as jcfg
    assert (GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_FOV,
            GOLDEN_CAMERA_FOCAL) == (
        jcfg.GOLDEN_CAMERA_ORIGIN, jcfg.GOLDEN_CAMERA_LOOKDIR,
        jcfg.GOLDEN_CAMERA_FOV, jcfg.GOLDEN_CAMERA_FOCAL)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_camera_normalises_lookdir_like_jax(cam):
    jc, tc = _pair(cam)
    np.testing.assert_array_equal(np.asarray(tc.lookdir, np.float32),
                                  np.asarray(jc.lookdir, np.float32))


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("width,height", [(800, 600), (1920, 1080),
                                          (37, 19)])
def test_perspective_basis_matches_jax(cam, width, height):
    jc, tc = _pair(cam)
    jb = tpuray.perspective_basis(jc, width, height)
    tb = tt.perspective_basis(tc, width, height, device="cpu")
    for f in dataclasses.fields(tb):
        got = getattr(tb, f.name)
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(jb, f.name)),
                                   err_msg=f.name, **TOL)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("width,height", [(800, 600), (1920, 1080),
                                          (37, 19)])
@pytest.mark.parametrize("row0", [0, 8])
def test_generate_rays_matches_jax(cam, width, height, row0):
    jc, tc = _pair(cam)
    jb = tpuray.perspective_basis(jc, width, height)
    tb = tt.perspective_basis(tc, width, height, device="cpu")
    rows = min(height, 64)          # a slab keeps the 1080p case small
    jo, jd = tpuray.generate_rays(jb, width, rows, row0=float(row0))
    to, td = tt.generate_rays(tb, width, rows, row0=row0)
    assert td.shape == (width * rows, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


def test_slab_rays_are_rows_of_the_full_image():
    tc = _pair("golden")[1]
    tb = tt.perspective_basis(tc, 37, 19, device="cpu")
    _, full = tt.generate_rays(tb, 37, 19)
    _, slab = tt.generate_rays(tb, 37, 5, row0=8)
    np.testing.assert_array_equal(slab.numpy(),
                                  full.numpy()[8 * 37:13 * 37])


@pytest.mark.parametrize("fov,lookdir", [(180.0, (0.2, 0.0, 1.0)),
                                         (0.0, (0.2, 0.0, 1.0)),
                                         (90.0, (0.0, 1.0, 0.0))])
def test_invalid_cameras_raise_in_both(fov, lookdir):
    with pytest.raises(ValueError):
        tpuray.perspective_basis(tpuray.Camera((0, 0, 0), lookdir, fov), 8, 8)
    with pytest.raises(ValueError):
        tt.perspective_basis(tt.Camera((0, 0, 0), lookdir, fov), 8, 8,
                             device="cpu")
