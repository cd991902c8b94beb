"""The plain version of the port's megakernel held against the JAX
megakernel in Pallas interpret mode on seeded random scenes of glass,
mirror and plastic spheres, with the cases and the tolerance of
``test_torch_megakernel.py`` (a file of its own, so that the interpret
renders spread over the test workers)."""
import numpy as np
import pytest

import tpuray
import tpuray_torch as tt
from test_torch_megakernel import (CASES, case_id, check_render_parity,
                                   jax_scene_arrays)

SCENE_SEEDS = (1, 2)


def glass_mirror_spec(mod, seed: int):
    """A scene spec of ``mod`` (``tpuray`` or ``tpuray_torch``) laid out
    like render.map, in view of the golden camera: a glass, a mirror, a
    reflective plastic and a second glass sphere of random index, a
    textured floor, a tinted mirror wall and three area lights."""
    rng = np.random.default_rng(seed)

    def rgb(hi=1.0):
        return tuple(float(x) for x in rng.uniform(0, hi, 3))

    def sphere(material):
        radius = float(rng.uniform(0.4, 1.0))
        centre = (float(rng.uniform(-2.5, 3.5)),
                  radius + float(rng.uniform(0, 0.6)),
                  float(rng.uniform(-2, 5)))
        return mod.SphereSpec(centre, radius, material)

    spheres = [
        sphere(mod.GLASS.replace(rgb=rgb())),
        sphere(mod.MIRROR.replace(rgb=rgb(0.5))),
        sphere(mod.PLASTIC.replace(rgb=rgb(),
                                   reflectivity=float(rng.uniform(0, 0.5)))),
        sphere(mod.GLASS.replace(n=float(rng.uniform(1.1, 1.9)),
                                 ambient=0.05)),
    ]
    planes = [
        mod.PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0), mod.STONE.replace(
            rgb=(0.0, 0.0, 0.0), texture_id=int(rng.integers(0, 4)),
            texture_scale=float(rng.uniform(20, 150)))),
        mod.PlaneSpec((0.0, 0.0, -1.0), (0.0, 0.0, float(rng.uniform(6, 9))),
                      mod.MIRROR.replace(
                          ambient=0.3, shininess=float(rng.integers(50, 200)),
                          specular=0.4, rgb=rgb(0.5))),
    ]
    lights = [mod.LightSpec((float(rng.uniform(-3, 3)),
                             float(rng.uniform(1.5, 5)),
                             float(rng.uniform(-1, 5))),
                            float(rng.uniform(0.05, 0.3)),
                            float(rng.uniform(5, 50)), rgb())
              for _ in range(3)]
    return mod.SceneSpec(spheres=spheres, planes=planes, lights=lights)


@pytest.fixture(scope="module", params=SCENE_SEEDS,
                ids=[f"seed{s}" for s in SCENE_SEEDS])
def scene_pair(request):
    jscene = tpuray.build_scene(glass_mirror_spec(tpuray, request.param))
    tscene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    # the port's own spec builder gives the same numbers
    built = tt.build_scene(glass_mirror_spec(tt, request.param), "cpu")
    np.testing.assert_array_equal(built.sphere_origin.numpy(),
                                  tscene.sphere_origin.numpy())
    return jscene, tscene


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_glass_mirror_scene_matches_jax_megakernel(scene_pair, case):
    check_render_parity(*scene_pair, case)
