"""The port's meshes (``tpuray_torch.meshes``) against ``tpuray.meshes``, and
the port's plain version on mesh scenes against the JAX package's renderers:
the XLA tracer (``render_from_basis_xla``, the f32 oracle), the Pallas
megakernel in interpret mode, and, above the JAX kernel's 32,768-triangle
VMEM cap, ``trace_rays``; and the raypng app on a mesh archive.

Bar for an image: on u8, more than 98% of channel values within 1 and a
mean |d| below 1.0 (``tests/test_pallas_engine.py:343-348``).  The port's
triangle test is f32 Möller–Trumbore, as the XLA tracer's; the Pallas
kernel's closest hit is a bf16x3 product and its feelers ignore occluders
within 0.05 of their origin's plane (``_TRI_FEELER_PLANE_DIST``), which the
port does not do (ROADMAP C): the bar leaves room for the pixels that
moves.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tpuray
from tpuray import config as jconfig
from tpuray import meshes as jmeshes
from tpuray.camera import generate_rays as jax_generate_rays
from tpuray.io import image_diff_stats
from tpuray.kernels.pallas_trace import render_pallas
from tpuray.kernels.trace import trace_rays
from tpuray.render import render_from_basis_xla

import tpuray_torch as tt
from tpuray_torch import meshes
from tpuray_torch.apps import raypng
from tpuray_torch.kernels.megakernel import (pack_scene,
                                             render_megakernel_reference)
from test_torch_megakernel import _assets_pair, _camera_pair, jax_scene_arrays
from test_torch_render import _write_inputs

FRAC_WITHIN_1 = 0.98
MEAN_ABS_U8 = 1.0


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_icosphere_matches_jax(order):
    v, f = meshes.icosphere(order)
    jv, jf = jmeshes.icosphere(order)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert f.shape == (20 * 4 ** order, 3)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("kw", [{}, dict(major=2.0, minor=0.5, nu=8, nv=4),
                                dict(nu=64, nv=40)])
def test_torus_matches_jax(kw):
    v, f = meshes.torus(**kw)
    jv, jf = jmeshes.torus(**kw)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert f.shape == (2 * kw.get("nu", 48) * kw.get("nv", 24), 3)


@pytest.mark.parametrize("order", [1, 2])
def test_mesh_benchmark_scene_archive_is_byte_equal(order):
    ours = tt.dumps_scene(meshes.mesh_benchmark_scene(order))
    assert ours == tpuray.dumps_scene(jmeshes.mesh_benchmark_scene(order))
    back = tt.loads_scene(ours)
    assert len(back.triangles) == 20 * 4 ** order + 2 * 48 * 24


def test_add_mesh_places_triangles_as_jax_does():
    v, f = meshes.torus(nu=6, nv=3)
    ours = meshes.add_mesh(tt.SceneSpec(), v, f, tt.GLASS, scale=0.5,
                           offset=(1.0, -2.0, 3.0))
    theirs = jmeshes.add_mesh(tpuray.SceneSpec(), v, f, tpuray.GLASS,
                              scale=0.5, offset=(1.0, -2.0, 3.0))
    assert len(ours.triangles) == len(theirs.triangles) == 36
    for a, b in zip(ours.triangles, theirs.triangles):
        assert (a.v0, a.v1, a.v2) == (b.v0, b.v1, b.v2)
        assert a.material.transparent and a.material.n == b.material.n


def test_built_mesh_scene_has_the_jax_leaves():
    """build_scene's Morton order is the JAX package's: triangle ids (the
    records' winner ids) mean the same triangle in both packages."""
    ours = tt.scene_leaves(tt.build_scene(meshes.mesh_benchmark_scene(2),
                                          "cpu"))
    theirs = jax_scene_arrays(tpuray.build_scene(
        jmeshes.mesh_benchmark_scene(2)))
    assert set(ours) == set(theirs)
    for name, value in ours.items():
        np.testing.assert_array_equal(value.numpy(), theirs[name], name)


# ---------------------------------------------------------------------------
# the plain version on mesh scenes
# ---------------------------------------------------------------------------

def _benchmark_spec(mod):
    return (jmeshes if mod is tpuray else meshes).mesh_benchmark_scene(
        1, (8, 4))


def _glass_torus_spec(mod):
    """The small benchmark mesh with a glass torus: feelers through it
    count transparent triangles."""
    spec = _benchmark_spec(mod)
    for tri in spec.triangles[80:]:
        tri.material = mod.GLASS
    return spec


SCENES = {"benchmark": _benchmark_spec, "glass_torus": _glass_torus_spec}


def _pair(spec_fn, width, height, depth, samples=2, rows=None, row0=0):
    """The port's plain render of ``rows`` rows from ``row0`` of a width x
    height frame, and the JAX side's inputs for the same."""
    jscene = tpuray.build_scene(spec_fn(tpuray))
    scene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    jassets, assets = _assets_pair()
    jcam, cam = _camera_pair()
    jbasis = tpuray.perspective_basis(jcam, width, height)
    basis = tt.perspective_basis(cam, width, height, device="cpu")
    rows = rows or height
    jcfg = jconfig.RenderConfig(width=width, height=rows, max_depth=depth,
                                shadow_samples=samples, chunk_size=0)
    cfg = tt.RenderConfig(width=width, height=rows, max_depth=depth,
                          shadow_samples=samples)
    port = render_megakernel_reference(pack_scene(scene, basis, row0), assets,
                                       cfg).numpy()
    return port, (jscene, jassets, jbasis, jcfg)


def _u8(img):
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def assert_u8_bar(port, ref, what):
    stats = image_diff_stats(_u8(port), _u8(ref))
    assert stats.frac_within_1 > FRAC_WITHIN_1, f"{what}: {stats}"
    assert stats.mean_abs < MEAN_ABS_U8, f"{what}: {stats}"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_matches_xla_tracer_on_mesh_scenes(name):
    port, (jscene, jassets, jbasis, jcfg) = _pair(SCENES[name], 64, 32, 3)
    ref = np.asarray(render_from_basis_xla(jscene, jassets, jbasis, jcfg))
    assert_u8_bar(port, ref, name)


def test_plain_matches_pallas_megakernel_on_a_mesh_scene():
    """144 triangles, two of the JAX kernel's 128-triangle blocks; rows
    16-31 of a 64x32 frame, one of its tiles, through both meshes."""
    port, (jscene, jassets, jbasis, jcfg) = _pair(
        SCENES["benchmark"], 64, 32, 3, rows=16, row0=16)
    ref = np.asarray(render_pallas(jscene, jassets, jbasis, jcfg,
                                   interpret=True, row0=16.0))
    assert_u8_bar(port, ref, "pallas")


def test_plain_matches_trace_rays_above_the_vmem_cap():
    """36,864 triangles, above the JAX kernel's 32,768 VMEM cap (where it
    streams blocks from HBM), at 16x8 depth 2."""
    width, height = 16, 8

    def spec(mod):
        return (jmeshes if mod is tpuray else meshes).mesh_benchmark_scene(
            5, (128, 64))

    port, (jscene, jassets, jbasis, jcfg) = _pair(spec, width, height, 2)
    assert jscene.num_triangles == 36_864
    o, d = jax_generate_rays(jbasis, width, height)
    ids = jnp.arange(width * height, dtype=jnp.uint32)
    ref = np.asarray(trace_rays(jscene, jassets, o, d, ids,
                                jcfg)).reshape(height, width, 3)
    assert_u8_bar(port, ref, "trace_rays")
    assert np.abs(port - ref).max() < 1e-3


def test_raypng_renders_a_mesh_archive(tmp_path):
    _, asset_dir, tex, sky = _write_inputs(tmp_path)
    spec = meshes.mesh_benchmark_scene(1, (8, 4))
    path = str(tmp_path / "mesh.map")
    tt.dump_scene(path, spec)
    out = str(tmp_path / "mesh.png")
    res = raypng.main(["--scene", path, "--asset-dir", asset_dir, "--out",
                       out, "--width", "40", "--height", "24", "--depth",
                       "3", "--device", "cpu", "--selfcheck"])
    np.testing.assert_array_equal(tt.read_png(out), res["image"])
    scene = tt.load_scene(path).to_scene("cpu")
    assert scene.num_triangles == 144
    want = tt.render_u8(scene, tt.assets_from_arrays(tex, sky, "cpu"),
                        _camera_pair()[1],
                        tt.RenderConfig(width=40, height=24, max_depth=3))
    np.testing.assert_array_equal(res["image"], want)
    # the meshes are in the picture
    without = tt.render_u8(tt.build_scene(tt.SceneSpec(
        spheres=spec.spheres, planes=spec.planes, lights=spec.lights), "cpu"),
        tt.assets_from_arrays(tex, sky, "cpu"), _camera_pair()[1],
        tt.RenderConfig(width=40, height=24, max_depth=3))
    assert (res["image"] != without).any(-1).mean() > 0.02


def test_invrender_takes_a_mesh_archive(tmp_path):
    """The inverse-rendering app on a mesh scene, as the JAX app takes one:
    record mode and the replay through the triangles, a few steps that
    lower the loss."""
    from tpuray_torch.apps import invrender

    _, asset_dir, _, _ = _write_inputs(tmp_path)
    path = str(tmp_path / "mesh.map")
    tt.dump_scene(path, meshes.mesh_benchmark_scene(1, (8, 4)))
    res = invrender.main(["--scene", path, "--asset-dir", asset_dir,
                          "--steps", "4", "--width", "32", "--height", "24",
                          "--depth", "2", "--lr", "3e-2", "--device", "cpu",
                          "--every", "2", "--checkpoint",
                          str(tmp_path / "inv.pt")])
    losses = res["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
