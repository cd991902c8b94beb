"""The port's whole-image tracer (``kernels/trace.py``) held against the JAX
package's ``trace_rays`` on the same rays, with and without triangles, in
both loop modes; the engine dispatch of ``render.py`` (``'auto'`` above the
megakernel's cap, ``render_from_basis_checked``); and the apps'
``--engine tracer``.

Tolerance for an image: the bar of ``tests/test_torch_megakernel.py`` (at
least 99.9% of the pixels that are not chaotic within 1e-3, mean < 1e-4 on
them, chaotic pixels under 2%).  A pixel is chaotic when the port's own
tracer moves it by >= 1e-3 under a one-ulp nudge of the camera basis; the
nudged renders use ``loop='while'``, which gives the same image as
``'scan'`` (``test_while_and_scan_give_the_same_image_and_gradients``).
The port's triangle queries are its brute force on the CPU; the JAX tracer
uses its XLA scan.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
from tpuray import config as jconfig
from tpuray.kernels.trace import trace_rays as jax_trace_rays
from tpuray.meshes import mesh_benchmark_scene

import tpuray_torch as tt
from tpuray_torch.apps import invrender, raypng
from tpuray_torch.kernels.trace import trace_rays
from test_torch_megakernel import (_assets_pair, assert_agrees,
                                   chaotic_pixels, jax_scene_arrays)
from test_torch_render import GOLDEN_CAMERA, _write_inputs

# the traced image: 64x32 rows of a 64x72 frame, below its horizon row
# (36), whose rays graze the floor: a one-ulp nudge flips them between a far
# floor texel and the sky, so they are all chaotic
WIDTH, HEIGHT, FRAME_HEIGHT, ROW0 = 64, 32, 72, 38
# the module (the package's ``render`` is the function)
trender = importlib.import_module("tpuray_torch.render")
TRI_CAMERA = ((0.0, 1.0, -3.0), (0.0, 0.0, 1.0), 90.0, 1.0)


def two_triangle_spec(pkg):
    """test_pallas_vjp.py's mixed scene: 2 triangles, a ground plane, a
    glass sphere and a light."""
    return pkg.SceneSpec(
        spheres=[pkg.SphereSpec((1.5, 0.7, 2.5), 0.7, pkg.GLASS)],
        planes=[pkg.PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                              pkg.PLASTIC.replace(rgb=(0.4, 0.4, 0.4)))],
        triangles=[
            pkg.TriangleSpec((-1.2, 0.1, 3.0), (0.2, 0.2, 3.2),
                             (-0.5, 1.6, 2.8),
                             pkg.PLASTIC.replace(rgb=(0.9, 0.3, 0.2))),
            pkg.TriangleSpec((0.0, 0.1, 2.0), (1.0, 0.1, 2.4),
                             (0.6, 1.2, 2.2),
                             pkg.PLASTIC.replace(rgb=(0.2, 0.8, 0.3),
                                                 reflectivity=0.3)),
        ],
        lights=[pkg.LightSpec((0.5, 4.0, 0.0), 0.1, 40.0, (1.0, 1.0, 1.0))])


@functools.lru_cache(maxsize=None)
def scene_pair(name):
    """(JAX scene, the port's scene from the same arrays, camera args)."""
    if name == "canonical":
        jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
        camera = GOLDEN_CAMERA
    elif name == "triangles":
        jscene = tpuray.build_scene(two_triangle_spec(tpuray))
        camera = TRI_CAMERA
    else:
        jscene = tpuray.build_scene(mesh_benchmark_scene(1))
        camera = GOLDEN_CAMERA
    return jscene, tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu"), \
        camera


def rays(camera, width, height, frame_height=None, row0=0):
    """(basis, o, d, pixel ids) of ``height`` rows from ``row0`` of a
    ``width`` x ``frame_height`` frame."""
    basis = tt.perspective_basis(tt.Camera(*camera), width,
                                 frame_height or height, device="cpu")
    o, d = tt.generate_rays(basis, width, height, row0)
    return basis, o, d, torch.arange(width * height) + row0 * width


def jax_trace(jscene, jassets, o, d, ids, cfg):
    jcfg = jconfig.RenderConfig(
        width=cfg.width, height=cfg.height, max_depth=cfg.max_depth,
        shadow_samples=cfg.shadow_samples, chunk_size=0, loop=cfg.loop,
        scan_iters=cfg.scan_iters, filter=cfg.filter)
    return np.asarray(jax_trace_rays(
        jscene, jassets, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(ids.numpy().astype(np.uint32)), jcfg))


# (scene, depth, loop)
CASES = [("canonical", 3, "while"), ("canonical", 3, "scan"),
         ("canonical", 6, "while"), ("canonical", 6, "scan"),
         ("triangles", 3, "scan"), ("triangles", 6, "while"),
         ("mesh", 3, "scan"), ("mesh", 6, "while")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-d{c[1]}-"
                                                      f"{c[2]}")
def test_tracer_matches_jax_trace_rays(case):
    name, depth, loop = case
    jscene, scene, camera = scene_pair(name)
    jassets, assets = _assets_pair()
    cfg = tt.RenderConfig(width=WIDTH, height=HEIGHT, max_depth=depth,
                          chunk_size=0, loop=loop)
    basis, o, d, ids = rays(camera, WIDTH, HEIGHT, FRAME_HEIGHT, ROW0)
    ours = trace_rays(scene, assets, o, d, ids, cfg).numpy().reshape(
        HEIGHT, WIDTH, 3)
    theirs = jax_trace(jscene, jassets, o, d, ids, cfg).reshape(
        HEIGHT, WIDTH, 3)

    def render(b):
        return tt.render_from_basis_tracer(
            scene, assets, b, cfg.replace(loop="while"), ROW0).numpy()

    bad = np.abs(ours - theirs).max(-1) >= 1e-3
    chaotic = (chaotic_pixels(render, basis, ours) if bad.any()
               else np.zeros(bad.shape, bool))
    assert_agrees(ours, theirs, chaotic, f"{name} d{depth} {loop}")


@pytest.mark.parametrize("name", ["canonical", "triangles"])
def test_while_and_scan_give_the_same_image_and_gradients(name):
    """Where the scan's steps cover every lane, the two loops give the same
    image, and autograd through each the same gradients."""
    _, scene, camera = scene_pair(name)
    assets = _assets_pair()[1]
    _, o, d, ids = rays(camera, 32, 24)
    w = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(32 * 24, 3)).astype(np.float32))
    out = {}
    for loop in ("while", "scan"):
        cfg = tt.RenderConfig(width=32, height=24, max_depth=3, loop=loop,
                              chunk_size=0)
        params, rest = tt.partition(scene)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        img = trace_rays(tt.combine(leaves, rest), assets, o, d, ids, cfg)
        grads = torch.autograd.grad((img * w).sum(), list(leaves.values()),
                                    allow_unused=True)
        out[loop] = (img.detach(), dict(zip(leaves, grads)))
    np.testing.assert_array_equal(out["while"][0].numpy(),
                                  out["scan"][0].numpy())
    for k, g in out["while"][1].items():
        other = out["scan"][1][k]
        if g is None or other is None:
            assert g is None and other is None, k
            continue
        np.testing.assert_allclose(g.numpy(), other.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    if name == "triangles":
        assert float(out["scan"][1]["tri_v0"].abs().sum()) > 0


def test_chunks_and_rows_give_the_whole_image():
    """Chunked renders and row slabs (``row0``) give the pixels of the
    whole image: each chunk traces its own pixels with their own ids."""
    _, scene, camera = scene_pair("canonical")
    assets = _assets_pair()[1]
    basis = tt.perspective_basis(tt.Camera(*camera), 40, 24, device="cpu")
    cfg = tt.RenderConfig(width=40, height=24, max_depth=3, chunk_size=0,
                          engine="tracer")
    whole = tt.render_from_basis_tracer(scene, assets, basis, cfg)
    chunked = tt.render_from_basis_tracer(scene, assets, basis,
                                          cfg.replace(chunk_size=333))
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    slab = tt.render_from_basis(scene, assets, basis, cfg.replace(height=8),
                                row0=10)
    np.testing.assert_array_equal(slab.numpy(), whole[10:18].numpy())


def test_config_refuses_unknown_filter_engine_and_loop():
    for field in ("filter", "engine", "loop"):
        with pytest.raises(ValueError, match=f"unknown {field}"):
            tt.RenderConfig(**{field: "pallas"})
    cfg = tt.RenderConfig(max_depth=4)
    assert cfg.resolved_scan_iters() == 32
    assert cfg.replace(scan_iters=5).resolved_scan_iters() == 5


def test_auto_falls_back_to_the_tracer_above_the_cap(monkeypatch):
    """Above the megakernel's triangle cap (patched down to 1, as
    test_pallas_vjp.py:99 patches the JAX cap) ``engine='auto'`` warns and
    renders with the tracer; ``'megakernel'`` refuses the scene."""
    _, scene, camera = scene_pair("triangles")
    assets = _assets_pair()[1]
    basis = tt.perspective_basis(tt.Camera(*camera), 24, 16, device="cpu")
    cfg = tt.RenderConfig(width=24, height=16, max_depth=3)
    megakernel = tt.render_from_basis(scene, assets, basis, cfg)
    tracer = tt.render_from_basis_tracer(scene, assets, basis, cfg)
    assert float((megakernel - tracer).abs().max()) > 0   # two engines
    monkeypatch.setattr(trender, "TRI_MAX_TRIANGLES", 1)
    assert not tt.megakernel_supported(scene, cfg)
    with pytest.warns(RuntimeWarning, match="fell back to the whole-image"):
        img = tt.render_from_basis(scene, assets, basis, cfg)
    np.testing.assert_array_equal(img.numpy(), tracer.numpy())
    with pytest.warns(RuntimeWarning):
        img, info = tt.render_from_basis_checked(scene, assets, basis, cfg)
    assert info == {"dropped": 0, "retries": 0, "event_slots": 0,
                    "engine": "tracer"}
    np.testing.assert_array_equal(img.numpy(), tracer.numpy())


def test_checked_render_reports_no_drops():
    """TestCheckedRenderFallback (test_render.py:92-104) on the port, and
    the megakernel engine's report: nothing drops on either."""
    spec = tt.SceneSpec(
        spheres=[tt.SphereSpec((0.0, 1.0, 3.0), 1.0,
                               tt.PLASTIC.replace(rgb=(1.0, 0.2, 0.2))),
                 tt.SphereSpec((1.5, 0.7, 2.0), 0.7, tt.GLASS)],
        planes=[tt.PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                             tt.PLASTIC.replace(rgb=(0.4, 0.4, 0.4)))],
        lights=[tt.LightSpec((2.0, 4.0, 0.0), 0.1, 30.0, (1.0, 1.0, 1.0))])
    scene = tt.build_scene(spec, "cpu")
    assets = tt.solid_assets(device="cpu")
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), 32, 16,
                                 device="cpu")
    cfg = tt.RenderConfig(width=32, height=16, max_depth=2, chunk_size=0,
                          engine="tracer")
    img, info = tt.render_from_basis_checked(scene, assets, basis, cfg)
    assert img.shape == (16, 32, 3)
    assert info["engine"] == "tracer" and info["dropped"] == 0
    img, info = tt.render_from_basis_checked(
        scene, assets, basis, cfg.replace(engine="megakernel"))
    assert info["engine"] == "megakernel" and info["dropped"] == 0
    np.testing.assert_array_equal(img.numpy(), tt.render_from_basis(
        scene, assets, basis, cfg.replace(engine="megakernel")).numpy())
    _, dropped, needed = tt.render_megakernel_checked(scene, assets, basis,
                                                      cfg)
    assert dropped == 0 and needed == 0
    assert tt.render_megakernel_stats(scene, assets, basis, cfg) == {
        "dropped_events": 0, "max_slots_used": 0}


def test_raypng_engine_tracer(tmp_path):
    scene_path, asset_dir, tex, sky = _write_inputs(tmp_path)
    out = str(tmp_path / "tracer.png")
    res = raypng.main(["--scene", scene_path, "--asset-dir", asset_dir,
                       "--out", out, "--width", "40", "--height", "24",
                       "--depth", "4", "--device", "cpu", "--engine",
                       "tracer", "--chunk-size", "500"])
    np.testing.assert_array_equal(tt.read_png(out), res["image"])
    want = tt.render_u8(tt.build_scene(tt.canonical_scene_spec(), "cpu"),
                        tt.assets_from_arrays(tex, sky, "cpu"),
                        tt.Camera(*GOLDEN_CAMERA),
                        tt.RenderConfig(width=40, height=24, max_depth=4,
                                        engine="tracer"))
    np.testing.assert_array_equal(res["image"], want)


def test_invrender_engine_tracer_lowers_the_loss(tmp_path):
    """invrender's tracer engine (autograd through ``trace_rays``, as the
    JAX app's xla engine, invrender.py:233-236): a few steps at 32x24 depth
    2 lower the loss."""
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    res = invrender.main(["--scene", scene_path, "--asset-dir", asset_dir,
                          "--device", "cpu", "--engine", "tracer",
                          "--steps", "6", "--width", "32", "--height", "24",
                          "--depth", "2", "--lr", "3e-2", "--every", "5",
                          "--checkpoint", str(tmp_path / "ck.pt")])
    assert res["losses"][-1] < res["losses"][0]
    assert all(bool(torch.isfinite(v).all()) for v in res["params"].values())
