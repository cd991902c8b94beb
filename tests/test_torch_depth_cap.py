"""Depths above the megakernel's ray stack (``MAX_DEPTH_CAP`` = 16 levels).

The JAX megakernel sizes its stack by the depth (pallas_trace.py:2421-2426),
so the JAX package renders at any depth.  The port's kernel holds 16
levels: ``engine='auto'`` (``render`` and invrender) takes the whole-image
tracer above that with a ``RuntimeWarning``, as it does above the triangle
cap, and an explicit ``engine='megakernel'`` raises ``ValueError`` naming
the cap.  The auto render is held against the JAX package's XLA tracer
(``render_from_basis_xla``) at the bar of ``tests/test_render.py:83``:
more than 99.5% of pixels within 1e-2.
"""
import functools

import numpy as np
import pytest

import tpuray
from tpuray import config as jconfig
from tpuray.render import render_from_basis_xla

import tpuray_torch as tt
from tpuray_torch.apps import invrender
from tpuray_torch.kernels.megakernel import MAX_DEPTH_CAP
from test_torch_megakernel import _assets_pair, _camera_pair, \
    jax_scene_arrays
from test_torch_render import _write_inputs

WIDTH, HEIGHT = 48, 36
DEPTH = MAX_DEPTH_CAP + 1
TRACER_AGREE_ABS = 1e-2
TRACER_AGREE_FRAC = 0.995


@functools.lru_cache(maxsize=None)
def scenes():
    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    return jscene, tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")


def test_auto_renders_above_the_depth_cap_with_the_tracer():
    jscene, scene = scenes()
    jassets, assets = _assets_pair()
    jcam, cam = _camera_pair()
    cfg = tt.RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    assert not tt.megakernel_supported(scene, cfg)
    assert tt.megakernel_supported(scene, cfg.replace(max_depth=16))
    with pytest.warns(RuntimeWarning, match="MAX_DEPTH_CAP = 16"):
        ours = tt.render(scene, assets, cam, cfg).numpy()
    jcfg = jconfig.RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH,
                                chunk_size=0)
    theirs = np.asarray(render_from_basis_xla(
        jscene, jassets, tpuray.perspective_basis(jcam, WIDTH, HEIGHT),
        jcfg))
    assert ours.shape == (HEIGHT, WIDTH, 3) and np.isfinite(ours).all()
    d = np.abs(ours - theirs).max(-1)
    assert (d < TRACER_AGREE_ABS).mean() > TRACER_AGREE_FRAC, \
        f"mismatch {(d >= TRACER_AGREE_ABS).mean()}, max {d.max()}"
    # the same pixels as the tracer engine asked for by name
    with pytest.warns(RuntimeWarning):
        img, info = tt.render_from_basis_checked(
            scene, assets, tt.perspective_basis(cam, WIDTH, HEIGHT,
                                                device="cpu"), cfg)
    assert info["engine"] == "tracer"
    np.testing.assert_array_equal(img.numpy(), ours)


def test_explicit_megakernel_refuses_depths_above_the_cap():
    _, scene = scenes()
    _, assets = _assets_pair()
    _, cam = _camera_pair()
    cfg = tt.RenderConfig(width=8, height=4, max_depth=DEPTH,
                          engine="megakernel")
    with pytest.raises(ValueError, match="at most 16 levels"):
        tt.render(scene, assets, cam, cfg)


def test_invrender_auto_takes_the_tracer_above_the_depth_cap(
        tmp_path, monkeypatch, capsys):
    """invrender's default engine at depth 17 trains through the tracer,
    with the warning, and never reaches the record megakernel.  The scan's
    step count is capped at 16 (it would be 8,192 at this depth) to keep
    the run short: what is tested is the dispatch."""
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    monkeypatch.setattr(invrender, "RenderConfig",
                        functools.partial(tt.RenderConfig, max_iters=16))

    def refuse(*args, **kw):
        raise AssertionError("the record megakernel was called")

    monkeypatch.setattr(invrender, "render_megakernel_record", refuse)
    monkeypatch.setattr(invrender, "render_megakernel_diff", refuse)
    with pytest.warns(RuntimeWarning, match="MAX_DEPTH_CAP = 16"):
        res = invrender.main(["--scene", scene_path, "--asset-dir", asset_dir,
                              "--device", "cpu", "--steps", "2", "--width",
                              "8", "--height", "6", "--depth", str(DEPTH),
                              "--every", "1",
                              "--checkpoint", str(tmp_path / "ck.pt")])
    assert "engine=tracer" in capsys.readouterr().out
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
