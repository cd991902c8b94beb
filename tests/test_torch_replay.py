"""The port's replay (``kernels/replay.py``): it reproduces the record
render it replays, and its autograd gradients match ``jax.grad`` through
the JAX package's ``replay_render`` on the same records.

Both replays read the port's records (made by the plain record version on
the CPU), cut to their first ``max_nodes`` slots, the slots any pixel
used; the JAX replay gets the port's texel picks as its texel events, in
DFS order.  Gradients are compared leaf by leaf on the pixels where the
two replays' images agree (< 1e-4), each pixel weighted by a distinct
seeded number, with ``atol = 2e-2 * max|g_jax|`` (the bound of
``tests/test_pallas_vjp.py``): the two programs sum in other orders (the
port reads all of a solid's fields with one one-hot product over one
table, the JAX replay with one per field), and
``sphere_radius`` amplifies float noise through dt/dr ~ 1/sqrt(disc) at
grazing hits.  Both images are unclamped: ``jnp.clip`` passes half the
gradient at an exact tie, ``torch.clamp`` all of it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
from tpuray import config as jconfig
from tpuray import diff as jdiff
from tpuray.kernels.replay import replay_render as jax_replay_render

import tpuray_torch as tt
from tpuray_torch.kernels.megakernel import (pack_scene,
                                             render_megakernel_record)
from tpuray_torch.kernels.replay import replay_render
from tpuray_torch.kernels.triblocks import TRI_MAX_TRIANGLES
from test_torch_cuda import many_triangles
from test_torch_megakernel import _assets_pair, _camera_pair
from test_torch_record import picks_in_event_order

REPLAY_MEAN = 1e-3     # tests/test_pallas_vjp.py:82-83
REPLAY_MAX = 5e-2
GRAD_ATOL = 2e-2       # tests/test_pallas_vjp.py:297-303, times max|g|
AGREE_ABS = 1e-4

# (width, height, max_depth, shadow_samples, frame_height, row0)
REPLAY_CASES = [(48, 32, 2, 0, 32, 0), (32, 24, 3, 2, 24, 0),
                (32, 16, 5, 2, 16, 0), (40, 30, 6, 2, 30, 0),
                (32, 8, 3, 2, 24, 10)]
GRAD_CASES = [(48, 32, 2, 0), (32, 24, 3, 2)]
BASIS_FIELDS = ("corner", "origin", "up", "right", "w_factor", "h_factor")


def case_id(c):
    rows = f"-rows{c[5]}+{c[1]}of{c[4]}" if len(c) > 4 and c[5] else ""
    return f"{c[0]}x{c[1]}-d{c[2]}-ss{c[3]}{rows}"


def port_inputs(width, frame_height, depth, samples, height=None):
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    assets = _assets_pair()[1]
    basis = tt.perspective_basis(_camera_pair()[1], width, frame_height,
                                 device="cpu")
    cfg = tt.RenderConfig(width=width, height=height or frame_height,
                          max_depth=depth, shadow_samples=samples)
    return scene, assets, basis, cfg


@pytest.mark.parametrize("case", REPLAY_CASES, ids=case_id)
def test_replay_reproduces_the_record_render(case):
    width, height, depth, samples, frame_h, row0 = case
    scene, assets, basis, cfg = port_inputs(width, frame_h, depth, samples,
                                            height)
    img, records = render_megakernel_record(pack_scene(scene, basis, row0),
                                            assets, cfg)
    rep = replay_render(scene, assets, basis, records, cfg, row0)
    assert rep.shape == (height, width, 3)
    d = (rep - img).abs()
    assert float(d.mean()) < REPLAY_MEAN, f"mean|d| {float(d.mean())}"
    assert float(d.max()) < REPLAY_MAX, f"max|d| {float(d.max())}"


def test_replay_refuses_what_it_cannot_replay():
    scene, assets, basis, cfg = port_inputs(8, 8, 2, 0)
    _, records = render_megakernel_record(pack_scene(scene, basis), assets,
                                          cfg)
    with pytest.raises(ValueError, match="524,288"):
        replay_render(many_triangles(scene, TRI_MAX_TRIANGLES + 1), assets,
                      basis, records, cfg)
    crowded = dataclasses.replace(
        scene, light_origin=torch.zeros(63, 3), light_radius=torch.ones(63),
        light_intensity=torch.ones(63), light_rgb=torch.ones(63, 3))
    with pytest.raises(ValueError, match="62 lights"):
        replay_render(crowded, assets, basis, records, cfg)


def jax_leaf(tree, name):
    for part in name.split("."):
        tree = getattr(tree, part)
    return np.asarray(tree)


@pytest.fixture(scope="module", params=GRAD_CASES, ids=case_id)
def grads(request):
    """Port and JAX gradients of ``sum(replay * w)`` on the port's records,
    with respect to the scene's float leaves and the basis."""
    width, height, depth, samples = request.param
    scene, assets, basis, cfg = port_inputs(width, height, depth, samples)
    _, records = render_megakernel_record(pack_scene(scene, basis), assets,
                                          cfg)
    used = int(records["max_nodes"])
    records = {"rec": records["rec"][:used], "ssr": records["ssr"][:used],
               "pick": records["pick"][:used],
               "max_nodes": records["max_nodes"]}

    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    jassets = _assets_pair()[0]
    jbasis = tpuray.perspective_basis(_camera_pair()[0], width, height)
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=depth,
                                shadow_samples=samples)
    jrecords = {"rec": jnp.asarray(records["rec"].numpy()),
                "ssr": jnp.asarray(records["ssr"].numpy()),
                "ev_idx": jnp.asarray(picks_in_event_order(
                    records["pick"].numpy()))}
    d_scene, rest = jdiff.partition(jscene)
    jimg, vjp = jax.vjp(
        lambda d, b: jax_replay_render(jdiff.combine(d, rest), jassets, b,
                                       jrecords, jcfg), d_scene, jbasis)

    params = {k: v.clone().requires_grad_()
              for k, v in tt.diff.partition(scene)[0].items()}
    tbasis = tt.PerspectiveBasis(*(getattr(basis, f).clone().requires_grad_()
                                   for f in BASIS_FIELDS))
    img = replay_render(tt.diff.combine(params, tt.diff.partition(scene)[1]),
                        assets, tbasis, records, cfg)

    agree = np.abs(img.detach().numpy() - np.asarray(jimg)).max(-1) \
        < AGREE_ABS
    assert agree.mean() > 0.99, f"replays agree on {agree.mean():.4f}"
    w = np.random.default_rng(0).uniform(size=(height, width, 3)) \
        * agree[..., None]
    w = w.astype(np.float32)
    g_scene, g_basis = vjp(jnp.asarray(w))
    ours = torch.autograd.grad(
        img, [*params.values(), *(getattr(tbasis, f) for f in BASIS_FIELDS)],
        torch.from_numpy(w), allow_unused=True)
    names = [*params, *(f"basis.{f}" for f in BASIS_FIELDS)]
    theirs = [jax_leaf(g_scene, k) for k in params] \
        + [jax_leaf(g_basis, f) for f in BASIS_FIELDS]
    ours = [np.zeros_like(t) if g is None else g.numpy()
            for g, t in zip(ours, theirs)]
    return dict(zip(names, zip(ours, theirs)))


def test_replay_grads_match_jax_leaf_by_leaf(grads):
    for name, (ours, theirs) in grads.items():
        assert ours.shape == theirs.shape, name
        assert np.isfinite(ours).all(), name
        if ours.size == 0:
            continue          # triangle leaves: the scene has none
        scale = max(np.abs(theirs).max(), 1e-3)
        np.testing.assert_allclose(ours, theirs, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=name)


@pytest.mark.parametrize("name", ["sphere_mat.ambient", "light_origin",
                                  "light_intensity", "sphere_origin",
                                  "basis.corner", "basis.w_factor"])
def test_replay_grads_reach_materials_lights_geometry_and_camera(grads,
                                                                 name):
    ours, _ = grads[name]
    assert np.abs(ours).sum() > 0, name
