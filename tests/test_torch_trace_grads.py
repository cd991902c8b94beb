"""Gradients of the port's whole-image tracer: against ``jax.grad`` of the
JAX tracer, against central finite differences (the JAX package's
``tests/test_render.py::TestGradients`` and ``TestBilinearFilter``, with
their scenes and tolerances), and as the oracle of the replay's gradients
(``tests/test_pallas_vjp.py::TestReplayGradients``, plus depth 6 with record
slots for every node).

Leaf-by-leaf comparisons use ``atol = 2e-2 * max|g_reference|``
(test_pallas_vjp.py:297-303) on the pixels where the two forwards agree
(< 1e-4), each pixel weighted by a distinct seeded number: a pixel whose
two forwards took different discrete paths has unrelated gradients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuray import config as jconfig
from tpuray import diff as jdiff
from tpuray.kernels.trace import trace_rays as jax_trace_rays

import tpuray_torch as tt
from tpuray_torch.kernels.megakernel import (pack_scene,
                                             render_megakernel_record)
from tpuray_torch.kernels.trace import sample_skybox, trace_rays
from test_torch_megakernel import _assets_pair
from test_torch_render import GOLDEN_CAMERA
from test_torch_replay import jax_leaf
from test_torch_trace import rays, scene_pair

GRAD_ATOL = 2e-2
AGREE_ABS = 1e-4


def leaves_of(scene):
    params, rest = tt.partition(scene)
    return {k: v.detach().clone().requires_grad_() for k, v in
            params.items()}, rest


def tracer_grads(scene, assets, o, d, ids, cfg, w):
    """(image, gradients of sum(trace_rays * w) by leaf name)."""
    leaves, rest = leaves_of(scene)
    img = trace_rays(tt.combine(leaves, rest), assets, o, d, ids, cfg)
    grads = torch.autograd.grad((img * w).sum(), list(leaves.values()),
                                allow_unused=True)
    return img.detach(), {k: torch.zeros_like(v) if g is None else g
                          for (k, v), g in zip(leaves.items(), grads)}


def assert_leaves_match(ours, theirs, what):
    for name, g in ours.items():
        g, ref = g.numpy(), theirs[name]
        assert g.shape == ref.shape, name
        assert np.isfinite(g).all(), name
        if g.size == 0:
            continue
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_ATOL * scale,
                                   err_msg=f"{what}: {name}")


# (scene, width, height, depth, shadow samples)
JAX_CASES = [("canonical", 32, 24, 2, 2), ("triangles", 48, 32, 2, 2)]


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: c[0])
def test_tracer_grads_match_jax_grad(case):
    name, width, height, depth, samples = case
    jscene, scene, camera = scene_pair(name)
    jassets, assets = _assets_pair()
    _, o, d, ids = rays(camera, width, height)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          shadow_samples=samples, loop="scan", chunk_size=0)
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=depth,
                                shadow_samples=samples, loop="scan",
                                chunk_size=0)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jids = jnp.asarray(ids.numpy().astype(np.uint32))
    d_scene, rest = jdiff.partition(jscene)

    def jax_image(ds):
        return jax_trace_rays(jdiff.combine(ds, rest), jassets, jo, jd, jids,
                              jcfg)

    jimg = np.asarray(jax.jit(jax_image)(d_scene))
    with torch.no_grad():
        img = trace_rays(scene, assets, o, d, ids, cfg).numpy()
    agree = np.abs(img - jimg).max(-1) < AGREE_ABS
    assert agree.mean() > 0.95, f"forwards agree on {agree.mean():.4f}"
    w = (np.random.default_rng(0).uniform(size=img.shape)
         * agree[:, None]).astype(np.float32)
    g_jax = jax.jit(jax.grad(lambda ds: jnp.sum(jax_image(ds) * w)))(d_scene)
    _, ours = tracer_grads(scene, assets, o, d, ids, cfg,
                           torch.from_numpy(w))
    assert_leaves_match(ours, {k: jax_leaf(g_jax, k) for k in ours}, name)
    if name == "triangles":
        assert float(ours["tri_v0"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# finite differences (test_render.py:226-402)
# ---------------------------------------------------------------------------

FD_CFG = tt.RenderConfig(width=32, height=24, max_depth=2, chunk_size=0,
                         loop="scan", scan_iters=8,
                         shadow_samples=0)   # smooth direct light
LUMA = torch.tensor([[0.3, 0.5, 0.2]])


def tiny_spec(with_glass=True):
    spheres = [tt.SphereSpec((0.0, 1.0, 3.0), 1.0,
                             tt.PLASTIC.replace(rgb=(1.0, 0.2, 0.2)))]
    if with_glass:
        spheres.append(tt.SphereSpec((1.5, 0.7, 2.0), 0.7, tt.GLASS))
    return tt.SceneSpec(
        spheres=spheres,
        planes=[tt.PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                             tt.PLASTIC.replace(rgb=(0.4, 0.4, 0.4)))],
        lights=[tt.LightSpec((2.0, 4.0, 0.0), 0.1, 30.0, (1.0, 1.0, 1.0))])


class FD:
    """A weighted luma loss of the tracer and its gradient by leaf, and the
    same loss with one leaf element moved."""

    def __init__(self, spec, assets, cfg, camera=GOLDEN_CAMERA):
        self.scene = tt.build_scene(spec, "cpu")
        self.assets, self.cfg = assets, cfg
        _, self.o, self.d, self.ids = rays(camera, cfg.width, cfg.height)

    def loss(self, scene, w):
        rgb = trace_rays(scene, self.assets, self.o, self.d, self.ids,
                         self.cfg)
        return (w * rgb * LUMA).sum()

    def check(self, w, field, idx, eps, rel=2e-2, floor=1e-3):
        leaves, rest = leaves_of(self.scene)
        grad = torch.autograd.grad(self.loss(tt.combine(leaves, rest), w),
                                   leaves[field])[0]
        g = float(grad[idx])
        with torch.no_grad():
            loss = []
            for sign in (1.0, -1.0):
                moved = {k: v.detach().clone() for k, v in leaves.items()}
                moved[field][idx] += sign * eps
                loss.append(float(self.loss(tt.combine(moved, rest), w)))
        fd = (loss[0] - loss[1]) / (2 * eps)
        assert np.isfinite(g)
        return g, fd

    def sphere_disc(self):
        v = self.o - self.scene.sphere_origin[0]
        b = 2.0 * (v * self.d).sum(-1)
        return b * b - 4.0 * (self.d * self.d).sum(-1) * (
            (v * v).sum(-1) - float(self.scene.sphere_radius[0]) ** 2)


@functools.lru_cache(maxsize=None)
def fd_setup(kind):
    return FD(tiny_spec(kind == "appearance"),
              tt.solid_assets(device="cpu"), FD_CFG)


def assert_fd(g, fd, rel=2e-2, floor=1e-3):
    tol = max(rel * max(abs(fd), abs(g)), floor)
    assert abs(g - fd) <= tol, f"analytic {g} vs fd {fd}"


# eps sized so the loss delta clears float32 cancellation noise
@pytest.mark.parametrize("field,idx,eps", [
    ("light_intensity", (0,), 1e-1),
    ("light_origin", (0, 1), 1e-2),
    ("sphere_mat.rgb", (0, 0), 1e-1),
    ("sphere_mat.reflectivity", (0,), 2e-2),
    ("sphere_mat.ambient", (0,), 5e-2),
])
def test_appearance_grad_matches_fd(field, idx, eps):
    """Light and material parameters: smooth everywhere, whole image."""
    fd = fd_setup("appearance")
    w = torch.ones(FD_CFG.width * FD_CFG.height, 1)
    assert_fd(*fd.check(w, field, idx, eps))


@pytest.mark.parametrize("field,idx,eps", [
    ("sphere_origin", (0, 2), 1e-3),
    ("sphere_origin", (0, 0), 1e-3),
    ("sphere_radius", (0,), 1e-3),
])
def test_geometry_grad_matches_fd_interior(field, idx, eps):
    """Geometry: pixels whose sphere-hit discriminant is comfortably
    positive (no silhouette)."""
    fd = fd_setup("geometry")
    w = (fd.sphere_disc() > 0.3).float()[:, None]
    assert w.sum() >= 3
    assert_fd(*fd.check(w, field, idx, eps))


def test_plane_point_grad_matches_fd():
    """The plane's offset, over plane pixels that miss the sphere."""
    fd = fd_setup("geometry")
    w = ((fd.sphere_disc() < -0.3) & (fd.d[:, 1] < -0.05)).float()[:, None]
    assert w.sum() >= 10
    assert_fd(*fd.check(w, "plane_point", (0, 1), 1e-3))


def test_bilinear_texture_spatial_gradient_matches_fd():
    """test_render.py:377-390: with bilinear weights, moving the textured
    ground plane moves every hit point across the texels, and that spatial
    texture term is part of the analytic gradient."""
    tex = np.zeros((1, 8, 8, 3), np.uint8)
    tex[0, :, :, 0] = np.arange(8)[None, :] * 20
    tex[0, :, :, 1] = np.arange(8)[:, None] * 20
    tex[0, :, :, 2] = 90
    assets = tt.SceneAssets(torch.from_numpy(tex),
                            torch.zeros(12, 16, 3, dtype=torch.uint8))
    spec = tt.SceneSpec(
        planes=[tt.PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                             tt.PLASTIC.replace(texture_id=0,
                                                texture_scale=1.0))],
        lights=[tt.LightSpec((2.0, 3.0, 2.0), 0.1, 25.0, (1.0, 1.0, 1.0))])
    cfg = tt.RenderConfig(width=16, height=12, max_depth=1, chunk_size=0,
                          loop="scan", scan_iters=4, shadow_samples=0,
                          filter="bilinear")
    # a steep look down over hit points near (2.5, 0, 2.5): texel
    # coordinates stay inside (1, 4), away from the ramp's wrap seams
    fd = FD(spec, assets, cfg, ((2.5, 1.5, 2.5), (0.02, -0.99, 0.02), 40.0,
                                1.0))
    g, fdv = fd.check(torch.ones(16 * 12, 1), "plane_point", (0, 1), 3e-4)
    assert abs(fdv) > 1e-3, (g, fdv)
    assert abs(g - fdv) <= max(5e-2 * abs(fdv), 2e-2), (g, fdv)


def test_bilinear_sky_reduces_to_nearest_on_a_flat_texture():
    sky = torch.full((12, 16, 3), 77, dtype=torch.uint8)
    d = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(sample_skybox(sky, d, "bilinear").numpy(),
                               sample_skybox(sky, d, "nearest").numpy(),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the tracer as the replay's oracle (test_pallas_vjp.py:249-358)
# ---------------------------------------------------------------------------

# (scene, width, height, depth)
REPLAY_CASES = [("canonical", 48, 32, 2), ("triangles", 48, 32, 2),
                ("canonical", 40, 30, 6)]


@pytest.mark.parametrize("case", REPLAY_CASES,
                         ids=lambda c: f"{c[0]}-d{c[3]}")
def test_replay_grads_match_tracer_grads(case):
    """The replay of the record kernel's records (its plain version here)
    against autograd through the tracer.  At depth 6 the record slots are
    raised to the deepest pixel's node count, so no subtree is dropped
    (ROADMAP A9: the test the JAX package lacks)."""
    name, width, height, depth = case
    _, scene, camera = scene_pair(name)
    assets = _assets_pair()[1]
    basis, o, d, ids = rays(camera, width, height)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          loop="while", chunk_size=0)
    packed = pack_scene(scene, basis)
    _, records = render_megakernel_record(packed, assets, cfg)
    need = int(records["max_nodes"])
    if need > cfg.resolved_record_slots():
        assert need <= 64
        cfg = cfg.replace(record_slots=need)
        _, records = render_megakernel_record(packed, assets, cfg)
    assert cfg.resolved_record_slots() >= int(records["max_nodes"])
    if depth > 3:
        assert int(records["max_nodes"]) > 15   # deeper than depth 3 reaches

    leaves, rest = leaves_of(scene)
    rep = tt.replay_render(tt.combine(leaves, rest), assets, basis, records,
                           cfg).reshape(-1, 3)
    img_x, _ = tracer_grads(scene, assets, o, d, ids, cfg,
                            torch.zeros(width * height, 3))
    agree = (rep.detach() - img_x).abs().amax(-1) < AGREE_ABS
    assert float(agree.float().mean()) > 0.25
    w = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(width * height, 3)).astype(np.float32)) * agree[:, None]
    g_rep = torch.autograd.grad((rep * w).sum(), list(leaves.values()),
                                allow_unused=True)
    g_rep = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), g_rep)}
    _, g_trace = tracer_grads(scene, assets, o, d, ids, cfg, w)
    assert_leaves_match(g_rep, {k: v.numpy() for k, v in g_trace.items()},
                        f"{name} d{depth}")
    nonzero = (("tri_v0", "tri_mat.diffuse", "light_origin")
               if name == "triangles" else
               ("sphere_mat.ambient", "light_origin", "light_intensity",
                "sphere_origin"))
    for leaf in nonzero:
        assert float(g_rep[leaf].abs().sum()) > 0, leaf
