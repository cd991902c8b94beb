"""Bilinear filtering (K2, ``cfg.filter='bilinear'``): the port's bilinear
primitives against the JAX package's, the plain version of the bilinear
megakernel against the JAX megakernel (Pallas interpret mode) and the JAX
tracer, its bilinear records (4 texel picks per fetch) against the JAX
record kernel's events, and the bilinear replay: its image and its
gradients against ``jax.vjp`` of the JAX replay on the same records, and
the few pixels where both replays miss their record image.

Tolerances: the megakernel's bar (``tests/test_torch_megakernel.py``: at
least 99.9% of the pixels that are not chaotic within 1e-3, mean < 1e-4),
with JAX ``dropped == 0`` (its event slots raised to 60, room for 15
fetches of 4 taps; ROADMAP C hazard 2); against the JAX tracer the bar of
``tests/test_render.py:83`` (99.5% within 1e-2: the tracer's operation
order differs); picks equal on 99.9% of the pixels that are not chaotic;
the replay's bar and gradient bound of ``tests/test_pallas_vjp.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
from tpuray import config as jconfig
from tpuray import diff as jdiff
from tpuray.kernels import pallas_trace as jpt
from tpuray.kernels import primitives as jpr
from tpuray.kernels.replay import replay_render as jax_replay_render
from tpuray.render import render_from_basis_xla

import tpuray_torch as tt
from tpuray_torch.kernels import primitives as pr
from tpuray_torch.kernels.megakernel import (pack_scene,
                                             render_megakernel_record,
                                             render_megakernel_reference)
from test_torch_megakernel import (AGREE_FRAC, ASSET_SEED, JaxAssets,
                                   _assets_pair, _camera_pair, _directions,
                                   _jax_checked, _t, assert_agrees,
                                   chaotic_pixels, jax_scene_arrays)
from test_torch_record import picks_in_event_order
from test_torch_replay import BASIS_FIELDS, jax_leaf

EVENT_SLOTS = 60
REPLAY_MEAN = 1e-3
REPLAY_MAX = 5e-2
GRAD_ATOL = 2e-2


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("face", [4, 32, 1024])
def test_cube_coordinates_match_jax(face):
    d = _directions(21)
    uf_j, vf_j = jpr.map_to_cube_float(jnp.asarray(d), face)
    uf, vf = pr.map_to_cube_float(_t(d), face)
    np.testing.assert_array_equal(uf.numpy(), np.asarray(uf_j))
    np.testing.assert_array_equal(vf.numpy(), np.asarray(vf_j))
    sky_h, sky_w = 3 * face, 4 * face
    xf, yf = pr.sky_coords(_t(d), sky_h, sky_w)
    np.testing.assert_array_equal(
        yf.numpy(), np.asarray(jnp.clip(np.float32(sky_h) - vf_j, 0.0,
                                        np.float32(sky_h - 1))))
    np.testing.assert_array_equal(
        xf.numpy(), np.asarray(jnp.clip(uf_j, 0.0, np.float32(sky_w - 1))))


@pytest.mark.parametrize("wrap", [True, False])
def test_bilinear_taps_match_jax(wrap):
    rng = np.random.default_rng(8)
    u = rng.uniform(-70, 70, 4096).astype(np.float32)
    v = rng.uniform(-70, 70, 4096).astype(np.float32)
    u[:6] = [0.0, -0.0, -1e-30, 63.999996, -64.0, 1e9]
    w, h = 64, 48
    ours = pr.bilinear_taps(_t(u), _t(v), w, h, wrap)
    theirs = jpr.bilinear_taps(jnp.asarray(u), jnp.asarray(v), w, h, wrap)
    for (x, y, wt), (xj, yj, wtj) in zip(ours, theirs):
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wtj))
        assert x.min() >= 0 and x.max() < w and y.min() >= 0 and y.max() < h
    total = sum(wt for _, _, wt in ours)
    np.testing.assert_allclose(total.numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# the plain version of K2 against the JAX megakernel and tracer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def canonical_pair():
    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    return jscene, tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")


# (width, height, max_depth, shadow_samples, frame_height, row0), as in
# test_torch_megakernel.py
CASES = [(128, 16, 3, 2, 96, 56), (100, 20, 2, 0, 75, 44)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-d{c[2]}"
                                                      f"-ss{c[3]}")
def test_bilinear_megakernel_matches_jax_megakernel(case):
    width, height, depth, samples, frame_h, row0 = case
    jscene, scene = canonical_pair()
    jassets, assets = _assets_pair()
    jcam, cam = _camera_pair()
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=depth,
                                shadow_samples=samples, filter="bilinear",
                                event_slots=EVENT_SLOTS)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          shadow_samples=samples, filter="bilinear")
    ref, dropped, _ = _jax_checked()(
        jscene, jassets, tpuray.perspective_basis(jcam, width, frame_h),
        jcfg, row0=float(row0))
    assert int(dropped) == 0, "the JAX oracle dropped texel events"
    ref = np.asarray(ref)

    def render(basis, cfg=cfg):
        return render_megakernel_reference(pack_scene(scene, basis, row0),
                                           assets, cfg).numpy()

    basis = tt.perspective_basis(cam, width, frame_h, device="cpu")
    port = render(basis)
    bad = np.abs(port - ref).max(-1) >= 1e-3
    chaotic = (chaotic_pixels(render, basis, port) if bad.any()
               else np.zeros(bad.shape, bool))
    assert_agrees(port, ref, chaotic, "bilinear")
    # bilinear is not nearest: the sky bands and texel edges differ
    nearest = render(basis, cfg.replace(filter="nearest"))
    assert np.abs(port - nearest).max() > 1e-3


def test_bilinear_megakernel_matches_jax_tracer():
    """test_render.py:65-89 on the canonical scene with seeded assets: the
    bilinear megakernel against the JAX tracer's bilinear render."""
    width, height = 128, 32
    jscene, scene = canonical_pair()
    jassets, assets = _assets_pair()
    jcam, cam = _camera_pair()
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=3,
                                chunk_size=0, filter="bilinear")
    b = np.asarray(render_from_basis_xla(
        jscene, jassets, tpuray.perspective_basis(jcam, width, height), jcfg))
    cfg = tt.RenderConfig(width=width, height=height, max_depth=3,
                          filter="bilinear")
    a = render_megakernel_reference(pack_scene(scene, tt.perspective_basis(
        cam, width, height, device="cpu")), assets, cfg).numpy()
    d = np.abs(a - b).max(-1)
    assert not np.isnan(a).any()
    assert (d < 1e-2).mean() > 0.995, f"mismatch {(d >= 1e-2).mean()}"


# ---------------------------------------------------------------------------
# bilinear records and the bilinear replay
# ---------------------------------------------------------------------------

def picks_as_events(pick):
    """[Krec, 4, n_pix] picks as the JAX kernel's events: per pixel the 4
    taps of each fetching node, in DFS order, the empty slots last."""
    return picks_in_event_order(pick.reshape(-1, pick.shape[-1]))


class Pair:
    """A bilinear record render by both packages, from the same numbers."""

    def __init__(self, width, height, depth, samples):
        self.jscene, self.scene = canonical_pair()
        self.jassets, self.assets = _assets_pair()
        jcam, cam = _camera_pair()
        self.jbasis = tpuray.perspective_basis(jcam, width, height)
        self.basis = tt.perspective_basis(cam, width, height, device="cpu")
        self.jcfg = jconfig.RenderConfig(
            width=width, height=height, max_depth=depth,
            shadow_samples=samples, filter="bilinear",
            event_slots=EVENT_SLOTS)
        self.cfg = tt.RenderConfig(width=width, height=height,
                                   max_depth=depth, shadow_samples=samples,
                                   filter="bilinear")
        jimg, jrec = jpt.render_pallas_record(
            self.jscene, self.jassets, self.jbasis, self.jcfg,
            interpret=True)
        self.jimg, self.jrec = np.asarray(jimg), jax.device_get(jrec)
        img, self.records = self.render(self.basis)
        self.img = img.numpy()
        bad = np.abs(self.img - self.jimg).max(-1) >= 1e-3
        self.chaotic = (chaotic_pixels(lambda b: self.render(b)[0].numpy(),
                                       self.basis, self.img)
                        if bad.any() else np.zeros(bad.shape, bool))

    def render(self, basis):
        return render_megakernel_record(pack_scene(self.scene, basis),
                                        self.assets, self.cfg)


@functools.lru_cache(maxsize=None)
def pair(case):
    return Pair(*case)


RECORD_CASES = [(48, 32, 2, 0), (32, 24, 3, 2)]


@pytest.mark.parametrize("case", RECORD_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-d{c[2]}-ss{c[3]}")
def test_bilinear_records_match_jax_events(case):
    p = pair(case)
    assert_agrees(p.img, p.jimg, p.chaotic, "bilinear record image")
    pick = p.records["pick"].numpy()
    krec = p.cfg.resolved_record_slots()
    assert pick.shape == (krec, 4, case[0] * case[1])
    # a node fetches 4 taps or none
    assert ((pick >= 0).all(1) | (pick < 0).all(1)).all()
    events = p.jrec["ev_idx"]
    picks = picks_as_events(pick)
    n = max(int((picks >= 0).sum(0).max()), int((events >= 0).sum(0).max()))
    assert 4 <= n <= events.shape[0]
    stable = ~p.chaotic.reshape(-1)
    same = (picks[:n] == events[:n]).all(0)[stable]
    assert same.mean() >= AGREE_FRAC, f"{int((~same).sum())} pixels differ"
    np.testing.assert_array_equal(p.records["rec"].numpy()[:, stable],
                                  p.jrec["rec"][:, stable])


class CardInputs:
    """A bilinear record render of the canonical scene on the CPU, with the
    inputs of ``chip_smoke.py``'s phase 15 (seeded 512-texel assets) and
    the rows ``row0 .. row0 + height`` of a ``width`` x ``frame_height``
    frame."""

    def __init__(self, width, frame_height, depth, samples, row0, height):
        self.jscene, self.scene = canonical_pair()
        tex, sky = tt.random_asset_arrays(ASSET_SEED, 512, 512)
        self.jassets = JaxAssets(jnp.asarray(tex), jnp.asarray(sky))
        self.assets = tt.assets_from_arrays(tex, sky, "cpu")
        jcam, cam = _camera_pair()
        self.jbasis = tpuray.perspective_basis(jcam, width, frame_height)
        self.basis = tt.perspective_basis(cam, width, frame_height,
                                          device="cpu")
        self.row0 = row0
        self.cfg = tt.RenderConfig(width=width, height=height,
                                   max_depth=depth, shadow_samples=samples,
                                   filter="bilinear")
        self.jcfg = jconfig.RenderConfig(
            width=width, height=height, max_depth=depth,
            shadow_samples=samples, filter="bilinear",
            event_slots=EVENT_SLOTS)
        img, self.records = render_megakernel_record(
            pack_scene(self.scene, self.basis, row0), self.assets, self.cfg)
        self.img = img.numpy()

    def replay_misses(self, rep):
        """Per pixel, whether the replayed image misses the record image
        by REPLAY_MAX or more; and the mean |d|."""
        d = np.abs(np.asarray(rep) - self.img)
        return d.max(-1) >= REPLAY_MAX, float(d.mean())


@pytest.mark.parametrize("case", ["48x32-d2-ss0", "256x64-d3-ss2"])
def test_bilinear_replay_reproduces_the_record_render(case):
    """test_pallas_vjp.py:137-149 on the port's records: a JAX pair's
    small case, and the first case of ``chip_smoke.py``'s phase 15 (its
    512-texel assets), where no pixel may miss either."""
    p = (pair(RECORD_CASES[0]) if case == "48x32-d2-ss0"
         else CardInputs(256, 64, 3, 2, 0, 64))
    rep = tt.replay_render(p.scene, p.assets, p.basis, p.records, p.cfg)
    d = (rep - torch.from_numpy(p.img)).abs()
    assert float(d.mean()) < REPLAY_MEAN and float(d.max()) < REPLAY_MAX


def test_bilinear_replay_misses_where_the_jax_replay_does():
    """Rows 376-385 of 800x600 d6 ss2: after a chain of curved reflections
    a few recomputed paths land far enough from the kernel's that the
    recomputed tap weights differ; the JAX replay on the same records
    misses there too, so this is the replay's design (fractions recomputed
    from the geometry), not the port.  The count of such pixels is pinned
    at 3 of 8,000 or fewer for each replay (3 for each when this was
    written; they share 2), and the JAX replay is at least 2e-2 off on
    each of the port's."""
    p = CardInputs(800, 600, 6, 2, 376, 10)
    rep = tt.replay_render(p.scene, p.assets, p.basis, p.records, p.cfg,
                           row0=p.row0)
    miss, mean = p.replay_misses(rep)
    assert 1 <= int(miss.sum()) <= 3 and mean < REPLAY_MEAN
    used = int(p.records["max_nodes"])
    jrecords = {"rec": jnp.asarray(p.records["rec"][:used].numpy()),
                "ssr": jnp.asarray(p.records["ssr"][:used].numpy()),
                "ev_idx": jnp.asarray(picks_as_events(
                    p.records["pick"][:used].numpy()))}
    jrep = np.asarray(jax_replay_render(p.jscene, p.jassets, p.jbasis,
                                        jrecords, p.jcfg, row0=float(p.row0)))
    jmiss, jmean = p.replay_misses(jrep)
    assert 1 <= int(jmiss.sum()) <= 3 and jmean < REPLAY_MEAN
    jd = np.abs(jrep - p.img).max(-1)
    assert (jd[miss] >= 2e-2).all(), jd[miss]


def test_bilinear_replay_grads_match_jax_replay():
    """The port's bilinear replay and the JAX one on the same records (the
    port's picks given to JAX as its events): gradients leaf by leaf, the
    spatial texture gradient on ``plane_point`` non-zero
    (test_pallas_vjp.py:151-170)."""
    p = pair(RECORD_CASES[1])
    used = int(p.records["max_nodes"])
    records = {"rec": p.records["rec"][:used], "ssr": p.records["ssr"][:used],
               "pick": p.records["pick"][:used],
               "max_nodes": p.records["max_nodes"]}
    jrecords = {"rec": jnp.asarray(records["rec"].numpy()),
                "ssr": jnp.asarray(records["ssr"].numpy()),
                "ev_idx": jnp.asarray(picks_as_events(
                    records["pick"].numpy()))}
    d_scene, rest = jdiff.partition(p.jscene)
    jimg, vjp = jax.vjp(
        lambda d, b: jax_replay_render(jdiff.combine(d, rest), p.jassets, b,
                                       jrecords, p.jcfg), d_scene, p.jbasis)
    params, trest = tt.partition(p.scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    tbasis = tt.PerspectiveBasis(*(getattr(p.basis, f).clone()
                                   .requires_grad_() for f in BASIS_FIELDS))
    img = tt.replay_render(tt.combine(params, trest), p.assets, tbasis,
                           records, p.cfg)
    agree = np.abs(img.detach().numpy() - np.asarray(jimg)).max(-1) < 1e-4
    assert agree.mean() > 0.99, f"replays agree on {agree.mean():.4f}"
    w = (np.random.default_rng(2).uniform(size=img.shape)
         * agree[..., None]).astype(np.float32)
    g_scene, g_basis = vjp(jnp.asarray(w))
    ours = torch.autograd.grad(
        img, [*params.values(), *(getattr(tbasis, f) for f in BASIS_FIELDS)],
        torch.from_numpy(w), allow_unused=True)
    theirs = [jax_leaf(g_scene, k) for k in params] \
        + [jax_leaf(g_basis, f) for f in BASIS_FIELDS]
    names = [*params, *(f"basis.{f}" for f in BASIS_FIELDS)]
    for name, g, ref in zip(names, ours, theirs):
        g = np.zeros_like(ref) if g is None else g.numpy()
        assert np.isfinite(g).all(), name
        if g.size:
            scale = max(np.abs(ref).max(), 1e-3)
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=GRAD_ATOL * scale, err_msg=name)
        if name == "plane_point":
            assert np.abs(g).sum() > 0
