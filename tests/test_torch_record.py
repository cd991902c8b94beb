"""The port's record mode held against the JAX package's
``render_pallas_record`` (Pallas interpret mode) on the canonical scene:
the image, the decoded records, the shadow ratios, the texel picks and
``max_nodes``; and a starved record buffer (``record_slots=4``).

The port runs ``render_megakernel_record`` on CPU tensors, i.e. its plain
version ``render_megakernel_record_reference``; the CUDA kernel is held
against that plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: the image bar of ``test_torch_megakernel.py`` (at least 99.9%
of the pixels that are not chaotic within 1e-3, mean < 1e-4); records,
picks and ``max_nodes`` exactly equal on at least 99.9% of the pixels that
are not chaotic (a chaotic pixel may take another path); ``ssr`` within
1e-5 on the solid nodes of those pixels (both sides divide the same count
of unblocked samples by the same sample count).
"""
import functools

import jax
import numpy as np
import pytest

import tpuray
from tpuray import config as jconfig
from tpuray.kernels import pallas_trace as jpt
from tpuray.kernels.replay import replay_render as jax_replay_render

import tpuray_torch as tt
from tpuray_torch.kernels.megakernel import (LIGHT_CODE, pack_scene,
                                             render_megakernel_record)
from tpuray_torch.kernels.replay import replay_render
from test_torch_cuda import check_record_refusals
from test_torch_megakernel import (AGREE_FRAC, _assets_pair, _camera_pair,
                                   assert_agrees, chaotic_pixels,
                                   jax_scene_arrays)

# (width, height, max_depth, shadow_samples, JAX event_slots): the JAX
# oracle's texel events are capped (ROADMAP C2); at depth 5 they are raised
# to 2^6 - 1, the most nodes a depth-5 pixel can have, so none drop
CASES = [(48, 32, 2, 0, 0), (32, 24, 3, 2, 0), (32, 16, 5, 2, 63)]
STARVED_SLOTS = 4


def case_id(c):
    return f"{c[0]}x{c[1]}-d{c[2]}-ss{c[3]}"


def decode(rec):
    """(code, parent slot, refracted, valid) of packed records."""
    pbyte = (rec >> 8) & 0xFF
    return rec & 0xFF, pbyte & 0x3F, (pbyte >> 6) & 1, pbyte >> 7


def picks_in_event_order(pick):
    """Per pixel, the port's texel picks with the empty slots moved last:
    the order in which the JAX kernel emits its texel events."""
    order = np.argsort(pick < 0, axis=0, kind="stable")
    return np.take_along_axis(pick, order, 0)


class Pair:
    """One case rendered by both packages, from the same numbers."""

    def __init__(self, case, record_slots=0):
        width, height, depth, samples, event_slots = case
        self.jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
        self.scene = tt.scene_from_arrays(jax_scene_arrays(self.jscene),
                                          "cpu")
        self.jassets, self.assets = _assets_pair()
        jcam, cam = _camera_pair()
        self.jbasis = tpuray.perspective_basis(jcam, width, height)
        self.basis = tt.perspective_basis(cam, width, height, device="cpu")
        self.jcfg = jconfig.RenderConfig(
            width=width, height=height, max_depth=depth,
            shadow_samples=samples, event_slots=event_slots,
            record_slots=record_slots)
        self.cfg = tt.RenderConfig(width=width, height=height,
                                   max_depth=depth, shadow_samples=samples,
                                   record_slots=record_slots)
        jimg, jrec = jpt.render_pallas_record(
            self.jscene, self.jassets, self.jbasis, self.jcfg,
            interpret=True)
        self.jimg = np.asarray(jimg)
        self.jrec = jax.device_get(jrec)
        img, self.records = self.render(self.basis)
        self.img = img.numpy()
        self.rec = {k: v.numpy() for k, v in self.records.items()}
        bad = np.abs(self.img - self.jimg).max(-1) >= 1e-3
        self.chaotic = (chaotic_pixels(lambda b: self.render(b)[0].numpy(),
                                       self.basis, self.img)
                        if bad.any() else np.zeros(bad.shape, bool))
        self.stable = ~self.chaotic.reshape(-1)

    def render(self, basis):
        return render_megakernel_record(pack_scene(self.scene, basis),
                                        self.assets, self.cfg)


@functools.lru_cache(maxsize=None)
def pair(case, record_slots=0):
    return Pair(case, record_slots)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_record_image_matches_jax(case):
    p = pair(case)
    assert_agrees(p.img, p.jimg, p.chaotic, case_id(case))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_records_match_jax(case):
    p = pair(case)
    ours, theirs = p.rec["rec"], p.jrec["rec"]
    assert ours.shape == theirs.shape
    assert ours.dtype == np.int32
    for name, a, b in zip(("code", "parent slot", "branch", "valid"),
                          decode(ours), decode(theirs)):
        same = (a == b).all(0)[p.stable]
        assert same.mean() >= AGREE_FRAC, \
            f"{name}: {int((~same).sum())} stable pixels differ"
    # the root has no parent, every other node has one; unused slots are -1
    code, _, _, valid = decode(ours)
    assert (valid[0][ours[0] >= 0] == 0).all()
    assert (valid[1:][ours[1:] >= 0] == 1).all()
    assert (ours[0] >= 0).all()


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_shadow_ratios_match_jax(case):
    p = pair(case)
    nl = p.scene.num_lights
    ssr, jssr = p.rec["ssr"], p.jrec["ssr"]
    assert ssr.shape == jssr.shape == (p.cfg.resolved_record_slots(), nl,
                                       p.cfg.width * p.cfg.height)
    code = p.rec["rec"] & 0xFF
    same = (p.rec["rec"] == p.jrec["rec"]).all(0) & p.stable
    solid = (p.rec["rec"] >= 0) & (code < LIGHT_CODE) & same[None, :]
    assert solid.any()
    for light in range(nl):
        np.testing.assert_allclose(ssr[:, light][solid],
                                   jssr[:, light][solid], rtol=0, atol=1e-5)
    # off solid nodes the port records 0 (JAX leaves tile-dependent values
    # there, which its replay never reads)
    off = (p.rec["rec"] < 0) | (code >= LIGHT_CODE)
    assert (ssr.transpose(1, 0, 2)[:, off] == 0).all()
    if case[3] == 0:   # no shadow samples: every solid node sees 1.0
        assert (ssr.transpose(1, 0, 2)[:, solid] == 1.0).all()


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_texel_picks_match_jax_events(case):
    """The texel at each of the port's picks, in DFS order, against the
    JAX atlas texel at each of the JAX kernel's events."""
    p = pair(case)
    picks = picks_in_event_order(p.rec["pick"])
    events = p.jrec["ev_idx"]
    n = max(int((picks >= 0).sum(0).max()), int((events >= 0).sum(0).max()))
    assert n <= events.shape[0]
    picks, events = picks[:n], events[:n]
    same = ((picks >= 0) == (events >= 0)).all(0)[p.stable]
    assert same.mean() >= AGREE_FRAC
    texels = np.concatenate([p.assets.textures.numpy().reshape(-1, 3),
                             p.assets.skybox.numpy().reshape(-1, 3)])
    atlas = np.asarray(jpt.build_atlas(p.jassets).rows).reshape(-1)
    both = (picks >= 0) & (events >= 0) & p.stable[None, :]
    ours = texels[picks[both]].astype(np.uint32)
    theirs = atlas[events[both]]
    theirs = np.stack([(theirs >> 16) & 0xFF, (theirs >> 8) & 0xFF,
                       theirs & 0xFF], -1)
    assert len(ours) > 0
    match = (ours == theirs).all(-1)
    assert match.mean() >= AGREE_FRAC, f"{int((~match).sum())} texels differ"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_max_nodes_matches_jax(case):
    p = pair(case)
    assert int(p.rec["max_nodes"]) == int(p.jrec["max_nodes"])
    assert p.rec["max_nodes"].dtype == np.int32
    assert int(p.rec["max_nodes"]) == int((p.rec["rec"] >= 0).sum(0).max())


def test_starved_records_report_true_count_and_replay_like_jax():
    """``record_slots=4`` at depth 3: both kernels still report the full
    node count, and the port's replay of its starved records matches the
    JAX replay of the JAX kernel's starved records (both drop the same
    subtrees)."""
    full = pair(CASES[1])
    need = int(full.rec["max_nodes"])
    assert need > STARVED_SLOTS
    p = pair(CASES[1], STARVED_SLOTS)
    assert p.rec["rec"].shape[0] == STARVED_SLOTS
    assert int(p.rec["max_nodes"]) == int(p.jrec["max_nodes"]) == need
    ours = replay_render(p.scene, p.assets, p.basis, p.records,
                         p.cfg).numpy()
    theirs = np.asarray(jax_replay_render(p.jscene, p.jassets, p.jbasis,
                                          p.jrec, p.jcfg))
    assert_agrees(ours, theirs, p.chaotic, "starved replay")
    # the starved image lost light: the replay is not the full image
    assert np.abs(ours - p.img).max() > 1e-2


def test_record_wrapper_refuses_what_records_cannot_hold():
    check_record_refusals("cpu")
