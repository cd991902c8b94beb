"""``tpuray_torch.scripts.profile_replay``'s four rows against the JAX
functions the JAX script times, at 32x24 depth 3 without shadow samples:
``render_pallas_record`` (Pallas interpret mode), ``replay_render`` on its
records, and the L2 loss and its gradient through the replay and through
``render_pallas_diff`` (the JAX script's ``jax.value_and_grad``, as one
``jax.vjp``: the loss against a black target is sum(img^2)).

Bars of ``tests/test_pallas_vjp.py``: images mean |d| < 1e-3 and max |d| <
5e-2 (:82-83); gradients within ``2e-2 * max|g_jax|`` a leaf (:297-303);
the image sums and the loss, sums over those images, within 1e-3
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpuray
from tpuray import config as jconfig
from tpuray import diff as jdiff
from tpuray.kernels.pallas_trace import render_pallas_record
from tpuray.kernels.replay import replay_render as jax_replay_render

import tpuray_torch as tt
from tpuray_torch.config import RenderConfig
from tpuray_torch.scripts import profile_replay
from test_torch_megakernel import (_assets_pair, _camera_pair,
                                   jax_scene_arrays)
from test_torch_replay import jax_leaf

REPLAY_MEAN = 1e-3     # tests/test_pallas_vjp.py:82-83
REPLAY_MAX = 5e-2
GRAD_ATOL = 2e-2       # tests/test_pallas_vjp.py:297-303, times max|g|
SUM_RTOL = 1e-3
REPLAY_SHAPE = (32, 24, 3)


@pytest.fixture(scope="module")
def replay_values():
    """The four rows' values in the port and in the JAX package."""
    width, height, depth = REPLAY_SHAPE
    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    scene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    jassets, assets = _assets_pair()
    jcam, cam = _camera_pair()
    jbasis = tpuray.perspective_basis(jcam, width, height)
    basis = tt.perspective_basis(cam, width, height, device="cpu")
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=depth,
                                shadow_samples=0)
    cfg = RenderConfig(width=width, height=height, max_depth=depth,
                       shadow_samples=0)
    ours = {label: fn() for label, fn in profile_replay.row_functions(
        scene, assets, basis, cfg).items()}

    img, records = render_pallas_record(jscene, jassets, jbasis, jcfg,
                                        interpret=True)
    d_scene, rest = jdiff.partition(jscene)

    def replay(d):
        return jax_replay_render(jdiff.combine(d, rest), jassets, jbasis,
                                 records, jcfg)

    def full(d):
        return jdiff.render_pallas_diff(jdiff.combine(d, rest), jassets,
                                        jbasis, jcfg, 0.0, True)

    def loss_and_grads(render):
        # the loss against a black target is sum(img^2): its cotangent is
        # 2 img (jax.value_and_grad of the JAX script, one forward less)
        out, vjp = jax.vjp(render, d_scene)
        return out, (jdiff.l2_image_loss(out, jnp.zeros_like(out)),
                     vjp(2.0 * out)[0])

    replay_img, replay_grad = loss_and_grads(replay)
    theirs = {
        profile_replay.RECORD: img,
        profile_replay.REPLAY: replay_img,
        profile_replay.REPLAY_GRAD: replay_grad,
        profile_replay.FULL: loss_and_grads(full)[1],
    }
    return ours, theirs


@pytest.mark.parametrize("label", [profile_replay.RECORD,
                                   profile_replay.REPLAY,
                                   profile_replay.REPLAY_GRAD,
                                   profile_replay.FULL])
def test_profile_replay_rows_match_jax(label, replay_values):
    ours, theirs = (v[label] for v in replay_values)
    if label in (profile_replay.RECORD, profile_replay.REPLAY):
        port, ref = ours.numpy(), np.asarray(theirs)
        d = np.abs(port - ref)
        assert d.mean() < REPLAY_MEAN and d.max() < REPLAY_MAX, \
            f"mean|d| {d.mean():.3g}, max|d| {d.max():.3g}"
        np.testing.assert_allclose(port.sum(), ref.sum(), rtol=SUM_RTOL)
        return
    (loss, grads), (jloss, jgrads) = ours, theirs
    np.testing.assert_allclose(float(loss), float(jloss), rtol=SUM_RTOL)
    for name, g in grads.items():
        want = jax_leaf(jgrads, name)
        assert g.shape == want.shape, name
        assert np.isfinite(g.numpy()).all(), name
        if g.numel() == 0:
            continue          # triangle leaves: the scene has none
        scale = max(np.abs(want).max(), 1e-3)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=name)
