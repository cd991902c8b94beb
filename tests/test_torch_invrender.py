"""The port's training path on the CPU: ``diff`` (partition, combine and
the ``render_megakernel_diff`` autograd function), the invrender app's
optimizer step against the JAX app's optax chain, its error measures
against the JAX functions, checkpoint and resume, and the whole app.

Tolerances: the optimizer step within 1e-6 of optax's (the same formulas
in float32, summed in another order); the error measures within 1e-6
relative; everything that the port computes twice in the same way
(forward vs ``render_megakernel``, the autograd function vs the replay's
own gradient, a resumed run vs a straight one) exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpuray
from tpuray import diff as jdiff
from tpuray.apps import invrender as jinv
from tpuray.scene import Materials as JaxMaterials
from tpuray.scene import Scene as JaxScene

import tpuray_torch as tt
from tpuray_torch.apps import invrender
from tpuray_torch.kernels.megakernel import (pack_scene, render_megakernel,
                                             render_megakernel_record)
from tpuray_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_torch_megakernel import jax_scene_arrays
from test_torch_render import GOLDEN_CAMERA, _write_inputs

BASIS_FIELDS = ("corner", "origin", "up", "right", "w_factor", "h_factor")


def small(width=24, height=16, depth=2, samples=2):
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(1), "cpu")
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), width, height,
                                 device="cpu")
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          shadow_samples=samples)
    return scene, assets, basis, cfg


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------

def test_partition_and_combine_round_trip():
    scene = small()[0]
    diff, rest = tt.partition(scene)
    assert all(v.is_floating_point() for v in diff.values())
    assert sorted(rest) == sorted(
        f"{m}.{f}" for m in ("sphere_mat", "plane_mat", "tri_mat")
        for f in ("transparent", "dielectric", "texture_id"))
    back = tt.combine(diff, rest)
    for (name, a), b in zip(tt.scene_leaves(scene).items(),
                            tt.scene_leaves(back).values()):
        assert a is b, name


def test_diff_forward_is_the_megakernel_image_and_backward_the_replay():
    scene, assets, basis, cfg = small()
    diff, rest = tt.partition(scene)
    leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
    tbasis = tt.PerspectiveBasis(*(getattr(basis, f).clone().requires_grad_()
                                   for f in BASIS_FIELDS))
    img = tt.render_megakernel_diff(tt.combine(leaves, rest), assets, tbasis,
                                    cfg)
    want = render_megakernel(pack_scene(scene, basis), assets, cfg)
    torch.testing.assert_close(img.detach(), want, rtol=0, atol=0)

    w = torch.from_numpy(np.random.default_rng(2).uniform(
        size=img.shape).astype(np.float32))
    inputs = [*leaves.values(), *(getattr(tbasis, f) for f in BASIS_FIELDS)]
    got = torch.autograd.grad(img, inputs, w)

    _, records = render_megakernel_record(pack_scene(scene, basis), assets,
                                          cfg)
    leaves2 = {k: v.clone().requires_grad_() for k, v in diff.items()}
    basis2 = tt.PerspectiveBasis(*(getattr(basis, f).clone().requires_grad_()
                                   for f in BASIS_FIELDS))
    rep = tt.replay_render(tt.combine(leaves2, rest), assets, basis2,
                           records, cfg)
    inputs2 = [*leaves2.values(), *(getattr(basis2, f) for f in BASIS_FIELDS)]
    direct = torch.autograd.grad(rep, inputs2, w, allow_unused=True)
    for name, a, b, t in zip([*leaves, *BASIS_FIELDS], got, direct, inputs2):
        b = torch.zeros_like(t) if b is None else b
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert float(got[list(leaves).index("light_origin")].abs().sum()) > 0


def test_diff_computes_only_the_gradients_asked_for():
    scene, assets, basis, cfg = small()
    diff, rest = tt.partition(scene)
    leaves = dict(diff)
    leaves["light_intensity"] = diff["light_intensity"].clone() \
        .requires_grad_()
    img = tt.render_megakernel_diff(tt.combine(leaves, rest), assets, basis,
                                    cfg)
    (g,) = torch.autograd.grad(img.sum(), [leaves["light_intensity"]])
    assert g.shape == (3,) and float(g.abs().min()) > 0


def test_value_and_scene_grad_and_l2_loss():
    scene, assets, basis, cfg = small()
    target = torch.zeros(cfg.height, cfg.width, 3)

    def loss(s):
        return tt.l2_image_loss(
            tt.render_megakernel_diff(s, assets, basis, cfg), target)

    value, grads = tt.value_and_scene_grad(loss, scene)
    img = render_megakernel(pack_scene(scene, basis), assets, cfg)
    torch.testing.assert_close(value, (img ** 2).sum())
    assert set(grads) == set(tt.partition(scene)[0])
    assert float(grads["light_radius"].abs().sum()) == 0   # ssr is frozen
    assert float(grads["sphere_mat.ambient"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# the optimizer against the JAX app's optax chain (invrender.py:245-284)
# ---------------------------------------------------------------------------

def jax_step(params, grads, mask, clip_mask, light_mask, opt, state,
             lights_on, light_lr_scale):
    """One update of the JAX app's train_step, fed ``grads``."""
    g = jax.tree.map(lambda gi, m: gi if m else jnp.zeros_like(gi), grads,
                     mask if lights_on else clip_mask)
    updates, state = opt.update(g, state)
    updates = jax.tree.map(lambda u, isl: u * light_lr_scale if isl else u,
                           updates, light_mask)
    params = optax.apply_updates(params, updates)
    params = jax.tree.map(lambda p, m: jnp.clip(p, 0.0, None) if m else p,
                          params, clip_mask)
    return params, state


@pytest.mark.parametrize("grad_scale", [0.1, 100.0], ids=["small", "clipped"])
def test_optimizer_steps_match_optax(grad_scale):
    steps, lr, lr_alpha, light_lr_scale = 5, 3e-2, 0.05, 0.25
    params = tt.partition(small()[0])[0]
    mask = invrender.optimize_mask(params)
    rng = np.random.default_rng(7)
    grad_seq = []
    for _ in range(steps):
        g = {k: (rng.standard_normal(v.shape) * grad_scale).astype(np.float32)
             for k, v in params.items()}
        g["sphere_mat.diffuse"][0] = np.nan     # zero_nans
        grad_seq.append(g)
    # material leaves near 0 so that the projection acts
    params = {k: v.clone() for k, v in params.items()}
    params["plane_mat.ambient"] = torch.tensor([0.001, 0.002])

    trainer = invrender.Trainer(params, {}, mask, None, None, steps=steps,
                                lr=lr, lr_alpha=lr_alpha,
                                light_lr_scale=light_lr_scale)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    clip_mask = {k: m and k != "light_origin" for k, m in mask.items()}
    light_mask = {k: m and not clip_mask[k] for k, m in mask.items()}
    sched = optax.cosine_decay_schedule(init_value=lr, decay_steps=steps,
                                        alpha=lr_alpha)
    opt = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(5.0),
                      optax.adam(sched))
    state = opt.init(jparams)
    for i, g in enumerate(grad_seq):
        lights_on = i >= 2
        trainer.apply({k: torch.from_numpy(g[k]) for k in trainer.trained},
                      lights_on)
        jparams, state = jax_step(jparams, {k: jnp.asarray(v)
                                            for k, v in g.items()},
                                  mask, clip_mask, light_mask, opt, state,
                                  lights_on, light_lr_scale)
        for k in params:
            np.testing.assert_allclose(trainer.params[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    assert float(trainer.params["plane_mat.ambient"].detach().min()) >= 0
    moved = [k for k in params
             if not torch.equal(trainer.params[k].detach(), params[k])]
    assert sorted(moved) == sorted(k for k, m in mask.items() if m)


def jax_scene_from_leaves(leaves):
    def mats(prefix):
        return JaxMaterials(**{f: jnp.asarray(leaves[f"{prefix}.{f}"])
                               for f in JaxMaterials._fields})
    return JaxScene(**{f: (mats(f) if f.endswith("_mat")
                           else jnp.asarray(leaves[f]))
                       for f in JaxScene._fields})


def test_errors_match_the_jax_app():
    truth = tt.partition(small()[0])[0]
    mask = invrender.optimize_mask(truth)
    params = invrender.perturb(truth, mask, seed=3, mat_scale=0.5,
                               light_shift=0.3)
    jtruth_scene = tpuray.build_scene(tpuray.canonical_scene_spec())
    arrays = jax_scene_arrays(jtruth_scene)
    jtruth, static = jdiff.partition(jtruth_scene)
    jparams = jdiff.partition(jax_scene_from_leaves(
        {**arrays, **{k: v.numpy() for k, v in params.items()}}))[0]
    jmask = jinv.optimize_mask(jtruth)
    assert [k for k, m in mask.items() if m] == [
        k for k in mask if bool(jax_leaf_mask(jmask, k))]
    for group in (None, "light", "mat"):
        np.testing.assert_allclose(
            invrender.param_error(params, truth, mask, group),
            jinv.param_error(jparams, jtruth, jmask, group), rtol=1e-6)
    np.testing.assert_allclose(invrender.observable_error(params, truth),
                               jinv.observable_error(jparams, jtruth, static),
                               rtol=1e-6)
    assert invrender.param_error(params, truth, mask) > 0.03


def jax_leaf_mask(tree, name):
    for part in name.split("."):
        tree = getattr(tree, part)
    return tree


def test_perturb_is_seeded_and_moves_only_the_masked_leaves():
    truth = tt.partition(small()[0])[0]
    mask = invrender.optimize_mask(truth)
    a = invrender.perturb(truth, mask, seed=5)
    b = invrender.perturb(truth, mask, seed=5)
    c = invrender.perturb(truth, mask, seed=6)
    for k in truth:
        assert torch.equal(a[k], b[k])
        if not mask[k]:
            assert a[k] is truth[k]
        elif truth[k].numel():
            assert not torch.equal(a[k], truth[k]), k
    assert not torch.equal(a["light_origin"], c["light_origin"])
    assert all(float(a[k].min()) >= 0 for k in mask
               if mask[k] and k != "light_origin")


# ---------------------------------------------------------------------------
# checkpoint and the app
# ---------------------------------------------------------------------------

def make_trainer(steps):
    scene, assets, basis, cfg = small(depth=2, samples=0)
    truth, static = tt.partition(scene)
    mask = invrender.optimize_mask(truth)

    def render(s):
        return tt.render_megakernel_diff(s, assets, basis, cfg).clamp(0, 1)

    with torch.no_grad():
        target = render(scene)
    return invrender.Trainer(invrender.perturb(truth, mask, 0), static, mask,
                             render, target, steps=steps, lr=3e-2)


def test_checkpoint_resume_equals_a_straight_run(tmp_path):
    path = str(tmp_path / "ck.pt")
    straight = make_trainer(4)
    for step in range(4):
        straight.step(step >= 1)
    first = make_trainer(4)
    for step in range(2):
        first.step(step >= 1)
    first.save(path, 2)
    resumed = make_trainer(4)
    assert resumed.restore(path) == 2
    for step in range(2, 4):
        resumed.step(step >= 1)
    for k, v in straight.params.items():
        torch.testing.assert_close(resumed.params[k], v, rtol=0, atol=0,
                                   msg=k)
    # a checkpoint of another run's parameters is refused
    other = dict(first.params)
    other["light_origin"] = torch.zeros(2, 3)
    save_checkpoint(path, other, {}, 0)
    with pytest.raises(ValueError, match="parameters"):
        make_trainer(4).restore(path)


def test_invrender_app_recovers(tmp_path, capsys):
    """The JAX app's recovery test (tests/test_apps.py
    TestInvrender::test_pallas_engine_recovers) on the port: 48x36 depth 2, 150 steps, the same flags
    and bar (end error < half the start error)."""
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    ck = str(tmp_path / "inv.pt")
    res = invrender.main(["--steps", "150", "--width", "48", "--height",
                          "36", "--depth", "2", "--lr", "3e-2",
                          "--light-lr-scale", "1.0", "--every", "50",
                          "--checkpoint", ck, "--scene", scene_path,
                          "--asset-dir", asset_dir, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "recovered vs truth" in out and "param error:" in out
    assert len(res["losses"]) == 150 and res["steps"] == 150
    assert res["err0"] > 0.03
    assert res["err1"] < 0.5 * res["err0"], (res["err0"], res["err1"])
    assert res["obs1"] < res["obs0"]
    assert res["losses"][-1] < 0.1 * res["losses"][0]
    _, _, step = load_checkpoint(ck, res["params"])
    assert step == 150


def test_invrender_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        invrender.main(["--steps", "1", "--scene", scene_path,
                        "--asset-dir", asset_dir,
                        "--checkpoint", str(tmp_path / "x.pt")])
