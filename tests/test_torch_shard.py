"""The port's sharded paths (``tpuray_torch/parallel/``) on local worlds of
gloo ranks on the CPU, held against the JAX package's sharded functions
(``tpuray/parallel/shard.py`` on the virtual CPU devices of
``tests/conftest.py``, Pallas in interpret mode) and against the port's own
single-rank renders.

The port's worlds run in fresh interpreters, one per world
(``python -m tpuray_torch.parallel.selfcheck``: 2 ranks on a 1-D mesh, 4 on
a 2x2 mesh), started once for the module and read back from ``.npz``
files; the JAX side is computed in this process meanwhile.  Scenes and
shapes are those of ``tests/sharding_subproc.py``: two spheres on a plane
(64x32 d3 forward, 32x16 d2 gradients), the 272-triangle mesh scene (32x16
d2); flat assets of one colour; targets from a numpy seed.  JAX's scenes
are built from the port's arrays.

Tolerances:

* sharded against the port's single rank: images max |d| <= 1e-6 (a
  pixel's arithmetic does not depend on its share; the triangle ids are
  exact); losses rtol 1e-5 and gradients rtol 5e-3, atol 5e-5 (the bar of
  ``tests/sharding_subproc.py:199-201``: per-rank sums then an all-reduce
  sum in another order);
* against JAX: the megakernel and the pixel-sharded tracer at the bar of
  ``tests/test_torch_megakernel.py`` (99.9% of pixels within 1e-3, mean
  |d| < 1e-4) over every pixel, none set apart as chaotic; triangles sharded
  at atol 1e-4 (``tests/sharding_subproc.py:121-123``); losses rtol 1e-3
  and gradients atol 2e-2 * max |g_jax| per leaf (the bar of
  ``tests/test_torch_replay.py``: the frameworks round the chaotic pixels
  apart).  The assets' colour is above 0 and no pixel of the clamped loss
  sits at 0 or 1, where ``jnp.clip`` and ``torch.clamp`` pass different
  gradients.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tpuray
from tpuray import config as jconfig
from tpuray import diff as jdiff
from tpuray.kernels.trace import trace_rays as jax_trace_rays
from tpuray.parallel import shard as jshard
from tpuray.scene import Materials as JaxMaterials
from tpuray.scene import Scene as JaxScene
from tpuray.textures import solid_assets as jax_solid_assets

from tpuray_torch.parallel import distributed, selfcheck, shard
from test_torch_megakernel import assert_agrees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 300
FWD_ABS = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ABS = 5e-3, 5e-5
TRI_ABS = 1e-4
JAX_LOSS_RTOL = 1e-3
JAX_GRAD_ATOL = 2e-2
# the megakernel bar with no pixel set apart as chaotic: the images agree
# on every pixel (the 64x32 frame's horizon row is chaotic, 3% of it)
NO_CHAOTIC = np.zeros((selfcheck.FORWARD.height, selfcheck.FORWARD.width),
                      bool)
CAMERA = (jconfig.GOLDEN_CAMERA_ORIGIN, jconfig.GOLDEN_CAMERA_LOOKDIR,
          jconfig.GOLDEN_CAMERA_FOV, jconfig.GOLDEN_CAMERA_FOCAL)


class Worlds:
    """The port's selfcheck worlds, started at once and read on demand."""

    def __init__(self, tmp):
        self.paths, self.procs, self.results = {}, {}, {}
        for name, args in (("w2", ["--world", "2"]),
                           ("w4", ["--world", "4", "--mesh", "2x2"])):
            self.paths[name] = str(tmp / f"{name}.npz")
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "tpuray_torch.parallel.selfcheck",
                 *args, "--device", "cpu", "--timeout", str(WORLD_TIMEOUT),
                 "--out", self.paths[name]],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)

    def get(self, name):
        if name not in self.results:
            proc = self.procs[name]
            out, err = proc.communicate(timeout=WORLD_TIMEOUT + 60)
            assert proc.returncode == 0, out + err
            with np.load(self.paths[name]) as f:
                self.results[name] = dict(f)
        return self.results[name]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("shard"))
    yield w
    w.close()


def jax_cfg(cfg):
    return jconfig.RenderConfig(
        width=cfg.width, height=cfg.height, max_depth=cfg.max_depth,
        chunk_size=0, loop=cfg.loop, scan_iters=cfg.scan_iters)


def jax_scene(res, prefix):
    """The JAX ``Scene`` of the port's arrays ``<prefix>/<leaf>``."""
    def leaf(name):
        return jnp.asarray(res[f"{prefix}/{name}"])
    return JaxScene(**{
        f: JaxMaterials(*(leaf(f"{f}.{k}") for k in JaxMaterials._fields))
        if f.endswith("_mat") else leaf(f) for f in JaxScene._fields})


def jax_inputs(cfg):
    assert jax.device_count() >= 4, jax.device_count()
    basis = tpuray.perspective_basis(tpuray.Camera(*CAMERA), cfg.width,
                                     cfg.height)
    assets = jax_solid_assets(selfcheck.N_TEXTURES, rgb=selfcheck.ASSET_RGB)
    return assets, basis, jax_cfg(cfg)


def jax_grads(grads):
    """A JAX grad pytree (``Scene``) as a dict by the port's leaf names."""
    out = {}
    for f, v in grads._asdict().items():
        if hasattr(v, "_asdict"):
            for k, g in v._asdict().items():
                if g is not None:
                    out[f"{f}.{k}"] = np.asarray(g)
        elif v is not None:
            out[f] = np.asarray(v)
    return out


def assert_grads(res, case, want_loss, want, loss_rtol, rtol=0.0, atol=0.0,
                 scale=0.0):
    """The port's sharded loss and gradients of ``case`` against
    ``want_loss`` and ``want`` (by leaf): each leaf within rtol and atol +
    ``scale`` * max |want|."""
    np.testing.assert_allclose(res[f"{case}/sharded/loss"], want_loss,
                               rtol=loss_rtol)
    names = [k.rsplit("/", 1)[1] for k in res
             if k.startswith(f"{case}/sharded/grad/")]
    assert names
    for name in names:
        got, ref = res[f"{case}/sharded/grad/{name}"], want[name]
        assert np.all(np.isfinite(got)), name
        tol = atol + scale * float(np.abs(ref).max(initial=0.0))
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=tol,
                                   err_msg=name)
    assert np.any(res[f"{case}/sharded/grad/light_intensity"] != 0)


def test_a_render_sharded_matches_jax(worlds):
    cfg = selfcheck.FORWARD
    jassets, jbasis, jcfg = jax_inputs(cfg)
    res = worlds.get("w2")
    want = np.asarray(jshard.render_sharded(
        jax_scene(res, "scene"), jassets, jbasis, jcfg, jshard.make_mesh(2)))
    assert_agrees(res["a/sharded"], want, NO_CHAOTIC, "render_sharded")


def test_b_render_sharded_pallas_matches_jax(worlds):
    cfg = selfcheck.FORWARD
    jassets, jbasis, jcfg = jax_inputs(cfg)
    res = worlds.get("w2")
    want = np.asarray(jshard.render_sharded_pallas(
        jax_scene(res, "scene"), jassets, jbasis, jcfg, jshard.make_mesh(2),
        interpret=True))
    assert_agrees(res["b/sharded"], want, NO_CHAOTIC,
                  "render_sharded_pallas")


def test_c_loss_and_scene_grad_sharded_matches_jax(worlds):
    """JAX's ``loss_and_scene_grad_sharded`` returns n times the gradient
    of one device (``shard_map`` already sums the cotangent of the
    replicated scene, and its ``psum`` sums it again; ROADMAP C, hazards),
    so the port's are held against JAX's over the mesh size, and those
    against ``jax.grad`` of one device's ``trace_rays``."""
    cfg = selfcheck.GRAD
    jassets, jbasis, jcfg = jax_inputs(cfg)
    res = worlds.get("w2")
    jscene = jax_scene(res, "scene")
    target = jnp.asarray(res["target/c"])
    loss, grads = jshard.loss_and_scene_grad_sharded(
        jscene, jassets, jbasis, target, jcfg, jshard.make_mesh(2))
    grads = {k: g / 2 for k, g in jax_grads(grads).items()}
    o, d = tpuray.generate_rays(jbasis, cfg.width, cfg.height)
    ids = jnp.arange(cfg.width * cfg.height, dtype=jnp.uint32)
    one_loss, one = jdiff.value_and_scene_grad(
        lambda s: jnp.sum((jax_trace_rays(s, jassets, o, d, ids, jcfg)
                           - target) ** 2), jscene)
    for name, g in jax_grads(one).items():
        np.testing.assert_allclose(grads[name], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ABS, err_msg=name)
    np.testing.assert_allclose(float(loss), float(one_loss), rtol=LOSS_RTOL)
    assert_grads(res, "c", float(loss), grads, JAX_LOSS_RTOL,
                 scale=JAX_GRAD_ATOL)


def test_d_loss_and_scene_grad_sharded_pallas_matches_jax(worlds):
    cfg = selfcheck.GRAD
    jassets, jbasis, jcfg = jax_inputs(cfg)
    res = worlds.get("w2")
    # no clamp tie: jnp.clip and torch.clamp differ only at 0 and 1
    img = res["d/image"]
    assert not np.any((img == 0.0) | (img == 1.0))
    loss, grads = jshard.loss_and_scene_grad_sharded_pallas(
        jax_scene(res, "scene"), jassets, jbasis,
        jnp.asarray(res["target/d"]), jcfg, jshard.make_mesh(2),
        interpret=True)
    assert_grads(res, "d", float(loss), jax_grads(grads), JAX_LOSS_RTOL,
                 scale=JAX_GRAD_ATOL)


def test_e_render_scene_parallel_matches_jax(worlds):
    cfg = selfcheck.SMALL
    jassets, jbasis, jcfg = jax_inputs(cfg)
    res = worlds.get("w2")
    want = np.asarray(jshard.render_scene_parallel(
        jax_scene(res, "mesh_scene"), jassets, jbasis, jcfg,
        jshard.make_mesh(2)))
    np.testing.assert_allclose(res["e/sharded"], want, rtol=0, atol=TRI_ABS)


def test_f_render_sharded_2d_matches_jax(worlds):
    cfg = selfcheck.SMALL
    jassets, jbasis, jcfg = jax_inputs(cfg)
    mesh2d = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                  (jshard.AXIS, jshard.TRI_AXIS))
    res = worlds.get("w2")
    want = np.asarray(jshard.render_sharded_2d(
        jax_scene(res, "mesh_scene"), jassets, jbasis, jcfg, mesh2d))
    np.testing.assert_allclose(worlds.get("w4")["f/sharded"], want, rtol=0,
                               atol=TRI_ABS)


@pytest.mark.parametrize("case", ["a", "b", "b_mesh", "e", "h", "i"])
def test_g_sharded_render_equals_single_rank(worlds, case):
    res = worlds.get("w2")
    got, want = res[f"{case}/sharded"], res[f"{case}/single"]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= FWD_ABS, case


def test_g_sharded_2d_render_equals_single_rank(worlds):
    res = worlds.get("w4")
    got, want = res["f/sharded"], res["f/single"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_ABS


@pytest.mark.parametrize("case", ["c", "d"])
def test_g_sharded_gradients_equal_single_rank(worlds, case):
    res = worlds.get("w2")
    want = {k.rsplit("/", 1)[1]: v for k, v in res.items()
            if k.startswith(f"{case}/single/grad/")}
    assert_grads(res, case, res[f"{case}/single/loss"], want, LOSS_RTOL,
                 rtol=GRAD_RTOL, atol=GRAD_ABS)


def test_h_empty_triangle_shard(worlds):
    """One triangle over two ranks: the second rank's slice is empty and it
    still takes part in every reduction; the triangle is in the image."""
    res = worlds.get("w2")
    assert np.abs(res["h/sharded"] - res["h/single"]).max() <= FWD_ABS
    assert (np.abs(res["h/single"] - res["sphere/single"]).max(-1)
            > 1e-3).sum() >= 20


def test_i_lowest_id_wins_a_tie_across_shards(worlds):
    """Two coincident triangles, one per rank: the image is the first's
    (the lower id), as on one rank, and not the second's."""
    res = worlds.get("w2")
    assert np.abs(res["i/sharded"] - res["i/single"]).max() <= FWD_ABS
    assert np.array_equal(res["i/single"], res["h/single"])
    assert (np.abs(res["i/sharded"] - res["i_second/single"]).max(-1)
            > 1e-3).sum() >= 20


def test_j_ensure_initialized_is_a_noop_without_a_configuration(
        monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.ensure_initialized() is False
    assert not torch.distributed.is_initialized()
    info = distributed.runtime_info()
    assert info["initialized"] is False and info["world_size"] == 1
    with pytest.raises(ValueError, match="no process group"):
        shard.make_mesh(1, device="cpu")


def test_k_make_mesh_refuses_a_small_world(worlds):
    msg = str(worlds.get("w2")["k/message"])
    assert "requested a mesh of 3" in msg and "world has 2" in msg \
        and "rank 0" in msg, msg


def test_l_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
        distributed.launch(selfcheck.raise_on_rank, 2, 1, device="cpu",
                           timeout=120)


def test_l_a_hung_rank_fails_the_launch_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 10"):
        distributed.launch(selfcheck.hang_on_rank, 2, 1, device="cpu",
                           timeout=10)
    assert time.monotonic() - t0 < 40


def test_dryrun_multichip_on_four_cpu_ranks():
    res = shard.dryrun_multichip(4, device="cpu", timeout=240)
    assert len(res) == 4 and res[0]["render_sharded_2d"] == (16, 32, 3)
    assert all(r == res[0] for r in res)
