"""The port's slice end to end on the CPU: ``render_u8`` against the JAX
megakernel (Pallas interpret mode) plus ``quantize_image``; the raypng and
scenegen apps; the golden slabs where the reference tree is mounted; and
the rule that the port never imports JAX."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
from tpuray import config as jconfig
from tpuray.kernels.pallas_trace import render_pallas_checked
from tpuray.kernels.trace import quantize_image as jax_quantize
from tpuray.textures import SceneAssets as JaxAssets

import tpuray_torch as tt
from tpuray_torch.apps import raypng, scenegen
from tpuray_torch.config import REFERENCE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER_MAP = os.path.join(REFERENCE_DIR, "scenes", "render.map")

GOLDEN_CAMERA = (jconfig.GOLDEN_CAMERA_ORIGIN, jconfig.GOLDEN_CAMERA_LOOKDIR,
                 jconfig.GOLDEN_CAMERA_FOV, jconfig.GOLDEN_CAMERA_FOCAL)


def test_render_u8_matches_jax_megakernel_and_quantize():
    """128x16 at depth 3: at least 99.9% of channel values within +-1."""
    width, height, depth = 128, 16, 3
    tex, sky = tt.random_asset_arrays(0)
    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=depth)
    jbasis = tpuray.perspective_basis(tpuray.Camera(*GOLDEN_CAMERA), width,
                                      height)
    rgb, dropped, _ = render_pallas_checked(
        jscene, JaxAssets(jnp.asarray(tex), jnp.asarray(sky)), jbasis, jcfg,
        interpret=True)
    assert int(dropped) == 0
    want = np.asarray(jax_quantize(rgb.reshape(-1, 3), width, height))

    got = tt.render_u8(tt.build_scene(tt.canonical_scene_spec(), "cpu"),
                       tt.assets_from_arrays(tex, sky, "cpu"),
                       tt.Camera(*GOLDEN_CAMERA),
                       tt.RenderConfig(width=width, height=height,
                                       max_depth=depth))
    assert got.dtype == np.uint8 and got.shape == (height, width, 3)
    close = np.abs(got.astype(int) - want.astype(int)) <= 1
    assert close.mean() >= 0.999, f"within +-1: {close.mean()}"


def test_quantize_image_matches_jax():
    rng = np.random.default_rng(4)
    rgb = rng.uniform(-0.5, 1.5, (6, 7, 3)).astype(np.float32)
    rgb[0, 0] = [np.inf, -np.inf, 0.99999994]
    want = np.asarray(jax_quantize(jnp.asarray(rgb).reshape(-1, 3), 7, 6))
    got = tt.quantize_image(torch.from_numpy(rgb), 7, 6).numpy()
    np.testing.assert_array_equal(got, want)


def _write_inputs(tmp_path, seed=3):
    """A render.map and an asset directory (four textures, a cross sky)
    made from the canonical scene and seeded random images."""
    scene_path = str(tmp_path / "render.map")
    tt.dump_scene(scene_path, tt.canonical_scene_spec())
    asset_dir = tmp_path / "assets"
    (asset_dir / "bg").mkdir(parents=True)
    tex, sky = tt.random_asset_arrays(seed)
    for name, img in zip(tt.textures.DEFAULT_TEXTURES, tex):
        tt.write_png(str(asset_dir / name), img)
    tt.write_png(str(asset_dir / tt.textures.DEFAULT_SKYBOX), sky)
    return scene_path, str(asset_dir), tex, sky


def test_raypng_writes_the_rendered_png(tmp_path, capsys):
    scene_path, asset_dir, tex, sky = _write_inputs(tmp_path)
    out = str(tmp_path / "out" / "scene.png")
    res = raypng.main(["--scene", scene_path, "--asset-dir", asset_dir,
                       "--out", out, "--width", "40", "--height", "24",
                       "--depth", "4", "--device", "cpu", "--selfcheck"])
    printed = capsys.readouterr().out
    assert "Done, took:" in printed and "selfcheck: image finite" in printed
    np.testing.assert_array_equal(tt.read_png(out), res["image"])
    # the same render through the library
    want = tt.render_u8(tt.build_scene(tt.canonical_scene_spec(), "cpu"),
                        tt.assets_from_arrays(tex, sky, "cpu"),
                        tt.Camera(*GOLDEN_CAMERA),
                        tt.RenderConfig(width=40, height=24, max_depth=4))
    np.testing.assert_array_equal(res["image"], want)
    assert res["report"].device == "cpu" and res["golden"] is None


def test_raypng_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raypng.main(["--scene", scene_path, "--asset-dir", asset_dir,
                     "--out", str(tmp_path / "x.png"), "--width", "8",
                     "--height", "8"])


def test_scenegen_writes_the_canonical_archive(tmp_path):
    out = str(tmp_path / "scenes" / "render.map")
    scenegen.main(["--out", out])
    assert open(out, "rb").read() == tpuray.dumps_scene(
        tpuray.canonical_scene_spec())


@pytest.mark.parametrize("row0", [288, 8])
def test_golden_slab(row0):
    """16 full-width rows of the 800x600 depth-15 golden image, rendered
    by the plain version, against the reference's out/scene.png (the bar
    of the JAX package's TestGoldenSlabInterpret)."""
    if not os.path.exists(RENDER_MAP):
        pytest.skip(f"the reference tree is not mounted at {REFERENCE_DIR}")
    scene = tt.load_scene(RENDER_MAP).to_scene("cpu")
    assets = tt.load_default_assets(device="cpu")
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), 800, 600,
                                 device="cpu")
    cfg = tt.RenderConfig(height=16)            # 800 wide, depth 15
    rgb = tt.render_from_basis(scene, assets, basis, cfg, row0=row0)
    q = tt.quantize_image(rgb, 800, 16).numpy()
    gold = tt.read_png(tt.io.GOLDEN_PNG)[row0:row0 + 16]
    d = np.abs(q.astype(np.int32) - gold.astype(np.int32))
    assert d.mean() < 1.0, f"mean|d|={d.mean()}"
    assert (d <= 8).mean() > 0.99, f"within-8 {(d <= 8).mean()}"


def test_port_imports_neither_jax_nor_tpuray():
    """Every module of the port (found by ``pkgutil.walk_packages``, so a
    new one cannot escape) and ``chip_smoke`` import neither JAX nor the
    JAX package (nor Triton or PIL)."""
    code = ("import importlib, pkgutil, sys, tpuray_torch; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "tpuray_torch.__path__, 'tpuray_torch.')] + ['chip_smoke']; "
            "[importlib.import_module(m) for m in mods]; "
            "print(len(mods), 'modules'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpuray', 'triton', 'PIL')); "
            "print(bad); sys.exit(1 if bad or len(mods) < 40 else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
