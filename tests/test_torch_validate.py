"""The port's validation and scaling entry points
(``tpuray_torch.scripts.validate``, ``tpuray_torch.benchmarks.scaling``)
against the JAX package's scripts.

* validate: its JSON sections and the keys of its golden and invrender
  sections are those of ``scripts/validate.py`` (read from its source); its
  golden gate is ``true`` against a PNG of its own render, exits nonzero
  against a perturbed one, and is ``null`` (``measured: false``) without
  the file.  The sections run at tiny sizes (the module's configurations
  replaced).
* scaling: ``--device cpu --max-devices 2`` runs worlds of 1 and 2 ranks
  over gloo and prints a row for each, with the JAX keys.
"""
import ast
import json
import os

import pytest

from tpuray import config as jconfig

import tpuray_torch as tt
from tpuray_torch.benchmarks import scaling
from tpuray_torch.config import RenderConfig
from tpuray_torch.scripts import profile_replay, validate
from test_torch_bench import REPO, jax_row_keys
from test_torch_render import _write_inputs

TINY = ["--width", "16", "--height", "12"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    scene_path, asset_dir, _, _ = _write_inputs(
        tmp_path_factory.mktemp("inputs"), seed=0)
    return ["--scene", scene_path, "--asset-dir", asset_dir]


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

def jax_validate_keys():
    """From ``scripts/validate.py``'s source: the top-level keys of its
    results, and the keys of the dicts ``run_golden`` and ``run_invrender``
    return."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "validate.py")).read())
    top, returned = set(), {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and getattr(
                node.value, "id", None) == "results" \
                and isinstance(node.slice, ast.Constant):
            top.add(node.slice.value)
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "results" \
                and isinstance(node.value, ast.Dict):
            top |= {k.value for k in node.value.keys}
        if isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) \
                        and isinstance(sub.value, ast.Dict):
                    returned[node.name] = {k.value for k in sub.value.keys}
    return top, returned["run_golden"], returned["run_invrender"]


@pytest.fixture
def tiny_validate(monkeypatch):
    """validate's sections at tiny sizes."""
    monkeypatch.setattr(validate, "GOLDEN_CFG", RenderConfig(
        width=16, height=12, max_depth=2, chunk_size=0))
    monkeypatch.setattr(validate, "STAGES_ARGV", [*TINY, "--chain", "1"])
    monkeypatch.setattr(validate, "INVRENDER_ARGV", [
        "--steps", "3", "--width", "16", "--height", "12", "--depth", "2",
        "--lr", "3e-2", "--light-lr-scale", "1.0"])
    monkeypatch.setattr(validate, "REPLAY_ARGV",
                        (["2", "--json", "16", "12", "--reps", "1"],))
    monkeypatch.setattr(validate, "BENCH_ARGV", [*TINY, "--reps", "1"])


def test_validate_writes_the_jax_layout(tiny_validate, inputs, tmp_path):
    out = str(tmp_path / "v.json")
    res = validate.main(["--device", "cpu", "--stages", "1", "--out", out,
                         "--golden", str(tmp_path / "none.png"), *inputs])
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(res))
    top, _, inv = jax_validate_keys()
    assert set(written) == top
    assert written["golden"]["measured"] is False
    assert inv <= set(written["invrender"])
    assert [r["stage"] for r in written["stages"]] == [1]
    assert [r["what"] for r in written["replay"]] == [
        profile_replay.RECORD, profile_replay.REPLAY,
        profile_replay.REPLAY_GRAD, profile_replay.FULL]
    assert written["bench"]["timer"] == "host"
    assert written["golden_gate_psnr45"] is None


@pytest.mark.parametrize("golden", ["own", "perturbed", "missing"])
def test_validate_golden_gate(golden, tiny_validate, inputs, tmp_path):
    cfg = validate.GOLDEN_CFG
    png = str(tmp_path / "golden.png")
    if golden != "missing":
        scene = tt.load_scene(inputs[1]).to_scene("cpu")
        assets = tt.load_default_assets(inputs[3], device="cpu")
        basis = tt.perspective_basis(tt.Camera(*_golden_camera()), cfg.width,
                                     cfg.height, device="cpu")
        img = tt.quantize_image(tt.render_from_basis(scene, assets, basis,
                                                     cfg),
                                cfg.width, cfg.height).numpy()
        if golden == "perturbed":
            img = 255 - img
        tt.write_png(png, img)
    out = str(tmp_path / "v.json")
    argv = ["--device", "cpu", "--skip-stages", "--skip-invrender",
            "--skip-replay", "--golden", png, "--out", out, *inputs]
    if golden == "perturbed":
        with pytest.raises(SystemExit) as e:
            validate.main(argv)
        assert e.value.code == 1
    else:
        validate.main(argv)
    with open(out) as f:
        section = json.load(f)
    gate = section["golden_gate_psnr45"]
    if golden != "missing":
        assert jax_validate_keys()[1] <= set(section["golden"])
    if golden == "own":
        assert gate is True and section["golden"]["psnr_db"] >= 45.0
        assert section["golden"]["mean_abs"] == 0.0
    elif golden == "perturbed":
        assert gate is False and section["golden"]["psnr_db"] < 45.0
    else:
        assert gate is None and section["golden"]["measured"] is False
        assert png in section["golden"]["reason"]


def _golden_camera():
    return (jconfig.GOLDEN_CAMERA_ORIGIN, jconfig.GOLDEN_CAMERA_LOOKDIR,
            jconfig.GOLDEN_CAMERA_FOV, jconfig.GOLDEN_CAMERA_FOCAL)


# ---------------------------------------------------------------------------
# scaling over gloo on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["pixel", "scene"])
def test_scaling_rows_for_worlds_of_1_and_2(layout, inputs, capsys):
    rows = scaling.main(["--device", "cpu", "--max-devices", "2",
                         "--layout", layout, "--mesh-order", "0",
                         *TINY, "--depth", "2", "--reps", "1", *inputs])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == json.loads(json.dumps(rows))
    assert [r["devices"] for r in rows] == [1, 2]
    want = jax_row_keys("benchmarks/scaling.py")
    for row in rows:
        assert list(row)[:len(want)] == want, (want, row)
        assert row["layout"] == layout and row["backend"] == "cpu"
        assert row["dist_backend"] == "gloo" and row["timer"] == "host"
        assert len(row["rank_ms"]) == row["devices"]
    assert rows[0]["efficiency"] == 1.0
