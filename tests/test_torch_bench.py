"""The port's benchmark entry points (``tpuray_torch.bench``,
``tpuray_torch.benchmarks.stages`` and ``.stream``,
``tpuray_torch.scripts.profile_tri``) against the JAX package's scripts.

The JAX scripts build their scenes and configurations inside ``main``, so
each is run here with its timing function replaced by a recorder (and the
reference tree's loaders by the canonical scene and seeded textures); the
port's ``main`` is run the same way, its ``time_render`` replaced, and the
two records are compared field by field.  Renders of stages 1 and 5 at
64x48 are held against the JAX megakernel in Pallas interpret mode at the
bar of ``tests/test_torch_megakernel.py``.  Every entry point is also run
with ``--device cpu`` at a tiny size: its rows carry the JAX script's keys
and ``timer: "host"``.
"""
import ast
import contextlib
import importlib.util
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
import tpuray.sceneio
import tpuray.textures
from tpuray.textures import SceneAssets as JaxAssets

import tpuray_torch as tt
from tpuray_torch import bench
from tpuray_torch.benchmarks import scaling, stages, stream, timing
from tpuray_torch.render import render_from_basis
from tpuray_torch.scripts import profile_replay, profile_tri, validate
from test_torch_megakernel import (_camera_pair, _jax_checked, assert_agrees,
                                   chaotic_pixels, jax_scene_arrays)
from test_torch_render import _write_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET_SEED = 0
STAGE_RENDER = (64, 48)


def jax_script(relpath: str):
    """A JAX script of the repo as a module (not run)."""
    name = "jax_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_row_keys(relpath: str) -> list:
    """The keys of the last dict a JAX script passes to ``json.dumps``:
    the row it prints."""
    tree = ast.parse(open(os.path.join(REPO, relpath)).read())
    dicts = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", None) == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    last = max(dicts, key=lambda d: d.lineno)
    return [k.value for k in last.keys]


def _jax_assets():
    tex, sky = tt.random_asset_arrays(ASSET_SEED)
    return JaxAssets(jnp.asarray(tex), jnp.asarray(sky))


def run_jax_main(relpath: str, argv: list, timer_name: str,
                 syspath=None) -> list:
    """Run a JAX script's ``main`` with its timing function (module
    attribute ``timer_name``) replaced by a recorder, the reference scene by
    the canonical one and the reference textures by seeded ones.  Returns
    [(scene, cfg, printed row)] per timed call."""
    mp = pytest.MonkeyPatch()
    if syspath:
        mp.syspath_prepend(os.path.join(REPO, syspath))
    try:
        mod = jax_script(relpath)
        calls = []
        mp.setattr(tpuray.sceneio, "load_scene",
                   lambda path: tpuray.canonical_scene_spec())
        mp.setattr(tpuray.textures, "load_default_assets", _jax_assets)

        def record(render, scene, assets, basis, cfg, *rest):
            calls.append((scene, cfg))
            return 1.0
        mp.setattr(mod, timer_name, record)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.main(argv)
    finally:
        mp.undo()
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]
    return [(scene, cfg, row) for (scene, cfg), row in zip(calls, rows)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    scene_path, asset_dir, _, _ = _write_inputs(
        tmp_path_factory.mktemp("inputs"), seed=ASSET_SEED)
    return ["--scene", scene_path, "--asset-dir", asset_dir]


def run_port_main(monkeypatch, module, argv) -> list:
    """Run a port entry point's ``main`` on the CPU with ``time_render``
    replaced by a recorder; returns [(scene, cfg, row)]."""
    calls = []

    def record(scene, assets, basis, cfg, device, **kw):
        calls.append((scene, cfg))
        return {"ms_per_render": 1.0, "mrays_per_s": 1.0}
    monkeypatch.setattr(module, "time_render", record)
    rows = module.main([*argv, "--device", "cpu"])
    rows = rows if isinstance(rows, list) else [rows]
    return [(s, c, r) for (s, c), r in zip(calls, rows)]


CFG_FIELDS = ("width", "height", "max_depth", "shadow_samples", "chunk_size")


def assert_same_config(ours, theirs, what):
    for f in CFG_FIELDS:
        assert getattr(ours, f) == getattr(theirs, f), f"{what}: {f}"


def assert_same_scene(ours, theirs, what):
    """The port's scene against the JAX one carried across with
    ``scene_from_arrays``, leaf by leaf."""
    carried = tt.scene_leaves(tt.scene_from_arrays(jax_scene_arrays(theirs),
                                                   "cpu"))
    mine = tt.scene_leaves(ours)
    assert set(mine) == set(carried), what
    for name, value in mine.items():
        np.testing.assert_array_equal(value.numpy(), carried[name].numpy(),
                                      f"{what}: {name}")


# ---------------------------------------------------------------------------
# stage table, stream and profile_tri configurations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stages():
    calls = run_jax_main("benchmarks/stages.py", ["--stages", "1,2,3,4,5,6"],
                         "measure")
    return {row["stage"]: (scene, cfg, row) for scene, cfg, row in calls}


@pytest.fixture(scope="module")
def port_stages(inputs):
    mp = pytest.MonkeyPatch()
    try:
        calls = run_port_main(mp, stages, ["--stages", "1,2,3,4,5,6",
                                           *inputs])
    finally:
        mp.undo()
    return {row["stage"]: (scene, cfg, row) for scene, cfg, row in calls}


@pytest.mark.parametrize("stage", sorted(stages.STAGES))
def test_stage_table_matches_jax(stage, jax_stages, port_stages):
    jscene, jcfg, jrow = jax_stages[stage]
    scene, cfg, row = port_stages[stage]
    entry = stages.STAGES[stage]
    assert entry.config == jrow["config"] == row["config"]
    assert (entry.width, entry.height, entry.max_depth,
            entry.shadow_samples) == (jcfg.width, jcfg.height,
                                      jcfg.max_depth, jcfg.shadow_samples)
    assert_same_config(cfg, jcfg, f"stage {stage}")
    assert cfg.chunk_size == 0 and cfg.engine == "megakernel"
    assert scene.num_triangles == jscene.num_triangles \
        == {5: 7_424, 6: 10_240}.get(stage, 0)
    assert_same_scene(scene, jscene, f"stage {stage}")


def test_stream_matches_jax(monkeypatch, inputs):
    """stream.py's defaults: 163,840 triangles (not the 81,920 of the JAX
    docstring) at 512x384 d3; the row's config names the scene's count."""
    [(jscene, jcfg, jrow)] = run_jax_main(
        "benchmarks/stream.py", [], "measure", syspath="benchmarks")
    [(scene, cfg, row)] = run_port_main(monkeypatch, stream, inputs[2:])
    assert scene.num_triangles == jscene.num_triangles == 163_840
    assert row["config"] == jrow["config"] == "512x384_d3_tri163840_streamed"
    assert_same_config(cfg, jcfg, "stream")
    assert row["build_s"] > 0
    assert_same_scene(scene, jscene, "stream")


def test_profile_tri_variants_match_jax(monkeypatch, inputs):
    jax_calls = run_jax_main(
        "scripts/profile_tri.py", ["--variants", ",".join(
            [*profile_tri.VARIANTS, *profile_tri.NOT_PORTED])], "measure")
    jax_by = {row["variant"]: (scene, cfg) for scene, cfg, row in jax_calls}
    assert set(jax_by) == set(profile_tri.VARIANTS) \
        | set(profile_tri.NOT_PORTED)
    ours = run_port_main(monkeypatch, profile_tri,
                         ["--variants", ",".join(profile_tri.VARIANTS),
                          *inputs[2:]])
    assert [row["variant"] for _, _, row in ours] == list(
        profile_tri.VARIANTS)
    for scene, cfg, row in ours:
        jscene, jcfg = jax_by[row["variant"]]
        assert_same_config(cfg, jcfg, row["variant"])
        assert scene.num_triangles == jscene.num_triangles \
            == (0 if row["variant"] == "notri" else 7_424)


def test_profile_tri_refuses_nocull(inputs):
    with pytest.raises(ValueError, match="_TRI_CULL"):
        profile_tri.main(["--variants", "base,nocull", "--device", "cpu",
                          *inputs[2:]])


# ---------------------------------------------------------------------------
# stage renders against the JAX megakernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 5])
def test_stage_renders_match_jax(stage, jax_stages):
    """The stage's scene and settings at 64x48: the port's render call
    against ``render_pallas_checked`` in interpret mode."""
    jscene, jcfg, _ = jax_stages[stage]
    width, height = STAGE_RENDER
    jcfg = jcfg.replace(width=width, height=height)
    cfg = stages.stage_config(stages.STAGES[stage], width, height)
    scene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    tex, sky = tt.random_asset_arrays(ASSET_SEED)
    assets = tt.assets_from_arrays(tex, sky, "cpu")
    jcam, cam = _camera_pair()
    ref, dropped, _ = _jax_checked()(jscene, _jax_assets(),
                                     tpuray.perspective_basis(jcam, width,
                                                              height),
                                     jcfg, row0=0.0)
    assert int(dropped) == 0, "the JAX oracle dropped texel events"
    ref = np.asarray(ref)

    def render(basis):
        return render_from_basis(scene, assets, basis, cfg).numpy()

    basis = tt.perspective_basis(cam, width, height, device="cpu")
    port = render(basis)
    try:
        assert_agrees(port, ref, np.zeros(port.shape[:2], bool),
                      f"stage {stage}")
    except AssertionError:
        # the bar holds on the pixels that are not chaotic
        assert_agrees(port, ref, chaotic_pixels(render, basis, port),
                      f"stage {stage}")


# ---------------------------------------------------------------------------
# rows on the CPU
# ---------------------------------------------------------------------------

TINY = ["--width", "16", "--height", "12"]
ENTRY_POINTS = {
    "bench": (bench, "bench.py", [*TINY, "--reps", "2"], True),
    "stages": (stages, "benchmarks/stages.py",
               ["--stages", "1,5", *TINY, "--chain", "2"], True),
    "stream": (stream, "benchmarks/stream.py",
               ["--order", "1", "--torus", "8,4", *TINY, "--chain", "2"],
               False),
    "profile_tri": (profile_tri, "scripts/profile_tri.py",
                    ["--order", "1", *TINY, "--chain", "2"], False),
    "profile_replay": (profile_replay, "scripts/profile_replay.py",
                       ["2", "--json", "16", "12", "--reps", "2"], True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_rows_carry_the_jax_keys_on_the_host_clock(name, inputs, capsys):
    module, jax_path, argv, with_scene = ENTRY_POINTS[name]
    module.main([*argv, "--device", "cpu",
                 *(inputs if with_scene else inputs[2:])])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu; torch ")
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert rows
    want = jax_row_keys(jax_path)
    for row in rows:
        assert list(row)[:len(want)] == want, (want, row)
        assert row["timer"] == "host" and row["device"] == "cpu"
        assert row["reps"] == 2 and row["min_ms"] <= row["max_ms"]
        assert all(n == 0 for n in row["launches"].values())


@pytest.mark.parametrize("module", [bench, stages, stream, scaling,
                                    profile_tri, profile_replay, validate],
                         ids=lambda m: m.__name__.rpartition(".")[2])
def test_entry_points_refuse_cuda_without_a_card(module, monkeypatch,
                                                 inputs):
    """``--device cuda`` (every entry point's default) raises where there
    is no card; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene_less = module in (stream, profile_tri)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--device", "cuda", *(inputs[2:] if scene_less
                                           else inputs)])


def test_missing_inputs_name_their_path(tmp_path):
    missing = str(tmp_path / "nope.map")
    with pytest.raises(FileNotFoundError, match="nope.map"):
        bench.main(["--device", "cpu", "--scene", missing, *TINY])


def test_measure_on_the_host_clock():
    calls = []
    t = timing.measure(lambda: calls.append(1), "cpu", warmup=2, reps=5)
    assert len(calls) == 7
    assert t["timer"] == "host" and t["reps"] == 5
    assert 0 <= t["min_ms"] <= t["ms"] <= t["max_ms"]
    assert timing.device_info("cpu")["device"] == "cpu"
    with pytest.raises(ValueError, match="reps"):
        timing.measure(lambda: None, "cpu", reps=0)
