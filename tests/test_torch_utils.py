"""The port's debug and metrics helpers (``tpuray_torch.utils.debug``,
``tpuray_torch.utils.metrics``) held against the JAX package's:
``check_finite`` raises the same error with the same message on the same
trees, ``RenderReport.to_json`` carries JAX's keys with JAX's values;
``nan_guard`` raises on an op and on the kernel wrappers' hook;
``profile_trace`` writes a Chrome trace that parses (also through raypng's
``--profile``); ``timed`` prints its line."""
import collections
import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from tpuray.utils import debug as jdebug
from tpuray.utils import metrics as jmetrics

import tpuray_torch as tt
from tpuray_torch.apps import raypng
from tpuray_torch.utils import debug, metrics
from test_torch_render import _write_inputs

Pair = collections.namedtuple("Pair", ["first", "second"])
NAN, INF = float("nan"), float("inf")

# trees of numpy leaves; each goes to both packages as it is, and to the
# port also with torch tensors in place of the float arrays
TREES = {
    "finite": {"ok": np.ones(3, np.float32), "n": np.int32(7)},
    "dict": {"bad": np.array([1.0, NAN], np.float32)},
    "sorted keys": {"b": np.array([INF]), "a": np.array([NAN, NAN, 1.0])},
    "list": [np.zeros(2), np.array([[1.0, INF], [NAN, 2.0]])],
    "nested": {"x": [np.ones(1), {"y": (np.zeros(3), np.full(4, -INF))}]},
    "named tuple": Pair(np.ones(2), np.array([NAN])),
    "ints skipped": {"i": np.array([1, 2]), "f": np.array([np.float32(NAN)])},
    "scalar": [1.5, math.inf],
    "none": {"a": None, "b": [None, np.array([NAN])]},
}


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(as_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_torch(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
        return torch.from_numpy(tree)
    return tree


def outcome(fn, tree, label):
    try:
        fn(tree, label)
    except Exception as e:       # the outcome compared: type and message
        return type(e), str(e)
    return None


@pytest.mark.parametrize("name", sorted(TREES))
def test_check_finite_matches_jax(name):
    tree = TREES[name]
    want = outcome(jdebug.check_finite, tree, "render")
    assert outcome(debug.check_finite, tree, "render") == want
    assert outcome(debug.check_finite, as_torch(tree), "render") == want
    if name != "finite":
        assert want[0] is FloatingPointError


def test_nan_guard_raises_on_an_op():
    x = torch.tensor([1.0, -1.0])
    with debug.nan_guard():
        torch.sqrt(x.abs())
        torch.empty(1000)               # uninitialised memory is no NaN
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(x)
    torch.sqrt(x)                        # no guard, no error


def test_nan_guard_raises_on_a_nan_in_the_backward():
    """A backward op that makes a NaN raises from the dispatch mode; a
    backward that returns one made before the guard, from anomaly mode."""
    made_before = torch.full((3,), NAN)

    class NanGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, make):
            ctx.make = make
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return (g * NAN if ctx.make else made_before), None

    for make, error in ((True, FloatingPointError), (False, RuntimeError)):
        x = torch.ones(3, requires_grad=True)
        with debug.nan_guard():
            y = NanGrad.apply(x, make).sum()
            with pytest.raises(error, match="(?i)nan"):
                y.backward()


def test_nan_guard_checks_the_kernel_wrappers_hook():
    bad = torch.tensor([[0.5, NAN, NAN]])
    debug.check_kernel_output("megakernel", bad)     # no guard: a no-op
    assert not debug.guard_active()
    with debug.nan_guard():
        assert debug.guard_active()
        debug.check_kernel_output("megakernel", torch.zeros(2),
                                  torch.tensor([1, 2]))
        with pytest.raises(FloatingPointError,
                           match="2 NaN values out of the megakernel"):
            debug.check_kernel_output("megakernel", torch.zeros(1), bad)
    assert not debug.guard_active()


def test_render_report_to_json_has_jax_keys():
    kw = dict(width=1920, height=1080, max_depth=4, seconds=0.1)
    want = json.loads(jmetrics.RenderReport(**kw,
                                            compile_seconds=2.5).to_json())
    got = json.loads(metrics.RenderReport(**kw, device="cpu",
                                          first_seconds=2.5).to_json())
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cpu" and got["first_seconds"] == 2.5
    r = metrics.RenderReport(**kw, device="cpu")
    assert json.loads(r.to_json())["compile_seconds"] is None
    assert abs(r.mrays_per_s - 20.736) < 1e-6


def _trace_events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    assets = tt.solid_assets(3, device="cpu")
    cam = tt.Camera((0.8, 2.5, -8.0), (0.2, 0.0, 1.0))
    cfg = tt.RenderConfig(width=16, height=8, max_depth=2)
    log_dir = str(tmp_path / "trace")
    with metrics.profile_trace(log_dir):
        tt.render(scene, assets, cam, cfg)
    names = {e.get("name") for e in _trace_events(log_dir)}
    assert "aten::mul" in names


def test_raypng_profile_writes_a_trace(tmp_path):
    scene_path, asset_dir, _, _ = _write_inputs(tmp_path)
    log_dir = str(tmp_path / "prof")
    raypng.main(["--scene", scene_path, "--asset-dir", asset_dir,
                 "--out", str(tmp_path / "x.png"), "--width", "16",
                 "--height", "8", "--depth", "2", "--device", "cpu",
                 "--repeat", "2", "--profile", log_dir])
    assert any(e.get("cat") == "cpu_op" for e in _trace_events(log_dir))


def test_timed_prints_its_line(capsys):
    with metrics.timed("render"):
        torch.ones(10).sum()
    out = capsys.readouterr().out
    assert out.startswith("render: ") and out.rstrip().endswith(" ms")
