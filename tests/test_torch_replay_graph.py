"""The replay's backward as one captured CUDA graph (``diff.ReplayGraph``).

On the CPU: :func:`diff.replay_vjp`, the eager body that the card captures,
gives the gradients of ``render_megakernel_diff``'s backward and of the
backward as it was written before the graph (the replay and
``torch.autograd.grad``, copied below) bit for bit, and the JAX replay's
at the bar of ``tests/test_torch_replay.py`` (``2e-2 * max|g_jax|`` on the
pixels where the two replays agree); the cache key changes with what
changes the captured work and with nothing else; the replay puts no host
data on the device and reads none back once it is given its slot count.

On the card (marker ``cuda``; run ``python -m pytest
tests/test_torch_replay_graph.py -q`` there), each skipping without one:
the graph's gradients equal the eager ones bit for bit over three
backward calls with the leaves changed between them (no atomics without
triangles), within 1e-5 of max|g| on 7,424 triangles (``index_select``'s
backward adds atomically, in any order); a new key drops the old graph and
its pool (``memory_reserved`` back within 5%) and captures again; a
capture that fails raises, naming the key; ``nan_guard`` runs it eagerly;
threads calling at once share one capture.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
from tpuray import config as jconfig
from tpuray import diff as jdiff
from tpuray.kernels.replay import replay_render as jax_replay_render

import tpuray_torch as tt
from tpuray_torch import diff
from tpuray_torch.apps import invrender
from tpuray_torch.camera import PerspectiveBasis
from tpuray_torch.kernels.megakernel import (pack_scene,
                                             render_megakernel_record)
from tpuray_torch.kernels.replay import record_slots, replay_render
from tpuray_torch.meshes import mesh_benchmark_scene
from test_torch_megakernel import _assets_pair, _camera_pair
from test_torch_record import picks_in_event_order
from test_torch_replay import (AGREE_ABS, BASIS_FIELDS, GRAD_ATOL, jax_leaf,
                               port_inputs)
from torch_threads import cap_threads

cap_threads()

GOLDEN_CAMERA = ((0.8, 2.5, -8.0), (0.2, 0.0, 1.0), 90.0, 1.0)
# graph against eager with triangles, times max|g|: the same kernels,
# index_select's backward summing in another order
MESH_GRAD_RTOL = 1e-5
# memory_reserved after a key change, against before the first capture
RESERVED_RTOL = 0.05


def old_backward(leaves, basis, rest, records, grad_img, assets, cfg, need):
    """``_RecordReplay.backward``'s body before the graph, verbatim but for
    its arguments."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(want) for t, want in zip(
            [*leaves.values(), *(getattr(basis, f) for f in BASIS_FIELDS)],
            need)]
        n = len(leaves)
        scene = tt.combine(dict(zip(leaves, inputs[:n])), rest)
        img = replay_render(scene, assets, PerspectiveBasis(*inputs[n:]),
                            records, cfg, 0)
        wanted = [t for t in inputs if t.requires_grad]
        grads = (torch.autograd.grad(img, wanted, grad_img,
                                     allow_unused=True)
                 if img.requires_grad else [None] * len(wanted))
    grads = iter(grads)
    out = []
    for t in inputs:
        g = next(grads) if t.requires_grad else None
        if g is None and t.requires_grad:
            g = torch.zeros_like(t)
        out.append(g)
    return out


def inputs(device, width, height, depth, samples, **kw):
    """The canonical scene, seeded assets, the golden camera; its float
    leaves, other leaves, basis and config."""
    scene = tt.build_scene(tt.canonical_scene_spec(), device)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 256, 256),
                                   device)
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), width, height,
                                 device=device)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          shadow_samples=samples, **kw)
    leaves, rest = tt.partition(scene)
    return leaves, rest, basis, assets, cfg


def trainer_need(leaves):
    """The gradients a training step wants: the trained leaves, no basis."""
    mask = invrender.optimize_mask(leaves)
    return [mask[k] for k in leaves] + [False] * len(BASIS_FIELDS)


def grad_weights(height, width, seed=0, device="cpu"):
    g = np.random.default_rng(seed).uniform(size=(height, width, 3))
    return torch.from_numpy(g.astype(np.float32)).to(device)


def through_the_function(leaves, rest, basis, assets, cfg, grad_img, need):
    """Gradients of ``render_megakernel_diff`` by autograd, in
    ``replay_vjp``'s layout."""
    ins = [t.detach().clone().requires_grad_(w) for t, w in zip(
        [*leaves.values(), *(getattr(basis, f) for f in BASIS_FIELDS)],
        need)]
    n = len(leaves)
    img = tt.render_megakernel_diff(
        tt.combine(dict(zip(leaves, ins[:n])), rest), assets,
        PerspectiveBasis(*ins[n:]), cfg)
    wanted = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad(img, wanted, grad_img,
                                   allow_unused=True))
    return [next(got) if t.requires_grad else None for t in ins]


def records_of(leaves, rest, basis, assets, cfg):
    return render_megakernel_record(
        pack_scene(tt.combine(leaves, rest), basis), assets, cfg)[1]


def assert_equal_grads(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if g is not None:
            assert torch.equal(g, w), (i, float((g - w).abs().max()))


# ---------------------------------------------------------------------------
# the CPU: replay_vjp, the key, the capture's rules
# ---------------------------------------------------------------------------

VJP_CASES = {"32x24-d3-ss2": dict(samples=2, need="all"),
             "32x24-d3-ss2-bilinear-trained": dict(
                 samples=2, need="trainer", filter="bilinear")}


@pytest.mark.parametrize("case", VJP_CASES)
def test_replay_vjp_is_the_backward_bit_for_bit(case):
    kw = dict(VJP_CASES[case])
    samples, need_of = kw.pop("samples"), kw.pop("need")
    leaves, rest, basis, assets, cfg = inputs("cpu", 32, 24, 3, samples,
                                              **kw)
    need = ([True] * (len(leaves) + len(BASIS_FIELDS)) if need_of == "all"
            else trainer_need(leaves))
    grad_img = grad_weights(24, 32)
    captures = diff.replay_graph.captures
    via_function = through_the_function(leaves, rest, basis, assets, cfg,
                                        grad_img, need)
    records = records_of(leaves, rest, basis, assets, cfg)
    got = diff.replay_vjp(leaves, basis, rest, records, grad_img, assets,
                          cfg, 0, need)
    given_slots = diff.replay_vjp(leaves, basis, rest, records, grad_img,
                                  assets, cfg, 0, need,
                                  n_slots=record_slots(records))
    before = old_backward(leaves, basis, rest, records, grad_img, assets,
                          cfg, need)
    assert_equal_grads(got, via_function)
    assert_equal_grads(got, before)
    assert_equal_grads(given_slots, before)
    assert sum(g is not None for g in got) == sum(need)
    assert diff.replay_graph.captures == captures    # the CPU runs eagerly


def test_replay_vjp_matches_the_jax_replay():
    """``replay_vjp`` against ``jax.vjp`` of the JAX replay on the same
    records, 32x24 d3 ss2, leaf by leaf (``tests/test_torch_replay.py``'s
    bar)."""
    width, height = 32, 24
    scene, assets, basis, cfg = port_inputs(width, height, 3, 2)
    _, records = render_megakernel_record(pack_scene(scene, basis), assets,
                                          cfg)
    used = int(records["max_nodes"])
    leaves, rest = tt.partition(scene)
    img = replay_render(scene, assets, basis, records, cfg)

    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=3,
                                shadow_samples=2)
    jrecords = {"rec": jnp.asarray(records["rec"][:used].numpy()),
                "ssr": jnp.asarray(records["ssr"][:used].numpy()),
                "ev_idx": jnp.asarray(picks_in_event_order(
                    records["pick"][:used].numpy()))}
    d_scene, jrest = jdiff.partition(jscene)
    jimg, vjp = jax.vjp(
        lambda d, b: jax_replay_render(jdiff.combine(d, jrest),
                                       _assets_pair()[0], b, jrecords, jcfg),
        d_scene, tpuray.perspective_basis(_camera_pair()[0], width, height))
    agree = np.abs(img.numpy() - np.asarray(jimg)).max(-1) < AGREE_ABS
    assert agree.mean() > 0.99, f"replays agree on {agree.mean():.4f}"
    w = (np.random.default_rng(0).uniform(size=(height, width, 3))
         * agree[..., None]).astype(np.float32)
    g_scene, g_basis = vjp(jnp.asarray(w))

    need = [True] * (len(leaves) + len(BASIS_FIELDS))
    ours = diff.replay_vjp(leaves, basis, rest, records, torch.from_numpy(w),
                           assets, cfg, 0, need)
    theirs = [jax_leaf(g_scene, k) for k in leaves] \
        + [jax_leaf(g_basis, f) for f in BASIS_FIELDS]
    names = [*leaves, *(f"basis.{f}" for f in BASIS_FIELDS)]
    for name, g, want in zip(names, ours, theirs):
        g = g.numpy()
        assert g.shape == want.shape and np.isfinite(g).all(), name
        if g.size:
            scale = max(np.abs(want).max(), 1e-3)
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=GRAD_ATOL * scale, err_msg=name)


def _key_args(width=16, height=12):
    leaves, rest, basis, assets, cfg = inputs("cpu", width, height, 3, 0)
    records = records_of(leaves, rest, basis, assets, cfg)
    grad_img = grad_weights(height, width)
    need = trainer_need(leaves)
    return dict(leaves=leaves, basis=basis, rest=rest, records=records,
                grad_img=grad_img, assets=assets, cfg=cfg, row0=0, need=need,
                n_slots=record_slots(records))


def _changed(what):
    args = _key_args()
    if what == "need":
        args["need"] = [not w for w in args["need"]]
    elif what == "n_slots":
        args["n_slots"] -= 1
    elif what == "shape":
        args = _key_args(width=20)
    elif what == "assets":
        a = args["assets"]
        args["assets"] = tt.SceneAssets(a.textures.clone(), a.skybox)
    elif what == "epsilon":
        args["cfg"] = args["cfg"].replace(epsilon=args["cfg"].epsilon * 2)
    return args


@pytest.mark.parametrize("what", ["need", "n_slots", "shape", "assets",
                                  "epsilon"])
def test_replay_key_changes_with_the_captured_work(what):
    base = _key_args()
    assert diff.replay_key(**base) != diff.replay_key(**_changed(what))


def test_replay_key_ignores_the_values():
    """New values of the same shapes (the next step's leaves, records and
    gradient) keep the key: they are copied into the graph's inputs."""
    a = _key_args()
    b = dict(a, leaves={k: v + 1 for k, v in a["leaves"].items()},
             basis=PerspectiveBasis(*(getattr(a["basis"], f) * 2
                                      for f in BASIS_FIELDS)),
             records={k: v.clone() for k, v in a["records"].items()},
             grad_img=a["grad_img"] * 3)
    key = diff.replay_key(**a)
    assert diff.replay_key(**b) == key and hash(diff.replay_key(**b))
    assert key.n_slots == record_slots(a["records"])
    assert key.counts == (4, 2, 3, 0)


def test_replay_puts_no_host_data_on_the_device_and_reads_none_back(
        monkeypatch):
    """Given its slot count, ``replay_vjp`` makes no tensor from host data
    on a device (``torch.tensor``/``as_tensor`` with a device: a copy from
    pageable memory, which a capture refuses) and reads no value back
    (``item``, ``int``, ``float``, ``bool``, ``tolist``: a sync)."""
    leaves, rest, basis, assets, cfg = inputs("cpu", 24, 16, 3, 2)
    records = records_of(leaves, rest, basis, assets, cfg)
    n_slots = record_slots(records)
    made = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def spy(*a, _real=real, _name=name, **kw):
            if kw.get("device") is not None:
                made.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, spy)
    reads = []
    for name in ("item", "tolist", "__int__", "__float__", "__bool__",
                 "__index__"):
        real = getattr(torch.Tensor, name)

        def read(self, *a, _real=real, _name=name, **kw):
            reads.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    args = (leaves, basis, rest, records, grad_weights(16, 24), assets, cfg,
            0, trainer_need(leaves))
    grads = diff.replay_vjp(*args, n_slots=n_slots)
    assert not made, made
    assert not reads, reads
    diff.replay_vjp(*args)          # without its slot count it reads one
    monkeypatch.undo()
    assert reads == ["__int__"], reads
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    diff.replay_graph.release()
    yield torch.device("cuda")
    diff.replay_graph.release()


def moved(leaves, i):
    """The leaves after ``i`` made-up optimizer steps."""
    out = dict(leaves)
    out["light_origin"] = leaves["light_origin"] + 0.01 * i
    out["sphere_mat.rgb"] = leaves["sphere_mat.rgb"] * (1 - 0.02 * i)
    out["plane_mat.diffuse"] = leaves["plane_mat.diffuse"] * (1 + 0.03 * i)
    return out


def graph_and_eager(dev, leaves, rest, basis, assets, cfg, calls=3):
    """``calls`` backward calls through ``render_megakernel_diff`` with the
    leaves moved between them (the first eager, the second captures, the
    rest replay), and ``replay_vjp`` run eagerly on the same records."""
    need = trainer_need(leaves)
    before = (diff.replay_graph.captures, diff.replay_graph.replays)
    pairs = []
    for i in range(calls):
        now = moved(leaves, i)
        grad_img = grad_weights(cfg.height, cfg.width, seed=i, device=dev)
        graphed = through_the_function(now, rest, basis, assets, cfg,
                                       grad_img, need)
        records = records_of(now, rest, basis, assets, cfg)
        eager = diff.replay_vjp(now, basis, rest, records, grad_img, assets,
                                cfg, 0, need)
        pairs.append((graphed, eager))
    assert diff.replay_graph.captures == before[0] + 1
    assert diff.replay_graph.replays == before[1] + calls - 1
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 96, 3, 2), (512, 384, 3, 0)],
                         ids=lambda s: f"{s[0]}x{s[1]}-d{s[2]}-ss{s[3]}")
def test_graph_equals_eager_bit_for_bit(cuda, shape):
    width, height, depth, samples = shape
    leaves, rest, basis, assets, cfg = inputs(cuda, width, height, depth,
                                              samples)
    for graphed, eager in graph_and_eager(cuda, leaves, rest, basis, assets,
                                          cfg):
        assert_equal_grads(graphed, eager)
        assert any(g is not None and bool(g.abs().sum() > 0)
                   for g in graphed)


@pytest.mark.cuda
def test_graph_on_a_mesh_within_rounding(cuda):
    scene = tt.build_scene(mesh_benchmark_scene(4), cuda)
    assert scene.num_triangles == 7424
    leaves, rest = tt.partition(scene)
    _, _, basis, assets, cfg = inputs(cuda, 128, 96, 3, 0)
    for graphed, eager in graph_and_eager(cuda, leaves, rest, basis, assets,
                                          cfg):
        for g, w in zip(graphed, eager):
            if g is not None and w.numel():
                scale = max(float(w.abs().max()), 1e-30)
                assert float((g - w).abs().max()) <= MESH_GRAD_RTOL * scale


@pytest.mark.cuda
def test_a_new_key_drops_the_old_graph_and_its_pool(cuda):
    big = inputs(cuda, 512, 384, 3, 0)
    small = inputs(cuda, 64, 48, 3, 0)
    need = trainer_need(big[0])
    args = {}
    for name, (leaves, rest, basis, assets, cfg) in (("big", big),
                                                     ("small", small)):
        args[name] = (leaves, basis, rest,
                      records_of(leaves, rest, basis, assets, cfg),
                      grad_weights(cfg.height, cfg.width, device=cuda),
                      assets, cfg, 0, need)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    for _ in range(3):
        diff.replay_graph.vjp(*args["big"])
    big_key = diff.replay_graph.key
    assert big_key is not None and big_key.width == 512
    held = torch.cuda.memory_reserved()
    assert held > reserved0
    diff.replay_graph.vjp(*args["small"])      # eager: drops the graph
    assert diff.replay_graph.key is None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    assert reserved <= reserved0 * (1 + RESERVED_RTOL), (reserved0, held,
                                                         reserved)
    captures = diff.replay_graph.captures
    diff.replay_graph.vjp(*args["small"])      # captures the new key
    assert diff.replay_graph.captures == captures + 1
    assert diff.replay_graph.key.width == 64


@pytest.mark.cuda
def test_a_failed_capture_raises_naming_the_key(cuda, monkeypatch):
    leaves, rest, basis, assets, cfg = inputs(cuda, 64, 48, 3, 0)
    args = (leaves, basis, rest, records_of(leaves, rest, basis, assets, cfg),
            grad_weights(48, 64, device=cuda), assets, cfg, 0,
            trainer_need(leaves))
    real = diff.replay_vjp

    def syncs(*a, **kw):
        out = real(*a, **kw)
        float(next(g for g in out if g is not None).sum())   # a read back
        return out
    monkeypatch.setattr(diff, "replay_vjp", syncs)
    diff.replay_graph.vjp(*args)               # eager: the read is allowed
    with pytest.raises(RuntimeError, match="capturing the replay's CUDA "
                                           "graph failed, key ReplayKey"):
        diff.replay_graph.vjp(*args)
    assert diff.replay_graph.key is None
    monkeypatch.undo()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_nan_guard_runs_the_replay_eagerly(cuda):
    from tpuray_torch.utils.debug import nan_guard

    leaves, rest, basis, assets, cfg = inputs(cuda, 64, 48, 3, 0)
    need = trainer_need(leaves)
    captures = diff.replay_graph.captures
    grad_img = grad_weights(48, 64, device=cuda)
    with nan_guard():
        got = [through_the_function(leaves, rest, basis, assets, cfg,
                                    grad_img, need) for _ in range(3)]
    assert diff.replay_graph.captures == captures
    for g in got[1:]:
        assert_equal_grads(g, got[0])


@pytest.mark.cuda
def test_threads_share_one_capture(cuda):
    """Four threads calling at once, with a short switch interval: one
    capture, and every call's gradients equal the eager ones."""
    leaves, rest, basis, assets, cfg = inputs(cuda, 64, 48, 3, 0)
    args = (leaves, basis, rest, records_of(leaves, rest, basis, assets, cfg),
            grad_weights(48, 64, device=cuda), assets, cfg, 0,
            trainer_need(leaves))
    want = diff.replay_vjp(*args)
    captures = diff.replay_graph.captures
    results, errors = [], []

    def work():
        try:
            for _ in range(3):
                results.append(diff.replay_graph.vjp(*args))
        except Exception as e:      # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 12
    assert diff.replay_graph.captures == captures + 1
    torch.cuda.synchronize()
    for got in results:
        assert_equal_grads(got, want)
