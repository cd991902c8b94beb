"""The port's triangle path below the image: the triangle primitives against
the JAX package's, the triangle tables (``kernels/triblocks.py``), the tree
walk that ``chip_smoke.py`` counts the kernel's work with, the triangle cap,
and record mode with the replay on the JAX package's small mixed scene
(``tests/test_pallas_vjp.py:31-55``), held against the JAX record, the JAX
replay and the XLA tracer.

Tolerances: primitives within 1e-6 (the same f32 operations; XLA may sum a
dot in another order); record codes and triangle ids equal on at least
99.9% of the pixels that are not chaotic (the JAX kernel's triangle t is a
bf16x3 product on the MXU, so a chaotic edge pixel may take another
triangle); the replay against the port's record image at mean < 2e-3, max
< 1e-1, and the gradients at 2e-2 * max|g| per leaf, the bars of
``tests/test_pallas_vjp.py:96-97`` and ``:336-341``.
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
from tpuray.meshes import mesh_benchmark_scene as jax_mesh_benchmark_scene
from tpuray.render import render_from_basis_xla

import chip_smoke
import tpuray_torch as tt
from tpuray_torch.kernels import primitives as pr
from tpuray_torch.kernels import triblocks
from tpuray_torch.kernels.megakernel import (pack_scene,
                                             render_megakernel_record)
from tpuray_torch.kernels.replay import replay_render
from tpuray_torch.meshes import add_mesh, mesh_benchmark_scene
from test_torch_cuda import many_triangles, tie_triangles
from test_torch_megakernel import (AGREE_FRAC, _assets_pair, chaotic_pixels,
                                   jax_scene_arrays)
from test_torch_record import decode, picks_in_event_order

REPLAY_MEAN = 2e-3
REPLAY_MAX = 1e-1
GRAD_ATOL = 2e-2
AGREE_ABS = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _triangle_rays(seed, n=4096):
    """Rays from random origins at random triangles: aimed at random points
    inside, at the vertices and edge midpoints (where Möller–Trumbore
    decides on a rounding), past the triangles, and at degenerate and
    edge-on triangles."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (rng.uniform(-2, 2, (n, 3)).astype(np.float32)
                  for _ in range(3))
    v2[:64] = v0[:64] + 0.5 * (v1[:64] - v0[:64])          # degenerate
    bary = rng.dirichlet((1, 1, 1), n).astype(np.float32)
    target = bary[:, 0:1] * v0 + bary[:, 1:2] * v1 + bary[:, 2:3] * v2
    target[64:256] = v0[64:256]
    target[256:512] = 0.5 * (v1[256:512] + v2[256:512])
    target[512:1024] += rng.normal(size=(512, 3)).astype(np.float32)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[1024:1088] = target[1024:1088] + 2.0 * (v1 - v0)[1024:1088]  # edge-on
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[2048:2304] *= -1.0                                  # behind the origin
    return o, d, v0, v1, v2


def test_triangle_primitives_match_jax():
    o, d, v0, v1, v2 = _triangle_rays(1)
    hit_t, t_t = pr.intersect_triangle(_t(o), _t(d), _t(v0), _t(v1), _t(v2))
    hit_j, t_j = jpr.intersect_triangle(*map(jnp.asarray, (o, d, v0, v1, v2)))
    hit_j, t_j = np.asarray(hit_j), np.asarray(t_j)
    assert (hit_t.numpy() == hit_j).mean() >= 0.999
    both = hit_t.numpy() & hit_j
    assert both.sum() > 1000 and (~hit_j).sum() > 500
    np.testing.assert_allclose(t_t.numpy()[both], t_j[both], rtol=1e-5,
                               atol=1e-6)
    # the edge form the kernel reads gives the same answers
    hit_e, t_e = pr.intersect_triangle_edges(_t(o), _t(d), _t(v0),
                                             _t(v1 - v0), _t(v2 - v0))
    assert torch.equal(hit_e, hit_t) and torch.equal(t_e, t_t)
    for ours, theirs in (
            (pr.cross3(_t(v0), _t(v1)), jpr.cross3(v0, v1)),
            (pr.length3(_t(v2)), jpr.length3(v2)),
            (pr.distance3(_t(v0), _t(v2)), jpr.distance3(v0, v2))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the tables and the tree walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 3])
def test_triangle_tables_cover_the_mesh(order):
    """Each block's box covers its triangles (test_pallas_engine.py:292-305)
    and each node's box covers its children's (:307-321), up to the root;
    the normals and materials are the JAX package's."""
    jscene = tpuray.build_scene(jax_mesh_benchmark_scene(order))
    scene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    tris = triblocks.build_tri_tables(scene)
    n = scene.num_triangles
    nblk = -(-n // tris.block)
    assert tris.level_n[-1] == nblk and tris.level_n[0] == 1
    for upper, lower in zip(tris.level_n, tris.level_n[1:]):
        assert upper == -(-lower // tris.fanout)
    verts = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
    blocks = tris.level(len(tris.level_n) - 1)
    owner = torch.arange(n) // tris.block
    assert (blocks[owner, None, 0:3] <= verts).all()
    assert (blocks[owner, None, 4:7] >= verts).all()
    for level in range(len(tris.level_n) - 1):
        up, down = tris.level(level), tris.level(level + 1)
        parent = torch.arange(down.shape[0]) // tris.fanout
        assert (up[parent, 0:3] <= down[:, 0:3]).all()
        assert (up[parent, 4:7] >= down[:, 4:7]).all()
    flat = verts.reshape(-1, 3)
    root = tris.level(0)[0]
    assert (root[0:3] < flat.min(0).values).all()
    assert (root[4:7] > flat.max(0).values).all()
    # the geometry rows and the winner attributes
    np.testing.assert_array_equal(tris.v0.numpy(), scene.tri_v0.numpy())
    np.testing.assert_array_equal(tris.e2.numpy(),
                                  (scene.tri_v2 - scene.tri_v0).numpy())
    e1 = np.asarray(jscene.tri_v1) - np.asarray(jscene.tri_v0)
    e2 = np.asarray(jscene.tri_v2) - np.asarray(jscene.tri_v0)
    np.testing.assert_allclose(
        tris.attr[:, 0:3].numpy(),
        np.asarray(jpr.normalize3(jpr.cross3(e1, e2))), atol=1e-6)
    np.testing.assert_allclose(tris.attr[:, 3:6].numpy(),
                               np.asarray(jscene.tri_mat.rgb))
    assert not tris.transparent.any()


def _flat_grid_scene():
    """A mesh scene plus a grid of axis-aligned triangles in the plane
    y = 1.25, whose boxes have no thickness, and a glass torus."""
    spec = mesh_benchmark_scene(1, (16, 8))
    for tri in spec.triangles[80:]:
        tri.material = tt.GLASS
    xs = np.linspace(-2.0, 2.0, 9)
    verts = np.array([(x, 1.25, z) for x in xs for z in xs])
    faces = [[i * 9 + j, i * 9 + j + 1, (i + 1) * 9 + j]
             for i in range(8) for j in range(8)]
    add_mesh(spec, verts, np.array(faces), tt.PLASTIC)
    return tt.build_scene(spec, "cpu")


def test_tree_walk_answers_as_brute_force_does():
    """``chip_smoke.TreeSearch`` walks the kernel's tree with the kernel's
    slab arithmetic: its closest hits, winner ids, light occlusion, feeler
    blocks and crossings equal brute force on rays aimed at vertices, at
    edges and at flat axis-aligned triangles, so no cull hides a hit; its
    pair count stays below the brute force's."""
    scene = _flat_grid_scene()
    tris = triblocks.build_tri_tables(scene)
    rng = np.random.default_rng(2)
    n = 6000
    pts = torch.cat([scene.tri_v0, scene.tri_v1,
                     0.5 * (scene.tri_v1 + scene.tri_v2)])
    target = pts[torch.from_numpy(rng.integers(0, pts.shape[0], n))]
    o = torch.from_numpy(rng.uniform(-5, 5, (n, 3)).astype(np.float32))
    o[:1000, 1] = 1.25                       # in the flat triangles' plane
    d = pr.normalize3(target - o)
    lt = torch.from_numpy(rng.uniform(0.5, 12, n).astype(np.float32))
    lt[::3] = float("inf")
    bt = torch.from_numpy(rng.uniform(1, 20, n).astype(np.float32))
    bt[::2] = float("inf")
    walk = chip_smoke.TreeSearch(tris, chunk=2048)
    brute = triblocks.BruteForce(tris)
    (t_w, wid_w, lb_w), (t_b, wid_b, lb_b) = (
        search.closest(o, d, lt, bt) for search in (walk, brute))
    # a triangle beyond the closest analytic solid (bt) cannot win, and the
    # walk does not look for one
    won = t_b < bt
    assert won.sum() > 1000 and lb_b.any()
    assert torch.equal(t_w < bt, won)
    assert torch.equal(t_w[won], t_b[won])
    assert torch.equal(wid_w[won], wid_b[won])
    # light occlusion matters only where a light was hit (lt finite)
    lit = torch.isfinite(lt)
    assert torch.equal(lb_w[lit], lb_b[lit])
    tmax = torch.from_numpy(rng.uniform(0.5, 12, n).astype(np.float32))
    blocked_w, count_w = walk.blocked(o, d, tmax)
    blocked_b, count_b = brute.blocked(o, d, tmax)
    assert torch.equal(blocked_w, blocked_b)
    assert torch.equal(count_w[~blocked_w], count_b[~blocked_b])
    assert blocked_b.any() and (count_b > 0).any()
    assert 0 < walk.pairs < 2 * n * tris.n and walk.boxes > 0
    # the kernels' walk, in its order and in the id order it replaced, by a
    # thread alone and by a group of lanes
    for order in ("nearest", "id"):
        for group in (1, 16):
            kernel_walk = chip_smoke.WalkCount(tris, order, group)
            t_k, wid_k, lb_k = kernel_walk.closest(o, d, lt, bt)
            assert torch.equal(t_k < bt, won)
            assert torch.equal(t_k[won], t_b[won])
            assert torch.equal(wid_k[won], wid_b[won])
            assert torch.equal(lb_k[lit], lb_b[lit])
            blocked_k, count_k = kernel_walk.blocked(o, d, tmax)
            assert torch.equal(blocked_k, blocked_b)
            assert torch.equal(count_k[~blocked_k], count_b[~blocked_b])
            assert kernel_walk.totals["pairs"] < 2 * n * tris.n


@pytest.mark.parametrize("order", ["nearest", "id"])
@pytest.mark.parametrize("group", [1, 16])
def test_walk_takes_the_lowest_id_among_ties(order, group):
    """On the tie mesh (duplicated and coplanar triangles, the nearer box
    holding the higher ids) the walk's closest hits and winners, and its
    blocker flags and counts with tmax past and exactly at the hit, equal
    brute force: the lowest id wins among equal t whatever the order."""
    v0, v1, v2, transp, o, d = (torch.from_numpy(x)
                                for x in tie_triangles())
    tables = triblocks.build_query_tables(v0, v1, v2, transp)
    brute = triblocks.BruteForce(tables)
    walk = chip_smoke.WalkCount(tables, order, group)
    t, wid, _ = brute.closest(o, d)
    inf = torch.full_like(t, float("inf"))
    t_w, wid_w, _ = walk.closest(o, d, -inf, inf)
    hit = torch.isfinite(t)
    assert torch.equal(t_w, t) and torch.equal(wid_w, wid)
    # the duplicates in the nearer box lose to the lower ids
    assert int(hit.sum()) > 1000 and bool((wid[hit] // 16 % 2 == 0).all())
    for tmax in (t * 1.5, t):
        tmax = torch.where(hit, tmax, torch.full_like(t, 4.0))
        for inclusive in (False, True):
            blocked, count = brute.blocked(o, d, tmax, inclusive)
            blocked_w, count_w = walk.blocked(o, d, tmax, inclusive=inclusive)
            assert torch.equal(blocked_w, blocked)
            assert torch.equal(count_w[~blocked], count[~blocked])


def test_cap_is_checked_before_building():
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    basis = tt.perspective_basis(tt.Camera((0, 1, -3), (0, 0, 1), 90.0, 1.0),
                                 8, 4, device="cpu")
    cap = triblocks.TRI_MAX_TRIANGLES
    with pytest.raises(ValueError, match="524,288"):
        pack_scene(many_triangles(scene, cap + 1), basis)
    with pytest.raises(ValueError, match="524,288"):
        replay_render(many_triangles(scene, cap + 1), None, basis, {},
                      tt.RenderConfig(width=8, height=4))
    packed = pack_scene(many_triangles(scene, 1000), basis)
    assert packed.tris.n == 1000 and packed.tris.level_n == (1, 8, 63)
    # the cap itself builds, within the levels the kernel takes
    packed = pack_scene(many_triangles(scene, cap), basis)
    assert packed.tris.level_n == (1, 8, 64, 512, 4096, 32768)
    assert len(packed.tris.level_n) <= triblocks.TRI_MAX_LEVELS


# ---------------------------------------------------------------------------
# record mode, replay and gradients on the JAX package's mixed scene
# ---------------------------------------------------------------------------

def _tri_spec(mod):
    """tests/test_pallas_vjp.py:31-55: two triangles, a ground plane, a
    glass sphere and a light, built with package ``mod``."""
    return mod.SceneSpec(
        spheres=[mod.SphereSpec((1.5, 0.7, 2.5), 0.7, mod.GLASS)],
        planes=[mod.PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                              mod.PLASTIC.replace(rgb=(0.4, 0.4, 0.4)))],
        triangles=[
            mod.TriangleSpec((-1.2, 0.1, 3.0), (0.2, 0.2, 3.2),
                             (-0.5, 1.6, 2.8),
                             mod.PLASTIC.replace(rgb=(0.9, 0.3, 0.2))),
            mod.TriangleSpec((0.0, 0.1, 2.0), (1.0, 0.1, 2.4),
                             (0.6, 1.2, 2.2),
                             mod.PLASTIC.replace(rgb=(0.2, 0.8, 0.3),
                                                 reflectivity=0.3)),
        ],
        lights=[mod.LightSpec((0.5, 4.0, 0.0), 0.1, 40.0, (1.0, 1.0, 1.0))])


class TriPair:
    """The mixed scene at 48x32 depth 2 in both packages; the JAX record
    in Pallas interpret mode, the port's on the CPU."""
    width, height, depth = 48, 32, 2

    def __init__(self):
        w, h = self.width, self.height
        self.jscene = tpuray.build_scene(_tri_spec(tpuray))
        self.scene = tt.scene_from_arrays(jax_scene_arrays(self.jscene),
                                          "cpu")
        self.jassets, self.assets = _assets_pair()
        cam = ((0.0, 1.0, -3.0), (0.0, 0.0, 1.0), 90.0, 1.0)
        self.jbasis = tpuray.perspective_basis(tpuray.Camera(*cam), w, h)
        self.basis = tt.perspective_basis(tt.Camera(*cam), w, h,
                                          device="cpu")
        self.jcfg = jconfig.RenderConfig(width=w, height=h,
                                         max_depth=self.depth, chunk_size=0,
                                         loop="scan")
        self.cfg = tt.RenderConfig(width=w, height=h, max_depth=self.depth)
        jimg, jrec = jpt.render_pallas_record(self.jscene, self.jassets,
                                              self.jbasis, self.jcfg,
                                              interpret=True)
        self.jimg, self.jrec = np.asarray(jimg), jax.device_get(jrec)
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
def tri_pair():
    return TriPair()


def test_triangle_records_match_jax():
    p = tri_pair()
    ours, theirs = p.rec["rec"], p.jrec["rec"]
    code, _, _, _ = decode(ours)
    jcode, _, _, _ = decode(theirs)
    tri = (code == triblocks.TRI_CODE) & (ours >= 0)
    assert tri.any(0).mean() > 0.02, "the triangles cover too few pixels"
    for name, a, b in zip(("code", "parent slot", "branch", "valid"),
                          decode(ours), decode(theirs)):
        same = (a == b).all(0)[p.stable]
        assert same.mean() >= AGREE_FRAC, name
    # the JAX kernel packs the winner's 15-bit id above the parent byte
    jwid = np.where(jcode == triblocks.TRI_CODE, (theirs >> 16) & 0x7FFF, -1)
    jwid = np.where(theirs >= 0, jwid, -1)
    same = (p.rec["wid"] == jwid).all(0)[p.stable]
    assert same.mean() >= AGREE_FRAC
    assert ((p.rec["wid"] >= 0) == tri).all()
    assert set(np.unique(p.rec["wid"])) == {-1, 0, 1}


def test_triangle_replay_reproduces_the_record_image():
    p = tri_pair()
    rep = replay_render(p.scene, p.assets, p.basis, p.records, p.cfg)
    d = np.abs(rep.numpy() - p.img)
    assert d.mean() < REPLAY_MEAN, f"mean|d| {d.mean()}"
    assert d.max() < REPLAY_MAX, f"max|d| {d.max()}"


def test_records_without_triangles_have_an_empty_id_plane():
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    basis = tt.perspective_basis(tt.Camera((0.8, 2.5, -8.0), (0.2, 0, 1),
                                           90.0, 1.0), 16, 8, device="cpu")
    _, rec = render_megakernel_record(
        pack_scene(scene, basis), _assets_pair()[1],
        tt.RenderConfig(width=16, height=8, max_depth=3))
    assert rec["wid"].shape == rec["rec"].shape
    assert (rec["wid"] == -1).all()


def _jax_leaf(tree, name):
    for part in name.split("."):
        tree = getattr(tree, part)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def tri_grads():
    """Gradients of sum(image * w) with respect to the scene's float
    leaves: the port's replay and the JAX replay on the port's records, and
    the XLA tracer; w is seeded and zero where the images disagree."""
    p = tri_pair()
    used = int(p.records["max_nodes"])
    records = {k: v[:used] for k, v in p.records.items() if k != "max_nodes"}
    records["max_nodes"] = p.records["max_nodes"]
    jrecords = {"rec": jnp.asarray(records["rec"].numpy()),
                "ssr": jnp.asarray(records["ssr"].numpy()),
                "wid": jnp.asarray(records["wid"].numpy()),
                "ev_idx": jnp.asarray(picks_in_event_order(
                    records["pick"].numpy()))}
    d_scene, rest = jdiff.partition(p.jscene)
    jimg, jvjp = jax.vjp(
        lambda d: jax_replay_render(jdiff.combine(d, rest), p.jassets,
                                    p.jbasis, jrecords, p.jcfg), d_scene)
    ximg, xvjp = jax.vjp(
        lambda d: render_from_basis_xla(jdiff.combine(d, rest), p.jassets,
                                        p.jbasis, p.jcfg), d_scene)
    params = {k: v.clone().requires_grad_()
              for k, v in tt.partition(p.scene)[0].items()}
    img = replay_render(tt.combine(params, tt.partition(p.scene)[1]),
                        p.assets, p.basis, records, p.cfg)
    ours_img = img.detach().numpy()
    agree = ((np.abs(ours_img - np.asarray(jimg)).max(-1) < AGREE_ABS)
             & (np.abs(ours_img - np.asarray(ximg)).max(-1) < AGREE_ABS))
    assert agree.mean() > 0.9, f"images agree on {agree.mean():.4f}"
    w = (np.random.default_rng(1).uniform(size=ours_img.shape)
         * agree[..., None]).astype(np.float32)
    (g_rep,) = jvjp(jnp.asarray(w))
    (g_xla,) = xvjp(jnp.asarray(w))
    ours = torch.autograd.grad(img, list(params.values()),
                               torch.from_numpy(w), allow_unused=True)
    return {name: (np.zeros_like(_jax_leaf(g_rep, name)) if g is None
                   else g.numpy(), _jax_leaf(g_rep, name),
                   _jax_leaf(g_xla, name))
            for name, g in zip(params, ours)}


@pytest.mark.parametrize("oracle", ["jax_replay", "xla_tracer"])
def test_triangle_replay_grads_match(tri_grads, oracle):
    for name, (ours, g_rep, g_xla) in tri_grads.items():
        theirs = g_rep if oracle == "jax_replay" else g_xla
        assert ours.shape == theirs.shape, name
        assert np.isfinite(ours).all(), name
        if ours.size == 0:
            continue
        scale = max(np.abs(theirs).max(), 1e-3)
        np.testing.assert_allclose(ours, theirs, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=name)


@pytest.mark.parametrize("name", ["tri_v0", "tri_v1", "tri_v2",
                                  "tri_mat.diffuse", "tri_mat.rgb"])
def test_triangle_grads_reach_vertices_and_materials(tri_grads, name):
    assert np.abs(tri_grads[name][0]).sum() > 0, name
