"""The plain version of the port's triangle-query kernel (K6,
``kernels/query.py``) held against the JAX query kernels in Pallas interpret
mode, the JAX tracer's XLA scan and the f64 Möller–Trumbore oracle of
``tests/test_tri_query.py``; and the tracer's use of its wrappers.

Inputs: ``mesh_benchmark_scene(1)`` (2,384 triangles, every third one made
transparent) and 300 rays (a count that is no multiple of a tile) from
random origins, every other one aimed near a triangle, some with a zero
direction.  Tolerances: the same hit set as the oracle; t within 2e-3 of
the oracle (the JAX kernel is bf16x3, ROADMAP C hazard 4) and within 1e-6
relative of the XLA scan, which does the same f32 arithmetic; winner ids
equal where the oracle's closest t is unique; blocked flags equal away from
tmax (|t - tmax| > 1e-3), inclusive and strict; crossing counts equal where
the ray is not blocked (the kernel stops at the first opaque triangle).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
from tpuray.kernels import pallas_trace as jpt
from tpuray.kernels import trace as jtrace
from tpuray.meshes import mesh_benchmark_scene

import tpuray_torch as tt
from tpuray_torch.kernels import query
from tpuray_torch.kernels.trace import TriangleQueries
from tpuray_torch.kernels.triblocks import (TRI_QUERY_MAX_TRIANGLES,
                                            build_query_tables)
from test_torch_cuda import query_rays
from test_torch_megakernel import jax_scene_arrays

T_ORACLE = 2e-3
T_SCAN_REL = 1e-6
NEAR_TMAX = 1e-3


def mt_oracle(v0, v1, v2, o, d):
    """Brute-force Möller–Trumbore in f64 (tests/test_tri_query.py:37-55):
    t [P, T], inf where a ray misses a triangle."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(v1, np.float64) - v0
    e2 = np.asarray(v2, np.float64) - v0
    o = np.asarray(o, np.float64)[:, None, :]
    d = np.asarray(d, np.float64)[:, None, :]
    p = np.cross(d, e2[None])
    det = (p * e1[None]).sum(-1)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    tv = o - v0[None]
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1[None])
    v = (d * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    return np.where(hit, t, np.inf)


@functools.lru_cache(maxsize=None)
def inputs():
    """(JAX scene, port tables, o, d, tmax, the oracle's t [P, T]), every
    third triangle transparent on both sides."""
    jscene = tpuray.build_scene(mesh_benchmark_scene(1))
    transp = np.asarray(jscene.tri_mat.transparent).copy()
    transp[::3] = True
    jscene = jscene._replace(tri_mat=jscene.tri_mat._replace(
        transparent=jnp.asarray(transp)))
    scene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    tables = build_query_tables(scene.tri_v0, scene.tri_v1, scene.tri_v2,
                                scene.tri_mat.transparent)
    o, d, tmax = query_rays(tables, "cpu")
    oracle = mt_oracle(jscene.tri_v0, jscene.tri_v1, jscene.tri_v2,
                       o.numpy(), d.numpy())
    return jscene, tables, o, d, tmax, oracle


def test_tables_keep_the_scene_triangles_and_have_no_cap():
    _, tables, *_ = inputs()
    jscene = inputs()[0]
    assert tables.attr is None and tables.n == 2384
    np.testing.assert_array_equal(tables.v0.numpy(),
                                  np.asarray(jscene.tri_v0))
    np.testing.assert_array_equal(tables.transparent.numpy(),
                                  np.asarray(jscene.tri_mat.transparent))
    assert TRI_QUERY_MAX_TRIANGLES == 16 * 8 ** 7
    with pytest.raises(ValueError, match="query tables"):
        build_query_tables(*(torch.zeros(0, 3),) * 3, torch.zeros(0))


def test_closest_matches_oracle_jax_kernel_and_xla_scan():
    jscene, tables, o, d, _, oracle = inputs()
    before = query.tri_query_closest.launches
    t, wid = query.tri_query_closest(tables, o, d)
    assert query.tri_query_closest.launches == before   # plain on the CPU
    t, wid = t.numpy(), wid.numpy()
    assert t.dtype == np.float32 and wid.dtype == np.int32
    t_ref = oracle.min(1)
    hit = np.isfinite(t_ref)
    assert hit.sum() > 100 and (~hit).sum() > 50
    assert np.array_equal(np.isfinite(t), hit)
    assert (wid[~hit] == -1).all() and (wid[hit] >= 0).all()
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=T_ORACLE,
                               atol=T_ORACLE)
    assert not np.isfinite(t[::37]).any()       # zero directions miss

    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    t_k, _ = jpt.tri_query_closest(jscene, jo, jd, interpret=True)
    assert np.array_equal(np.isfinite(np.asarray(t_k)), hit)
    np.testing.assert_allclose(t[hit], np.asarray(t_k)[hit], rtol=T_ORACLE,
                               atol=T_ORACLE)
    t_s, i_s = jtrace._tri_closest(jscene, jo, jd)
    t_s, i_s = np.asarray(t_s), np.asarray(i_s)
    assert np.array_equal(np.isfinite(t_s), hit)
    np.testing.assert_allclose(t[hit], t_s[hit], rtol=T_SCAN_REL, atol=0)
    unique = hit & ((oracle <= t_ref[:, None] + 1e-6).sum(1) == 1)
    assert unique.sum() > 100
    np.testing.assert_array_equal(wid[unique], i_s[unique])
    np.testing.assert_array_equal(wid[unique], oracle.argmin(1)[unique])


@pytest.mark.parametrize("inclusive", [False, True], ids=["strict",
                                                          "inclusive"])
def test_blocker_matches_oracle_jax_kernel_and_xla_scan(inclusive):
    jscene, tables, o, d, tmax, oracle = inputs()
    blocked, count = query.tri_query_blocker(tables, o, d, tmax, inclusive)
    blocked, count = blocked.numpy(), count.numpy()
    tm = tmax.numpy()
    transp = np.asarray(jscene.tri_mat.transparent)
    within = oracle <= tm[:, None] if inclusive else oracle < tm[:, None]
    within &= (tm > 0)[:, None]
    want_blocked = (within & ~transp[None]).any(1)
    want_count = (within & transp[None]).sum(1)
    clear = (np.abs(oracle - tm[:, None]) > NEAR_TMAX).all(1)
    assert clear.mean() > 0.9
    assert want_blocked[clear].sum() > 30 and want_count[clear].sum() > 10
    np.testing.assert_array_equal(blocked[clear], want_blocked[clear])
    free = clear & ~want_blocked
    np.testing.assert_array_equal(count[free], want_count[free])
    assert not blocked[tm <= 0].any() and (count[tm <= 0] == 0).all()

    jo, jd, jt = (jnp.asarray(x.numpy()) for x in (o, d, tmax))
    b_k, c_k = jpt.tri_query_blocker(jscene, jo, jd, jt, inclusive,
                                     interpret=True)
    np.testing.assert_array_equal(blocked[clear], np.asarray(b_k)[clear])
    np.testing.assert_array_equal(count[free], np.asarray(c_k)[free])
    t_count = jscene.num_triangles
    pad = (-t_count) % jtrace._TRI_TILE      # the scan's tiles, trace.py:377
    b_s, c_s = jtrace._tri_blocker_arrays(
        *(jnp.pad(v, ((0, pad), (0, 0))) for v in (
            jscene.tri_v0, jscene.tri_v1, jscene.tri_v2)),
        jnp.pad(jscene.tri_mat.transparent, (0, pad)), np.int32(t_count),
        jo, jd, jt, inclusive)
    np.testing.assert_array_equal(blocked[clear], np.asarray(b_s)[clear])
    np.testing.assert_array_equal(count[free], np.asarray(c_s)[free])


def test_tracer_queries_go_through_the_wrappers(monkeypatch):
    """The tracer asks the query wrappers, which pick the plain version from
    the rays' device (no launch on the CPU) and refuse rays they cannot
    take."""
    jscene, tables, o, d, tmax, _ = inputs()
    calls = []
    wrappers = {name: getattr(query, name)
                for name in ("tri_query_closest", "tri_query_blocker")}
    before = {name: fn.launches for name, fn in wrappers.items()}

    def spy(name):
        def wrapped(*args):
            calls.append(name)
            return wrappers[name](*args)
        return wrapped

    for name in wrappers:
        monkeypatch.setattr(query, name, spy(name))
    scene = tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    tris = TriangleQueries(scene)
    t, wid = tris.closest(o, d)
    want_t, want_wid = query.tri_query_closest_reference(tables, o, d)
    assert torch.equal(t, want_t) and torch.equal(wid, want_wid)
    blocked, count = tris.blocker(o, d, tmax, True)
    want_b, want_c = query.tri_query_blocker_reference(tables, o, d, tmax,
                                                       True)
    assert torch.equal(blocked, want_b) and torch.equal(count, want_c)
    calls.clear()
    cfg = tt.RenderConfig(width=8, height=4, max_depth=2, shadow_samples=1)
    basis = tt.perspective_basis(tt.Camera((0.0, 2.0, -8.0), (0.0, 0.0, 1.0),
                                           60.0, 1.0), 8, 4, device="cpu")
    ro, rd = tt.generate_rays(basis, 8, 4)
    img = tt.trace_rays(scene, tt.solid_assets(device="cpu"), ro, rd,
                        torch.arange(32), cfg)
    assert torch.isfinite(img).all()
    assert set(calls) == set(wrappers)
    assert {name: fn.launches for name, fn in wrappers.items()} == before
    with pytest.raises(ValueError, match="contiguous f32"):
        tris.closest(o.double(), d.double())
    with pytest.raises(ValueError, match="share a device"):
        tris.blocker(o.to("meta"), d.to("meta"), tmax.to("meta"), False)
