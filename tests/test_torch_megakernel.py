"""The plain version of the port's megakernel held against the JAX
megakernel in Pallas interpret mode, on the canonical scene; and the
primitives the kernel is built from, held against the JAX package's.

Tolerance for a render: at least 99.9% of pixels within 1e-3 (largest
channel), mean |d| < 1e-4, no NaN, JAX ``dropped == 0``.  The port adds
texels in line where JAX adds them in a post-pass (another summation
order), and XLA's CPU ``rsqrt`` differs from PyTorch's in the last bit for
about a third of its inputs.  That moves some pixels far: grazing sphere
hits and texel edges, whose float32 answer is itself unstable.  Such a
pixel is *chaotic*: the port's own value moves by >= 1e-3 when one
component of the camera basis moves by one ulp.  The bar is applied to the
pixels that are not chaotic, and chaotic pixels must stay under 2%.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuray
from tpuray import config as jconfig
from tpuray.kernels import primitives as jpr
from tpuray.kernels import pallas_trace as jpt
from tpuray.textures import SceneAssets as JaxAssets

import tpuray_torch as tt
from tpuray_torch.kernels import primitives as pr
from tpuray_torch.kernels.megakernel import (MAX_DEPTH_CAP, _check_inputs,
                                             pack_scene, render_megakernel,
                                             render_megakernel_record,
                                             render_megakernel_reference)
from tpuray_torch.kernels.triblocks import TRI_MAX_TRIANGLES
from test_torch_cuda import many_triangles

AGREE_ABS = 1e-3
AGREE_FRAC = 0.999
MEAN_ABS = 1e-4
CHAOTIC_MAX = 0.02
ASSET_SEED = 0

# (width, height, max_depth, shadow_samples, frame_height, row0): a slab of
# `height` rows at `row0` of a `width` x `frame_height` golden-camera frame,
# through the spheres (glass, refraction, shadows), the textured floor and
# the mirror wall's reflections; 100x20 is a ragged tile.
CASES = [(128, 16, d, s, 96, 56) for d in (1, 3, 6) for s in (0, 2)] \
    + [(100, 20, 3, 2, 75, 44)]


def case_id(c):
    return f"{c[0]}x{c[1]}-d{c[2]}-ss{c[3]}"


def jax_scene_arrays(scene) -> dict:
    """A JAX ``Scene``'s leaves as numpy arrays under its field names."""
    out = {}
    for name, value in scene._asdict().items():
        if hasattr(value, "_asdict"):
            for k, v in value._asdict().items():
                out[f"{name}.{k}"] = np.asarray(v)
        else:
            out[name] = np.asarray(value)
    return out


@functools.lru_cache(maxsize=None)
def _jax_checked():
    # one jitted oracle per process: scenes of one layout share a compile
    return jax.jit(functools.partial(jpt.render_pallas_checked,
                                     interpret=True),
                   static_argnames=("cfg",))


def _assets_pair():
    tex, sky = tt.random_asset_arrays(ASSET_SEED)
    return (JaxAssets(jnp.asarray(tex), jnp.asarray(sky)),
            tt.assets_from_arrays(tex, sky, "cpu"))


def _camera_pair():
    args = (jconfig.GOLDEN_CAMERA_ORIGIN, jconfig.GOLDEN_CAMERA_LOOKDIR,
            jconfig.GOLDEN_CAMERA_FOV, jconfig.GOLDEN_CAMERA_FOCAL)
    return tpuray.Camera(*args), tt.Camera(*args)


def chaotic_pixels(render, basis, img) -> np.ndarray:
    """Pixels of ``img`` (rendered by ``render(basis)``) that move by
    >= AGREE_ABS when one component of the basis corner moves one ulp."""
    mask = np.zeros(img.shape[:2], bool)
    for k in range(3):
        for sign in (-1.0, 1.0):
            corner = basis.corner.clone()
            corner[k] = torch.nextafter(corner[k],
                                        torch.tensor(sign * np.inf))
            nudged = render(tt.PerspectiveBasis(
                corner=corner, origin=basis.origin, up=basis.up,
                right=basis.right, w_factor=basis.w_factor,
                h_factor=basis.h_factor))
            mask |= np.abs(nudged - img).max(-1) >= AGREE_ABS
    return mask


def assert_agrees(port, ref, chaotic, what=""):
    assert not np.isnan(port).any() and not np.isnan(ref).any(), what
    assert port.shape == ref.shape
    diff = np.abs(port - ref)
    bad = diff.max(-1) >= AGREE_ABS
    stable = ~chaotic
    msg = (f"{what}: {int(bad.sum())}/{bad.size} pixels differ by >= "
           f"{AGREE_ABS} ({int((bad & chaotic).sum())} of them chaotic, "
           f"{int(chaotic.sum())} chaotic in all), mean|d| {diff.mean():.3g}"
           f" over all pixels")
    assert chaotic.mean() < CHAOTIC_MAX, msg
    assert (~bad[stable]).mean() >= AGREE_FRAC, msg
    assert diff[stable].mean() < MEAN_ABS, msg


def check_render_parity(jscene, tscene, case):
    width, height, depth, samples, frame_h, row0 = case
    jassets, tassets = _assets_pair()
    jcam, tcam = _camera_pair()
    jbasis = tpuray.perspective_basis(jcam, width, frame_h)
    tbasis = tt.perspective_basis(tcam, width, frame_h, device="cpu")
    jcfg = jconfig.RenderConfig(width=width, height=height, max_depth=depth,
                                shadow_samples=samples)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                          shadow_samples=samples)
    ref, dropped, _ = _jax_checked()(jscene, jassets, jbasis, jcfg,
                                     row0=float(row0))
    assert int(dropped) == 0, "the JAX oracle dropped texel events"
    ref = np.asarray(ref)

    def render(basis):
        return render_megakernel_reference(pack_scene(tscene, basis, row0),
                                           tassets, cfg).numpy()

    port = render(tbasis)
    bad = np.abs(port - ref).max(-1) >= AGREE_ABS
    chaotic = (chaotic_pixels(render, tbasis, port) if bad.any()
               else np.zeros(bad.shape, bool))
    assert_agrees(port, ref, chaotic, case_id(case))


@pytest.fixture(scope="module")
def canonical_pair():
    jscene = tpuray.build_scene(tpuray.canonical_scene_spec())
    return jscene, tt.scene_from_arrays(jax_scene_arrays(jscene), "cpu")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_canonical_scene_matches_jax_megakernel(canonical_pair, case):
    check_render_parity(*canonical_pair, case)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _small_inputs(width=16, height=8, depth=3):
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    cam = _camera_pair()[1]
    basis = tt.perspective_basis(cam, width, height, device="cpu")
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(1),
                                   "cpu")
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth)
    return pack_scene(scene, basis), assets, cfg


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    packed, assets, cfg = _small_inputs()
    before = render_megakernel.launches
    out = render_megakernel(packed, assets, cfg)
    assert render_megakernel.launches == before   # no kernel on the CPU
    assert out.shape == (cfg.height, cfg.width, 3)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(
        out.numpy(), render_megakernel_reference(packed, assets, cfg).numpy())


def test_wrapper_rejects_what_the_kernel_cannot_take():
    packed, assets, cfg = _small_inputs()
    with pytest.raises(ValueError, match="at most 16"):
        render_megakernel(packed, assets,
                          cfg.replace(max_depth=MAX_DEPTH_CAP + 1))
    render_megakernel(packed, assets, cfg.replace(max_depth=MAX_DEPTH_CAP,
                                                  width=4, height=2))
    bad_tex = tt.SceneAssets(assets.textures[:2], assets.skybox)
    with pytest.raises(ValueError, match="texture 2"):
        render_megakernel(packed, bad_tex, cfg)
    with pytest.raises(ValueError, match="u8"):
        render_megakernel(packed, tt.SceneAssets(
            assets.textures.float(), assets.skybox), cfg)


def test_wrappers_refuse_images_of_2_31_pixels():
    """The kernel indexes pixels with 32-bit integers (and image and record
    elements with 64-bit ones): both wrappers refuse 2^31 pixels or more
    before allocating anything; one pixel fewer passes the check (the
    render itself is not run; ``tests/test_torch_cuda.py`` renders an image
    of more than 2^31 elements on the card)."""
    packed, assets, cfg = _small_inputs()
    big = cfg.replace(width=1 << 16, height=1 << 15)
    for wrapper in (render_megakernel, render_megakernel_record):
        with pytest.raises(ValueError, match="32-bit"):
            wrapper(packed, assets, big)
    _check_inputs(packed, assets, cfg.replace(width=(1 << 31) - 1, height=1))


def test_triangles_and_bilinear_are_refused():
    """More triangles than the megakernel's cap (the JAX kernel's 524,288,
    above which ``engine='auto'`` renders with the tracer) raise before any
    table is built; an unknown filter is refused, bilinear is taken."""
    scene = tt.build_scene(tt.canonical_scene_spec(), "cpu")
    basis = tt.perspective_basis(_camera_pair()[1], 8, 8, device="cpu")
    with pytest.raises(ValueError, match="524,288"):
        pack_scene(many_triangles(scene, TRI_MAX_TRIANGLES + 1), basis)
    assert pack_scene(many_triangles(scene, 1), basis).tris.n == 1
    with pytest.raises(ValueError, match="unknown filter"):
        tt.RenderConfig(filter="bogus")
    assert tt.RenderConfig(filter="bilinear").filter == "bilinear"


# ---------------------------------------------------------------------------
# primitives, against the JAX megakernel's helpers and jax primitives
# ---------------------------------------------------------------------------

def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_xorshift32_matches_megakernel_bit_for_bit():
    rng = np.random.default_rng(5)
    seeds = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                            rng.integers(0, 2 ** 32, 2043, dtype=np.uint64)])
    state_t = _t(seeds.astype(np.int64))
    state_i = jnp.asarray(seeds.astype(np.uint32).view(np.int32))
    state_u = jnp.asarray(seeds.astype(np.uint32))
    for _ in range(8):
        state_t, sample_t = pr.xorshift32(state_t)
        state_i, sample_i = jpt._xorshift32(state_i)
        state_u, sample_u = jpr.xorshift32(state_u)
        np.testing.assert_array_equal(
            state_t.numpy(), np.asarray(state_i).view(np.uint32))
        np.testing.assert_array_equal(state_t.numpy(), np.asarray(state_u))
        np.testing.assert_array_equal(sample_t.numpy(), np.asarray(sample_i))
        np.testing.assert_allclose(sample_t.numpy(), np.asarray(sample_u),
                                   rtol=1e-6)
    assert float(sample_t.max()) >= 2.0    # the reference's [0, 4) range
    assert int(pr.xorshift32(_t(np.array([0])))[0]) == 0   # pixel 0 stays 0


def _directions(seed, n=4096):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    # ties between axes (the reference's non-exclusive face tests), axes,
    # and the zero vector
    d[:6] = [[1, 0, 1], [-1, 1, 0], [0, -1, -1], [1, 1, 1], [0, 0, 0],
             [0, 0, -1]]
    d[6:] /= np.linalg.norm(d[6:], axis=-1, keepdims=True)
    return d


@pytest.mark.parametrize("face", [32, 1024])
def test_map_to_cube_and_sky_texel_match_megakernel(face):
    d = _directions(11)
    u_j, v_j = jpt._map_to_cube(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]),
                                jnp.asarray(d[:, 2]), face)
    u_t, v_t = pr.map_to_cube(_t(d), face)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    sky_h, sky_w = 3 * face, 4 * face
    sy, sx = pr.sky_texel(_t(d), sky_h, sky_w)
    # pallas_trace.py:1826-1828: v flipped, both clamped into the image
    np.testing.assert_array_equal(
        sy.numpy(), np.clip(sky_h - np.asarray(v_j), 0, sky_h - 1))
    np.testing.assert_array_equal(sx.numpy(),
                                  np.clip(np.asarray(u_j), 0, sky_w - 1))


@pytest.mark.parametrize("normal", [(0.0, 1.0, 0.0), (0.0, 0.0, -1.0),
                                    (1.0, 0.0, 0.0), (0.6, 0.8, 0.0),
                                    (-0.48, 0.6, 0.64)])
def test_plane_texture_basis_matches_megakernel(normal):
    b0_t, b1_t = pr.plane_texture_basis(_t(np.float32([normal])))
    (b0x, b0y, b0z), (b1x, b1y, b1z) = jpt._plane_basis(
        *[jnp.float32(c) for c in normal])
    np.testing.assert_array_equal(b0_t.numpy()[0],
                                  np.float32([b0x, b0y, b0z]))
    np.testing.assert_array_equal(b1_t.numpy()[0],
                                  np.float32([b1x, b1y, b1z]))


def test_texel_index_maths_matches_jax_including_negative_coords():
    rng = np.random.default_rng(3)
    n = 4096
    points = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    points[:8] = [[-0.001, 0, -0.001], [-1e-30, 0, 0], [0, 0, 0],
                  [np.nan, 0, 1], [np.inf, 0, 1], [-np.inf, 0, -1],
                  [1e12, 0, -1e12], [-0.999, 0, -1.001]]
    normals = np.float32([[0, 1, 0], [0, 0, -1], [0.6, 0.8, 0]])
    scale = np.float32(rng.uniform(1, 150, n))
    for normal in normals:
        nn = np.broadcast_to(normal, (n, 3))
        jb0, jb1 = jpr.plane_texture_basis(jnp.asarray(nn))
        tb0, tb1 = pr.plane_texture_basis(_t(np.ascontiguousarray(nn)))
        for tex_h, tex_w in ((64, 64), (48, 80)):
            xj, yj = jpr.texture_texel_coords(jb0, jb1, jnp.asarray(points),
                                              jnp.asarray(scale), tex_h,
                                              tex_w)
            xt, yt = pr.texture_texel_coords(tb0, tb1, _t(points),
                                             _t(scale), tex_h, tex_w)
            np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
            assert xt.min() >= 0 and xt.max() < tex_w
    # truncation toward zero then a floor-mod: -0.5 -> 0, -1.5 -> w - 1
    x, _ = pr.texture_texel_coords(_t(np.float32([[1, 0, 0]] * 3)),
                                   _t(np.float32([[0, 0, 1]] * 3)),
                                   _t(np.float32([[-0.5, 0, 0], [-1.5, 0, 0],
                                                  [-64.5, 0, 0]])),
                                   _t(np.float32([1, 1, 1])), 64, 64)
    assert x.tolist() == [0, 63, 0]


def test_intersections_and_optics_match_jax_primitives():
    rng = np.random.default_rng(9)
    n = 4096
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = _directions(12, n)
    center = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 2.5, n).astype(np.float32)
    normal = _directions(13, n)
    n1 = np.float32(rng.choice([1.0, 1.52], n))
    n2 = np.float32(np.where(n1 == 1.0, 1.52, 1.0))
    pairs = [
        (pr.intersect_sphere(_t(o), _t(d), _t(center), _t(radius)),
         jpr.intersect_sphere(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(center), jnp.asarray(radius))),
        (pr.intersect_plane(_t(o), _t(d), _t(normal), _t(center)),
         jpr.intersect_plane(jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(normal), jnp.asarray(center))),
        ((pr.reflect(_t(d), _t(normal)),),
         (jpr.reflect(jnp.asarray(d), jnp.asarray(normal)),)),
        (pr.refract(_t(n1), _t(n2), _t(d), _t(normal)),
         jpr.refract(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(d),
                     jnp.asarray(normal))),
        ((pr.schlick(_t(n1), _t(n2), _t(d), _t(normal)),),
         (jpr.schlick(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(d),
                      jnp.asarray(normal)),)),
    ]
    for ours, theirs in pairs:
        for a, b in zip(ours, theirs):
            b = np.asarray(b)
            if b.dtype == bool:
                np.testing.assert_array_equal(a.numpy(), b)
            else:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-6)
    hit, _ = pairs[0][0]
    assert 0.05 < float(hit.float().mean()) < 0.95
