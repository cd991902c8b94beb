"""The CUDA kernels on the card: the megakernel in its base, triangle,
bilinear and record instantiations and the triangle-query kernel, built
with nvcc from the repository's sources and held against their plain
PyTorch versions; the gradient through ``render_megakernel_diff`` and the
whole-image tracer against the same on the CPU; the wrappers' refusals;
the sharded paths on one and two ranks.  Every test needs an
NVIDIA GPU and the CUDA toolkit and skips without them (marker ``cuda``);
on the card run ``python -m pytest tests/test_torch_cuda.py -q``."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import tpuray_torch as tt
from tpuray_torch.kernels import build
from tpuray_torch.kernels.megakernel import (
    MAX_DEPTH_CAP, PC_VALID, pack_scene, render_megakernel, render_megakernel_record,
    render_megakernel_record_reference, render_megakernel_reference)
from tpuray_torch.kernels.triblocks import TRI_MAX_TRIANGLES

pytestmark = pytest.mark.cuda

GOLDEN_CAMERA = ((0.8, 2.5, -8.0), (0.2, 0.0, 1.0), 90.0, 1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(device, width=256, height=64, depth=3):
    scene = tt.build_scene(tt.canonical_scene_spec(), device)
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), width, height,
                                 device=device)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 256, 256),
                                   device)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth)
    return pack_scene(scene, basis), assets, cfg


def test_toolchain_is_present(cuda):
    """The card's machine has nvcc (the kernel's build) and records
    whether Triton is installed (no kernel of the port needs it yet)."""
    nvcc = build.find_nvcc()
    assert nvcc is not None and shutil.which(nvcc) is not None
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    lib = build.load_library()
    assert lib.path.startswith(build.BUILD_DIR)


def test_kernel_matches_plain_version(cuda):
    packed, assets, cfg = _inputs(cuda)
    before = render_megakernel.launches
    got = render_megakernel(packed, assets, cfg)
    torch.cuda.synchronize()
    assert render_megakernel.launches == before + 1
    want = render_megakernel_reference(packed, assets, cfg)
    diff = (got - want).abs().amax(-1).cpu().numpy()
    assert not torch.isnan(got).any()
    # built with --fmad=false, the kernel rounds as the plain version does
    assert (diff < 1e-3).mean() >= 0.999, (diff >= 1e-3).sum()
    assert float((got - want).abs().mean()) < 1e-4


def test_wrapper_refuses_mixed_devices_and_deep_stacks(cuda):
    packed, assets, cfg = _inputs(cuda, 32, 16)
    cpu_assets = assets.to("cpu")
    with pytest.raises(ValueError, match="share a device"):
        render_megakernel(packed, cpu_assets, cfg)
    with pytest.raises(ValueError, match="at most 16"):
        render_megakernel(packed, assets,
                          cfg.replace(max_depth=MAX_DEPTH_CAP + 1))
    out = render_megakernel(packed, assets, cfg.replace(max_depth=16))
    torch.cuda.synchronize()
    assert np.isfinite(out.cpu().numpy()).all()


@pytest.mark.parametrize("shape", [(256, 64, 3, 2), (200, 50, 6, 2),
                                   (128, 96, 3, 0)])
def test_record_kernel_matches_plain_version(cuda, shape):
    width, height, depth, samples = shape
    packed, assets, cfg = _inputs(cuda, width, height, depth)
    cfg = cfg.replace(shadow_samples=samples)
    before = render_megakernel_record.launches
    img, rec = render_megakernel_record(packed, assets, cfg)
    torch.cuda.synchronize()
    assert render_megakernel_record.launches == before + 1
    want, plain = render_megakernel_record_reference(packed, assets, cfg)
    # the record instantiation renders the base kernel's image
    assert torch.equal(img, render_megakernel(packed, assets, cfg))
    assert float((img - want).abs().max()) < 1e-3
    for key in ("rec", "pick"):
        same = (rec[key] == plain[key]).all(0).float().mean()
        assert float(same) >= 0.999, key
    assert float((rec["ssr"] - plain["ssr"]).abs().max()) <= 1e-5
    assert int(rec["max_nodes"]) == int(plain["max_nodes"])


def test_diff_backward_on_the_card_matches_the_cpu(cuda):
    """atol 2e-2 * max|g| per leaf (tests/test_pallas_vjp.py:297-303): the
    card's reductions (the one-hot reads' backward sums over pixels) add
    in another order than the CPU's."""
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        packed, assets, cfg = _inputs(dev, 64, 48, 3)
        scene = tt.build_scene(tt.canonical_scene_spec(), dev)
        basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), 64, 48,
                                     device=dev)
        diff, rest = tt.partition(scene)
        leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
        w = torch.from_numpy(np.random.default_rng(0).uniform(
            size=(48, 64, 3)).astype(np.float32)).to(dev)
        img = tt.render_megakernel_diff(tt.combine(leaves, rest), assets,
                                        basis, cfg)
        g = torch.autograd.grad((img * w).sum(), list(leaves.values()))
        grads[dev.type] = {k: v.cpu() for k, v in zip(leaves, g)}
    for name, ours in grads["cuda"].items():
        want = grads["cpu"][name]
        assert torch.isfinite(ours).all(), name
        if want.numel():
            scale = max(float(want.abs().max()), 1e-3)
            assert float((ours - want).abs().max()) <= 2e-2 * scale, name


def _mesh_inputs(device, width, height, depth=3):
    from tpuray_torch.meshes import mesh_benchmark_scene

    scene = tt.build_scene(mesh_benchmark_scene(2, (16, 8)), device)
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), width, height,
                                 device=device)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 256, 256),
                                   device)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=depth)
    return scene, basis, assets, cfg


def test_mesh_kernels_match_plain_version(cuda):
    """The triangle walk (K3/K4) and its records against the brute-force
    plain version: 576 triangles at 256x192 depth 3."""
    scene, basis, assets, cfg = _mesh_inputs(cuda, 256, 192)
    packed = pack_scene(scene, basis)
    got = render_megakernel(packed, assets, cfg)
    want = render_megakernel_reference(packed, assets, cfg)
    diff = (got - want).abs()
    assert (diff.amax(-1) < 1e-3).float().mean() >= 0.999
    assert float(diff.mean()) < 1e-4
    img, rec = render_megakernel_record(packed, assets, cfg)
    _, plain = render_megakernel_record_reference(packed, assets, cfg)
    assert torch.equal(img, got)
    assert bool(((rec["rec"] & 0xFF) == 126).any())
    for key in ("rec", "wid", "pick"):
        same = (rec[key] == plain[key]).all(0).float().mean()
        assert float(same) >= 0.999, key
    assert float((rec["ssr"] - plain["ssr"]).abs().max()) <= 1e-5


def test_mesh_diff_backward_on_the_card_matches_the_cpu(cuda):
    """Triangle vertices and materials included, at 2e-2 * max|g|."""
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        scene, basis, assets, cfg = _mesh_inputs(dev, 64, 48)
        diff, rest = tt.partition(scene)
        leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
        w = torch.from_numpy(np.random.default_rng(0).uniform(
            size=(48, 64, 3)).astype(np.float32)).to(dev)
        img = tt.render_megakernel_diff(tt.combine(leaves, rest), assets,
                                        basis, cfg)
        g = torch.autograd.grad((img * w).sum(), list(leaves.values()))
        grads[dev.type] = {k: v.cpu() for k, v in zip(leaves, g)}
    assert float(grads["cuda"]["tri_v0"].abs().sum()) > 0
    for name, ours in grads["cuda"].items():
        want = grads["cpu"][name]
        assert torch.isfinite(ours).all(), name
        scale = max(float(want.abs().max()), 1e-3)
        assert float((ours - want).abs().max()) <= 2e-2 * scale, name


def test_bilinear_kernel_matches_plain_version(cuda):
    """K2: the bilinear instantiation against the plain version's bilinear
    fetches (the nearest bar), and different from the nearest image."""
    packed, assets, cfg = _inputs(cuda)
    cfg = cfg.replace(filter="bilinear")
    before = render_megakernel.bilinear_launches
    got = render_megakernel(packed, assets, cfg)
    torch.cuda.synchronize()
    assert render_megakernel.bilinear_launches == before + 1
    want = render_megakernel_reference(packed, assets, cfg)
    diff = (got - want).abs()
    assert (diff.amax(-1) < 1e-3).float().mean() >= 0.999
    assert float(diff.mean()) < 1e-4
    nearest = render_megakernel(packed, assets, cfg.replace(filter="nearest"))
    assert float((got - nearest).abs().max()) > 1e-3


# (width, rows, height, row0, depth, samples, extra lights); without
# samples no lane stays as a helper
SHADING_CASES = pytest.mark.parametrize(
    "case", [(800, 32, 600, 368, 15, 2, 0), (203, 37, 37, 0, 6, 2, 0),
             (64, 48, 48, 0, 4, 3, 29), (203, 37, 37, 0, 6, 0, 0)],
    ids=["deep-slab", "ragged", "many-lights", "ragged-ss0"])


def shading_inputs(device, filt, case):
    """(scene, packed scene, assets, cfg) of a shared-shading case."""
    width, rows, height, row0, depth, samples, extra_lights = case
    scene = tt.build_scene(crowded_spec(n_lights=extra_lights), device)
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), width, height,
                                 device=device)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 512, 512),
                                   device)
    cfg = tt.RenderConfig(width=width, height=rows, max_depth=depth,
                          shadow_samples=samples, filter=filt)
    return scene, pack_scene(scene, basis, row0), assets, cfg


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
@SHADING_CASES
def test_shared_shading_matches_plain_version(cuda, filt, case):
    """K1 and K2 shade a warp's solid hits together, with helper lanes: on
    rows 368-399 of 800x600 d15, the frame's deepest pixels (up to 116
    nodes, most warps shading a few pixels); on a 203x37 image, whose
    blocks at the right and bottom edges hold lanes outside the image; and
    with 32 lights and 3 samples, 96 feelers a hit, in 12 chunks; and the
    203x37 image without samples, where each lane shades alone and leaves
    when its pixel is done.  Phase 3's bar: >= 99.9% of pixels within
    1e-3, mean < 1e-4."""
    width, rows, _, row0, depth, samples, _ = case
    scene, packed, assets, cfg = shading_inputs(cuda, filt, case)
    got = render_megakernel(packed, assets, cfg)
    torch.cuda.synchronize()
    want = render_megakernel_reference(packed, assets, cfg)
    diff = (got - want).abs()
    print(f"{filt} {width}x{rows} from row {row0} d{depth} ss{samples}, "
          f"{scene.num_lights} lights: max|d| {float(diff.max()):.3g}")
    assert bool(torch.isfinite(got).all())
    assert (diff.amax(-1) < 1e-3).float().mean() >= 0.999
    assert float(diff.mean()) < 1e-4


RECORD_SENTINEL = {torch.int32: 0x5A5A5A5A, torch.float32: -7777.0}
GUARD = 4096


def filled_empty(monkeypatch):
    """Make ``torch.empty`` hand out views of buffers filled with a
    sentinel, each followed by ``GUARD`` more elements of it; returns the
    list of (buffer, elements handed out) it fills.  An element the kernel
    never writes keeps the sentinel, and a write past a tensor's end lands
    in its guard."""
    made = []

    def empty(shape, *, dtype, device):
        n = int(np.prod(shape))
        buf = torch.full((n + GUARD,), RECORD_SENTINEL[dtype], dtype=dtype,
                         device=device)
        made.append((buf, n))
        return buf[:n].view(shape)

    monkeypatch.setattr(torch, "empty", empty)
    return made


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
@SHADING_CASES
def test_shared_shading_records_match_plain_version(cuda, filt, case,
                                                    monkeypatch):
    """K5 shades a warp's solid hits together as K1 does, its owners
    writing the shadow ratios and carrying the parent codes: on the cases
    of ``test_shared_shading_matches_plain_version``, its records, winner
    ids and picks equal the plain version's on >= 99.9% of pixels, its
    ratios within 1e-5, its ``max_nodes`` exactly, and its image is K1's
    bit for bit.  The outputs are allocated over a sentinel: every element
    is written (unused slots padded), and nothing past their ends (the
    203x37 image's lanes outside it write nothing)."""
    width, rows, _, row0, depth, samples, _ = case
    scene, packed, assets, cfg = shading_inputs(cuda, filt, case)
    with monkeypatch.context() as m:
        made = filled_empty(m)
        img, rec = render_megakernel_record(packed, assets, cfg)
    torch.cuda.synchronize()
    assert len(made) == 6      # the image, rec, wid, ssr, pick, max_nodes
    for buf, n in made:
        sentinel = RECORD_SENTINEL[buf.dtype]
        assert not bool((buf[:n] == sentinel).any()), "unwritten element"
        assert bool((buf[n:] == sentinel).all()), "written past the end"
    want, plain = render_megakernel_record_reference(packed, assets, cfg)
    assert torch.equal(img, render_megakernel(packed, assets, cfg))
    diff = (img - want).abs()
    assert (diff.amax(-1) < 1e-3).float().mean() >= 0.999
    assert float(diff.mean()) < 1e-4
    n_pix = width * rows
    deep = int(plain["max_nodes"])
    print(f"{filt} {width}x{rows} from row {row0} d{depth} ss{samples}, "
          f"{scene.num_lights} lights: max_nodes {deep}")
    for key in ("rec", "wid", "pick"):
        same = (rec[key] == plain[key]).reshape(-1, n_pix).all(0)
        assert float(same.float().mean()) >= 0.999, key
    assert float((rec["ssr"] - plain["ssr"]).abs().max()) <= 1e-5
    assert int(rec["max_nodes"]) == deep
    # children with a parent byte, which the shared shading must carry
    assert bool(((plain["rec"] >= 0) & (plain["rec"] >> 8 & PC_VALID != 0)
                 ).any())


def test_images_past_2_31_image_elements(cuda):
    """Above 715,827,882 pixels an image's float index, 3 x pixel, passes
    2^31 while the pixel index does not: K1 and K5 (one record slot) on a
    32768x21848 image at depth 1 store their last 8 rows as a render of
    those rows alone does, records included."""
    width, height, tail = 32768, 21848, 8
    assert width * height * 3 >= 2 ** 31 > width * height
    scene = tt.build_scene(tt.canonical_scene_spec(), cuda)
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), width, height,
                                 device=cuda)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 256, 256),
                                   cuda)
    cfg = tt.RenderConfig(width=width, height=height, max_depth=1,
                          record_slots=1)
    slab = pack_scene(scene, basis, height - tail)
    slab_cfg = cfg.replace(height=tail)
    want = render_megakernel(slab, assets, slab_cfg)
    img = render_megakernel(pack_scene(scene, basis), assets, cfg)
    torch.cuda.synchronize()
    assert torch.equal(img[-tail:], want)
    del img
    want_img, want_rec = render_megakernel_record(slab, assets, slab_cfg)
    assert torch.equal(want_img, want)
    img, rec = render_megakernel_record(pack_scene(scene, basis), assets, cfg)
    torch.cuda.synchronize()
    assert torch.equal(img[-tail:], want)
    for key in ("rec", "wid", "ssr", "pick"):
        assert torch.equal(rec[key][..., -tail * width:], want_rec[key]), key


def test_bilinear_record_kernel_matches_plain_version(cuda):
    """K5 with bilinear records: 4 picks per node, equal to the plain
    version's; the replay reproduces the image."""
    packed, assets, cfg = _inputs(cuda, 128, 96, 3)
    cfg = cfg.replace(filter="bilinear")
    img, rec = render_megakernel_record(packed, assets, cfg)
    want, plain = render_megakernel_record_reference(packed, assets, cfg)
    assert rec["pick"].shape == (cfg.resolved_record_slots(), 4, 128 * 96)
    assert torch.equal(img, render_megakernel(packed, assets, cfg))
    assert float((img - want).abs().max()) < 1e-3
    for key in ("rec", "wid", "pick"):
        same = (rec[key] == plain[key]).reshape(
            -1, 128 * 96).all(0).float().mean()
        assert float(same) >= 0.999, key
    assert float((rec["ssr"] - plain["ssr"]).abs().max()) <= 1e-5
    scene = tt.build_scene(tt.canonical_scene_spec(), cuda)
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), 128, 96,
                                 device=cuda)
    d = (tt.replay_render(scene, assets, basis, rec, cfg) - img).abs()
    assert float(d.mean()) < 1e-3 and float(d.max()) < 5e-2


def query_rays(tables, device, n=300, seed=7):
    """``n`` rays from random origins, every other one in a random
    direction and the rest aimed near a random triangle's centre, some with
    a zero direction; and tmax values past the plain version's closest hits
    (4 on a miss, 0 for an inactive ray)."""
    from tpuray_torch.kernels.query import tri_query_closest_reference

    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    centre = ((tables.v0 + (tables.e1 + tables.e2) / 3.0).cpu().numpy())
    aim = centre[rng.integers(0, tables.n, n // 2)]
    d[1::2] = aim + rng.normal(scale=0.05, size=aim.shape) - o[1::2]
    d[::37] = 0.0
    o, d = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    t, _ = tri_query_closest_reference(tables, o, d)
    tmax = torch.where(torch.isfinite(t), t * 1.5, torch.full_like(t, 4.0))
    tmax[::11] = 0.0      # inactive rays
    return o, d, tmax.contiguous()


def test_query_kernels_match_plain_versions(cuda):
    """K6 against brute force: the same hits and winners, t to 1e-6
    relative, blocked flags away from tmax and counts where not blocked,
    on a mesh with transparent triangles (mesh_benchmark_scene(1))."""
    from tpuray_torch.kernels import query
    from tpuray_torch.kernels.triblocks import build_query_tables
    from tpuray_torch.meshes import mesh_benchmark_scene

    scene = tt.build_scene(mesh_benchmark_scene(1), cuda)
    transp = scene.tri_mat.transparent.clone()
    transp[::3] = True
    tables = build_query_tables(scene.tri_v0, scene.tri_v1, scene.tri_v2,
                                transp)
    o, d, tmax = query_rays(tables, cuda)
    before = query.tri_query_closest.launches
    t, wid = query.tri_query_closest(tables, o, d)
    torch.cuda.synchronize()
    assert query.tri_query_closest.launches == before + 1
    t_ref, wid_ref = query.tri_query_closest_reference(tables, o, d)
    hit = torch.isfinite(t_ref)
    assert torch.equal(torch.isfinite(t), hit) and int(hit.sum()) > 100
    assert float(((t - t_ref).abs() / t_ref.abs())[hit].max()) <= 1e-6
    assert torch.equal(wid, wid_ref)
    for inclusive in (False, True):
        blocked, count = query.tri_query_blocker(tables, o, d, tmax,
                                                 inclusive)
        b_ref, c_ref = query.tri_query_blocker_reference(tables, o, d, tmax,
                                                         inclusive)
        assert torch.equal(blocked, b_ref)
        assert torch.equal(count[~b_ref], c_ref[~b_ref])
        assert not bool(blocked[tmax <= 0].any())


def test_query_kernels_take_the_lowest_id_among_ties(cuda):
    """K6 on the tie mesh: closest t and ids, blocker flags (tmax past and
    exactly at the hit) and counts where not blocked equal the plain
    version's."""
    from tpuray_torch.kernels import query
    from tpuray_torch.kernels.triblocks import build_query_tables

    v0, v1, v2, transp, o, d = (torch.from_numpy(x).to(cuda)
                                for x in tie_triangles())
    tables = build_query_tables(v0, v1, v2, transp)
    t, wid = query.tri_query_closest(tables, o, d)
    t_ref, wid_ref = query.tri_query_closest_reference(tables, o, d)
    hit = torch.isfinite(t_ref)
    assert torch.equal(t, t_ref) and torch.equal(wid, wid_ref)
    assert bool((wid[hit] // 16 % 2 == 0).all())
    for tmax in (t_ref * 1.5, t_ref):
        tmax = torch.where(hit, tmax, torch.full_like(t_ref, 4.0))
        for inclusive in (False, True):
            blocked, count = query.tri_query_blocker(tables, o, d, tmax,
                                                     inclusive)
            b_ref, c_ref = query.tri_query_blocker_reference(
                tables, o, d, tmax, inclusive)
            assert torch.equal(blocked, b_ref)
            assert torch.equal(count[~b_ref], c_ref[~b_ref])


def test_mesh_kernels_take_the_lowest_id_among_ties(cuda):
    """The megakernel on the tie mesh: its image and its records' triangle
    ids against the plain versions'."""
    scene = tie_scene(cuda)
    cam = tt.Camera((0.1, 0.2, -1.0), (0.0, 0.0, 1.0), 45.0, 1.0)
    basis = tt.perspective_basis(cam, 128, 96, device=cuda)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 256, 256),
                                   cuda)
    cfg = tt.RenderConfig(width=128, height=96, max_depth=3,
                          shadow_samples=2)
    packed = pack_scene(scene, basis)
    got = render_megakernel(packed, assets, cfg)
    want = render_megakernel_reference(packed, assets, cfg)
    assert (((got - want).abs().amax(-1) < 1e-3).float().mean()) >= 0.999
    img, rec = render_megakernel_record(packed, assets, cfg)
    _, plain = render_megakernel_record_reference(packed, assets, cfg)
    assert torch.equal(img, got)
    tri = (plain["rec"] & 0xFF) == 126
    assert int(tri.sum()) > 1000
    assert torch.equal(rec["wid"], plain["wid"])
    assert bool((plain["wid"][tri] // 16 % 2 == 0).all())


@pytest.mark.parametrize("mesh", [False, True], ids=["canonical", "mesh"])
def test_tracer_on_the_card_matches_the_cpu(cuda, mesh):
    """The whole-image tracer on the card (triangle queries through the
    query kernel) against the same on the CPU (brute force), at the
    megakernel's bar: the card's sin, cos and sqrt may round otherwise."""
    from tpuray_torch.kernels import query

    imgs = {}
    for dev in (cuda, torch.device("cpu")):
        if mesh:
            scene, basis, assets, cfg = _mesh_inputs(dev, 64, 48)
        else:
            scene = tt.build_scene(tt.canonical_scene_spec(), dev)
            basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), 64, 48,
                                         device=dev)
            assets = tt.assets_from_arrays(
                *tt.random_asset_arrays(0, 256, 256), dev)
            cfg = tt.RenderConfig(width=64, height=48, max_depth=3)
        before = query.tri_query_closest.launches
        imgs[dev.type] = tt.render_from_basis_tracer(
            scene, assets, basis, cfg.replace(engine="tracer")).cpu()
        launched = query.tri_query_closest.launches - before
        assert (launched > 0) == (mesh and dev.type == "cuda")
    diff = (imgs["cuda"] - imgs["cpu"]).abs()
    assert (diff.amax(-1) < 1e-3).float().mean() >= 0.999
    assert float(diff.mean()) < 1e-4


def test_record_wrapper_refusals_on_the_card(cuda):
    check_record_refusals(cuda)


def crowded_spec(n_spheres=0, n_lights=0):
    spec = tt.canonical_scene_spec()
    spec.spheres += [tt.SphereSpec((0.1 * i, 5.0, 9.0), 0.05, tt.PLASTIC)
                     for i in range(n_spheres)]
    spec.lights += [tt.LightSpec((0.1 * i, 9.0, 9.0), 0.05, 1.0, (1, 1, 1))
                    for i in range(n_lights)]
    return spec


def tie_triangles(cells=12):
    """A mesh of ties for the triangle walk: (v0, v1, v2 [T, 3] f32,
    transparent [T] bool) in the order the tables take, and rays (o, d)
    [R, 3] along +z through it.  Cell c (a square of the plane z = 5) owns
    two leaf blocks: block 2c holds a big triangle, a coplanar one that
    overlaps it, and 14 specks at z = 9; block 2c + 1 holds duplicates of
    the two (same vertices, higher ids) and 14 specks at z = 1.  So the box
    with the nearer entry (z = 1) holds the higher ids, and a ray that hits
    the big triangle meets two equal t.  Which duplicates are transparent
    varies with the cell."""
    v0, v1, v2, transp = [], [], [], []

    def tri(a, b, c, z, clear=False):
        for out, (x, y) in zip((v0, v1, v2), (a, b, c)):
            out.append((x, y, z))
        transp.append(clear)

    for c in range(cells):
        cx, cy = c % 4 - 1.5, c // 4 - 1.0
        big = ((cx - 0.45, cy - 0.45), (cx + 0.45, cy - 0.45),
               (cx - 0.45, cy + 0.45))
        over = ((cx - 0.2, cy - 0.2), (cx + 0.45, cy + 0.4),
                (cx - 0.2, cy + 0.45))
        speck = ((cx + 0.44, cy + 0.44), (cx + 0.45, cy + 0.44),
                 (cx + 0.44, cy + 0.45))
        for z, first in ((9.0, True), (1.0, False)):
            tri(*big, 5.0, clear=not first and c % 3 == 0)
            tri(*over, 5.0, clear=first and c % 2 == 1)
            for _ in range(14):
                tri(*speck, z)
    v0, v1, v2 = (np.asarray(v, dtype=np.float32) for v in (v0, v1, v2))
    rng = np.random.default_rng(5)
    n = 4096
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-2.0, 2.0, n)
    o[:, 1] = rng.uniform(-1.5, 1.5, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[n // 2:, :2] = rng.normal(scale=0.05, size=(n - n // 2, 2))
    return v0, v1, v2, np.asarray(transp), o, d


def tie_scene(device):
    """The tie mesh as a scene, its triangles in the order given (no Morton
    sort): the big triangles and duplicates PLASTIC or GLASS, under a light,
    seen from z = -1."""
    v0, v1, v2, transp, _, _ = tie_triangles()
    base = tt.build_scene(tt.SceneSpec(
        lights=[tt.LightSpec((0.5, 1.0, -2.0), 0.3, 2.0, (1, 1, 1))],
        triangles=[tt.TriangleSpec((0, 0, 0), (1, 0, 0), (0, 1, 0), tt.PLASTIC),
                   tt.TriangleSpec((0, 0, 1), (1, 0, 1), (0, 1, 1), tt.GLASS)]),
        device)
    row = torch.from_numpy(transp.astype(np.int64)).to(device)
    row = torch.where(row.bool(), base.tri_mat.transparent.long().argmax(),
                      base.tri_mat.transparent.long().argmin())
    mat = tt.Materials(**{f.name: getattr(base.tri_mat, f.name)[row]
                          for f in dataclasses.fields(tt.Materials)})
    verts = [torch.from_numpy(v).to(device) for v in (v0, v1, v2)]
    return dataclasses.replace(base, tri_v0=verts[0], tri_v1=verts[1],
                               tri_v2=verts[2], tri_mat=mat)


def many_triangles(scene, n):
    """``scene`` with ``n`` copies of one triangle, made without a spec or
    a sort, so that a scene past the triangle cap stays cheap."""
    one = tt.build_scene(
        tt.SceneSpec(triangles=[tt.TriangleSpec((0, 0, 0), (1, 0, 0),
                                                (0, 1, 0), tt.PLASTIC)]),
        scene.device)
    mat = tt.Materials(**{f.name: getattr(one.tri_mat, f.name).expand(
        n, *getattr(one.tri_mat, f.name).shape[1:])
        for f in dataclasses.fields(tt.Materials)})
    return dataclasses.replace(scene, tri_v0=one.tri_v0.expand(n, 3),
                               tri_v1=one.tri_v1.expand(n, 3),
                               tri_v2=one.tri_v2.expand(n, 3), tri_mat=mat)


def check_record_refusals(device):
    """More than 64 solids or 62 lights (the hit code's ranges), record
    slots outside [1, 64] (6-bit parent slots), more than 524,288 triangles
    (the cap of the triangle path) and an unknown filter are refused; the
    caps themselves work, and bilinear records hold 4 picks per node."""
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), 8, 4,
                                 device=device)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0), device)
    cfg = tt.RenderConfig(width=8, height=4, max_depth=2)
    for spec, what in ((crowded_spec(n_spheres=59), "64 solids"),
                       (crowded_spec(n_lights=60), "62 lights")):
        packed = pack_scene(tt.build_scene(spec, device), basis)
        with pytest.raises(ValueError, match=what):
            render_megakernel_record(packed, assets, cfg)
    packed = pack_scene(tt.build_scene(crowded_spec(58, 59), device), basis)
    _, records = render_megakernel_record(packed, assets, cfg)   # at the caps
    assert records["ssr"].shape[1] == 62
    packed = pack_scene(tt.build_scene(tt.canonical_scene_spec(), device),
                        basis)
    for slots in (-1, 65):
        with pytest.raises(ValueError, match="record_slots"):
            render_megakernel_record(packed, assets,
                                     cfg.replace(record_slots=slots))
    for slots in (1, 64):
        _, records = render_megakernel_record(
            packed, assets, cfg.replace(record_slots=slots))
        assert records["rec"].shape == (slots, 32)
    scene = tt.build_scene(tt.canonical_scene_spec(), device)
    with pytest.raises(ValueError, match="524,288"):
        pack_scene(many_triangles(scene, TRI_MAX_TRIANGLES + 1), basis)
    packed = pack_scene(many_triangles(scene, 100), basis)
    _, records = render_megakernel_record(packed, assets, cfg)
    assert records["wid"].shape == (cfg.resolved_record_slots(), 32)
    with pytest.raises(ValueError, match="unknown filter"):
        tt.RenderConfig(filter="bogus", record_slots=8)
    _, records = render_megakernel_record(
        packed, assets, cfg.replace(filter="bilinear", record_slots=8))
    assert records["pick"].shape == (8, 4, 32)


@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_paths_match_one_rank(cuda, world, backend):
    """``tpuray_torch.parallel.selfcheck``'s cases on the card: one rank
    over NCCL, and two ranks sharing the card over gloo (NCCL takes one
    rank per card).  Rows sharded over the megakernel (K1, K3) are bit-equal
    to one render; the tracer's shares and the scene-parallel queries (K6)
    within 1e-6; the gradients of one rank bit-equal, of two at the bar of
    ``tests/sharding_subproc.py:199-201``."""
    from tpuray_torch.parallel import distributed, selfcheck
    res = distributed.launch(selfcheck.checks, world, "cuda", backend=backend,
                             device="cuda", timeout=300)[0]
    assert str(res["backend"]) == backend
    for case in ("b", "b_mesh"):
        np.testing.assert_array_equal(res[f"{case}/sharded"],
                                      res[f"{case}/single"], err_msg=case)
    for case in ("a", "e", "h", "i"):
        got, want = res[f"{case}/sharded"], res[f"{case}/single"]
        assert np.isfinite(got).all() and np.abs(got - want).max() <= 1e-6, \
            case
    for case in ("c", "d"):
        loss = res[f"{case}/sharded/loss"]
        want_loss = res[f"{case}/single/loss"]
        names = [k.rsplit("/", 1)[1] for k in res
                 if k.startswith(f"{case}/sharded/grad/")]
        assert names
        if world == 1:
            assert loss == want_loss, case
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=case)
        for name in names:
            got = res[f"{case}/sharded/grad/{name}"]
            want = res[f"{case}/single/grad/{name}"]
            if world == 1:
                np.testing.assert_array_equal(got, want, err_msg=name)
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-5,
                                       err_msg=f"{case} {name}")


@pytest.mark.parametrize("mesh", [False, True], ids=["canonical", "mesh"])
def test_viewer_frames_launch_once_and_equal_fresh_renders(cuda, mesh,
                                                           monkeypatch):
    """The viewer's frame loop on the card: the scene (and its triangle
    tables) packed once, one megakernel launch a frame, and each frame
    bit-equal to a fresh ``render_from_basis`` of the same basis."""
    from tpuray_torch.apps import rayview
    from tpuray_torch.kernels import megakernel
    from tpuray_torch.meshes import mesh_benchmark_scene

    builds = []
    build = megakernel.build_tri_tables
    monkeypatch.setattr(megakernel, "build_tri_tables",
                        lambda s: builds.append(1) or build(s))
    spec = mesh_benchmark_scene(2) if mesh else tt.canonical_scene_spec()
    scene = tt.build_scene(spec, cuda)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 256, 256),
                                   cuda)
    width, height = 320, 240
    cfg = tt.RenderConfig(width=width, height=height, max_depth=6,
                          chunk_size=0)
    ctl = rayview.CameraController()
    loop = rayview.FrameLoop(scene, assets, cfg, ctl.camera())
    assert loop.engine == "megakernel" and len(builds) == 1
    for k in "wa8 6":
        ctl.key(k)
        cam = ctl.camera()
        before, built = render_megakernel.launches, len(builds)
        img = loop.frame(cam)
        assert render_megakernel.launches == before + 1
        assert len(builds) == built           # the frame built no table
        basis = tt.perspective_basis(cam, width, height, device="cpu")
        want = tt.render_from_basis(scene, assets, basis, cfg)
        assert torch.equal(loop.rgb, want)
        np.testing.assert_array_equal(
            img, tt.quantize_image(want, width, height).cpu().numpy())
        assert loop.times[-1]["device"] > 0


def test_serve_answers_frames_with_the_real_renderer(cuda):
    import threading
    import time
    import urllib.request

    from tpuray_torch.apps import rayview

    scene = tt.build_scene(tt.canonical_scene_spec(), cuda)
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 256, 256),
                                   cuda)
    cfg = tt.RenderConfig(width=256, height=192, max_depth=6, chunk_size=0)
    ctl = rayview.CameraController()
    loop = rayview.FrameLoop(scene, assets, cfg, ctl.camera())
    box = {}
    th = threading.Thread(
        target=rayview.serve,
        args=(ctl, lambda: loop.frame(ctl.camera()), 256, 192, 0),
        kwargs={"host": "127.0.0.1",
                "started": lambda httpd, stop: box.update(httpd=httpd,
                                                          stop=stop)},
        daemon=True)
    th.start()
    for _ in range(200):
        if "httpd" in box:
            break
        time.sleep(0.05)
    base = f"http://127.0.0.1:{box['httpd'].server_address[1]}"
    try:
        jpg = urllib.request.urlopen(f"{base}/frame.jpg", timeout=60).read()
        assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
        before = render_megakernel.launches
        urllib.request.urlopen(f"{base}/key?k=w", timeout=10).read()
        for _ in range(400):
            if render_megakernel.launches > before:
                break
            time.sleep(0.025)
        assert render_megakernel.launches == before + 1
    finally:
        box["stop"].set()
        box["httpd"].shutdown()
        th.join(timeout=10)
    assert not th.is_alive()


def test_nan_guard_catches_a_nan_out_of_the_megakernel(cuda):
    """K1 is launched through ctypes, out of the dispatcher's sight: under
    ``nan_guard`` its wrapper checks the image itself.  A NaN planted in
    the spheres' colour (packed before the guard) reaches the image; a NaN
    radius would not (every comparison with it is false: the sphere is
    missed)."""
    from tpuray_torch.utils.debug import nan_guard

    packed, assets, cfg = _inputs(cuda)
    with nan_guard():
        render_megakernel(packed, assets, cfg)
    scene = tt.build_scene(tt.canonical_scene_spec(), cuda)
    scene.sphere_mat.rgb[:, 0] = float("nan")
    basis = tt.perspective_basis(tt.Camera(*GOLDEN_CAMERA), cfg.width,
                                 cfg.height, device=cuda)
    bad = pack_scene(scene, basis)
    with nan_guard():
        with pytest.raises(FloatingPointError,
                           match="NaN values out of the megakernel"):
            render_megakernel(bad, assets, cfg)
