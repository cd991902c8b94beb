"""The CUDA megakernel on the card, in its base and record instantiations:
built with nvcc from the repository's sources, held against the plain
PyTorch versions, the gradient through ``render_megakernel_diff`` against
the same on the CPU, and the wrappers' refusals.  Every test needs an
NVIDIA GPU and the CUDA toolkit and skips without them (marker ``cuda``);
on the card run ``python -m pytest tests/test_torch_cuda.py -q``."""
import shutil

import numpy as np
import pytest
import torch

import tpuray_torch as tt
from tpuray_torch.kernels import build
from tpuray_torch.kernels.megakernel import (
    MAX_DEPTH_CAP, pack_scene, render_megakernel, render_megakernel_record,
    render_megakernel_record_reference, render_megakernel_reference)

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


def test_record_wrapper_refusals_on_the_card(cuda):
    check_record_refusals(cuda)


def crowded_spec(n_spheres=0, n_lights=0):
    spec = tt.canonical_scene_spec()
    spec.spheres += [tt.SphereSpec((0.1 * i, 5.0, 9.0), 0.05, tt.PLASTIC)
                     for i in range(n_spheres)]
    spec.lights += [tt.LightSpec((0.1 * i, 9.0, 9.0), 0.05, 1.0, (1, 1, 1))
                    for i in range(n_lights)]
    return spec


def check_record_refusals(device):
    """More than 64 solids or 62 lights (the hit code's ranges), record
    slots outside [1, 64] (6-bit parent slots), triangles and bilinear
    filtering (not ported yet) are refused; the caps themselves work."""
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
    spec = tt.canonical_scene_spec()
    spec.triangles.append(tt.TriangleSpec((0, 0, 0), (1, 0, 0), (0, 1, 0),
                                          tt.PLASTIC))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pack_scene(tt.build_scene(spec, device), basis)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.RenderConfig(filter="bilinear", record_slots=8)
