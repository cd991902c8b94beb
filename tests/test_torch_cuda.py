"""The CUDA megakernel on the card: built with nvcc from the repository's
sources, held against its plain PyTorch version, and its wrapper's
refusals.  Every test needs an NVIDIA GPU and the CUDA toolkit and skips
without them (marker ``cuda``); on the card run
``python -m pytest tests/test_torch_cuda.py -q``."""
import shutil

import numpy as np
import pytest
import torch

import tpuray_torch as tt
from tpuray_torch.kernels import build
from tpuray_torch.kernels.megakernel import (MAX_DEPTH_CAP, pack_scene,
                                             render_megakernel,
                                             render_megakernel_reference)

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
