"""Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``)
into one shared library with a plain C interface (``tpuray_megakernel``,
``tpuray_megakernel_record``), which is loaded with ``ctypes``.  A library built against PyTorch's headers would take minutes to
compile; this one takes seconds.  The library goes into ``_build/`` (ignored
by git) under a name that carries a hash of the sources and flags, so it is
rebuilt only when they change.  Nothing outside this package is compiled.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# No --use_fast_math: its sin/cos/pow/sqrt move soft-shadow samples and
# grazing hits.  --fmad=false keeps a*b+c as two roundings, as the plain
# PyTorch version computes it: with nvcc's default FMA contraction 0.15%
# (1080p d4) to 0.5% (200x50 d6) of pixels came out different from the
# plain version on the H100, all of them chaotic grazing or texel-edge
# pixels; without it every pixel agrees to 4e-7, for 7-9% more kernel
# time (1080p depth 4).  -Xptxas -v reports registers, stack and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class KernelLibrary:
    path: str
    lib: ctypes.CDLL
    log: str            # nvcc's output from the build ("" if cached)


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME / $CUDA_PATH, else
    where PyTorch's extension builder finds the toolkit."""
    path = shutil.which("nvcc")
    if path:
        return path
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    if not any(homes):
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpuray_kernels_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> str:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cu = [s for s in sources() if s.endswith(".cu")]
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builders never see half
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; once per process."""
    path = library_path()
    log = _compile(path) if not os.path.exists(path) else ""
    lib = ctypes.CDLL(path)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpuray_megakernel.argtypes = [
        p, i, i, i,            # scene, n_spheres, n_planes, n_lights
        p, i, i,               # textures, tex_h, tex_w
        p, i, i,               # skybox, sky_h, sky_w
        i, i, i, i,            # width, height, max_depth, shadow_samples
        fl, fl, fl,            # epsilon, transparent_through, default_n
        p, p]                  # out, stream
    lib.tpuray_megakernel.restype = i
    lib.tpuray_megakernel_record.argtypes = [
        p, i, i, i,            # scene, n_spheres, n_planes, n_lights
        p, i, i, i,            # textures, n_textures, tex_h, tex_w
        p, i, i,               # skybox, sky_h, sky_w
        i, i, i, i,            # width, height, max_depth, shadow_samples
        fl, fl, fl,            # epsilon, transparent_through, default_n
        i,                     # record slots
        p, p, p, p, p,         # out, rec, ssr, pick, max_nodes
        p]                     # stream
    lib.tpuray_megakernel_record.restype = i
    lib.tpuray_error_string.argtypes = [i]
    lib.tpuray_error_string.restype = ctypes.c_void_p
    return KernelLibrary(path=path, lib=lib, log=log)
