"""ctypes bindings for the native C++ I/O library (``native/``).

Port of :mod:`tpuray.native_lib`.  The reference's host runtime is C
(cpu_ray.c's png_dump, opencl_wrap.c's PNG loader, cpu_obj.c's scene
archive); its I/O side has a C++ equivalent here, ``native/tpuray_native.cc``
(the port's own copy of the JAX package's source), with a PNG codec over
libpng and the ``render.map`` codec.

At first use ``g++`` builds it (``-O2 -fPIC -std=c++17 -shared -lpng -lz``)
into ``native/_build/`` (ignored by git), under a name that carries a hash
of the source, the compiler and the flags; the library is written to a
temporary name and moved into place by an atomic rename, so processes that
build at the same time never load half a file.  Where it cannot be built
or loaded (no ``g++``, no ``png.h``), :func:`available` is False, warns
once with the reason, and :func:`status` gives it; ``io.write_png`` then
writes through numpy + zlib.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native", "tpuray_native.cc")
BUILD_DIR = os.path.join(_HERE, "native", "_build")
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")
LIBS = ("-lpng", "-lz")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_path: Optional[str] = None
_error: Optional[str] = None


def library_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS, *LIBS)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpuray_native_{h.hexdigest()[:16]}.so")


def _build(cxx: str, path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            lines = proc.stderr.strip().splitlines() or [""]
            why = next((ln for ln in lines if "error" in ln), lines[-1])
            raise OSError(f"{cxx} failed ({proc.returncode}): {why.strip()}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_char_p, ctypes.c_int
    u8p, ip, vp = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(i),
                   ctypes.c_void_p)
    for name, argtypes in (
            ("tpuray_write_png", [p, u8p, i, i]),
            ("tpuray_read_png_size", [p, ip, ip]),
            ("tpuray_read_png", [p, u8p]),
            ("tpuray_scene_counts", [p, ip, ip, ip, ip]),
            ("tpuray_scene_read", [p, vp, vp, vp, vp]),
            ("tpuray_scene_write", [p, vp, i, vp, i, vp, i, vp, i])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library once per process; a failure
    is kept with its reason and not retried."""
    global _lib, _path, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        try:
            if cxx is None:
                raise OSError("no C++ compiler: g++ (or $CXX) is not on "
                              "PATH")
            path = library_path(cxx)
            if not os.path.exists(path):
                _build(cxx, path)
            _lib, _path = _bind(ctypes.CDLL(path)), path
        except OSError as e:
            _error = str(e)
            warnings.warn(f"native I/O library not loaded ({_error}); PNGs "
                          "are written with numpy + zlib", RuntimeWarning,
                          stacklevel=3)
        return _lib


def available() -> bool:
    """Whether the library builds and loads; the first time it does not,
    a ``RuntimeWarning`` gives the reason (also in :func:`status`)."""
    return _load() is not None


def status() -> str:
    """``'loaded <path>'``, or ``'not loaded: <reason>'``."""
    _load()
    return f"loaded {_path}" if _lib is not None else f"not loaded: {_error}"


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native I/O library not loaded: {_error}")
    return lib


def write_png(path: str, img_u8: np.ndarray) -> None:
    lib = _require()
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes RGB u8 [H, W, 3], got "
                         f"{img.shape}")
    h, w = img.shape[0], img.shape[1]
    rc = lib.tpuray_write_png(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h)
    if rc != 1:
        raise IOError(f"native png write failed for {path}")


def read_png(path: str) -> np.ndarray:
    lib = _require()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.tpuray_read_png_size(path.encode(), ctypes.byref(w),
                                ctypes.byref(h)) != 1:
        raise IOError(f"native png open failed for {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.tpuray_read_png(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))) != 1:
        raise IOError(f"native png read failed for {path}")
    return out


# ---------------------------------------------------------------------------
# Scene archive codec (numpy structured dtypes mirror the on-disk C structs;
# the layout is sceneio.py's)
# ---------------------------------------------------------------------------

MATERIAL_DTYPE = np.dtype({
    "names": ["rgb", "ambient", "diffuse", "specular", "shininess",
              "transperent", "dielectric", "n", "reflectivity", "texture_id",
              "texture_scale"],
    "formats": [("<f4", (3,)), "<f4", "<f4", "<f4", "<u4", "<u4", "<u4",
                "<f4", "<f4", "<i4", "<f4"],
    "offsets": [0, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52],
    "itemsize": 64,
})
SPHERE_DTYPE = np.dtype({
    "names": ["origin", "radius", "mat"],
    "formats": [("<f4", (3,)), "<f4", MATERIAL_DTYPE],
    "offsets": [0, 16, 32], "itemsize": 96,
})
PLANE_DTYPE = np.dtype({
    "names": ["normal", "point", "mat"],
    "formats": [("<f4", (3,)), ("<f4", (3,)), MATERIAL_DTYPE],
    "offsets": [0, 16, 32], "itemsize": 96,
})
LIGHT_DTYPE = np.dtype({
    "names": ["origin", "radius", "intensity", "rgb"],
    "formats": [("<f4", (3,)), "<f4", "<f4", ("<f4", (3,))],
    "offsets": [0, 16, 20, 32], "itemsize": 48,
})
TRIANGLE_DTYPE = np.dtype({
    "names": ["v0", "v1", "v2", "mat"],
    "formats": [("<f4", (3,)), ("<f4", (3,)), ("<f4", (3,)), MATERIAL_DTYPE],
    "offsets": [0, 16, 32, 48], "itemsize": 112,
})


def scene_read(path: str):
    """extract_robj equivalent: returns structured arrays
    (spheres, planes, lights, triangles)."""
    lib = _require()
    counts = [ctypes.c_int() for _ in range(4)]
    if lib.tpuray_scene_counts(path.encode(),
                               *[ctypes.byref(c) for c in counts]) != 1:
        raise IOError(f"native scene parse failed for {path}")
    ns, npl, nl, nt = (c.value for c in counts)
    spheres = np.zeros(ns, SPHERE_DTYPE)
    planes = np.zeros(npl, PLANE_DTYPE)
    lights = np.zeros(nl, LIGHT_DTYPE)
    tris = np.zeros(nt, TRIANGLE_DTYPE)
    if lib.tpuray_scene_read(path.encode(), spheres.ctypes.data,
                             planes.ctypes.data, lights.ctypes.data,
                             tris.ctypes.data) != 1:
        raise IOError(f"native scene read failed for {path}")
    return spheres, planes, lights, tris


def scene_write(path: str, spheres: np.ndarray, planes: np.ndarray,
                lights: np.ndarray, tris: np.ndarray) -> None:
    """dump_robj equivalent (padding zeroed, unlike the reference)."""
    lib = _require()
    spheres = np.ascontiguousarray(spheres, SPHERE_DTYPE)
    planes = np.ascontiguousarray(planes, PLANE_DTYPE)
    lights = np.ascontiguousarray(lights, LIGHT_DTYPE)
    tris = np.ascontiguousarray(tris, TRIANGLE_DTYPE)
    if lib.tpuray_scene_write(path.encode(), spheres.ctypes.data,
                              len(spheres), planes.ctypes.data, len(planes),
                              lights.ctypes.data, len(lights),
                              tris.ctypes.data, len(tris)) != 1:
        raise IOError(f"native scene write failed for {path}")
