"""Native (C++) host-side components, built on demand with g++ + ctypes.

Counterpart of `youreditableavatar_tpu/native/__init__.py`: `MeshSDF`, the
BVH signed distance to a watertight mesh used by the shape init. The port
keeps its own copy of the C++ source (`meshsdf.cpp` here) and builds it
with g++ at first use into the package's git-ignored `_build/` directory,
keyed by a hash of the source and flags. A chunked NumPy fallback covers
environments without a toolchain (small meshes only); `using_native` says
which one a `MeshSDF` runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "meshsdf.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared"]
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _compile(out: Path, flags) -> bool:
    """g++ into a temporary file, then an atomic rename onto `out`."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build_library() -> Optional[Path]:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmeshsdf_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # With OpenMP, else without it.
    if _compile(out, _FLAGS + ["-fopenmp"]) or _compile(out, _FLAGS):
        return out
    return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        path = _build_library()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.meshsdf_build.restype = ctypes.c_void_p
        lib.meshsdf_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.meshsdf_query.restype = None
        lib.meshsdf_query.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.meshsdf_free.restype = None
        lib.meshsdf_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


class MeshSDF:
    """Signed distance to a watertight mesh (positive outside)."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self.verts = np.ascontiguousarray(verts, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self._lib = _get_lib()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.meshsdf_build(
                self.verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(self.verts),
                self.faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                len(self.faces),
            )

    @property
    def using_native(self) -> bool:
        return self._handle is not None

    def __call__(self, points: np.ndarray) -> np.ndarray:
        pts = np.ascontiguousarray(points, np.float32)
        if self._handle is not None:
            out = np.empty(len(pts), np.float32)
            self._lib.meshsdf_query(
                self._handle,
                pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(pts),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out
        return self._numpy_fallback(pts)

    def _numpy_fallback(self, pts: np.ndarray, chunk: int = 2048) -> np.ndarray:
        """Brute-force closest-triangle distance + ray-parity sign."""
        v = self.verts.astype(np.float64)
        f = self.faces
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        out = np.empty(len(pts), np.float32)
        for s in range(0, len(pts), chunk):
            p = pts[s : s + chunk].astype(np.float64)
            d = _point_tri_dist(p, a, b, c)
            sign = _ray_parity(p, a, b, c)
            out[s : s + chunk] = np.where(sign, -d, d)
        return out

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            self._lib.meshsdf_free(self._handle)
            self._handle = None


def _point_tri_dist(p, a, b, c):
    """(P,) min distance from points to any triangle (vectorized Ericson)."""
    ab = b - a
    ac = c - a
    pa = p[:, None, :] - a[None]
    d1 = np.einsum("fk,pfk->pf", ab, pa)
    d2 = np.einsum("fk,pfk->pf", ac, pa)
    pb = p[:, None, :] - b[None]
    d3 = np.einsum("fk,pfk->pf", ab, pb)
    d4 = np.einsum("fk,pfk->pf", ac, pb)
    pc = p[:, None, :] - c[None]
    d5 = np.einsum("fk,pfk->pf", ab, pc)
    d6 = np.einsum("fk,pfk->pf", ac, pc)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    w_b = np.where(np.abs(denom) > 1e-30, vb / np.where(denom == 0, 1, denom),
                   0.0)
    w_c = np.where(np.abs(denom) > 1e-30, vc / np.where(denom == 0, 1, denom),
                   0.0)

    # Clamp to each region following the scalar algorithm.
    t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0, 1)
    t_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1, d2 - d6), 0, 1)
    t_bc = np.clip(
        (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1,
                             (d4 - d3) + (d5 - d6)), 0, 1,
    )

    cand_face = a[None] + w_b[..., None] * ab[None] + w_c[..., None] * ac[None]
    cand_ab = a[None] + t_ab[..., None] * ab[None]
    cand_ac = a[None] + t_ac[..., None] * ac[None]
    cand_bc = b[None] + t_bc[..., None] * (c - b)[None]

    inside = (vb >= 0) & (vc >= 0) & (va >= 0)
    d_face = np.where(
        inside,
        np.sum((p[:, None] - cand_face) ** 2, -1),
        np.inf,
    )
    d_ab = np.sum((p[:, None] - cand_ab) ** 2, -1)
    d_ac = np.sum((p[:, None] - cand_ac) ** 2, -1)
    d_bc = np.sum((p[:, None] - cand_bc) ** 2, -1)
    d2_all = np.minimum(np.minimum(d_ab, d_ac), np.minimum(d_bc, d_face))
    return np.sqrt(d2_all.min(axis=1))


def _ray_parity(p, a, b, c, d=np.array([0.57735, 0.267261, 0.801784])):
    d = d / np.linalg.norm(d)
    e1 = b - a
    e2 = c - a
    pv = np.cross(d[None], e2)
    det = np.einsum("fk,fk->f", e1, pv)
    ok = np.abs(det) > 1e-12
    invdet = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
    tv = p[:, None, :] - a[None]
    u = np.einsum("pfk,fk->pf", tv, pv) * invdet[None]
    qv = np.cross(tv, e1[None])
    v = np.einsum("pfk,k->pf", qv, d) * invdet[None]
    t = np.einsum("pfk,fk->pf", qv, e2) * invdet[None]
    hit = ok[None] & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-7)
    return hit.sum(axis=1) % 2 == 1
