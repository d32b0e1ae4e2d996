"""ctypes binding of the repository's C++ score oracles,
``gotoh_score_cpu`` and ``gotoh_score_cpu_subst`` (a (256, 256) byte-pair
score table: protein matrices) in ``native/gotoh_cpu.cpp``.

An independent reference-equivalent CPU fill (int64, row-major, linear
memory): the check for pair sizes no Python oracle reaches. It is
compiled at first use with the host C++ compiler and the flags of
``native/Makefile`` into the port's build directory (only this one
source; the library that ``make -C native`` builds also holds the
suffix-tree code, which the port does not need yet).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from genomics_rs_tpu_torch.ops._build import PKG_DIR, build_dir

SOURCE = PKG_DIR.parent / "native" / "gotoh_cpu.cpp"
#: native/Makefile's CXXFLAGS (it documents why -O2 and not -O3).
CXXFLAGS = ["-O2", "-march=native", "-fPIC", "-shared", "-Wall", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not SOURCE.exists():
            raise RuntimeError(f"{SOURCE} not found")
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++/c++) to build the oracle")
        h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode())
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"libgotoh_cpu_{h.hexdigest()[:16]}.so"
        if not so.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.run(
                [cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"C++ build failed:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.gotoh_score_cpu.argtypes = [vp, i64, vp, i64, i64, i64, i64, i64,
                                        ctypes.c_int, vp]
        lib.gotoh_score_cpu.restype = ctypes.c_int
        lib.gotoh_score_cpu_subst.argtypes = [vp, i64, vp, i64, vp, i64, i64, ctypes.c_int, vp]
        lib.gotoh_score_cpu_subst.restype = ctypes.c_int
        _lib = lib
        return lib


def gotoh_score_cpu(s1: str, s2: str, scores, is_local: bool) -> tuple[int, int, int]:
    """(score, start_i, start_j) under the classic two-score model."""
    if scores.s_transition is not None:
        raise ValueError("the oracle binding covers classic scoring only")
    lib = library()
    a = np.frombuffer(s1.encode("ascii"), np.uint8).copy()
    b = np.frombuffer(s2.encode("ascii"), np.uint8).copy()
    out = np.zeros(3, np.int64)
    rc = lib.gotoh_score_cpu(
        a.ctypes.data, len(a), b.ctypes.data, len(b),
        scores.s_match, scores.s_mismatch, scores.g, scores.h,
        int(is_local), out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"gotoh_score_cpu returned {rc}")
    return int(out[0]), int(out[1]), int(out[2])


def gotoh_score_cpu_subst(s1: str, s2: str, lut256, g: int, h: int,
                          is_local: bool) -> tuple[int, int, int]:
    """(score, start_i, start_j) with ``sub(a, b) = lut256[a, b]``, e.g.
    ``SubstMatrix.byte_lut()``."""
    lib = library()
    lut = np.ascontiguousarray(lut256, dtype=np.int32)
    if lut.shape != (256, 256):
        raise ValueError(f"lut256 must be (256, 256), got {lut.shape}")
    a = np.frombuffer(s1.encode("latin-1"), np.uint8).copy()
    b = np.frombuffer(s2.encode("latin-1"), np.uint8).copy()
    out = np.zeros(3, np.int64)
    rc = lib.gotoh_score_cpu_subst(
        a.ctypes.data, len(a), b.ctypes.data, len(b), lut.ctypes.data,
        g, h, int(is_local), out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"gotoh_score_cpu_subst returned {rc}")
    return int(out[0]), int(out[1]), int(out[2])
