"""ctypes binding of the repository's C++ host code in ``native/``: the
score oracles ``gotoh_score_cpu`` and ``gotoh_score_cpu_subst`` (a
(256, 256) byte-pair score table: protein matrices) in ``gotoh_cpu.cpp``,
the suffix-tree arena core (``st_*``, ``suffixtree.cpp``) and SA-IS
(``sais_u8``, ``sais.cpp``).

The Gotoh oracle is an independent reference-equivalent CPU fill (int64,
row-major, linear memory): the check for pair sizes no Python oracle
reaches. The suffix-tree and SA-IS functions are wrapped by
``suffixtree/native.py``. The three sources are compiled at first use
into one library, as ``native/Makefile`` links them, with the host C++
compiler and the Makefile's flags, into the port's build directory under
a hash of the sources and flags (never into ``native/build/``, which
``make -C native`` owns). A failed build raises.
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

NATIVE_DIR = PKG_DIR.parent / "native"
SOURCES = [NATIVE_DIR / name for name in ("gotoh_cpu.cpp", "suffixtree.cpp", "sais.cpp")]
#: native/Makefile's CXXFLAGS (it documents why -O2 and not -O3).
CXXFLAGS = ["-O2", "-march=native", "-fPIC", "-shared", "-Wall", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _declare(lib: ctypes.CDLL) -> None:
    i32, i64, vp, cp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    sigs = {
        "gotoh_score_cpu": ([vp, i64, vp, i64, i64, i64, i64, i64, ctypes.c_int, vp],
                            ctypes.c_int),
        "gotoh_score_cpu_subst": ([vp, i64, vp, i64, vp, i64, i64, ctypes.c_int, vp],
                                  ctypes.c_int),
        "st_new": ([cp, i64], vp),
        "st_free": ([vp], None),
        "st_insert": ([vp, cp, i64, ctypes.c_int], ctypes.c_int),
        "st_stats": ([vp, ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_double), cp, i64],
                     ctypes.c_int),
        "st_lcs": ([vp, i32, i32, ctypes.POINTER(i64)], ctypes.c_int),
        "st_similarity": ([cp, i64, cp, i64, cp, i64, ctypes.c_char, ctypes.c_char,
                           ctypes.POINTER(i64)], ctypes.c_int),
        "sais_u8": ([cp, i64, ctypes.POINTER(i32)], ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        missing = [str(s) for s in SOURCES if not s.exists()]
        if missing:
            raise RuntimeError(f"{', '.join(missing)} not found")
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++/c++) to build native/")
        h = hashlib.sha256(" ".join(CXXFLAGS).encode())
        for s in SOURCES:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"libgenomics_native_{h.hexdigest()[:16]}.so"
        if not so.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.run(
                [cxx, *CXXFLAGS, "-o", tmp, *map(str, SOURCES)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"C++ build failed:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
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
