"""Build and load the port's CUDA kernels, and route tensors to them.

The kernels in ``csrc/*.cu`` have a plain C interface. At first use
they are compiled by ``nvcc`` for Hopper (``sm_90a``), one process per
source, all at once, and linked into one shared library, loaded with
``ctypes``. The library lands in ``_build/``
inside this package (git ignores it), under a name keyed by a hash of
the sources and flags, so an edit rebuilds and an unchanged tree
reuses the last build. Nothing is downloaded: the build reads only the
package's own sources.

Routing (:func:`uses_kernel`): a CPU tensor takes the plain PyTorch
version, a CUDA tensor takes the kernel, anything else raises. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when it was reused) and ptxas's
#: register/shared-memory report from it.
BUILD_INFO: dict = {}


def build_dir() -> Path:
    return PKG_DIR / "_build"


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "cannot be built"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"libgenomics_kernels_{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not so.exists():
            BUILD_INFO["ptxas"] = _compile(srcs, out_dir, so)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["path"] = str(so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


def _compile(srcs: list[Path], out_dir: Path, so: Path) -> str:
    """One ``nvcc -c`` per ``.cu`` source, all started together, then one
    link into ``so``. Returns ptxas's report of every source."""
    nvcc = _find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for s in srcs:
            if s.suffix == ".cu":
                obj = Path(tmp) / f"{s.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
                procs.append((s, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errs = [proc.communicate()[1] for _, _, proc in procs]  # wait for all
        for (s, _, proc), err in zip(procs, errs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name} ({proc.returncode}):\n{err}")
        lib = Path(tmp) / "lib.so"
        link = [nvcc, *LINK_FLAGS, "-o", str(lib)] + [str(o) for _, o, _ in procs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, so)
    return "".join(errs)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gotoh_rowblock_blocks_per_sm.argtypes = [i, i, i]
    lib.gotoh_rowblock_blocks_per_sm.restype = i
    lib.gotoh_rowblock_launch.argtypes = [vp] * 10 + [i] * 19 + [ctypes.c_longlong, vp]
    lib.gotoh_rowblock_launch.restype = i
    lib.traceback_walk_launch.argtypes = [vp, vp] + [i] * 7 + [vp]
    lib.traceback_walk_launch.restype = i
    lib.gotoh_stream_blocks_per_sm.argtypes = [i, i, i]
    lib.gotoh_stream_blocks_per_sm.restype = i
    lib.gotoh_stream_launch.argtypes = [vp] * 7 + [i] * 16 + [ctypes.c_longlong, vp]
    lib.gotoh_stream_launch.restype = i
    lib.walk_many_launch.argtypes = [vp] * 4 + [i] * 6 + [vp]
    lib.walk_many_launch.restype = i
    lib.gotoh_shortread_launch.argtypes = [vp] * 6 + [i] * 12 + [vp]
    lib.gotoh_shortread_launch.restype = i
    lib.walk_rows16_launch.argtypes = [vp] * 4 + [i] * 8 + [vp]
    lib.walk_rows16_launch.restype = i
    lib.gotoh_banded_blocks_per_sm.argtypes = []
    lib.gotoh_banded_blocks_per_sm.restype = i
    lib.gotoh_banded_launch.argtypes = [vp] * 8 + [i] * 15 + [ctypes.c_longlong, vp]
    lib.gotoh_banded_launch.restype = i
    lib.walk_banded_launch.argtypes = [vp] * 5 + [i] * 7 + [vp]
    lib.walk_banded_launch.restype = i
    lib.matrix_profile_launch.argtypes = [vp] * 4 + [i] * 4 + [vp]
    lib.matrix_profile_launch.restype = i
    lib.gotoh_matrix_blocks_per_sm.argtypes = [i, i, i]
    lib.gotoh_matrix_blocks_per_sm.restype = i
    lib.gotoh_matrix_launch.argtypes = [vp] * 7 + [i] * 13 + [ctypes.c_longlong, vp]
    lib.gotoh_matrix_launch.restype = i
    lib.gotoh_segmented_launch.argtypes = [vp] * 6 + [i] * 10 + [vp]
    lib.gotoh_segmented_launch.restype = i
    lib.gotoh_pallas_blocks_per_sm.argtypes = [i, i]
    lib.gotoh_pallas_blocks_per_sm.restype = i
    lib.gotoh_pallas_launch.argtypes = [vp] * 6 + [i] * 14 + [ctypes.c_longlong, vp]
    lib.gotoh_pallas_launch.restype = i


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_handle(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def require(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    """Check one kernel operand's device, dtype, contiguity and shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
