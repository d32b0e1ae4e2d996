"""Device meshes (counterpart of ``genomics_rs_tpu/parallel/mesh.py``).

JAX's ``Mesh`` is one controller driving the local devices of one
process; so is this one: an object array of ``torch.device``s with axis
names. A ``data`` axis spreads pairs over devices, a ``seq`` axis spreads
the DP rows of one long pair (``parallel/longseq``). Work across
processes goes through ``torch.distributed`` instead
(``parallel/distributed``).

By default a mesh takes the local CUDA devices. An explicit ``devices=``
list may repeat a device: P shards on one card run their tiles of one
wave on P CUDA streams at once, and the CPU tests build meshes of
``torch.device("cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


class Mesh:
    """``devices``: object array of ``torch.device``, one axis a name."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array, axis names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def axis_devices(mesh: Mesh, axis_name: str) -> list[torch.device]:
    """The devices along ``axis_name`` (index 0 on any other axis): where
    a JAX ``shard_map`` would shard over that axis and replicate over the
    others."""
    ax = mesh.axis_names.index(axis_name)
    arr = np.moveaxis(mesh.devices, ax, -1)
    return list(arr.reshape(-1, arr.shape[-1])[0])


def local_devices(devices) -> list[torch.device]:
    if devices is not None:
        return [resolve_device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass devices= for a CPU or explicit mesh)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS, devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (the local CUDA
    devices by default; all of them when ``n_devices`` is None)."""
    devs = local_devices(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, (axis_name,))


def make_mesh_2d(n_data: int, n_seq: int, axis_names: tuple[str, str] = (DATA_AXIS, SEQ_AXIS),
                 devices=None) -> Mesh:
    """2-D (data, seq) mesh: pairs over ``data``, the wavefront tiles of
    one long pair over ``seq``."""
    devs = local_devices(devices)
    need = n_data * n_seq
    if need > len(devs):
        raise ValueError(f"requested {need} devices, only {len(devs)} available")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(n_data, n_seq), axis_names)
