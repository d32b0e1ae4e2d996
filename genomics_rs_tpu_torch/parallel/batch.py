"""Batched pair scoring (counterpart of ``genomics_rs_tpu/parallel/batch.py``:
``score_pairs``, ``_kernel_scores``, ``pad_batch`` and the router's tier
bounds).

Five kernel engines, each a kernel on a CUDA device and its plain version
on the CPU: ``"shortread"`` (K6, a group of 8-32 lanes a pair, up to 256
bytes), ``"segmented"`` (K7: the warp-strip kernel, one warp a pair at
any length), ``"stream8"`` (K8) and ``"stream"`` (K3), both the
warp-strip pipeline at their own launch counts, and ``"pallas"`` (K9);
the last three pipeline one pair's row strips over many warps, K3's and
K8's launches returning their error words unread. ``"auto"`` tiers a bucket
by padded length as the JAX router does on its device
(:func:`route_engine`). ``"scan"`` is the JAX package's oracle engine,
:func:`batch_scores`: the scan fill (``ops/gotoh_scan``) over the whole
batch as torch ops on the batch's device. The router never picks it, and
no named engine falls back to it.

The mesh paths: :func:`batch_scores_sharded` gives each device of a mesh
axis an equal slice of the batch, scored on that device by the engine
:func:`mesh_bucket_engine` picks (the JAX package's picks for a sharded
bucket), and merges the batch statistics as JAX's ``pmax``/``psum`` do;
:func:`device_loop_scores` places equal slices on a list of devices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_pallas import gotoh_scores_pallas_batch, raise_on_err
from genomics_rs_tpu_torch.ops.gotoh_scan import gotoh_fill_scan_batch
from genomics_rs_tpu_torch.ops.gotoh_segmented import gotoh_scores_segmented
from genomics_rs_tpu_torch.ops.gotoh_shortread import SHORTREAD_MAX_LEN, gotoh_scores_shortread
from genomics_rs_tpu_torch.ops.gotoh_stream import gotoh_scores_stream, gotoh_stream_fill
from genomics_rs_tpu_torch.ops.gotoh_stream8 import gotoh_scores_stream8, gotoh_stream8_fill
from genomics_rs_tpu_torch.parallel.mesh import DATA_AXIS, axis_devices
from genomics_rs_tpu_torch.utils.profiling import annotate

#: The JAX router's tier bounds (padded lengths): past the short-read
#: tier (K6, up to ``SHORTREAD_MAX_LEN``), the segmented tier up to this
#: one...
SEGMENTED_MAX_LEN = 8192
#: ...with the 8-stream tier above this one in global mode at B >= 2.
STREAM8_MIN_LEN = 1024

_ENGINES = {
    "shortread": gotoh_scores_shortread,
    "segmented": gotoh_scores_segmented,
    "stream8": gotoh_scores_stream8,
    "stream": gotoh_scores_stream,
    "pallas": gotoh_scores_pallas_batch,
}
#: the engines whose fill returns its error word unread (:func:`_read`
#: reads it).
_FILLS = {"stream": gotoh_stream_fill, "stream8": gotoh_stream8_fill}


def shortread_fits(L1: int, L2: int, ms, ns) -> bool:
    """True when K6 takes a (L1, L2) bucket: both padded lengths within
    ``SHORTREAD_MAX_LEN``, ``L2`` a multiple of 16, and no empty
    sequence."""
    return (max(L1, L2) <= SHORTREAD_MAX_LEN and L2 % 16 == 0
            and int(np.min(ms, initial=1)) >= 1 and int(np.min(ns, initial=1)) >= 1)


def route_engine(B: int, Lm: int, Ln: int, is_local: bool, ms, ns) -> str:
    """The engine ``"auto"`` runs for a bucket of B pairs padded to (Lm, Ln):
    the JAX router's tiers (short-read up to 256, segmented up to 8,192
    with stream8 for global buckets past 1,024 at B >= 2, then stream at
    B >= 2 and pallas for a single pair). A short bucket that K6 does not
    take (an empty sequence, ``Ln % 16 != 0``) goes to the segmented
    kernel, where JAX's short-read wrapper pads it."""
    if max(Lm, Ln) <= SHORTREAD_MAX_LEN:
        return "shortread" if shortread_fits(Lm, Ln, ms, ns) else "segmented"
    if Lm <= SEGMENTED_MAX_LEN:
        return "stream8" if not is_local and Lm > STREAM8_MIN_LEN and B >= 2 else "segmented"
    return "stream" if B >= 2 else "pallas"


def _kernel_scores(engine: str, s1b, s2b, ms, ns, scores, is_local: bool):
    """Dispatch one named engine on tensors already on their device;
    returns (score, start_i, start_j) int32 tensors of shape (B,) and
    K3's or K8's unread error word (None from the other engines, which
    read their own): the caller reads it with the scores (:func:`_read`)."""
    if engine == "scan":
        fill = gotoh_fill_scan_batch(s1b, s2b, ms, ns, scores, is_local, emit_dirs=False)
        return fill.score, fill.start_i, fill.start_j, None
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine in _FILLS:
        fill = _FILLS[engine](s1b, s2b, ms, ns, scores, is_local)
        return fill.score, fill.start_i, fill.start_j, fill.err
    return (*_ENGINES[engine](s1b, s2b, ms, ns, scores, is_local), None)


def _read(outs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy (score, start_i, start_j) of :func:`_kernel_scores` results,
    concatenated, after their error words are read."""
    for o in outs:
        if o[3] is not None:
            raise_on_err(o[3], "batch fill")
    with annotate("genomics/batch.readback"):
        return tuple(np.concatenate([o[x].cpu().numpy() for o in outs]) for x in range(3))


def score_pairs(s1b, s2b, ms, ns, scores, is_local: bool = False,
                engine: str = "auto", device="cuda"):
    """Score a batch of encoded pairs (uint8 (B, Lm) and (B, Ln), true
    lengths ``ms``/``ns``) on ``device``: ``engine`` is ``"auto"``
    (:func:`route_engine`) or one of ``"shortread"``, ``"segmented"``,
    ``"stream8"``, ``"stream"``, ``"pallas"``, ``"scan"``. Returns numpy
    ``(score, start_i, start_j)`` int32 arrays of shape (B,)."""
    dev = resolve_device(device)
    if engine == "auto":
        engine = route_engine(s1b.shape[0], s1b.shape[1], s2b.shape[1], is_local, ms, ns)
    s1 = torch.as_tensor(np.ascontiguousarray(s1b), dtype=torch.uint8).to(dev)
    s2 = torch.as_tensor(np.ascontiguousarray(s2b), dtype=torch.uint8).to(dev)
    return _read([_kernel_scores(engine, s1, s2, ms, ns, scores, is_local)])


def _cells(ms, ns) -> np.float32:
    """True DP cells, sum of (m + 1)(n + 1), in float32 as JAX sums them."""
    f = np.float32
    return np.sum((np.asarray(ms).astype(f) + f(1)) * (np.asarray(ns).astype(f) + f(1)),
                  dtype=f)


def batch_scores(s1eb, s2eb, ms, ns, scores, is_local: bool) -> "BatchScores":
    """Score a batch of pairs on one device with the scan fill (the JAX
    package's ``vmap`` over ``gotoh_fill_scan``): uint8 (B, Lm) and (B, Ln)
    tensors (their device runs the fill) or numpy arrays (on the CPU), true
    lengths ``ms``/``ns``. Returns :class:`BatchScores` with numpy
    per-pair results."""
    s1 = torch.as_tensor(np.ascontiguousarray(s1eb)) if not torch.is_tensor(s1eb) else s1eb
    s2 = torch.as_tensor(np.ascontiguousarray(s2eb)) if not torch.is_tensor(s2eb) else s2eb
    sc, si, sj = _read([_kernel_scores("scan", s1, s2.to(s1.device), ms, ns, scores,
                                       is_local)])
    ms_h = ms.cpu().numpy() if torch.is_tensor(ms) else ms
    ns_h = ns.cpu().numpy() if torch.is_tensor(ns) else ns
    return BatchScores(score=sc, start_i=si, start_j=sj, max_score=int(sc.max()),
                       total_cells=_cells(ms_h, ns_h))


def pad_batch(arrs, batch: int, multiple: int, pad_values=None):
    """Pad the leading batch dim of every array in ``arrs`` up to a
    multiple. ``pad_values[i]`` fills array i's padding rows; ``None``
    replicates row 0. Returns (padded arrays, padded batch size)."""
    pb = -(-batch // multiple) * multiple
    if pb == batch:
        return arrs, batch
    if pad_values is None:
        pad_values = [None] * len(arrs)
    out = []
    for a, pv in zip(arrs, pad_values):
        if pv is None:
            pad = np.broadcast_to(a[:1], (pb - batch,) + a.shape[1:])
        else:
            pad = np.full((pb - batch,) + a.shape[1:], pv, dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out, pb


class BatchScores(NamedTuple):
    """Per-pair results plus the merged batch statistics.

    score, start_i, start_j: int32 numpy (B,): per pair (start = (m, n)
        global, the local argmax local).
    max_score: int: the batch's largest score.
    total_cells: float32: true DP cells, sum of (m + 1)(n + 1), summed in
        float32 per shard and then over the shards, as JAX's ``psum``.
    """

    score: np.ndarray
    start_i: np.ndarray
    start_j: np.ndarray
    max_score: int
    total_cells: np.float32


def mesh_bucket_engine(engine: str, L1: int, L2: int, is_local: bool) -> str:
    """Per-shard engine for a sharded bucket of padded length L1 x L2 (the
    JAX package's picks): ``"scan"`` and explicit ``"shortread"`` /
    ``"segmented"`` stay; otherwise short-read up to ``SHORTREAD_MAX_LEN``,
    segmented up to ``SEGMENTED_MAX_LEN`` rows, else ``"pallas"`` (which
    ``parallel/allpairs`` runs as K3 slices by ``device_loop_scores``)."""
    if engine == "scan":
        return "scan"
    if engine in ("shortread", "segmented"):
        return engine
    if max(L1, L2) <= SHORTREAD_MAX_LEN:
        return "shortread"
    if L1 <= SEGMENTED_MAX_LEN:
        return "segmented"
    return "pallas"


def batch_scores_sharded(mesh, s1eb, s2eb, ms, ns, scores, is_local: bool,
                         axis_name: str = DATA_AXIS, engine: str = "auto") -> BatchScores:
    """Shard the batch over ``axis_name`` and merge the statistics.

    The batch must divide by the axis size (:func:`pad_batch`). Each
    device scores its slice with ``engine`` (``"auto"``:
    :func:`mesh_bucket_engine`'s pick for the padded shape; ``"scan"``:
    :func:`batch_scores`' fill on that device); a short slice
    K6 does not take (an empty sequence, ``L2 % 16 != 0``) runs on the
    segmented kernel, as :func:`route_engine` sends it. Per-pair results
    come back as numpy; ``max_score``/``total_cells`` are merged over the
    slices."""
    devs = axis_devices(mesh, axis_name)
    ms = np.asarray(ms, np.int32).reshape(-1)
    ns = np.asarray(ns, np.int32).reshape(-1)
    B, L1, L2 = len(ms), s1eb.shape[1], s2eb.shape[1]
    if B % len(devs):
        raise ValueError(f"batch {B} must divide into {len(devs)} shards (use pad_batch)")
    eng = mesh_bucket_engine(engine, L1, L2, is_local) if engine == "auto" else engine
    per = B // len(devs)
    outs, cells = [], []
    for k, d in enumerate(devs):
        sl = slice(k * per, (k + 1) * per)
        e = eng
        if e == "shortread" and not shortread_fits(L1, L2, ms[sl], ns[sl]):
            e = "segmented"
        s1 = torch.as_tensor(np.ascontiguousarray(s1eb[sl]), dtype=torch.uint8).to(d)
        s2 = torch.as_tensor(np.ascontiguousarray(s2eb[sl]), dtype=torch.uint8).to(d)
        outs.append(_kernel_scores(e, s1, s2, ms[sl], ns[sl], scores, is_local))
        cells.append(_cells(ms[sl], ns[sl]))
    sc, si, sj = _read(outs)
    return BatchScores(score=sc, start_i=si, start_j=sj, max_score=int(sc.max()),
                       total_cells=np.sum(np.array(cells, np.float32), dtype=np.float32))


def device_loop_scores(devices, s1b, s2b, ms, ns, scores, is_local: bool,
                       engine: str = "stream"):
    """Score a bucket across ``devices`` by explicit placement: the batch
    is padded to a multiple of the device count (padding rows replicate
    pair 0 and are dropped) and each device scores an equal slice with
    ``engine``. Returns numpy (score, start_i, start_j) of shape (B,)."""
    devices = [resolve_device(d) for d in devices]
    B = len(ms)
    n_dev = min(len(devices), B)
    (s1p, s2p, mp, np_), Bp = pad_batch(
        (np.asarray(s1b), np.asarray(s2b), np.asarray(ms), np.asarray(ns)), B, n_dev)
    per = Bp // n_dev
    outs = []
    for k, d in enumerate(devices[:n_dev]):
        sl = slice(k * per, (k + 1) * per)
        s1 = torch.as_tensor(np.ascontiguousarray(s1p[sl]), dtype=torch.uint8).to(d)
        s2 = torch.as_tensor(np.ascontiguousarray(s2p[sl]), dtype=torch.uint8).to(d)
        outs.append(_kernel_scores(engine, s1, s2, mp[sl], np_[sl], scores, is_local))
    return tuple(x[:B] for x in _read(outs))
