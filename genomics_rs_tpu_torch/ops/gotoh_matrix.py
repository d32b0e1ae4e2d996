"""Protein (substitution-matrix) Gotoh fill: the query profile and the
matrix fill (counterpart of ``genomics_rs_tpu/ops/gotoh_matrix.py``).

A full matrix (BLOSUM62 and the like) scores a cell by an arbitrary
``M[a, b]`` lookup, so the JAX package builds each pair's substitution
plane with exact bf16 one-hot matmuls and shears it diagonal-major for
its TPU kernels (K13 ``_matrix_seg_call``; K14 and K15 in
``gotoh_matrix_stream``). The port needs neither the matmul nor the
shear:

* :func:`matrix_profile` (K15's counterpart, ``csrc/gotoh_matrix.cu``):
  the query profile ``prof[p, a, j] = ext[a, code(s2[p, j])]``, int16
  (B, A, Ln), 0 past ``n_p``; ``ext`` is the matrix extended with an
  unknown-byte row and column at its minimum when the alphabet has no
  ``X`` (:func:`_ext_matrix`), ``code`` the byte -> alphabet index map
  (:func:`_alpha_code`). Row ``a`` is s1's character, column s2's. The
  kernel reads one byte-indexed table, ``ext[:, code]`` (A, 256);
  :func:`device_tables` makes it and the code and ext tables once per
  alphabet, matrix values and device.
* :func:`matrix_fill` (K13's and K14's counterpart, one kernel): K3's
  warp-strip pipeline (``ops/gotoh_stream``) with ``s(i, j) = prof[p,
  code(s1[i-1]), j-1]``; same outputs, same per-pair ``(B, KW, V)`` dirs,
  the same unread error word in the result.

A CUDA tensor launches the kernels, a CPU tensor runs
:func:`matrix_profile_plain` and :func:`matrix_fill_plain`. Launches are
counted by route: ``"pallas"`` (K13's contract, scores and starts) and
``"stream"`` (K14's: the ``gotoh_matrix_stream`` entries, dirs, the
aligners).

:func:`gotoh_scores_matrix` keeps the JAX router's engines: ``"auto"``,
``"pallas"`` and ``"stream"`` all run the matrix fill; ``"scan"`` runs
:func:`matrix_scores_scan`, the JAX package's ``lax.scan`` twin
(``_matrix_scores_call``): the scan fill (``ops/gotoh_scan``) with the
substitution gathered from the byte table ``ext[code(a), code(b)]``
where JAX shears one-hot products; the scores and starts are the same.
``"auto"`` never picks it: JAX sends matrices with ``127 < |v| <= 256``
there, the port runs the kernel on them.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops.gotoh_scan import gotoh_fill_scan_batch
from genomics_rs_tpu_torch.ops.gotoh_stream import (
    StreamFill,
    _lengths,
    dirs_shape,
    stream_rows,
    wavefront_plain,
)
from genomics_rs_tpu_torch.ops.subst import warn_unknown_bytes
from genomics_rs_tpu_torch.utils.profiling import annotate

#: launches of the two kernels and calls of their plain versions, the
#: fill's by route.
COUNTS = {"profile_kernel": 0, "profile_plain": 0, "pallas_kernel": 0, "pallas_plain": 0,
          "stream_kernel": 0, "stream_plain": 0}

#: batches at least this large take the ``"stream"`` route under
#: ``engine="auto"`` (the JAX router's bound)...
STREAM_MIN_B = 8
#: ...and at least this large its grouped form.
STREAM_GROUPED_MIN_B = 2048

#: the profile kernel's blocks an SM (each stages the whole byte table):
#: 2 was the fastest of 1, 2, 4 and 8 at 32,768 x 383 on one H100 and tied
#: at 1,024 x 384 (``tools/time_fills.py``).
PROFILE_BLOCKS_PER_SM = 2


def _alpha_code(matrix) -> np.ndarray:
    """(256,) int32: byte -> alphabet index; unknown bytes -> the
    wildcard index (``X``) when present, else the extra row that
    :func:`_ext_matrix` scores at the matrix minimum."""
    A = len(matrix.alphabet)
    fallback = matrix.alphabet.index("X") if "X" in matrix.alphabet else A
    idx = np.full(256, fallback, dtype=np.int32)
    for i, ch in enumerate(matrix.alphabet):
        idx[ord(ch)] = i
    return idx


def _ext_matrix(matrix) -> np.ndarray:
    """The matrix, extended with the unknown-byte row and column (at the
    matrix minimum) when the alphabet has no ``X``."""
    A = len(matrix.alphabet)
    if "X" in matrix.alphabet:
        return np.asarray(matrix.matrix, dtype=np.int32)
    ext = np.full((A + 1, A + 1), int(matrix.matrix.min()), dtype=np.int32)
    ext[:A, :A] = matrix.matrix
    return ext


def _alpha_bytes(matrix):
    """(alphabet byte values (A0,) uint8, fallback index, ext dim A)."""
    A0 = len(matrix.alphabet)
    fallback = matrix.alphabet.index("X") if "X" in matrix.alphabet else A0
    ab = np.frombuffer(matrix.alphabet.encode("latin-1"), dtype=np.uint8).copy()
    return ab, fallback, A0 if "X" in matrix.alphabet else A0 + 1


def _tables(matrix, dev):
    """(code (256,) int32, ext (A, A) int32) on ``dev``, made anew."""
    return (torch.as_tensor(_alpha_code(matrix)).to(dev),
            torch.as_tensor(_ext_matrix(matrix)).to(dev))


#: device_tables' cache: (alphabet, matrix shape and values, device) ->
#: (code, ext, tab).
_DEVICE_TABLES: dict = {}


def device_tables(matrix, dev):
    """``(code (256,) int32, ext (A, A) int32, tab (A, 256) int16)`` on
    ``dev``: :func:`_tables`' two and the profile kernel's byte-indexed
    table ``tab[a, b] = ext[a, code[b]]``, made once per alphabet, matrix
    values and device and kept (keyed on the values, not on the matrix
    object)."""
    vals = np.asarray(matrix.matrix)
    dev = dev if isinstance(dev, torch.device) else torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (matrix.alphabet, vals.dtype.str, vals.shape, vals.tobytes(), dev.type, dev.index)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        code, ext = _alpha_code(matrix), _ext_matrix(matrix)
        tab = np.ascontiguousarray(ext[:, code].astype(np.int16))
        hit = tuple(torch.from_numpy(x).to(dev) for x in (code, ext, tab))
        _DEVICE_TABLES[key] = hit
    return hit


def _col_lengths(ns, B: int, Ln: int) -> np.ndarray:
    """The s2 lengths as int32 numpy, checked against (B,) and 0..Ln."""
    ns = np.asarray(ns.cpu() if torch.is_tensor(ns) else ns).reshape(-1)
    if ns.shape != (B,):
        raise ValueError(f"ms/ns must have shape ({B},)")
    if B and (ns.min() < 0 or ns.max() > Ln):
        raise ValueError(f"lengths outside 0..(0, {Ln})")
    return ns.astype(np.int32, copy=False)


def matrix_profile(s2eb: torch.Tensor, ns, matrix, ns_dev=None) -> torch.Tensor:
    """The query profile of a batch's s2 rows: int16 (B, A, Ln),
    ``prof[p, a, j] = ext[a, code(s2[p, j])]`` for ``j < n_p``, else 0.
    The device of ``s2eb`` picks the route. ``ns_dev``: the same lengths
    already on the card, int32 (B,) (a grouped caller uploads them once),
    for the kernel to read instead of a copy of ``ns``."""
    if _build.uses_kernel(s2eb):
        return _profile_cuda(s2eb, ns, matrix, ns_dev)
    return matrix_profile_plain(s2eb, ns, matrix)


def matrix_profile_plain(s2eb: torch.Tensor, ns, matrix) -> torch.Tensor:
    """The plain version: one index op, ``ext[:, code[s2]]``, then the
    zeros past each ``n_p``."""
    COUNTS["profile_plain"] += 1
    dev = s2eb.device
    B, Ln = s2eb.shape
    ns_h = _col_lengths(ns, B, Ln)
    code, ext = _tables(matrix, dev)
    prof = ext[:, code[s2eb.long()]].permute(1, 0, 2)  # (B, A, Ln)
    live = torch.arange(Ln, device=dev)[None, :] < torch.as_tensor(ns_h).to(dev)[:, None]
    return torch.where(live[:, None, :], prof, 0).to(torch.int16).contiguous()


def _profile_cuda(s2eb, ns, matrix, ns_dev=None) -> torch.Tensor:
    dev = s2eb.device
    if dev.type != "cuda":
        raise ValueError(f"the profile kernel takes CUDA tensors, not {dev}")
    B, Ln = s2eb.shape
    with annotate("genomics/gotoh_matrix.plan"):
        _build.require(s2eb, "s2eb", torch.uint8, dev, (B, Ln))
        ns_h = _col_lengths(ns, B, Ln)
        _, _, tab = device_tables(matrix, dev)
        A = tab.shape[0]
        prof = torch.empty((B, A, Ln), dtype=torch.int16, device=dev)
        if B == 0 or Ln == 0:
            return prof.zero_()
        if ns_dev is None:  # a non-blocking copy: no wait on the stream
            ns_dev = torch.from_numpy(ns_h).to(dev, non_blocking=True)
        _build.require(ns_dev, "ns_dev", torch.int32, dev, (B,))
        lib = _build.library()
    with torch.cuda.device(dev), annotate("genomics/gotoh_matrix.launch"):
        err = lib.matrix_profile_launch(
            _build.ptr(s2eb), _build.ptr(ns_dev), _build.ptr(tab), _build.ptr(prof), B, Ln, A,
            PROFILE_BLOCKS_PER_SM, _build.stream_handle(dev),
        )
    _build.check(err, "matrix_profile")
    COUNTS["profile_kernel"] += 1
    return prof


def row_codes(s1eb: torch.Tensor, matrix) -> torch.Tensor:
    """(B, Lm) int32 alphabet code of every s1 byte (one index op)."""
    code = device_tables(matrix, s1eb.device)[0]
    return code[s1eb.long()]


def matrix_fill(code1: torch.Tensor, prof: torch.Tensor, ms, ns, g: int, h: int,
                is_local: bool = False, emit_dirs: bool = False,
                route: str = "pallas") -> StreamFill:
    """Fill every pair from its row codes (B, Lm) and query profile
    (B, A, Ln). The device of ``code1`` picks the kernel or the plain
    version; ``route`` ("pallas" or "stream") names the JAX contract the
    call serves, for the launch counts."""
    if route not in ("pallas", "stream"):
        raise ValueError(f"unknown route {route!r}")
    fn = _matrix_cuda if _build.uses_kernel(code1) else matrix_fill_plain
    return fn(code1, prof, ms, ns, g, h, is_local, emit_dirs, route)


def gotoh_matrix_fill(s1eb: torch.Tensor, s2eb: torch.Tensor, ms, ns, matrix, g: int,
                      h: int, is_local: bool = False, emit_dirs: bool = False,
                      route: str = "pallas") -> StreamFill:
    """Profile (K15's counterpart) and fill (K13's/K14's) of a padded
    uint8 batch ``s1eb`` (B, Lm), ``s2eb`` (B, Ln) with true lengths
    ``ms``/``ns``."""
    prof = matrix_profile(s2eb, ns, matrix)
    return matrix_fill(row_codes(s1eb, matrix), prof, ms, ns, g, h, is_local, emit_dirs, route)


def _matrix_cuda(code1, prof, ms, ns, g, h, is_local, emit_dirs, route, rows_per_strip=None,
                 max_blocks=None, spin_ns=None) -> StreamFill:
    """Launch the matrix fill on K3's warp-strip pipeline at strips of
    ``rows_per_strip`` rows (default ``gotoh_stream.stream_rows``), one
    launch for each of ``gotoh_pallas.pipeline_groups``' pair ranges,
    each adding one to ``COUNTS[f"{route}_kernel"]``; ``max_blocks`` and
    ``spin_ns`` as K3's. Does not synchronise: the error word comes back
    in the result."""
    dev = code1.device
    if dev.type != "cuda":
        raise ValueError(f"the matrix fill kernel takes CUDA tensors, not {dev}")
    B, Lm = code1.shape
    A, Ln = prof.shape[1], prof.shape[2]
    with torch.cuda.device(dev):
        with annotate("genomics/gotoh_matrix.plan"):
            _build.require(code1, "code1", torch.int32, dev, (B, Lm))
            _build.require(prof, "prof", torch.int16, dev, (B, A, Ln))
            ms_h, ns_h = _lengths(ms, ns, B, Lm, Ln)
            rows = (stream_rows(ms_h, ns_h, Lm, emit_dirs) if rows_per_strip is None
                    else int(rows_per_strip))
            gp.check_rows(rows, "gotoh_matrix")
            lib = _build.library()
            per_sm = gp.blocks_per_sm(lib.gotoh_matrix_blocks_per_sm, rows // 32, int(is_local),
                                      int(emit_dirs))
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return run_matrix(lib, code1, prof, ms_h, ns_h, g, h, is_local, emit_dirs, route, rows,
                          gp.resident_blocks(per_sm, sms, max_blocks),
                          gp.SPIN_NS if spin_ns is None else spin_ns,
                          _build.stream_handle(dev))


def run_matrix(lib, code1, prof, ms_h, ns_h, g, h, is_local, emit_dirs, route, rows, resident,
               spin_ns, stream) -> StreamFill:
    """Plan and launch the matrix fill over the batch's tensors
    (``gotoh_pallas.launch_groups``); returns the fill with its error
    word unread."""
    dev = code1.device
    B, Lm = code1.shape
    A, Ln = prof.shape[1], prof.shape[2]
    KW, V = dirs_shape(Lm, Ln)
    i32 = dict(dtype=torch.int32, device=dev)
    dirs = torch.zeros((B, KW, V), **i32) if emit_dirs else None
    res = torch.empty((B, 3), **i32)
    if B == 0:
        return StreamFill(res[:, 0], res[:, 1], res[:, 2], dirs, torch.zeros((), **i32))

    def launch(lo, hi, plan, work, ring, nlevels, total, blocks):
        return lib.gotoh_matrix_launch(
            _build.ptr(code1[lo:hi]), _build.ptr(prof[lo:hi]), _build.ptr(plan),
            _build.ptr(work), _build.ptr(ring), _build.ptr(None if dirs is None else dirs[lo:hi]),
            _build.ptr(res[lo:hi]), hi - lo, Lm, Ln, A, V, KW, nlevels, total, g, h,
            int(is_local), rows // 32, blocks, int(spin_ns), stream,
        )

    counts = {"kernel": 0}
    err = gp.launch_groups(launch, ms_h, ns_h, Ln, rows, resident, dev, counts, "gotoh_matrix")
    COUNTS[f"{route}_kernel"] += counts["kernel"]
    return StreamFill(res[:, 0], res[:, 1], res[:, 2], dirs, err)


def matrix_fill_plain(code1, prof, ms, ns, g: int, h: int, is_local: bool = False,
                      emit_dirs: bool = False, route: str = "pallas") -> StreamFill:
    """The plain version: K3's plain body (``gotoh_stream.
    wavefront_plain``) with the substitution of lane ``iv`` at
    anti-diagonal ``k`` gathered from the profile, ``prof[p,
    code1[p, iv-1], k-iv-1]`` (clamped to the profile off the true
    cells). Runs on the tensors' device."""
    COUNTS[f"{route}_plain"] += 1
    dev = code1.device
    B, Lm = code1.shape
    A, Ln = prof.shape[1], prof.shape[2]
    ms_h, ns_h = _lengths(ms, ns, B, Lm, Ln)
    V = dirs_shape(Lm, Ln)[1]
    iv = torch.arange(V, device=dev)[None, :]
    # Lane iv reads profile line code1[p, iv-1] (line 0 at row 0 and past Lm).
    lines = torch.zeros((B, V), dtype=torch.int64, device=dev)
    lines[:, 1 : Lm + 1] = code1.long()
    base = lines * max(Ln, 1)
    flat = (prof.reshape(B, A * Ln).to(torch.int32) if Ln
            else torch.zeros((B, A), dtype=torch.int32, device=dev))

    def sub_at(k: int) -> torch.Tensor:
        col = (k - 1 - iv).clamp(0, max(Ln - 1, 0))
        return torch.gather(flat, 1, (base + col).expand(B, V))

    return wavefront_plain(sub_at, B, Lm, Ln, ms_h, ns_h, g, h, is_local, emit_dirs, dev)


def matrix_scores_scan(s1b: torch.Tensor, s2b: torch.Tensor, ms, ns, matrix, g: int, h: int,
                       is_local: bool = False):
    """``(score, start_i, start_j)`` int32 (B,) tensors of a batch under a
    full matrix by the scan fill, on the tensors' device: every byte pair
    scores ``ext[code(a), code(b)]`` (:func:`_alpha_code`,
    :func:`_ext_matrix`)."""
    code, ext = _alpha_code(matrix), _ext_matrix(matrix)
    lut = ext[code[:, None], code[None, :]]
    fill = gotoh_fill_scan_batch(s1b, s2b.to(s1b.device), ms, ns, Scores(0, 0, g, h),
                                 is_local, emit_dirs=False, subst_lut=lut)
    return fill.score, fill.start_i, fill.start_j


def _on_device(x, dev) -> torch.Tensor:
    """A uint8 batch as a tensor: tensors keep their device, numpy goes
    to ``dev``."""
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(dev)


def _check_matrix(matrix) -> int:
    """max |v| of the extended matrix; raises past 256 as the JAX package
    does (its bf16 one-hot planes are exact only to 256; the port's int16
    profile keeps the same admitted range)."""
    vmax = int(np.abs(_ext_matrix(matrix)).max())
    if vmax > 256:
        raise ValueError(
            "substitution-matrix entries must satisfy |v| <= 256 "
            f"(bf16-exact one-hot selection); got max |v| = {vmax}"
        )
    return vmax


def gotoh_scores_matrix(s1b, s2b, ms, ns, matrix, g: int, h: int, is_local: bool = False,
                        engine: str = "auto", device="cuda"):
    """Score a batch of pairs under a full substitution matrix.

    ``s1b``/``s2b``: padded (B, Lm)/(B, Ln) uint8 byte batches, tensors
    (their device picks the route) or numpy arrays (moved to ``device``;
    then, as in the JAX package, a batch mostly outside the alphabet is
    warned about). ``engine``: ``"auto"``, ``"pallas"`` (K13's route) or
    ``"stream"`` (K14's, grouped from ``STREAM_GROUPED_MIN_B`` pairs)
    run the matrix fill; ``"scan"`` runs :func:`matrix_scores_scan`.
    Returns ``(score,
    start_i, start_j)``, int32 tensors of shape (B,) on the fill's
    device, with the reference's local keep-last argmax.
    """
    host = not torch.is_tensor(s1b) and not torch.is_tensor(s2b)
    if host:
        ms_np, ns_np = np.asarray(ms), np.asarray(ns)
        live = np.concatenate([s1b[i, : ms_np[i]] for i in range(s1b.shape[0])]
                              + [s2b[i, : ns_np[i]] for i in range(s2b.shape[0])])
        warn_unknown_bytes(matrix, live, where="matrix batch")
    with annotate("genomics/gotoh_matrix.plan"):
        vmax = _check_matrix(matrix)
        if engine not in ("auto", "pallas", "stream", "scan"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "pallas" and vmax > 127:
            raise ValueError(
                "pallas matrix engine streams int8 substitution "
                f"scores; |matrix| max {vmax} > 127"
            )
        dev = resolve_device(device) if host else None
        s1, s2 = _on_device(s1b, dev), _on_device(s2b, dev)
        B = s1.shape[0]
        if engine == "auto":
            engine = "stream" if vmax <= 127 and B >= STREAM_MIN_B else "pallas"
    if engine == "scan":
        return matrix_scores_scan(s1, s2, ms, ns, matrix, g, h, is_local)
    if engine == "stream":
        from genomics_rs_tpu_torch.ops.gotoh_matrix_stream import (
            gotoh_scores_matrix_stream,
            gotoh_scores_matrix_stream_grouped,
        )

        out = None
        if B >= STREAM_GROUPED_MIN_B:
            out = gotoh_scores_matrix_stream_grouped(s1, s2, ms, ns, matrix, g, h, is_local)
        if out is None:
            out = gotoh_scores_matrix_stream(s1, s2, ms, ns, matrix, g, h, is_local)
        if out is not None:
            return out
    return checked_scores(gotoh_matrix_fill(s1, s2, ms, ns, matrix, g, h, is_local))


def checked_scores(fill: StreamFill):
    """``(score, start_i, start_j)`` of a fill, after reading its error
    word (on the card, one synchronisation)."""
    gp.raise_on_err(fill.err, "gotoh_matrix")
    return fill.score, fill.start_i, fill.start_j
