"""Measure on one CUDA card where the time of the K15 and K2 wrappers
goes: the launch latency (CUDA events around a one-element ``zero_``),
each kernel's launch alone (CUDA events around the raw launcher), the
wrapper (CUDA events around it) and the host time of each of the
wrapper's steps (``time.perf_counter`` over a run of calls, no
synchronisation inside). Inputs: ``chip_smoke.py``'s protein batches
(1,024 x 384 aa, the path's launch shape, and 32,768 x 383 aa) under
BLOSUM62, and K2 on the 10 kb local fill's walk of ``tools/time_fills.py``.

Prints the card's name and power limit, then one JSON object.

    python3 tools/wrapper_host.py [--reps 200]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    reps = ap.parse_args().reps
    import torch

    if not torch.cuda.is_available():
        sys.exit("wrapper_host: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    import chip_smoke
    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.ops import _build
    from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_top
    from genomics_rs_tpu_torch.ops.subst import blosum62
    from genomics_rs_tpu_torch.sequence import PAD_S2, round_up

    dev = torch.device("cuda", 0)
    lib = _build.library()
    stream = _build.stream_handle(dev)

    def host_us(fn, n=reps) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    def event_us(fn, n=25) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b) * 1e3)
        return float(np.median(ts))

    def device_context():
        with torch.cuda.device(dev):
            pass

    one = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {"launch latency (events around a 1-element zero_), us": event_us(one.zero_)}
    prot = chip_smoke.protein_bench_data()
    mx = blosum62()
    for name, s2h, ns in (("K15 1024 x 384", prot["p2"], prot["pns"]),
                          ("K15 32768 x 383", prot["u2"], np.full(prot["u2"].shape[0], 383))):
        s2 = torch.from_numpy(s2h).to(dev)
        B, Ln = s2.shape
        ns32 = np.asarray(ns, np.int32)
        ns_dev = torch.from_numpy(ns32).to(dev)
        tab = gm.device_tables(mx, dev)[2]
        A = tab.shape[0]
        prof = torch.empty((B, A, Ln), dtype=torch.int16, device=dev)

        def raw():
            return lib.matrix_profile_launch(
                _build.ptr(s2), _build.ptr(ns_dev), _build.ptr(tab), _build.ptr(prof), B, Ln, A,
                gm.PROFILE_BLOCKS_PER_SM, stream)

        out[name] = {
            "launch alone (events), us": event_us(raw),
            "wrapper (events), us": event_us(lambda: gm.matrix_profile(s2, ns, mx)),
            "wrapper, lengths on the card (events), us": event_us(
                lambda: gm.matrix_profile(s2, ns, mx, ns_dev)),
            "host us": {
                "wrapper": host_us(lambda: gm.matrix_profile(s2, ns, mx), 50),
                "wrapper, lengths on the card": host_us(
                    lambda: gm.matrix_profile(s2, ns, mx, ns_dev), 50),
                "length checks": host_us(lambda: gm._col_lengths(ns, B, Ln)),
                "device_tables": host_us(lambda: gm.device_tables(mx, dev)),
                "torch.empty of the profile": host_us(
                    lambda: torch.empty((B, A, Ln), dtype=torch.int16, device=dev), 50),
                "lengths' upload": host_us(lambda: torch.from_numpy(ns32).to(dev, non_blocking=True)),
                "torch.cuda.device context": host_us(device_context),
                "stream handle": host_us(lambda: _build.stream_handle(dev)),
                "raw launch": host_us(raw, 50),
            }}
        del prof
    # K2: the 10 kb local fill's walk (as tools/time_fills.py makes it)
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = acgt[rng.integers(0, 4, 10_000)]
    b = a[:9_990].copy()
    snp = rng.random(9_990) < 0.01
    b[snp] = acgt[rng.integers(0, 4, int(snp.sum()))]

    def padded(x, L, pad):
        y = np.full(L, pad, np.uint8)
        y[: len(x)] = x
        return torch.from_numpy(y).to(dev)

    sc = Scores()
    s1, s2 = padded(a, round_up(10_000, 128), 0xFE), padded(b, round_up(9_990, 128), PAD_S2)
    res = rb.gotoh_rowblock(s1, s2, global_boundary_top(0, s2.shape[0], sc, device=dev), len(a),
                            len(b), 0, sc, True, emit_dirs=True, emit_bottom=False)
    si, sj, cap = int(res.best[1]), int(res.best[2]), 24_576
    KW, V = res.dirs.shape
    buf = torch.empty(tw.META_SLOTS + -(-cap // 16), dtype=torch.int32, device=dev)
    moves = len(tw.walk_full(res.dirs, si, sj, 0, max_steps=cap)[0])

    def raw2():
        return lib.traceback_walk_launch(_build.ptr(res.dirs), _build.ptr(buf), KW, V, si, sj, 0,
                                         0, cap, stream)

    words, count, *_ = tw.walk_kernel(res.dirs, si, sj, 0, cap)
    out["K2 10 kb walk"] = {
        "moves": moves,
        "launch alone (events), us": event_us(raw2),
        "walk_kernel (events), us": event_us(lambda: tw.walk_kernel(res.dirs, si, sj, 0, cap)),
        "walk_full (events), us": event_us(lambda: tw.walk_full(res.dirs, si, sj, 0, cap)),
        "host us": {
            "walk_kernel": host_us(lambda: tw.walk_kernel(res.dirs, si, sj, 0, cap), 50),
            "the one copy back": host_us(lambda: buf.cpu(), 50),
            "unpack_moves": host_us(lambda: tw.unpack_moves(words, count), 50),
        }}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
