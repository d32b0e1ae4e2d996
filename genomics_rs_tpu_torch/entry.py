"""The port's entry points (counterpart of ``__graft_entry__.py``).

``entry()`` returns a forward step of the flagship computation (the Gotoh
wavefront fill, the device half of ``PairwiseAligner.align``) and its
example arguments; ``dryrun_multichip(n)`` runs one sharded scoring step
over an n-device mesh, and the multi-device paths behind it, on small
shapes. Both take the same seeded inputs as the JAX entry.

Run it on the card with ``python -m genomics_rs_tpu_torch.entry`` (one
CUDA device per mesh slot), or on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_scan import gotoh_fill_scan

#: The entry's scores (the JAX entry's).
SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def entry(device="cuda"):
    """``(fn, example_args)``: a single-device forward step, a global
    affine-gap wavefront fill (score, start cell and the uint8 direction
    table) of one encoded 256 bp pair, with its inputs on ``device``."""
    dev = resolve_device(device)

    def step(s1e, s2e, m, n):
        res = gotoh_fill_scan(s1e, s2e, m, n, SCORES, is_local=False)
        return res.score, res.start_i, res.start_j, res.dirs

    rng = np.random.default_rng(0)
    L = 256
    s1e = torch.from_numpy(_BASES[rng.integers(0, 4, L)].copy()).to(dev)
    s2e = torch.from_numpy(_BASES[rng.integers(0, 4, L)].copy()).to(dev)
    return step, (s1e, s2e, L - 17, L - 5)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run one full sharded scoring step on an ``n_devices`` mesh: the
    local CUDA devices, or the first ``n_devices`` of ``devices`` (e.g.
    ``["cpu"] * n``). Pairs are sharded over the ``data`` axis and scored
    by the scan fill, global and local, with the statistics merged; then
    the per-shard short-read engine, the 2-D (data x seq) scores when
    ``n_devices`` is even and at least 4, and ``align_sharded``'s full
    traceback over a ``seq`` mesh, held equal to the single-device scan
    aligner. Raises on any mismatch."""
    from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
    from genomics_rs_tpu_torch.parallel.batch import batch_scores_sharded
    from genomics_rs_tpu_torch.parallel.longseq import align_sharded, batched_sharded_scores
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh, make_mesh_2d
    from genomics_rs_tpu_torch.sequence import Sequence

    mesh = make_mesh(n_devices, devices=devices)
    rng = np.random.default_rng(0)
    B = 2 * n_devices  # two pairs a device
    L = 128
    s1eb = _BASES[rng.integers(0, 4, (B, L))]
    s2eb = _BASES[rng.integers(0, 4, (B, L))]
    ms = rng.integers(L // 2, L + 1, B).astype(np.int32)
    ns = rng.integers(L // 2, L + 1, B).astype(np.int32)

    for is_local in (False, True):
        out = batch_scores_sharded(mesh, s1eb, s2eb, ms, ns, SCORES, is_local, engine="scan")
        if out.score.shape != (B,) or not float(out.total_cells) > 0:
            raise RuntimeError(f"sharded scan step gave {out}")
    out = batch_scores_sharded(mesh, s1eb, s2eb, ms, ns, SCORES, False, engine="shortread")
    if out.score.shape != (B,):
        raise RuntimeError(f"sharded short-read step gave {out}")

    if n_devices >= 4 and n_devices % 2 == 0:
        n_seq = n_devices // 2
        mesh2 = make_mesh_2d(2, n_seq, devices=devices)
        L2 = max(n_seq * 16, 64)
        s1b = _BASES[rng.integers(0, 4, (4, L2))]
        s2b = _BASES[rng.integers(0, 4, (4, L2))]
        ms2 = rng.integers(L2 // 2, L2 + 1, 4).astype(np.int32)
        ns2 = rng.integers(L2 // 2, L2 + 1, 4).astype(np.int32)
        out2 = batched_sharded_scores(mesh2, s1b, s2b, ms2, ns2, SCORES, is_local=False)
        if out2.score.shape != (4,):
            raise RuntimeError(f"2-D sharded step gave {out2}")

    mesh_seq = make_mesh(n_devices, axis_name=SEQ_AXIS, devices=devices)
    m3, n3 = 8 * n_devices + 5, 97
    a3 = Sequence("a", _BASES[rng.integers(0, 4, m3)].tobytes().decode())
    b3 = Sequence("b", _BASES[rng.integers(0, 4, n3)].tobytes().decode())
    got3 = align_sharded(mesh_seq, a3, b3, SCORES, engine="scan")
    ref3 = PairwiseAligner(SCORES, engine="scan", device=mesh_seq.devices.flat[0]).align(a3, b3)
    if got3.alignment != ref3.alignment or got3.score != ref3.score:
        raise RuntimeError("align_sharded != the scan aligner")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="the port's entry step and multi-device dry run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("-n", "--n-devices", type=int, default=None,
                   help="mesh size (default: every CUDA device, or 2 on the CPU)")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    score = fn(*example)[0]
    print("entry ok:", int(score))
    if args.device == "cpu":
        n = args.n_devices or 2
        dryrun_multichip(n, devices=["cpu"] * n)
    else:
        dryrun_multichip(args.n_devices or torch.cuda.device_count())
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
