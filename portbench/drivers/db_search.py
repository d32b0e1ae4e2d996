"""A protein database search: the database stays on the device, one
padded batch per power-of-two length class; a request is one query
scored against every class by ``ops.gotoh_matrix.gotoh_scores_matrix(
db_class, query_rows, ms, ns, matrix, g, h, is_local)``, the query on the
profiled s2 side; its answer is every entry's score and start cell on
the host.

The check holds a sample of each answer's entries against the plain
reference: ``check_rows`` entries of each length class drawn from the
seed (all of a smaller class) and the entry each query was copied from,
its best hit."""

from __future__ import annotations

import numpy as np
import torch

from portbench import bound, gen, reference
from portbench.driver import Cycle

PAD_S1, PAD_S2 = 0xFE, 0xFF


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def spread_order(n: int, shift: int) -> np.ndarray:
    """``0..n-1`` in bit-reversed order, rotated by ``shift``: any run of
    consecutive requests takes lengths from the whole range."""
    bits = max(1, (n - 1).bit_length())
    rev = [int(format(k, f"0{bits}b")[::-1], 2) for k in range(1 << bits)]
    return np.roll(np.array([r for r in rev if r < n], np.int64), -shift)


class Driver(Cycle):
    def __init__(self, ctx):
        super().__init__(ctx, int(ctx.params["queries"]))
        # Query q is the q-th shortest: a seeded rotation of a spread order.
        self.order = spread_order(self.n, int(gen.rng(ctx.seed, 3).integers(self.n)))

    def setup(self):
        from genomics_rs_tpu_torch.ops.subst import get_matrix

        cfg, p, dev = self.ctx.cfg, self.ctx.params, self.ctx.device
        self.matrix = get_matrix(cfg["matrix"])
        self.g, self.h, self.local = int(cfg["g"]), int(cfg["h"]), bool(cfg["local"])
        r = gen.rng(self.ctx.seed, 4)
        tg = gen.torch_gen(self.ctx.seed, 5, dev)
        L = gen.lognormal_lengths(cfg["entries"], cfg["length_median"], cfg["length_mean"],
                                  cfg["length_min"], cfg["length_max"])
        L = L[r.permutation(L.size)]  # entry e has length L[e]
        keys = np.array([gen.bucket_key(int(x)) for x in L])
        self.buckets = []  # (entry ids, lengths (int32), padded uint8 batch on the device)
        for key in sorted(set(keys.tolist())):
            ids = np.flatnonzero(keys == key)
            ms = L[ids].astype(np.int32)
            width = max(round_up(int(ms.max()), 128), 128)
            res = gen.residues(tg, (ids.size, width), cfg["frequencies"], dev)
            live = torch.arange(width, device=dev)[None, :] < torch.from_numpy(ms).to(dev)[:, None]
            self.buckets.append((ids, ms, torch.where(live, res, PAD_S1).contiguous()))
        self.entries = int(L.size)
        self.residues = float(L.sum())
        # Query q: a copy of the entry at length quantile (q + 0.5) / Q,
        # each residue redrawn with probability ``mutation``.
        where = {int(e): (b, row) for b, (ids, _, _) in enumerate(self.buckets)
                 for row, e in enumerate(ids)}
        by_len = np.argsort(L, kind="stable")
        ranks = ((np.arange(self.n) + 0.5) / self.n * L.size).astype(np.int64)
        self.queries = []
        for e in by_len[ranks]:
            b, row = where[int(e)]
            q = self.buckets[b][2][row, : int(L[e])].clone()
            redraw = torch.rand(q.shape, generator=tg, device=dev) < float(p["mutation"])
            q = torch.where(redraw, gen.residues(tg, q.shape, cfg["frequencies"], dev), q)
            row2 = torch.full((max(round_up(q.numel(), 128), 128),), PAD_S2, dtype=torch.uint8,
                              device=dev)
            row2[: q.numel()] = q
            self.queries.append(row2)
        self.qlen = [int(L[e]) for e in by_len[ranks]]
        self.alphabet = 24  # the matrix's letters, BLOSUM62's X among them
        # The entries the check compares: rows of each class, and the
        # columns of the answer they stand in.
        self.check_rows, cols, at = [], [], 0
        for ids, _, _ in self.buckets:
            k = min(int(p["check_rows"]), ids.size)
            rows = np.union1d(r.choice(ids.size, size=k, replace=False),
                              np.flatnonzero(np.isin(ids, by_len[ranks])))
            self.check_rows.append(rows)
            cols.append(at + rows)
            at += ids.size
        self.check_cols = np.concatenate(cols)

    def warm(self):
        # The longest and the shortest query: the largest buffers, then
        # the smallest.
        for q in (int(np.argmax(self.qlen)), int(np.argmin(self.qlen))):
            self._search(q)

    def _search(self, q: int) -> np.ndarray:
        from genomics_rs_tpu_torch.ops.gotoh_matrix import gotoh_scores_matrix

        row, n = self.queries[q], self.qlen[q]
        parts = []
        for _, ms, s1 in self.buckets:
            with self.ctx.span("ops.gotoh_matrix.gotoh_scores_matrix"):
                s2 = row.expand(s1.shape[0], row.numel()).contiguous()
                parts.append(gotoh_scores_matrix(s1, s2, ms, np.full(ms.size, n, np.int32),
                                                 self.matrix, self.g, self.h,
                                                 is_local=self.local))
        with self.ctx.span("results to host"):
            return torch.stack([torch.cat([p[k] for p in parts]) for k in range(3)]).cpu().numpy()

    def request(self, k):
        return self._search(self.input_of(k))

    def cells(self, k):
        return self.residues * self.qlen[self.input_of(k)]

    def work(self, k):
        n = self.qlen[self.input_of(k)]
        c = self.residues * n
        # One profile a query is what the search needs, whatever the
        # program builds: made once, read once.
        return {"K14": bound.fill(c, self.residues, self.entries, "local", matrix=True,
                                  profile_bytes=2.0 * self.alphabet * n),
                "K15": bound.profile(float(n), self.alphabet)}

    def keep(self, k, out):
        return out[:, self.check_cols]

    def release(self):
        self.matrix = None

    def reference(self, xs, control: bool = False) -> dict:
        """(3, sampled entries) scores and start cells of each query of
        ``xs`` by the plain reference, in the order of :meth:`keep`; the
        control keeps the first best cell instead of the last."""
        cfg = self.ctx.cfg
        tab = reference.blosum62_table()
        out = {}
        for x in xs:
            q = self.queries[x][: self.qlen[x]]
            parts = []
            for rows, (_, ms, s1) in zip(self.check_rows, self.buckets):
                if not rows.size:
                    continue
                sel = torch.from_numpy(rows).to(s1.device)
                res = reference.fill(s1.index_select(0, sel), q.expand(rows.size, q.numel()),
                                     ms[rows], np.full(rows.size, q.numel()), tab, int(cfg["g"]),
                                     int(cfg["h"]), bool(cfg["local"]),
                                     keep="first" if control else "last")
                parts.append(np.stack([res["score"], res["start_i"], res["start_j"]]))
            out[x] = np.concatenate(parts, 1)
        return out
