"""All-pairs genome comparison: one request is
``parallel.allpairs.allpairs_scores(corpus, scores, is_local=False,
engine="auto", device)`` on one of the seeded corpora, taken in turn;
its answer is the lower triangle of global scores (a global alignment
starts at (m, n), so the scores are all it returns)."""

from __future__ import annotations

import numpy as np

from portbench import bound, cells, gen, reference
from portbench.driver import Cycle


class Driver(Cycle):
    def __init__(self, ctx):
        super().__init__(ctx, int(ctx.params["corpora"]))

    def setup(self):
        from genomics_rs_tpu_torch.config import Scores
        from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer

        cfg = self.ctx.cfg
        self.scores = Scores(*cfg["scores"])
        r = gen.rng(self.ctx.seed, 1)
        self.corpora = [gen.genome_corpus(r, cfg) for _ in range(self.n)]
        self.containers = [SequenceContainer([Sequence(f"g{k}", s.decode())
                                              for k, s in enumerate(c)]) for c in self.corpora]
        self.pairs = [(i, j) for j in range(len(self.corpora[0]))
                      for i in range(len(self.corpora[0])) if i <= j]
        self._cells, self._work = [], []
        for c in self.corpora:
            ms = np.array([len(c[i]) for i, _ in self.pairs])
            ns = np.array([len(c[j]) for _, j in self.pairs])
            n_cells = cells.full(ms, ns)
            self._cells.append(n_cells)
            self._work.append({"K3": bound.fill(n_cells, float(ms.sum() + ns.sum()),
                                                len(self.pairs), "global")})

    def warm(self):
        self.request(0)

    def request(self, k):
        from genomics_rs_tpu_torch.parallel.allpairs import allpairs_scores

        with self.ctx.span("parallel.allpairs.allpairs_scores"):
            res = allpairs_scores(self.containers[self.input_of(k)], self.scores, is_local=False,
                                  engine="auto", device=self.ctx.device)
        return res.matrix

    def cells(self, k):
        return self._cells[self.input_of(k)]

    def work(self, k):
        return self._work[self.input_of(k)]

    def keep(self, k, out):
        return np.array([out[j, i] for i, j in self.pairs], np.int64)

    def release(self):
        self.containers = None

    def reference(self, xs, control: bool = False) -> dict:
        """The scores of corpora ``xs`` by the plain reference; the
        control fills only a band of ``control_band`` lanes around each
        pair's length-proportional diagonal."""
        sm, sx, g, h = self.ctx.cfg["scores"]
        band = cells.band_width(self.ctx.params["control_band"]) if control else None
        out = {}
        for x in xs:
            c = self.corpora[x]
            out[x] = reference.scores([(c[i], c[j]) for i, j in self.pairs],
                                      reference.dna_table(sm, sx), g, h, False, band=band,
                                      device=self.ctx.device, batch=len(self.pairs))["score"]
        return out
