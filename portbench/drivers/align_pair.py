"""One genome aligned to a reference: a request is
``PairwiseAligner(scores, is_local=False, device).align(ref, isolate)``
(the aligner built in set-up) on one of the seeded pairs, taken in turn;
its answer is the ``AlignedSequences`` (score, path, counts), not
rendered."""

from __future__ import annotations

from portbench import bound, cells, gen, reference
from portbench.driver import Cycle, alignment_record, choice_ids, same_alignment


class Driver(Cycle):
    #: the banded driver reuses everything but the request.
    band = None

    def __init__(self, ctx):
        super().__init__(ctx, int(ctx.params["pairs"]))

    def setup(self):
        from genomics_rs_tpu_torch.config import Scores
        from genomics_rs_tpu_torch.sequence import Sequence

        cfg = self.ctx.cfg
        self.scores = Scores(*cfg["scores"])
        r = gen.rng(self.ctx.seed, 2)
        self.raw = []
        for _ in range(self.n):
            a, b = gen.isolate_pair(r, cfg)
            self.raw.append((a, b) if len(a) >= len(b) else (b, a))
        self.seqs = [(Sequence("ref", a.decode()), Sequence("isolate", b.decode()))
                     for a, b in self.raw]
        self.ids = choice_ids()
        self.make()

    def make(self):
        from genomics_rs_tpu_torch.models.aligner import PairwiseAligner

        self.aligner = PairwiseAligner(self.scores, is_local=False, device=self.ctx.device)

    def warm(self):
        self.request(0)

    def request(self, k):
        a, b = self.seqs[self.input_of(k)]
        with self.ctx.span("models.aligner.PairwiseAligner.align"):
            return self.aligner.align(a, b)

    def cells(self, k):
        a, b = self.raw[self.input_of(k)]
        return cells.full([len(a)], [len(b)])

    def work(self, k):
        a, b = self.raw[self.input_of(k)]
        return {"K1": bound.fill(self.cells(k), float(len(a) + len(b)), 1, "global", dirs=True)}

    def keep(self, k, out):
        return alignment_record(out, self.ids)

    def release(self):
        self.aligner = self.seqs = None

    def reference(self, xs, control: bool = False) -> dict:
        """The alignments of inputs ``xs`` by the plain reference; the
        control takes ties in the reversed order (D, I, S)."""
        sm, sx, g, h = self.ctx.cfg["scores"]
        band = None if self.band is None else cells.band_width(self.band)
        recs = reference.align([self.raw[x] for x in xs], reference.dna_table(sm, sx), g, h,
                               False, band=band, tie="DIS" if control else "SID",
                               device=self.ctx.device)
        return dict(zip(xs, recs))

    def same(self, got, want) -> bool:
        return same_alignment(got, want)
