"""A genome aligned to a reference inside a band: a request is
``models.banded.align_banded(longer, shorter, scores, band)`` on the
pairs of ``align_pair`` (the same seeded pairs, taken in turn); its
answer is the ``AlignedSequences``."""

from __future__ import annotations

from portbench import bound, cells
from portbench.drivers import align_pair


class Driver(align_pair.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.band = int(ctx.params["band"])
        self.V = cells.band_width(self.band)

    def make(self):
        pass

    def request(self, k):
        from genomics_rs_tpu_torch.models.banded import align_banded

        a, b = self.seqs[self.input_of(k)]
        with self.ctx.span("models.banded.align_banded"):
            return align_banded(a, b, self.scores, band=self.band, device=self.ctx.device)

    def cells(self, k):
        a, b = self.raw[self.input_of(k)]
        return cells.banded(len(a), len(b), self.V)

    def work(self, k):
        a, b = self.raw[self.input_of(k)]
        return {"K10": bound.band(self.cells(k), float(len(a) + len(b)))}
