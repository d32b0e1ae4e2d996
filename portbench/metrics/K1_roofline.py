"""K1 (the row-block fill, ``csrc/gotoh_rowblock.cu``), every launch of
the window summed (one fill with direction codes a request where the
pair is one row block, as in ``cov-align-pair``; a forward pass and
windowed refills otherwise): the bound time of the work the inputs need
(one fill of the m x n table with direction codes) over K1's summed
device time, in %. Silent when K1 did not launch."""


def match(name):
    return "rowblock_kernel" in name


def read(c):
    if c.count("gotoh_rowblock.COUNTS.kernel") == 0:
        return None
    return c.roofline("K1", match)
