"""K3 (the batched DNA fill, ``csrc/gotoh_stream.cu`` on the warp-strip
pipeline with ``CharSub``): the bound time of the window's K3 work over
K3's summed device time, in %. Silent when K3 did not launch, or when
K9 (the same template) launched beside it."""


def match(name):
    return "warp_pipe_kernel" in name and "FullRows" in name and "CharSub" in name


def read(c):
    if c.count("gotoh_stream.COUNTS.kernel") == 0 or c.count("gotoh_pallas.COUNTS.kernel"):
        return None
    return c.roofline("K3", match)
