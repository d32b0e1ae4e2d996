"""K10 (the banded fill, ``csrc/gotoh_banded.cu`` on the warp-strip
pipeline with ``BandRows``): the bound time of the window's in-band work
over its summed device time, in %. Silent when K10 did not launch."""


def match(name):
    return "warp_pipe_kernel" in name and "BandRows" in name


def read(c):
    if c.count("gotoh_banded.COUNTS.kernel") == 0:
        return None
    return c.roofline("K10", match)
