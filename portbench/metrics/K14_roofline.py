"""K14 (the matrix fill, ``csrc/gotoh_matrix.cu`` on the warp-strip
pipeline with ``ProfileSub``; K13's route runs the same kernel): the
bound time of the window's matrix-fill work over its summed device
time, in %. Silent when the matrix fill did not launch."""


def match(name):
    return "warp_pipe_kernel" in name and "ProfileSub" in name


def read(c):
    if c.count("gotoh_matrix.COUNTS.stream_kernel") + c.count(
            "gotoh_matrix.COUNTS.pallas_kernel") == 0:
        return None
    return c.roofline("K14", match)
