"""K15 (the query profile, ``matrix_profile_kernel``): the bound time of
the window's profile bytes over its summed device time, in %. Silent
when the profile kernel did not launch."""


def match(name):
    return "matrix_profile_kernel" in name


def read(c):
    if c.count("gotoh_matrix.COUNTS.profile_kernel") == 0:
        return None
    return c.roofline("K15", match)
