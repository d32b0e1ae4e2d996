"""Seconds from the process's start to the window's: imports, the
kernel library (and its build in a fresh checkout), the cell's data from
the seed and its warm-up."""


def read(c):
    return c.setup_s
