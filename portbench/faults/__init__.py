"""Faults planted in a cell's timed path, one file a cell
(``faults/<cell>.py``, found by name). Each file defines ``FAULTS =
{name: (module, function, how)}``: the CPU tests wrap the program's
``module.function`` so that its result passes through ``how`` and see the
run's ``correct`` come out false. Helpers that fault files share live here."""

import numpy as np


def plus_one(m: np.ndarray) -> np.ndarray:
    """A copy of ``m`` with its last element one higher."""
    m = m.copy()
    m[-1, -1] += 1
    return m
