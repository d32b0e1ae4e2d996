"""Float formatting parity with Rust's ``{}`` f64 Display.

Rust prints the shortest string that round-trips (same algorithm as
Python's ``repr``) but drops the trailing ``.0`` on integral values
(``2.0`` -> ``"2"``). The reference renders Percent Identity and
Average string depth through f64 Display (``display.rs:124``,
``suffixtree/display.rs:20``)."""

from __future__ import annotations


def rust_f64(v: float) -> str:
    s = repr(float(v))
    return s[:-2] if s.endswith(".0") else s
