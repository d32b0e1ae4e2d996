"""ctypes front of the C++ suffix-tree core (``native/suffixtree.cpp``)
and of SA-IS (``native/sais.cpp``), counterpart of the JAX package's
``suffixtree/native.py``.

``NativeSuffixTree`` mirrors the Python oracle's public API
(``tree.SuffixTree``: insert_string / get_lcs / compute_stats) and is
output-identical to it. The library is the port's one native library
(``genomics_rs_tpu_torch.native.library``), built at first use; a failed
build raises, and nothing here falls back to the Python tree.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from genomics_rs_tpu_torch import native
from genomics_rs_tpu_torch.suffixtree.tree import STRING_TERMINATORS, TreeStats, load_alphabet


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        native.library()
    except (OSError, RuntimeError):
        return False
    return True


def native_suffix_array(text: bytes) -> np.ndarray:
    """Linear-time host suffix array of ``text`` (int32).

    It orders suffixes as ``ops.bwt_device.suffix_array`` does when
    ``text`` carries its own trailing terminator (proper-prefix suffixes
    first)."""
    lib = native.library()
    sa = np.empty(len(text), dtype=np.int32)
    rc = lib.sais_u8(text, len(text), sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"sais_u8 failed (rc={rc})")
    return sa


class NativeSuffixTree:
    """C++-backed generalized suffix tree (API-compatible subset)."""

    def __init__(self, alphabet_file: str, initial_allocation: int = 16):
        self._lib = native.library()
        self.alphabet = load_alphabet(alphabet_file)
        merged = "".join(self.alphabet).encode("latin-1")
        self._handle = self._lib.st_new(merged, len(merged))
        self.strings: list[str] = []
        self.stats = TreeStats()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.st_free(handle)
            self._handle = None

    def _require_handle(self):
        if not getattr(self, "_handle", None):
            raise RuntimeError(
                "suffix tree handle is unusable (a prior insert failed "
                "and left the arena corrupted)"
            )

    def insert_string(self, new_string: str, enable_suffix_links: bool = True,
                      print_time: bool = False) -> None:
        self._require_handle()
        if len(self.strings) >= len(STRING_TERMINATORS):
            raise ValueError("Suffix tree supports at most 32 strings")
        bad = set(new_string) & set(STRING_TERMINATORS)
        if bad:
            raise ValueError(f"sequence contains terminator characters {sorted(bad)!r}")
        full = new_string + STRING_TERMINATORS[len(self.strings)]
        self.strings.append(full)
        rc = self._lib.st_insert(self._handle, full.encode("latin-1"), len(full),
                                 1 if enable_suffix_links else 0)
        if rc != 0:
            # The arena is half-mutated: drop the string and poison the
            # handle so no later query reads a corrupted tree.
            self.strings.pop()
            self._lib.st_free(self._handle)
            self._handle = None
            raise KeyError("Character not found in alphabet")

    def get_lcs(self, a: int, b: int) -> tuple[int, int, int]:
        self._require_handle()
        out = (ctypes.c_int64 * 3)()
        if self._lib.st_lcs(self._handle, a, b, out) != 0:
            raise RuntimeError("st_lcs failed")
        return (int(out[0]), int(out[1]), int(out[2]))

    def compute_stats(self, string_idx: int = 0) -> TreeStats:
        self._require_handle()
        if string_idx != 0:
            raise ValueError("compute_stats supports string 0 only")
        slen = len(self.strings[0])
        out = (ctypes.c_int64 * 7)()
        avg = ctypes.c_double()
        buf = ctypes.create_string_buffer(slen + 1)
        rc = self._lib.st_stats(self._handle, out, ctypes.byref(avg), buf, slen)
        if rc != 0:
            raise RuntimeError(f"st_stats failed ({rc})")
        st = self.stats
        st.num_internal = int(out[0])
        st.num_leaves = int(out[1])
        st.num_nodes = int(out[2])
        st.max_string_depth = int(out[3])
        st.longest_repeat_len = int(out[4])
        st.longest_repeat_start = int(out[5])
        st.bwt = buf.raw[:slen].decode("latin-1").strip()
        st.average_string_depth = float(avg.value)
        return st


@functools.lru_cache(maxsize=16)
def _merged_alphabet(alphabet_file: str) -> bytes:
    return "".join(load_alphabet(alphabet_file)).encode("latin-1")


def similarity_native(a: str, b: str, alphabet_file: str) -> tuple[int, int]:
    """Compare-mode pair similarity in C++: (score, first_lcs).

    Output-identical to the Python recursion of
    ``comparison/driver.recursive_lcs_similarity(engine="python")`` (same
    tree code, same LCS tie-breaks, same prefix/suffix recursion) with
    one reused arena. The ctypes call releases the GIL, so a thread pool
    scales it."""
    lib = native.library()
    merged = _merged_alphabet(alphabet_file)
    out = (ctypes.c_int64 * 2)()
    rc = lib.st_similarity(
        merged, len(merged), a.encode("latin-1"), len(a), b.encode("latin-1"), len(b),
        STRING_TERMINATORS[0].encode("latin-1"), STRING_TERMINATORS[1].encode("latin-1"), out,
    )
    if rc != 0:
        raise KeyError("Character not found in alphabet")
    return (int(out[0]), int(out[1]))
