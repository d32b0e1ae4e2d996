"""Host-side suffix structures (counterpart of ``genomics_rs_tpu/suffixtree``):
the generalized suffix tree (construction, BWT, LCS) and, exported
lazily so that tree users do not import the device code, the FM-index.

``make_tree`` returns the C++ arena core (``native/suffixtree.cpp`` via
ctypes, built at first use); a failed build raises. The Python tree of
``tree.py`` is the oracle with the same semantics, used directly where a
caller wants it (the CLI's small-tree display)."""

from genomics_rs_tpu_torch.suffixtree.tree import STRING_TERMINATORS, SuffixTree, TreeStats


def __getattr__(name):
    if name in ("FMIndex", "MultiFMIndex"):
        from genomics_rs_tpu_torch.suffixtree import fmindex

        return getattr(fmindex, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_tree(alphabet_file: str, initial_allocation: int = 16):
    """The native suffix tree."""
    from genomics_rs_tpu_torch.suffixtree.native import NativeSuffixTree

    return NativeSuffixTree(alphabet_file, initial_allocation)


__all__ = [
    "SuffixTree",
    "TreeStats",
    "STRING_TERMINATORS",
    "make_tree",
    "FMIndex",
    "MultiFMIndex",
]
