"""Suffix-tree presentation (counterpart of
``genomics_rs_tpu/display/tree.py``; parity with the reference's
``src/suffixtree/display.rs``).

* ``format_tree_stats`` — the stats block (BWT preview truncated at
  100 chars, node counts, depths, longest repeat).
* ``write_graphviz`` — DOT export with per-string edge colors and
  dashed red suffix links; only sensible for small trees (the
  reference gates at <100 nodes — ``display.rs:43-48``).
"""

from __future__ import annotations

from genomics_rs_tpu_torch.display._fmt import rust_f64
from genomics_rs_tpu_torch.suffixtree.tree import SuffixTree, TreeStats

_EDGE_COLORS = ["blue", "green", "orange", "purple", "pink", "brown", "cyan", "magenta"]


def format_tree_stats(stats: TreeStats) -> str:
    bwt = stats.bwt
    if len(bwt) > 100:
        bwt = bwt[:100] + "... (truncated)"
    return (
        f"\n"
        f"            BWT: {bwt}\n"
        f"            BWT Length: {len(stats.bwt)}\n"
        f"            Internal nodes: {stats.num_internal}\n"
        f"            Leaves: {stats.num_leaves}\n"
        f"            Nodes: {stats.num_nodes}\n"
        f"            Average string depth: {rust_f64(stats.average_string_depth)}\n"
        f"            Max string depth: {stats.max_string_depth}\n"
        f"            Longest repeat start: {stats.longest_repeat_start}\n"
        f"            Longest repeat length: {stats.longest_repeat_len}\n"
    )


def write_graphviz(tree: SuffixTree) -> str:
    """DOT text: tree edges labeled with their substring, colored by
    source string; suffix links as dashed red edges."""
    nodes: list[int] = []
    edges: list[str] = []

    def visit(node) -> bool:
        nodes.append(node.id)
        if node.parent is not None:
            label = tree.strings[node.source_string][node.edge_start : node.edge_end]
            color = _EDGE_COLORS[node.source_string % len(_EDGE_COLORS)]
            edges.append(
                f'    n{node.parent} -> n{node.id} '
                f'[ label = "{_escape(label)}" color = "{color}" ]'
            )
        return False

    tree.dfs(visit, 0)

    for node in tree.nodes:
        if node is not None and node.suffix_link is not None:
            edges.append(
                f'    n{node.id} -> n{node.suffix_link} '
                f'[ color = "red" style = "dashed" ]'
            )

    lines = ["digraph {"]
    lines.extend(f'    n{i} [ label = "{i}" ]' for i in nodes)
    lines.extend(edges)
    lines.append("}")
    return "\n".join(lines)


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def format_string_depth(tree: SuffixTree) -> str:
    """Preorder string-depth listing, reference debug parity
    (``tree.rs:390-400``: "String Depth: depth (node ID)" then
    "depth (nID), " per visited node)."""
    parts = ["String Depth: depth (node ID)\n"]

    def visit(node) -> bool:
        parts.append(f"{node.string_depth} (n{node.id}), ")
        return False

    tree.dfs(visit, 0)
    parts.append("\n\n")
    return "".join(parts)


def format_tree(tree: SuffixTree, debug: bool = False) -> str:
    """``debug`` mirrors the reference's RUST_LOG=debug gate
    (``display.rs:50-52``): the string-depth dump is appended between
    the graphviz block and the stats."""
    parts = []
    if len(tree.nodes) < 100:
        parts.append("Graphviz:\n " + write_graphviz(tree))
    if debug:
        parts.append(format_string_depth(tree))
    parts.append("\nStats: " + format_tree_stats(tree.stats))
    return "\n".join(parts)
