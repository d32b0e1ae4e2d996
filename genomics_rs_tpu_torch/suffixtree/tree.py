"""Generalized suffix tree (McCreight construction with suffix links).

The port's own copy of ``genomics_rs_tpu/suffixtree/tree.py``, line for
line (the port imports nothing of the JAX package): a from-scratch
reimplementation of the reference's suffix-tree subsystem
(``src/suffixtree/tree.rs``) with output-identical semantics —
node-count stats, BWT text, LCS results and the deterministic id layout
are all observable through golden tests and must match. Key semantics preserved:

* id layout "S1_leaves S1_internal S2_leaves S2_internal ..."
  (``tree.rs:78-93``): leaves of string k get sequential ids from a
  per-string range recorded in ``string_leaf_ranges``;
* 32 fixed terminator characters cap the tree at 32 strings
  (``tree.rs:66-69``); the alphabet is the terminators + the alphabet
  file's characters (spaces stripped, newlines kept), ASCII-sorted
  (``tree.rs:140-148``);
* child slots are indexed by position in that sorted alphabet; DFS
  visits children in ascending slot order (``tree.rs:444-464``), which
  fixes the lexicographic leaf order used by the BWT;
* ``associated_strings`` bits are set exactly where the reference sets
  them (on fully-walked nodes in find_path, on new leaves/internals at
  creation) — get_lcs depends on this exact propagation;
* the perfect-suffix-match path reassigns ``next_leaf_id``
  (``tree.rs:872-879``) — matters for duplicate strings;
* ``compute_stats`` only supports string 0 (``tree.rs:755-757``), and
  reports the longest repeat's start as the id of the next leaf visited
  after the deepest internal node (``tree.rs:760-786``).

This pointer-chasing structure is deliberately host-side (SURVEY §7);
a C++ arena core provides the fast path (``suffixtree/native.py``), this
Python implementation is the readable oracle, and ``make_tree`` never
falls back to it.
"""

from __future__ import annotations

import dataclasses
import logging
import time

log = logging.getLogger(__name__)

# The suffix tree can support up to 32 strings (tree.rs:66-69).
STRING_TERMINATORS = [
    "$", "!", "@", "#", "%", "^", "&", "*", "(", ")", "-", "_", "=", "+",
    "{", "}", "[", "]", "|", ";", ":", "'", "<", ">", ",", ".", "?", "/",
    "~", "`", " ", "\n",
]


@dataclasses.dataclass
class TreeStats:
    num_internal: int = 0
    num_leaves: int = 0
    num_nodes: int = 0
    average_string_depth: float = 0.0
    max_string_depth: int = 0
    bwt: str = ""
    longest_repeat_len: int = 0
    longest_repeat_start: int = 0


class _Node:
    __slots__ = (
        "id",
        "string_depth",
        "edge_start",
        "edge_end",
        "parent",
        "suffix_link",
        "children",
        "source_string",
        "assoc",
    )

    def __init__(
        self,
        node_id: int,
        string_depth: int,
        edge_start: int,
        edge_end: int,
        parent: int | None,
        suffix_link: int | None,
        source_string: int,
        assoc: int,
    ):
        self.id = node_id
        self.string_depth = string_depth
        self.edge_start = edge_start
        self.edge_end = edge_end
        self.parent = parent
        self.suffix_link = suffix_link
        self.children: list[int | None] = []
        self.source_string = source_string
        self.assoc = assoc  # 32-bit "associated strings" bitmask


def load_alphabet(alphabet_file: str) -> list[str]:
    """Alphabet file chars (spaces stripped) + terminators, ASCII-sorted."""
    try:
        with open(alphabet_file, "r") as f:
            raw = f.read()
    except OSError:
        raise RuntimeError(f"Could not read alphabet file: {alphabet_file}")
    chars = list(raw.replace(" ", ""))
    merged = STRING_TERMINATORS + chars
    merged.sort()
    return merged


class SuffixTree:
    """Generalized suffix tree over up to 32 strings."""

    def __init__(self, alphabet_file: str, initial_allocation: int = 16):
        self.alphabet = load_alphabet(alphabet_file)
        # First slot index per char (reference get_child_index returns
        # the first linear-scan hit — tree.rs:56-63).
        self._char_slot: dict[str, int] = {}
        for idx, c in enumerate(self.alphabet):
            self._char_slot.setdefault(c, idx)

        self.strings: list[str] = []
        self.next_internal_id = 0
        self.next_leaf_id = 1
        self.nodes: list[_Node | None] = [None] * (initial_allocation * 2 + 1)
        self.string_leaf_ranges: dict[int, range] = {}
        self.stats = TreeStats()

        self.nodes[0] = _Node(
            node_id=0,
            string_depth=0,
            edge_start=0,
            edge_end=0,
            parent=None,
            suffix_link=0,
            source_string=0,
            assoc=0,
        )

    # ------------------------------------------------------------------
    # construction

    def insert_string(
        self, new_string: str, enable_suffix_links: bool = True, print_time: bool = False
    ) -> None:
        """Insert all suffixes of ``new_string`` (tree.rs:75-133)."""
        string_length = len(new_string)

        # Offset indices for the next string: S1_leaves S1_internal ...
        if self.next_internal_id != 0:
            self.next_leaf_id = self.next_internal_id
        self.next_internal_id += string_length + 2

        self.string_leaf_ranges[len(self.strings)] = range(
            self.next_leaf_id, self.next_internal_id
        )

        need = len(self.nodes) + string_length * 2 + 1
        self.nodes.extend([None] * (need - len(self.nodes)))

        string_idx = len(self.strings)
        if string_idx >= len(STRING_TERMINATORS):
            raise ValueError("Suffix tree supports at most 32 strings")
        # Terminator characters inside the payload break suffix
        # uniqueness (the reference panics unpredictably on such
        # input); reject them up-front so both implementations fail
        # identically (documented deviation).
        bad = set(new_string) & set(STRING_TERMINATORS)
        if bad:
            raise ValueError(
                f"sequence contains terminator characters {sorted(bad)!r}"
            )
        self.strings.append(new_string + STRING_TERMINATORS[string_idx])

        t0 = time.perf_counter()
        for i in range(string_length + 1):
            if enable_suffix_links:
                self._suffix_link_traversal(i, string_idx)
            else:
                self._find_path(i, 0, string_idx)
        elapsed = time.perf_counter() - t0
        if print_time:
            log.debug(
                "[FindPath] Time taken to build suffix tree: %d us (%d ms)",
                int(elapsed * 1e6),
                int(elapsed * 1e3),
            )

    def _child_slot(self, c: str) -> int:
        try:
            return self._char_slot[c]
        except KeyError:
            raise KeyError(f"Character {c!r} not found in alphabet")

    def _suffix_link_traversal(self, suffix_idx: int, string_idx: int) -> None:
        """Per-suffix McCreight jump (tree.rs:286-384)."""
        nodes = self.nodes
        nls = 0 if suffix_idx == 0 else self.next_leaf_id - 1
        parent = nodes[nls].parent
        u_idx = parent if parent is not None else 0
        v_link = nodes[u_idx].suffix_link

        should_establish_link = False
        if v_link is not None:
            # CASE 1: suffix link known — jump to v.
            v = v_link
        else:
            # CASE 2: walk up to u' and hop down from its link v'.
            u_prime = nodes[u_idx].parent
            v_prime = nodes[u_prime].suffix_link
            u = nodes[u_idx]
            if u_prime == 0:
                # CASE 2B: skip the first char of beta.
                v = self._node_hops(
                    v_prime, u.edge_start + 1, u.edge_end, u.source_string
                )
            else:
                # CASE 2A
                v = self._node_hops(
                    v_prime, u.edge_start, u.edge_end, u.source_string
                )
            should_establish_link = True

        if u_idx != 0 and should_establish_link:
            # Depth-1 internal nodes link to the root (tree.rs:369-378).
            if nodes[u_idx].string_depth == 1:
                nodes[u_idx].suffix_link = 0
            else:
                nodes[u_idx].suffix_link = v

        self._find_path(suffix_idx, v, string_idx)

    def _node_hops(
        self, current_node: int, beta_start: int, beta_end: int, beta_string_idx: int
    ) -> int:
        """Skip/count descent re-matching beta (tree.rs:633-734)."""
        nodes = self.nodes
        beta_length = beta_end - beta_start
        if beta_length < 0:
            raise ValueError(f"beta (start): {beta_start}, beta (end): {beta_end}")
        cur = current_node
        if beta_length == 0:
            return cur

        beta_string = self.strings[beta_string_idx]
        remaining = beta_length
        while remaining > 0:
            c = beta_string[beta_end - remaining]
            slot = self._child_slot(c)
            children = nodes[cur].children
            child = children[slot] if slot < len(children) else None
            if child is None:
                break
            child_ref = nodes[child]
            edge_len = child_ref.edge_end - child_ref.edge_start
            if edge_len <= remaining:
                remaining -= edge_len
                cur = child
            else:
                # Partial match: find the split point and break the edge.
                src = self.strings[child_ref.source_string]
                break_idx = 0
                for i in range(remaining):
                    if src[child_ref.edge_start + i] != beta_string[beta_end - remaining + i]:
                        break
                    break_idx = child_ref.edge_start + i + 1
                cur = self._break_edge(
                    child,
                    break_idx,
                    0,
                    0,
                    create_leaf=False,
                    internal_string_idx=child_ref.source_string,
                    leaf_string_idx=beta_string_idx,
                )
                break
        return cur

    def _find_path(self, suffix_idx: int, start_node: int, string_idx: int) -> None:
        """Naive walk inserting one suffix from ``start_node`` (tree.rs:808-923)."""
        nodes = self.nodes
        current = nodes[start_node]
        s = self.strings[string_idx]
        suffix_len = len(s) - suffix_idx
        # How far down the suffix the start node's *parent* already is.
        suffix_sub_idx = current.string_depth - (current.edge_end - current.edge_start)

        while True:
            current_id = current.id
            current_src = current.source_string
            src_str = self.strings[current_src]

            # Walk the label on the current node's edge.
            for label_idx in range(current.edge_start, current.edge_end):
                if suffix_sub_idx > suffix_len:
                    break
                suffix_char = s[suffix_idx + suffix_sub_idx]
                if suffix_char != src_str[label_idx]:
                    self._break_edge(
                        current_id,
                        label_idx,
                        suffix_idx + suffix_sub_idx,
                        len(s),
                        create_leaf=True,
                        internal_string_idx=current_src,
                        leaf_string_idx=string_idx,
                    )
                    return
                suffix_sub_idx += 1

            # Edge fully matched: associate the string with this node.
            current.assoc |= 1 << string_idx

            if suffix_sub_idx == suffix_len:
                # Perfect match with an existing path (tree.rs:872-879).
                self.next_leaf_id = current.id + 1
                return
            if suffix_sub_idx > suffix_len:
                log.error(
                    "Suffix sub-idx %d is greater than suffix length %d",
                    suffix_sub_idx,
                    suffix_len,
                )
                return

            c = s[suffix_idx + suffix_sub_idx]
            slot = self._child_slot(c)
            children = current.children
            child = children[slot] if slot < len(children) else None
            if child is not None:
                current = nodes[child]
            else:
                self._create_leaf(
                    current_id, suffix_idx + suffix_sub_idx, len(s), string_idx
                )
                return

    def _break_edge(
        self,
        node: int,
        break_idx: int,
        leaf_start: int,
        leaf_end: int,
        create_leaf: bool,
        internal_string_idx: int,
        leaf_string_idx: int,
    ) -> int:
        """Split an edge at ``break_idx``; optionally hang a new leaf
        off the new internal node (tree.rs:470-536)."""
        node_ref = self.nodes[node]
        if break_idx == node_ref.edge_start or break_idx == node_ref.edge_end:
            log.error(
                "Break index is at the %s of the edge for node %d",
                "start" if break_idx == node_ref.edge_start else "end",
                node_ref.id,
            )
            return node

        original_label_start = node_ref.edge_start
        node_ref.edge_start = break_idx

        parent = node_ref.parent
        new_internal = self._create_internal_node(
            parent, node, original_label_start, break_idx, internal_string_idx
        )
        self.nodes[new_internal].assoc |= 1 << leaf_string_idx

        if create_leaf:
            return self._create_leaf(new_internal, leaf_start, leaf_end, leaf_string_idx)
        return new_internal

    def _create_internal_node(
        self,
        parent: int,
        original_node: int,
        edge_start: int,
        edge_end: int,
        string_idx: int,
    ) -> int:
        """New internal node adopting ``original_node`` (tree.rs:541-587)."""
        nodes = self.nodes
        internal_id = self.next_internal_id
        depth = nodes[parent].string_depth + (edge_end - edge_start)
        internal = _Node(
            node_id=internal_id,
            string_depth=depth,
            edge_start=edge_start,
            edge_end=edge_end,
            parent=parent,
            suffix_link=None,
            source_string=string_idx,
            assoc=nodes[original_node].assoc | (1 << string_idx),
        )
        self.next_internal_id += 1
        self._add_child(parent, internal, string_idx)
        self._add_child(internal_id, nodes[original_node], string_idx)
        return internal_id

    def _create_leaf(
        self, parent: int, edge_start: int, edge_end: int, string_idx: int
    ) -> int:
        """New leaf under ``parent`` (tree.rs:592-627)."""
        leaf_id = self.next_leaf_id
        leaf = _Node(
            node_id=leaf_id,
            string_depth=self.nodes[parent].string_depth + (edge_end - edge_start),
            edge_start=edge_start,
            edge_end=edge_end,
            parent=parent,
            suffix_link=None,
            source_string=string_idx,
            assoc=1 << string_idx,
        )
        self.next_leaf_id += 1
        self._add_child(parent, leaf, string_idx)
        return leaf_id

    def _add_child(self, parent: int, child: _Node, string_idx: int) -> None:
        """Register ``child`` under ``parent`` at its alphabet slot
        (tree.rs:405-438). The slot character is looked up in
        ``strings[string_idx]`` — the caller's string — like the
        reference does."""
        child.parent = parent
        c = self.strings[string_idx][child.edge_start]
        slot = self._child_slot(c)
        children = self.nodes[parent].children
        if len(children) <= slot:
            children.extend([None] * (slot + 1 - len(children)))
        children[slot] = child.id
        self.nodes[child.id] = child

    # ------------------------------------------------------------------
    # queries

    def dfs(self, callback, start_node: int = 0) -> _Node | None:
        """Explicit-stack preorder DFS, children in ascending slot order
        (tree.rs:444-464). Stops early if ``callback`` returns True."""
        nodes = self.nodes
        stack = [nodes[start_node]]
        while stack:
            node = stack.pop()
            if callback(node):
                return node
            for child in reversed(node.children):
                if child is not None:
                    stack.append(nodes[child])
        return None

    def is_leaf(self, node: _Node) -> bool:
        return node.id in self.string_leaf_ranges[node.source_string]

    def offset_leaf(self, leaf_idx: int, string_idx: int) -> int:
        """Leaf id -> 0-based suffix start offset (tree.rs:196-201).

        Below-range ids clamp to 0 (the reference unwrap-panics there,
        tree.rs:272; the C++ core clamps identically — documented
        deviation for a latent case)."""
        if string_idx == 0:
            return leaf_idx - 1
        start = self.string_leaf_ranges[string_idx].start
        return leaf_idx - start if leaf_idx >= start else 0

    def get_lcs(self, string_one_idx: int, string_two_idx: int) -> tuple[int, int, int]:
        """Longest common substring of two inserted strings
        (tree.rs:218-281): deepest node associated with both strings,
        then one leaf of each string beneath it."""
        max_string_depth = 0
        deepest_common = 0

        def pass1(node: _Node) -> bool:
            nonlocal max_string_depth, deepest_common
            assoc = node.assoc
            if bin(assoc).count("1") < 2:
                return False
            has_both = bool(assoc & (1 << string_one_idx)) and bool(
                assoc & (1 << string_two_idx)
            )
            if has_both and node.string_depth > max_string_depth:
                max_string_depth = node.string_depth
                deepest_common = node.id
            return False

        self.dfs(pass1, 0)

        def leaf_of(string_idx: int):
            return self.dfs(
                lambda child: self.is_leaf(child)
                and bool(child.assoc & (1 << string_idx)),
                deepest_common,
            )

        leaf_one = leaf_of(string_one_idx)
        leaf_two = leaf_of(string_two_idx)
        if leaf_one is None or leaf_two is None:
            return (0, 0, 0)
        return (
            self.offset_leaf(leaf_one.id, string_one_idx),
            self.offset_leaf(leaf_two.id, string_two_idx),
            max_string_depth,
        )

    def compute_stats(self, string_idx: int = 0) -> TreeStats:
        """Tree stats + BWT via one lexicographic DFS (tree.rs:740-803).

        Only string 0 yields a meaningful BWT/leaf count (the leaf id
        test matches string 0's id layout — SURVEY §2.4-15); both
        implementations reject other indices so the API is identical.
        """
        if string_idx != 0:
            raise ValueError("compute_stats supports string 0 only")
        s = self.strings[string_idx]
        bwt = [" "] * len(s)
        state = {
            "idx": 0,
            "num_leaves": 0,
            "num_internal": 0,
            "max_depth": 0,
            "depth_sum": 0,
            "longest_len": 0,
            "longest_start": 0,
            "longest_flag": False,
        }

        def visit(node: _Node) -> bool:
            if 0 < node.id < len(s) + 1 and state["idx"] < len(s):
                if state["longest_flag"]:
                    state["longest_start"] = node.id
                    state["longest_flag"] = False
                state["num_leaves"] += 1
                bwt[state["idx"]] = "$" if node.id == 1 else s[node.id - 2]
                state["idx"] += 1
            else:
                if node.id == 0:
                    return False
                state["num_internal"] += 1
                state["depth_sum"] += node.string_depth
                if node.string_depth > state["max_depth"]:
                    state["longest_len"] = node.string_depth
                    state["longest_flag"] = True
                    state["max_depth"] = node.string_depth
            return False

        self.dfs(visit, 0)

        st = self.stats
        st.longest_repeat_len = state["longest_len"]
        st.longest_repeat_start = state["longest_start"]
        st.num_leaves = state["num_leaves"]
        st.num_internal = state["num_internal"]
        st.num_nodes = st.num_internal + st.num_leaves + 1
        st.bwt = "".join(bwt).strip()
        st.average_string_depth = (
            state["depth_sum"] / st.num_internal if st.num_internal else 0.0
        )
        st.max_string_depth = state["max_depth"]
        return st
