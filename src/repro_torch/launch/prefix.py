"""Radix-trie prefix index over token IDs, at page granularity
(DESIGN.md §18). The port's own copy of the reference's
``launch/prefix.py``: pure Python, copied rather than imported, so the
port loads nothing of the reference package.

The serving analogue of the paper's wise-sharing thesis applied to cache
memory: identical prompt prefixes (system prompts, few-shot headers) are
stored once in the page pool and mapped read-only into every request that
matches them.  The trie is the host-side index that makes the lookup
cheap: each node covers the tokens of exactly ONE pool page (up to
``page_size`` of them — the tail of a prompt may populate a partial
node), children are keyed by their token tuple, and a lookup walks the
longest matching chain.

Refcount protocol (owned by the engine, not the trie): the trie holds
+1 on every page its nodes reference, each block-table entry holds +1,
and a page is writable only at refcount 1.  The trie never touches the
refcount array itself — ``insert`` returns the pages that gained a node
and ``evict_lru`` returns the page it dropped, so the engine's
bookkeeping stays in one place and the invariant

    sum(refcounts) == mapped block-table entries + trie nodes

is checkable from outside.

Recency is a logical clock (ticked per ``match``/``insert``), so LRU
eviction is deterministic under test.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


class _Node:
    __slots__ = ("toks", "page", "children", "parent", "last_used")

    def __init__(self, toks: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.toks = toks            # 1..page_size token IDs this page holds
        self.page = page            # pool page with the matching K/V rows
        self.children = {}          # toks tuple -> _Node
        self.parent = parent
        self.last_used = 0


def _common(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixTrie:
    """Longest-cached-prefix index mapping prompts to pool pages."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _Node((), -1, None)
        self._clock = 0
        self._n_pages = 0

    def page_count(self) -> int:
        """Number of nodes == number of pages the trie holds a ref on."""
        return self._n_pages

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------------ #
    def match(self, prompt, *, touch: bool = True
              ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt``.

        Returns ``(pages, n_matched)``: the pool pages covering prompt
        rows ``[0, n_matched)`` in order.  The walk descends only through
        fully-matched FULL nodes; a partial node (a cached prompt tail)
        or a mid-node divergence contributes its matched rows and ends
        the chain — its page is a gather source for the caller, never a
        further branch point.  ``touch=False`` makes the lookup
        side-effect free (no LRU update) for admission planning."""
        prompt = tuple(int(t) for t in prompt)
        now = self._tick() if touch else self._clock
        node, pages, pos = self.root, [], 0
        while pos < len(prompt):
            rem = prompt[pos:]
            best, blen = None, 0
            for ch in node.children.values():
                n = _common(ch.toks, rem)
                if n > blen:
                    best, blen = ch, n
            if best is None or blen == 0:
                break
            pages.append(best.page)
            pos += blen
            if touch:
                best.last_used = now
            if blen < len(best.toks) or len(best.toks) < self.page_size:
                break
            node = best
        return pages, pos

    # ------------------------------------------------------------------ #
    def insert(self, prompt, pages) -> List[int]:
        """Publish a prompt's block-table pages into the trie.

        ``pages[j]`` is the pool page holding prompt rows
        ``[j*page_size, (j+1)*page_size)``.  Segments already present are
        reused (their node's page may differ from ``pages[j]`` — e.g. the
        caller forked a boundary page — and stays authoritative); new
        segments get nodes pointing at the caller's pages.  A divergent
        or longer tail becomes a SIBLING of the existing node — node
        pages are immutable once shared, so an upgrade-in-place would
        corrupt concurrent readers.  Returns the pages that gained a new
        trie reference, for the caller to incref."""
        prompt = tuple(int(t) for t in prompt)
        ps = self.page_size
        now = self._tick()
        node, new_pages = self.root, []
        for j in range(-(-len(prompt) // ps)):
            toks = prompt[j * ps:(j + 1) * ps]
            ch = node.children.get(toks)
            if ch is None and len(toks) < ps:
                # partial tail already covered by a longer sibling: a
                # duplicate node would spend a page on rows the longer
                # one already serves
                if any(_common(c.toks, toks) == len(toks)
                       for c in node.children.values()):
                    break
            if ch is None:
                ch = _Node(toks, int(pages[j]), node)
                node.children[toks] = ch
                self._n_pages += 1
                new_pages.append(int(pages[j]))
            ch.last_used = now
            if len(ch.toks) < ps:
                break
            node = ch
        return new_pages

    # ------------------------------------------------------------------ #
    def evict_lru(self, refs) -> Optional[int]:
        """Drop the least-recently-used zero-ref LEAF (a page only the
        trie still references: ``refs[page] == 1``) and return its page
        for the caller to decref/free.  Interior nodes become evictable
        leaves once their subtrees drain — cascading happens by repeated
        calls.  Returns None when nothing is evictable."""
        best = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            for ch in node.children.values():
                if ch.children:
                    stack.append(ch)
                elif refs[ch.page] == 1 and (
                        best is None or ch.last_used < best.last_used):
                    best = ch
        if best is None:
            return None
        del best.parent.children[best.toks]
        self._n_pages -= 1
        return best.page

    def evictable_pages(self, refs) -> int:
        """Pages reclaimable by cascading ``evict_lru``: nodes whose
        ENTIRE subtree is referenced only by the trie.  A node pinned by
        an active slot (refs > 1) blocks its ancestors — they can never
        become leaves — but not its evictable siblings/descendants."""
        def rec(node: _Node) -> Tuple[int, bool]:
            total, all_ev = 0, True
            for ch in node.children.values():
                t, ev = rec(ch)
                total += t
                all_ev = all_ev and ev
            ev = all_ev and refs[node.page] == 1
            return total + (1 if ev else 0), ev

        return sum(rec(ch)[0] for ch in self.root.children.values())
