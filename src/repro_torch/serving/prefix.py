"""Radix prefix index: maps prompt prefixes to live KV pages for reuse.

Host-side Python, ported almost verbatim from ``repro.serving.prefix``.

The index is a page-granular radix tree.  Each node owns exactly one
physical page and the tuple of prompt tokens whose KV that page holds —
full interior/leaf nodes carry ``page_size`` tokens, partial leaves carry
the tail of a prompt that did not fill its last page (``n_valid <
page_size`` slots written).  Only full nodes have children, because a
token beyond a node's page implies that page was full.

The index participates in the refcounted :class:`~repro_torch.serving.kv_cache.
PageAllocator` protocol: inserting a prompt takes one extra reference per
*newly created* node, which is what keeps a retired request's prompt
pages alive for future admissions (the whole point of prefix caching).
``evict`` walks least-recently-used leaves and drops those references
when the scheduler needs pages back — cached prefixes are strictly lower
value than live requests, so reclaim is tried before request eviction.

Matching is token-granular: a prompt may match a chain of full nodes and
then share the longest common prefix of one more (full or partial) node.
The scheduler maps matched full pages read-only into the new request's
page table, plans a copy-on-write clone for a partially-matched page, and
chunk-prefills only the uncovered tail.  Coverage is capped at
``len(prompt) - 1`` so every request prefills at least one token — the
model needs the last prompt position's logits to sample the first output
token, and the cap also guarantees a sharer never *writes* a fully-shared
page (prompt slots are write-once; the first write lands on the request's
own tail pages).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.serving.obs import NULL_RECORDER


class _Node:
    __slots__ = ("tokens", "page", "n_valid", "children", "parent",
                 "last_used")

    def __init__(self, tokens: Tuple[int, ...], page: int, n_valid: int,
                 parent: "_Node"):
        self.tokens = tokens
        self.page = page
        self.n_valid = n_valid
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


def _common(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixPrefixIndex:
    """Prompt-prefix → page radix tree over a shared ``PageAllocator``."""

    def __init__(self, allocator, page_size: int, *, recorder=None):
        self.allocator = allocator
        self.page_size = page_size
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self._root = _Node((), -1, 0, parent=None)  # sentinel, no page
        self._nodes: List[_Node] = []
        self._tick = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- lookup ------------------------------------------------------------
    def match(self, prompt: List[int]
              ) -> Tuple[List[int], Optional[Tuple[int, int]], int]:
        """Longest cached prefix of ``prompt``.

        Returns ``(full_pages, partial, covered)``: ``full_pages`` map
        read-only into the requester's page table, ``partial`` is
        ``(page, n_tokens)`` for a partially-matched page the requester
        must clone before extending, and ``covered`` is the total number
        of prefix tokens whose KV the match supplies (capped at
        ``len(prompt) - 1`` so at least one token is always prefilled).
        """
        ps = self.page_size
        pages: List[int] = []
        cur = self._root
        i = 0
        while len(prompt) - i >= ps:
            node = cur.children.get(tuple(prompt[i:i + ps]))
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            i += ps
            cur = node
        rest = prompt[i:]
        if rest:
            best, best_n = None, 0
            for child in cur.children.values():
                n = _common(child.tokens[:child.n_valid], rest)
                if n > best_n:
                    best, best_n = child, n
            if best is not None:
                self._touch(best)
                pages.append(best.page)
                i += best_n
        covered = min(i, len(prompt) - 1)
        n_full, rem = covered // ps, covered % ps
        partial = (pages[n_full], rem) if rem else None
        return pages[:n_full], partial, covered

    # -- insertion ---------------------------------------------------------
    def insert(self, prompt: List[int], pages: List[int]) -> int:
        """Index a finished prefill: walk/create one node per prompt page.

        Every *newly created* node takes one allocator reference on its
        page (released on eviction).  Pages already indexed under the
        same token path are left alone — the existing node keeps serving
        its own physical page.  Returns the number of new references.
        """
        ps = self.page_size
        n_full, rem = len(prompt) // ps, len(prompt) % ps
        cur = self._root
        added = 0
        for j in range(n_full):
            key = tuple(prompt[j * ps:(j + 1) * ps])
            node = cur.children.get(key)
            if node is None:
                node = _Node(key, pages[j], ps, parent=cur)
                self.allocator.share([pages[j]])
                cur.children[key] = node
                self._nodes.append(node)
                added += 1
            self._touch(node)
            cur = node
        if rem:
            tail = tuple(prompt[n_full * ps:])
            # skip if an existing child already covers this tail
            if not any(_common(c.tokens[:c.n_valid], tail) == rem
                       for c in cur.children.values()):
                node = _Node(tail, pages[n_full], rem, parent=cur)
                self.allocator.share([pages[n_full]])
                cur.children[tail] = node
                self._nodes.append(node)
                added += 1
        return added

    # -- reclaim -----------------------------------------------------------
    def _drop(self, node: _Node) -> None:
        del node.parent.children[node.tokens]
        self._nodes.remove(node)
        self.allocator.free([node.page])

    def evict(self, n: int) -> int:
        """Drop LRU leaves until ``n`` pages returned to the pool (or no
        reclaimable leaf remains).  Only leaves whose page the index is
        the *sole* holder of actually release memory — shared leaves are
        left alone (evicting them frees nothing and loses cache).
        Returns the number of pages actually freed to the pool."""
        freed = 0
        while freed < n:
            leaves = [nd for nd in self._nodes
                      if not nd.children
                      and self.allocator.refcount(nd.page) == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            self._drop(victim)
            freed += 1
        if self.obs and freed:
            self.obs.on_prefix_evict(freed)
        return freed

    def clear(self) -> int:
        """Drop every node (releasing the index's references)."""
        dropped = 0
        while self._nodes:
            leaves = [nd for nd in self._nodes if not nd.children]
            for nd in leaves:
                self._drop(nd)
                dropped += 1
        return dropped

    # -- invariants --------------------------------------------------------
    def pages_held(self) -> List[int]:
        """One entry per node (the reference it holds) — invariant checks
        reconcile these against allocator refcounts."""
        return [nd.page for nd in self._nodes]
