"""The one placement scorer: estimated cache-local bytes of a work unit
against a host's digest summary.

Two schedulers consume this module — and deliberately nothing else scores
placement anywhere in the tree:

* **Grant time** — :class:`repro_torch.dist.queue.WorkQueue` scores every
  live decision (grant / backlog fill / steal / speculation target / dead-node
  requeue) for one running cluster.
* **Admission time** — :mod:`repro_torch.core.campaign` buckets whole job
  arrays by the same score before anything is submitted, so a SLURM campaign lands
  on the hosts that already hold its bytes.

Keeping both on one function is a correctness property, not a style choice:
if admission-time and grant-time scoring drift, the campaign planner seeds a
queue with partitions the queue itself would immediately score differently
and re-shuffle — locality paid for twice, delivered once. A test imports
this function from both call sites and pins them to the same object.

Scores are *estimates* (Bloom false positives, stale summaries) and only
ever shape ordering; correctness is score-blind everywhere.

``summary`` is duck-typed: anything supporting ``len(summary)`` and
``digest in summary`` works (:class:`repro_torch.dist.cache.DigestSummary` in
production, plain sets in tests).
"""
from __future__ import annotations

from typing import (Container, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)


def unit_local_bytes(unit, summary) -> int:
    """Estimated bytes of ``unit``'s inputs already present in ``summary``
    (``Σ input_bytes[s]`` over input digests the summary holds). 0 without a
    usable summary or without manifest digests on the unit — the
    locality-blind fallback, never an error."""
    if summary is None or not len(summary):
        return 0
    digests = getattr(unit, "input_digests", None)
    if not digests:
        return 0
    sizes = unit.input_bytes
    return sum(sizes.get(s, 0) for s, d in digests.items() if d in summary)


def best_node(unit, candidates: Sequence[str], summaries: Mapping[str, object],
              load: Optional[Mapping[str, int]] = None) -> str:
    """The candidate holding the most of ``unit``'s input bytes; ties go to
    the lightest ``load`` (deque depth at grant time, assigned bytes at
    admission time), then lexicographic node id for determinism."""
    load = load or {}
    return min(candidates,
               key=lambda n: (-unit_local_bytes(unit, summaries.get(n)),
                              load.get(n, 0), n))


def best_peers(digest: str, candidates: Sequence[str],
               summaries: Mapping[str, object],
               load: Optional[Mapping[str, int]] = None,
               limit: Optional[int] = None) -> List[str]:
    """Candidates whose summary (probably) holds blob ``digest``, ranked
    warmest-first for the peer fabric: lightest ``load`` first (a busy
    node's disk and NIC are the straggler's), then lexicographic node id
    for determinism. Bloom membership is a *probably* — the fabric treats a
    peer 404 as a false positive and moves on — so ranking only ever shapes
    the order in which peers are tried, never correctness. Same scoring
    household as :func:`best_node`: the queue consumes both, and nothing
    else in the tree ranks placement."""
    load = load or {}
    holders = [n for n in candidates
               if (s := summaries.get(n)) is not None and len(s) and digest in s]
    holders.sort(key=lambda n: (load.get(n, 0), n))
    return holders[:limit] if limit is not None else holders


class WarmSetIndex:
    """Incremental inverse of :func:`unit_local_bytes`: digest → unit posting
    lists built once at admission, folded against each node's known digests
    as summaries arrive, so every placement decision reads a per-node
    ``unit → warm bytes`` dict instead of re-probing Bloom filters for up to
    hundreds of units under the queue lock.

    Three pieces of state:

    * ``_postings`` — ``digest → [(unit_idx, bytes)]`` where *bytes* is the
      summed manifest size of that unit's inputs carrying that digest.
      Immutable after construction; only *referenced* digests exist here, so
      hostile or irrelevant digests in a summary cost one dict miss and no
      memory.
    * ``_held`` — per node, a count per referenced digest (a multiset: the
      counting-Bloom summaries support repeated add/discard of one digest,
      and the index must not zero a score until the last copy drops).
    * ``_scores`` — per node, ``unit_idx → warm bytes`` holding only nonzero
      entries: the node's *warm set*. ``scores(node).items()`` is exactly
      "the units worth sorting" for a backlog fill — everything absent is
      score 0 by construction.

    ``rebuild`` (full summary push) probes every referenced digest against
    the summary, so its scores equal :func:`unit_local_bytes` probe-for-probe
    — Bloom false positives included — unless the wire carries an exact
    ``digests`` list, in which case the index is strictly *more* accurate
    than re-probing. ``add``/``discard`` (summary deltas) are O(delta ×
    posting-list length). Scores remain estimates and only shape ordering;
    correctness stays score-blind everywhere.
    """

    def __init__(self, units: Sequence[object], *,
                 skip: Container[int] = ()):
        """``skip`` excludes unit indices from the posting lists — journal
        recovery rebuilds the index over only still-placeable units, so a
        mostly-finished campaign's restarted coordinator doesn't carry (or
        score against) postings for work that already retired."""
        self._postings: Dict[str, List[Tuple[int, int]]] = {}
        for i, u in enumerate(units):
            if i in skip:
                continue
            digests = getattr(u, "input_digests", None)
            if not digests:
                continue
            sizes = getattr(u, "input_bytes", None) or {}
            per: Dict[str, int] = {}
            for s, d in digests.items():
                per[d] = per.get(d, 0) + sizes.get(s, 0)
            for d, w in per.items():
                if w > 0:
                    self._postings.setdefault(d, []).append((i, w))
        self._held: Dict[str, Dict[str, int]] = {}
        self._scores: Dict[str, Dict[int, int]] = {}

    # -- summary application ------------------------------------------------
    def rebuild(self, node: str, summary,
                digests: Optional[Iterable[str]] = None) -> None:
        """Replace ``node``'s warm set from a full summary push. With an
        exact ``digests`` list the rebuild is exact; otherwise every
        referenced digest is probed via ``d in summary`` (matching
        :func:`unit_local_bytes`, false positives and all)."""
        held: Dict[str, int] = {}
        if digests is not None:
            for d in digests:
                d = str(d)
                if d in self._postings:
                    held[d] = held.get(d, 0) + 1
        elif summary is not None and len(summary):
            for d in self._postings:
                if d in summary:
                    held[d] = 1
        scores: Dict[int, int] = {}
        for d in held:
            for i, w in self._postings[d]:
                scores[i] = scores.get(i, 0) + w
        self._held[node] = held
        self._scores[node] = scores

    def add(self, node: str, digest: str) -> None:
        """Apply one summary-delta ``add``; O(posting list)."""
        if digest not in self._postings:
            return
        held = self._held.setdefault(node, {})
        c = held.get(digest, 0)
        held[digest] = c + 1
        if c:
            return
        scores = self._scores.setdefault(node, {})
        for i, w in self._postings[digest]:
            scores[i] = scores.get(i, 0) + w

    def discard(self, node: str, digest: str) -> None:
        """Apply one summary-delta ``drop``; no-op below zero, mirroring the
        counting-Bloom discard."""
        held = self._held.get(node)
        if not held:
            return
        c = held.get(digest, 0)
        if c == 0:
            return
        if c > 1:
            held[digest] = c - 1
            return
        del held[digest]
        scores = self._scores.get(node) or {}
        for i, w in self._postings[digest]:
            left = scores.get(i, 0) - w
            if left > 0:
                scores[i] = left
            else:
                scores.pop(i, None)

    def drop_node(self, node: str) -> None:
        self._held.pop(node, None)
        self._scores.pop(node, None)

    # -- lookups ------------------------------------------------------------
    def score(self, node: str, unit_idx: int) -> int:
        """Warm bytes of one unit on one node — O(1)."""
        s = self._scores.get(node)
        return s.get(unit_idx, 0) if s else 0

    def scores(self, node: str) -> Mapping[int, int]:
        """The node's warm set (``unit_idx → bytes``, nonzero entries only).
        Callers must not mutate the returned mapping."""
        return self._scores.get(node) or {}

    def best_node(self, unit_idx: int, candidates: Sequence[str],
                  load: Optional[Mapping[str, int]] = None) -> str:
        """Index-backed :func:`best_node`: same tie-break (most warm bytes,
        then lightest load, then lexicographic node id) without touching a
        summary."""
        load = load or {}
        return min(candidates,
                   key=lambda n: (-self.score(n, unit_idx), load.get(n, 0), n))
