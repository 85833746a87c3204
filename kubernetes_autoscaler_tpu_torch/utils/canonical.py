"""Shared canonical encoding + object-identity change detection.

One vocabulary of "changed" for the two consumers that must agree on it BY
CONSTRUCTION:

  * the flight journal (replay/journal.py) — serializes each loop's world
    and commits listing-order add/del/mod delta records against the
    previous loop;
  * the device-resident WorldStore (models/world_store.py) — keeps the
    encoded planes resident on the device and applies a per-loop delta
    program derived from the same loop-to-loop object diff.

Both ride the repo-wide replace-on-update contract (a changed k8s object is
a NEW object; informer-fed sources and FakeCluster honor it, and the
incremental encoder's id()-based fingerprints already depend on it). The
helpers here are the single implementation of that contract:

  * `canonical` / `digest_of` / `digest_strs` — deterministic JSON + sha256/16
    digests, process- and platform-independent (journal record seals, world
    digests, composition fingerprints);
  * `canon_map` — ordered key → canonical-JSON maps with an object-IDENTITY
    cache, turning per-loop serialization cost from O(world) to O(churn);
  * `IdentityMemo` — the same identity-caching pattern for arbitrary derived
    values (marshal-cache exemplar signatures, template fingerprints), so
    every fingerprint on the encode path is O(churn) too;
  * `node_fp` — the cheap in-place-mutation fingerprint for Node objects
    (the one k8s object the control plane itself mutates in place).

If the journal says an object changed, the WorldStore's delta program
re-lowers it, and vice versa — there is no second, subtly different notion
of equality to drift.
"""

from __future__ import annotations

import hashlib
import json


def canonical(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace, default=str for the
    rare non-JSON leaf. Tuples and lists both serialize as arrays, so a
    live-object encoding and its JSON round trip share one canonical form."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), default=str)


def digest_of(obj) -> str:
    return hashlib.sha256(canonical(obj).encode()).hexdigest()[:16]


def digest_strs(parts: list[str]) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


def canon_map(objs, key_of, to_dict, cache: dict
              ) -> tuple[dict, dict[str, str]]:
    """Ordered key → canonical map, reusing cached canonical forms for
    objects whose IDENTITY is unchanged (replace-on-update contract).
    Returns (new cache holding only live objects, the map). The cache value
    holds the object reference, so a freed id can never alias — the
    host_mirror_token pattern."""
    new_cache: dict[int, tuple] = {}
    out: dict[str, str] = {}
    for obj in objs:
        hit = cache.get(id(obj))
        canon = hit[1] if hit is not None and hit[0] is obj \
            else canonical(to_dict(obj))
        new_cache[id(obj)] = (obj, canon)
        out[key_of(obj)] = canon
    return new_cache, out


class IdentityMemo:
    """Memoize `fn(obj)` by object identity across refresh rounds.

    `refresh(objs)` computes (or reuses) the value for every listed object
    and DROPS entries for objects no longer listed — the cache never grows
    past the live set, and holding the object reference pins its id against
    reuse. The derived value must be a pure function of the object's
    content, which the replace-on-update contract makes equivalent to a
    function of its identity between replacements."""

    __slots__ = ("fn", "_cache", "hits", "misses")

    def __init__(self, fn):
        self.fn = fn
        self._cache: dict[int, tuple] = {}
        self.hits = 0
        self.misses = 0

    def get(self, obj):
        """One lookup WITHOUT lifecycle management (caller sweeps via
        refresh, or accepts growth bounded by its own call pattern)."""
        hit = self._cache.get(id(obj))
        if hit is not None and hit[0] is obj:
            self.hits += 1
            return hit[1]
        self.misses += 1
        val = self.fn(obj)
        self._cache[id(obj)] = (obj, val)
        return val

    def refresh(self, objs) -> list:
        new_cache: dict[int, tuple] = {}
        out = []
        for obj in objs:
            hit = self._cache.get(id(obj))
            if hit is not None and hit[0] is obj:
                self.hits += 1
                val = hit[1]
            else:
                self.misses += 1
                val = self.fn(obj)
            new_cache[id(obj)] = (obj, val)
            out.append(val)
        self._cache = new_cache
        return out


def node_fp(nd) -> tuple:
    """Cheap change fingerprint for a Node. Catches the in-place mutations
    the control plane itself performs (ready flips, cordons, taint sync);
    label/capacity map REPLACEMENT is caught via id() — in-place mutation of
    those dicts is outside the source contract (k8s replaces objects on
    update)."""
    return (
        nd.ready, nd.unschedulable,
        tuple((t.key, t.value, t.effect) for t in nd.taints),
        id(nd.labels), id(nd.allocatable), id(nd.capacity),
        id(nd.annotations),
    )
