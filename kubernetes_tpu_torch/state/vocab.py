"""String interning vocabularies.

The tensor snapshot (state/snapshot.py) encodes label keys/values, taint
triples, ports, namespaces and spreading groups as dense integer ids.
Interners are append-only so ids are stable for the lifetime of a
scheduler process; tensor shapes derived from vocab sizes are bucketed
to powers of two to keep compiled shapes stable (SURVEY.md §7 hard
part (e): recompilation pressure).

Append-only is also a leak under node churn: every hostname/label/image
a departed node ever contributed stays interned until a compaction
(state/scrubber.py compact) rebuilds the vocabularies from live objects
via `Interner.adopt` — in place, preserving object identity, because
interners are shared by reference across the snapshot, the featurizer
and the node-lifecycle controller. `VocabSet.generation` counts those
rebuilds and is folded into `version()` so featurizer caches can never
confuse pre- and post-compaction id spaces even when sizes coincide.
"""

from __future__ import annotations

from typing import Dict, List


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round up to a power of two (>= minimum) so tensor shapes stay stable."""
    b = minimum
    while b < n:
        b *= 2
    return b


class Interner:
    """Append-only string -> id map. Id 0 is reserved for "absent"/pad."""

    __slots__ = ("_ids", "_strings")

    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._strings: List[str] = ["\x00<pad>"]

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strings)
            self._ids[s] = i
            self._strings.append(s)
        return i

    def lookup(self, s: str) -> int:
        """Id of s, or -1 if never interned. -1 never matches any stored id,
        which encodes "this selector value matches nothing here yet"."""
        return self._ids.get(s, -1)

    def string(self, i: int) -> str:
        return self._strings[i]

    def __len__(self) -> int:
        return len(self._strings)

    @property
    def size(self) -> int:
        return len(self._strings)

    def strings(self) -> List[str]:
        """Live strings in id order, pad excluded — the mark set a
        compaction rebuilds from."""
        return self._strings[1:]

    def adopt(self, other: "Interner") -> None:
        """Replace contents with `other`'s, IN PLACE. The object identity
        must survive: interners are shared by reference (snapshot.extended
        aliases vocabs.resources, nodelifecycle shares zones), so a
        compaction can never swap in a new Interner object."""
        self._ids = dict(other._ids)
        self._strings = list(other._strings)


class VocabSet:
    """All vocabularies used by the tensor encoding."""

    # attribute names of every interner, in declaration order — the
    # closed label set of the snapshot_vocab_size{vocab} gauge and the
    # iteration order of sizes()/adopt_all()
    NAMES = ("label_keys", "label_values", "taint_keys", "taint_values",
             "resources", "ports", "namespaces", "zones", "images",
             "pod_label_keys")

    def __init__(self):
        self.label_keys = Interner()
        self.label_values = Interner()  # global value vocab (shared across keys)
        self.taint_keys = Interner()
        self.taint_values = Interner()
        self.resources = Interner()  # extended resource names (snapshot columns)
        self.ports = Interner()  # "proto/port" strings
        self.namespaces = Interner()
        self.zones = Interner()  # GetZoneKey strings
        self.images = Interner()  # container image names
        self.pod_label_keys = Interner()  # pod-label key space (ep matrix)
        # bumped by every compaction adopt_all(); part of version() so a
        # post-compaction vocab whose sizes happen to match the
        # pre-compaction sizes still invalidates featurizer caches
        self.generation = 0

    def version(self) -> tuple:
        """Sizes of the vocabs selector compilation reads; featurizer caches
        are invalidated when this changes (a -1 'unknown value' lookup may
        have become valid). Includes the compaction generation: a rebuild
        REASSIGNS ids, so sizes alone cannot prove cached rows valid."""
        return (
            self.generation,
            self.label_keys.size,
            self.label_values.size,
            self.taint_keys.size,
            self.taint_values.size,
            self.pod_label_keys.size,
        )

    def sizes(self) -> Dict[str, int]:
        """Per-vocab sizes keyed by attribute name (metrics export and
        the soak harness's plateau gates)."""
        return {name: getattr(self, name).size for name in self.NAMES}

    def adopt_all(self, other: "VocabSet") -> None:
        """Adopt every interner's contents from `other` in place (object
        identities preserved — see Interner.adopt) and bump the
        generation. The compaction commit step."""
        for name in self.NAMES:
            getattr(self, name).adopt(getattr(other, name))
        self.generation += 1

    def intern_label(self, key: str, value: str) -> tuple:
        return self.label_keys.intern(key), self.label_values.intern(value)

    def port_id(self, protocol: str, port: int) -> int:
        return self.ports.intern(f"{protocol}/{port}")

    def lookup_port(self, protocol: str, port: int) -> int:
        return self.ports.lookup(f"{protocol}/{port}")
