# Copy of repro/lst/catalog/pointer.py; the port imports nothing of repro.
"""Catalog pointer records: one atomic fact per registered table.

A :class:`TablePointer` is everything a reader needs to open one synced
table without touching the table's own metadata first: where it lives
(``base_path``), which format views exist there, and — per view — the
head *token* and head *commit id* the pointer was published at
(:class:`ViewRef`).  The token is the read plane's conditional-GET ETag
(what ``head_token()`` returns); the commit id is what pins a snapshot:
``state_at(commit)`` resolves the exact published state even after the
table has moved on, which is what makes cross-table group reads
consistent instead of merely fresh.

Pointers are immutable values inside a catalog generation manifest — an
update is a NEW pointer in a NEW generation, never a mutation — so a
reader holding a resolved pointer can never observe it change.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ViewRef", "TablePointer", "pointer_to_json",
           "pointer_from_json"]


@dataclass(frozen=True)
class ViewRef:
    """One format view of a table at publish time: the opaque head token
    (conditional-GET identity) and the commit id the view is pinned at."""
    token: str
    commit: str


@dataclass(frozen=True)
class TablePointer:
    """name -> (base path, format views, pinned heads) registration.

    ``views`` maps each published format view to its :class:`ViewRef`;
    ``source_format`` names the writer's native format (the default view
    for readers that do not ask for a specific one).  ``properties`` is
    free-form registration metadata (owner, description, ...).
    """
    name: str
    base_path: str
    source_format: str
    views: dict = field(default_factory=dict)       # fmt -> ViewRef
    properties: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.name:
            raise ValueError("pointer name must be non-empty")
        if not self.base_path:
            raise ValueError("pointer base_path must be non-empty")
        if self.source_format not in self.views:
            raise ValueError(
                f"pointer {self.name!r} must carry a view for its source "
                f"format {self.source_format!r}; has {sorted(self.views)}")

    @property
    def formats(self) -> tuple:
        """The published format views, source format first."""
        rest = sorted(f for f in self.views if f != self.source_format)
        return (self.source_format, *rest)

    def view(self, fmt: str | None = None) -> ViewRef:
        """The pinned head of ``fmt`` (default: the source format view).

        Raises ``KeyError`` with the available views when the requested
        one was not published — a pointer never silently substitutes a
        different (differently pinned) view.
        """
        fmt = fmt or self.source_format
        ref = self.views.get(fmt)
        if ref is None:
            raise KeyError(
                f"table {self.name!r} has no published {fmt!r} view "
                f"(published: {sorted(self.views)})")
        return ref


def pointer_to_json(p: TablePointer) -> dict:
    return {"name": p.name, "basePath": p.base_path,
            "sourceFormat": p.source_format,
            "views": {f: {"token": r.token, "commit": r.commit}
                      for f, r in sorted(p.views.items())},
            "properties": dict(p.properties)}


def pointer_from_json(d: dict) -> TablePointer:
    return TablePointer(
        name=d["name"], base_path=d["basePath"],
        source_format=d["sourceFormat"],
        views={f: ViewRef(v["token"], v["commit"])
               for f, v in d.get("views", {}).items()},
        properties=dict(d.get("properties", {})))
