# Copy of repro/lst/catalog/__init__.py; the port imports nothing of repro.
"""Catalog subsystem: one consistent entry point over XTable-synced tables.

Each table syncs independently (that is what makes the write path
O(change)), but a *dataset* is usually many tables — and a reader joining
orders against customers must never see orders at cycle N with customers
at cycle N-1.  This package closes that gap (ROADMAP open item 2):

* ``pointer``  — :class:`TablePointer` / :class:`ViewRef`: immutable
                 name -> (base path, format views, pinned head token +
                 commit) registration records.
* ``store``    — :class:`CatalogStore`: generation-numbered manifest
                 documents persisted through the ``FileSystem`` protocol;
                 publishing is ONE atomic put-if-absent (the same
                 durability pattern as ``core/checkpoint.py``), losers
                 get :class:`CatalogConflict`.
* ``catalog``  — :class:`Catalog` / :class:`CatalogSnapshot` /
                 :class:`CatalogTransaction`: optimistic **group
                 commit** — any number of pointer and group updates
                 staged together become visible in one atomic manifest
                 swap, so cross-table readers observe either all of a
                 publish or none of it.

The daemon publishes through it (``catalog:`` config block), the read
plane pins cross-table reads to one generation
(:meth:`~repro_torch.serve.read_plane.SnapshotServer.read_group`), and
``ServeEngine.from_lake`` resolves tables by catalog name.  See
``docs/catalog-registration.md`` for the end-to-end walkthrough.
"""

from repro_torch.lst.catalog.catalog import (Catalog, CatalogSnapshot,
                                       CatalogTransaction, UnknownTableError)
from repro_torch.lst.catalog.pointer import (TablePointer, ViewRef,
                                       pointer_from_json, pointer_to_json)
from repro_torch.lst.catalog.store import (CATALOG_VERSION, CatalogConflict,
                                     CatalogStore)

__all__ = ["Catalog", "CatalogSnapshot", "CatalogTransaction",
           "UnknownTableError", "TablePointer", "ViewRef",
           "pointer_to_json", "pointer_from_json", "CATALOG_VERSION",
           "CatalogConflict", "CatalogStore"]
