"""Serving side of the port: the batched decode engine, whose weights
restore through any XTable-translated view of a lake checkpoint, and the
snapshot read plane it can restore through."""

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.read_plane import (GroupSnapshot, ReadResult,
                                          ScanResult, SnapshotServer,
                                          TableSnapshot)

__all__ = ["Request", "ServeEngine", "SnapshotServer", "TableSnapshot",
           "ReadResult", "ScanResult", "GroupSnapshot"]
