from repro_torch.kernels.ssd.ops import (SSDChunkScanFn, ssd_chunk_scan,
                                         ssd_chunk_scan_bwd)
from repro_torch.kernels.ssd.ref import ssd_bwd_ref, ssd_ref

__all__ = ["SSDChunkScanFn", "ssd_chunk_scan", "ssd_chunk_scan_bwd",
           "ssd_bwd_ref", "ssd_ref"]
