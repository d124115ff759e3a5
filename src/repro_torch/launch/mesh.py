"""Production meshes, as DeviceMeshes over the initialised process group.

Single pod: 256 devices as (data=16, model=16).
Multi-pod:  2 pods x 256 devices as (pod=2, data=16, model=16) — the
``pod`` axis is pure data parallelism whose gradient reduction crosses
pods once per step.  The shapes and axis names are the reference's
(``repro/launch/mesh.py``).  The dry run builds them over a fake process
group of 256 or 512 ranks; on the card host, ``make_host_mesh`` spans its
GPUs.  The mesh's device type follows the group's backend: ``cuda`` for
NCCL, ``cpu`` otherwise (gloo, or the dry run's fake group, whose tensors
live on ``meta``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh():
    """This host's GPUs as a 1D data mesh (the caller initialises an NCCL
    group of ``torch.cuda.device_count()`` ranks)."""
    return init_device_mesh("cuda", (torch.cuda.device_count(),),
                            mesh_dim_names=("data",))


def pod_size(mesh) -> int | None:
    """Devices per pod; None if single pod."""
    if "pod" in mesh.mesh_dim_names:
        i = mesh.mesh_dim_names.index("pod")
        return mesh.size() // mesh.shape[i]
    return None
