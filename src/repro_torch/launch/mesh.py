"""Meshes and device sets, the port of ``repro.launch.mesh``: the
data-parallel host mesh that the launchers train and serve over, any mesh of
``torch.device``s (``make_mesh``), per-stage device slices for a pipeline,
and the production meshes of H100 GPUs that the dry run lowers onto, with
the card's constants (``HW``) for its roofline."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.sharding import Mesh


def local_devices() -> list:
    """Every local CUDA device. Raises when there is none: nothing falls back
    to the CPU on its own; a caller that wants the CPU passes
    ``[torch.device("cpu")] * k`` itself."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device is available; pass a device list such as "
                           "[torch.device('cpu')] * k to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape, axes, devices) -> Mesh:
    """``devices`` (a list of ``torch.device``s, which may repeat one) laid
    out as a mesh of ``shape`` with the axis names ``axes``."""
    shape, devices = tuple(shape), [torch.device(d) for d in devices]
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"a mesh of shape {shape} needs {int(np.prod(shape))} devices, "
                         f"got {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device="meta") -> Mesh:
    """32 x 8 = 256 H100 GPUs on ``("data", "model")``, ``"model"`` inside a
    node's 8 NVLink GPUs; with ``multi_pod``, 2 x 32 x 8 = 512 on ``("pod",
    "data", "model")``. These are ``repro``'s chip counts, so that the two
    dry runs compare a device at the same size. Every position is
    ``device`` (``meta`` by default: the dry run allocates nothing)."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device(device)] * int(np.prod(shape)))


def make_host_mesh(devices=None) -> Mesh:
    """Every local CUDA device on one ``("data",)`` axis, or ``devices``
    where given (``[cuda:0] * 2`` runs two positions on one card; ``[cpu] *
    4`` four on the CPU). Raises without a card unless ``devices`` is
    given."""
    devices = local_devices() if devices is None else list(devices)
    return make_mesh((len(devices),), ("data",), devices)


def stage_device_sets(stage_plan, devices=None) -> list:
    """Per-stage device slices for an ``exec.stages.StagePlan`` on the local
    host (proportional to the topology's group sizes). ``devices`` defaults
    to ``local_devices()``, which raises without a card; a list may repeat
    a device, such as ``[cuda:0] * 2``, to run every stage on one card.
    Raises ``exec.stages.PipelineInfeasible`` when there are fewer devices
    than stages."""
    return stage_plan.assign_local_devices(local_devices() if devices is None else devices)


# NVIDIA H100 SXM5 80GB data-sheet constants (a GPU), for the dry run's
# roofline; the card measured beside them reads "NVIDIA H100 80GB HBM3,
# 700.00 W" from nvidia-smi. NVLink 4: 18 links of 25e9 B/s a direction,
# 450e9 B/s in all, as core/device.py's h100_nodes() takes it.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, dense
    "hbm_bw": 3.35e12,           # B/s
    "ici_bw": 25e9,              # B/s a link, a direction (NVLink 4)
    "links_per_chip": 18,
    "hbm_bytes": 80e9,
}
