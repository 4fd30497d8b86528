"""Device sets for a pipeline, the part of ``repro.launch.mesh`` that the
pipeline path uses."""
from __future__ import annotations

import torch


def local_devices() -> list:
    """Every local CUDA device, or the CPU where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def stage_device_sets(stage_plan, devices=None) -> list:
    """Per-stage device slices for an ``exec.stages.StagePlan`` on the local
    host (proportional to the topology's group sizes). ``devices`` defaults
    to ``local_devices()``; a list may repeat a device, such as
    ``[cuda:0] * 2``, to run every stage on one card. Raises
    ``exec.stages.PipelineInfeasible`` when there are fewer devices than
    stages."""
    return stage_plan.assign_local_devices(local_devices() if devices is None else devices)
