"""Device-topology graph (paper §4.2: device nodes = homogeneous GPU/TPU
groups; edges = inter-group links).

Includes the paper's two evaluation clusters (testbed / cloud), the random
topology generator used for GNN training (§5.2), the TPU-pod topology of
``repro``'s hardware adaptation, and an H100 cluster (``h100_nodes``), the
port's counterpart of it.

The ``GPU_PEAKS`` rows are data-sheet peaks that the cost model plans with,
each with a utilization prior; none is a measurement of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# public peak throughput (FLOP/s), memory, and the *default* utilization
# factor per device type. The utilization priors make heterogeneity RATIOS
# (what drives the search) match the paper's cluster; the runtime feedback
# subsystem (repro.runtime.calibration) refits them from measured step
# telemetry and overrides them via CalibrationProfile.apply().
GPU_PEAKS = {
    "V100": {"peak_flops": 15.7e12, "util": 0.45, "mem": 32e9},
    "V100-16": {"peak_flops": 15.7e12, "util": 0.45, "mem": 16e9},
    "1080Ti": {"peak_flops": 11.3e12, "util": 0.40, "mem": 11e9},
    "P100": {"peak_flops": 9.5e12, "util": 0.40, "mem": 16e9},
    "T4": {"peak_flops": 8.1e12, "util": 0.40, "mem": 16e9},
    "TPUv5e": {"peak_flops": 197e12, "util": 0.5, "mem": 16e9},
    "TPUv4": {"peak_flops": 275e12, "util": 0.5, "mem": 32e9},
    # NVIDIA H100 SXM 80GB, 700 W data sheet (bf16 dense). util is fitted
    # by runtime.calibration.fit_profile from the pipeline engines' F/B
    # events of full-width qwen2-1.5b on an H100 80GB HBM3 at 700 W
    # (chip_smoke.py, service phase): 0.0654 and 0.0493 in two runs, here
    # their mean. It is the traced graph's FLOPs over the events' wall time,
    # host dispatch included; bf16 GEMMs alone fit 0.82-0.85.
    "H100": {"peak_flops": 989e12, "util": 0.057, "mem": 80e9},
}

# effective throughput view (peak x default utilization) — kept for
# backward compatibility with callers that only need effective FLOP/s.
GPU_SPECS = {t: {"flops": s["peak_flops"] * s["util"], "mem": s["mem"]}
             for t, s in GPU_PEAKS.items()}


def peak_flops(gpu_type: str) -> float:
    return GPU_PEAKS[gpu_type]["peak_flops"]


def default_util(gpu_type: str) -> float:
    return GPU_PEAKS[gpu_type]["util"]


@dataclass
class DeviceGroup:
    group_id: int
    gpu_type: str
    num_gpus: int
    intra_bw: float            # B/s between devices inside the group
    mem_bytes: float = 0.0
    flops: float = 0.0

    def __post_init__(self):
        spec = GPU_SPECS[self.gpu_type]
        self.mem_bytes = self.mem_bytes or spec["mem"]
        self.flops = self.flops or spec["flops"]


@dataclass
class Topology:
    groups: list                       # list[DeviceGroup]
    inter_bw: np.ndarray               # (M, M) B/s between groups
    latency: float = 50e-6             # per-transfer latency (s)
    name: str = ""
    # Effective-bandwidth factors, calibrated so the simulator matches the
    # paper's MEASURED comm regressions (§4.1.2 / Table 5: cross-machine
    # NCCL-over-TCP AllReduce on TF in-graph replication delivers well
    # under nominal link bandwidth; P2P GRPC does better). TPU topologies
    # override these (ICI is not TCP).
    coll_eff_cross: float = 0.15       # collectives spanning machines
    coll_eff_intra: float = 0.7        # collectives inside one machine
    p2p_eff: float = 0.6               # point-to-point transfers
    # Per-(gi, gj) point-to-point efficiency overrides, fitted by the
    # runtime calibration's per-link-pair tier once a pair accumulates
    # enough telemetry (repro.runtime.calibration). Falls back to the
    # per-class ``p2p_eff`` for unobserved pairs.
    pair_eff: dict = field(default_factory=dict)

    @property
    def m(self):
        return len(self.groups)

    @property
    def total_devices(self):
        return sum(g.num_gpus for g in self.groups)

    def nominal_bw(self, gi: int, gj: int) -> float:
        """Raw (spec-sheet) link bandwidth between device groups, before
        any efficiency factor. Telemetry records transfers against this
        value so calibration can fit the achieved fraction."""
        if gi == gj:
            return self.groups[gi].intra_bw
        return float(self.inter_bw[gi, gj])

    def nominal_bottleneck(self, group_ids):
        """(raw bottleneck bandwidth, link class) for a collective among
        device groups; class is "intra" (one machine) or "cross"."""
        gids = sorted(set(group_ids))
        b = min(self.groups[g].intra_bw for g in gids)
        cls = "intra"
        for i in gids:
            for j in gids:
                if i < j:
                    b = min(b, float(self.inter_bw[i, j]))
                    cls = "cross"
        return b, cls

    def bw(self, gi: int, gj: int) -> float:
        """Effective point-to-point bandwidth between device groups
        (per-pair calibrated efficiency when available)."""
        eff = self.pair_eff.get((gi, gj), self.p2p_eff)
        return self.nominal_bw(gi, gj) * eff

    def bottleneck_bw(self, group_ids) -> float:
        """Effective bottleneck bandwidth for a collective among device
        groups (SFB's tau / ring AllReduce bandwidth)."""
        b, cls = self.nominal_bottleneck(group_ids)
        return b * (self.coll_eff_cross if cls == "cross"
                    else self.coll_eff_intra)


def _full_inter(m: int, bw: float) -> np.ndarray:
    a = np.full((m, m), bw)
    np.fill_diagonal(a, 0)
    return a


def testbed() -> Topology:
    """Paper §5.2 on-premise cluster: 1x(4 V100, NVLink) + 4x(2 1080Ti,
    PCIe) + 2x(2 P100, PCIe), 100 Gbps switch."""
    gbps = 1e9 / 8
    groups = [DeviceGroup(0, "V100", 4, intra_bw=300 * gbps)]       # NVLink
    for i in range(4):
        groups.append(DeviceGroup(1 + i, "1080Ti", 2, intra_bw=64 * gbps))
    for i in range(2):
        groups.append(DeviceGroup(5 + i, "P100", 2, intra_bw=64 * gbps))
    return Topology(groups, _full_inter(7, 100 * gbps), name="testbed")


def cloud() -> Topology:
    """Paper §5.2 public cloud: 2x(8 V100-16G) + 4x(4 T4), 10 Gbps."""
    gbps = 1e9 / 8
    groups = [DeviceGroup(0, "V100-16", 8, intra_bw=300 * gbps),
              DeviceGroup(1, "V100-16", 8, intra_bw=300 * gbps)]
    for i in range(4):
        groups.append(DeviceGroup(2 + i, "T4", 4, intra_bw=64 * gbps))
    return Topology(groups, _full_inter(6, 10 * gbps), name="cloud")


def two_1080ti() -> Topology:
    """Paper §5.6 SFB experiment: two machines, one 1080Ti each."""
    gbps = 1e9 / 8
    groups = [DeviceGroup(0, "1080Ti", 1, intra_bw=64 * gbps),
              DeviceGroup(1, "1080Ti", 1, intra_bw=64 * gbps)]
    return Topology(groups, _full_inter(2, 10 * gbps), name="2x1080ti")


def homogeneous_2v100() -> Topology:
    """Paper §5.4: two V100s on one machine."""
    gbps = 1e9 / 8
    return Topology([DeviceGroup(0, "V100", 2, intra_bw=300 * gbps)],
                    _full_inter(1, 0), name="2xV100")


def random_topology(rng: np.random.Generator) -> Topology:
    """Paper §5.2 GNN-training distribution: machines in [1,6], GPUs/machine
    in [1,8] of one of 3 types, intra-bw in [64,160] Gbps, inter-bw in
    [20,50] Gbps."""
    gbps = 1e9 / 8
    m = int(rng.integers(1, 7))
    types = ["V100", "1080Ti", "P100"]
    groups = []
    for i in range(m):
        groups.append(DeviceGroup(
            i, types[int(rng.integers(0, 3))], int(rng.integers(1, 9)),
            intra_bw=float(rng.uniform(64, 160)) * gbps))
    inter = rng.uniform(20, 50) * gbps
    return Topology(groups, _full_inter(m, float(inter)),
                    name=f"random-{m}")


def tpu_pods(n_pods: int = 2, chips_per_group: int = 16,
             groups_per_pod: int = 2, gen: str = "TPUv5e") -> Topology:
    """Hardware adaptation: TPU slices as device groups; ICI intra-group,
    DCI across pods. Mixed generations model fleet heterogeneity."""
    groups, gid = [], 0
    for p in range(n_pods):
        for _ in range(groups_per_pod):
            t = gen if p == 0 else ("TPUv4" if gen == "TPUv5e" else gen)
            groups.append(DeviceGroup(gid, t, chips_per_group,
                                      intra_bw=200e9))
            gid += 1
    m = len(groups)
    inter = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if i == j:
                continue
            same_pod = i // groups_per_pod == j // groups_per_pod
            inter[i, j] = 100e9 if same_pod else 25e9   # ICI vs DCI
    return Topology(groups, inter, name=f"tpu-{n_pods}pod",
                    coll_eff_cross=0.8, coll_eff_intra=0.9, p2p_eff=0.9)


def h100_nodes(n_nodes: int = 2, gpus_per_node: int = 8) -> Topology:
    """H100 SXM nodes as device groups: NVLink 4 inside a node, one
    400 Gb/s NDR InfiniBand port per direction between nodes.

    The link efficiencies are priors, set as ``tpu_pods`` sets them for
    links that are not TCP: collectives across nodes 0.8, inside a node 0.9,
    point to point 0.9. ``Topology``'s defaults (0.15 / 0.7 / 0.6) were
    fitted to the paper's NCCL-over-TCP runs and would plan an NDR port at
    7.5 GB/s. No NVLink or NDR collective has been measured to fit them."""
    groups = [DeviceGroup(i, "H100", gpus_per_node,
                          intra_bw=450e9)      # NVLink 4, per direction (data sheet)
              for i in range(n_nodes)]
    return Topology(groups, _full_inter(n_nodes, 50e9),   # 400 Gb/s NDR (data sheet)
                    name=f"h100-{n_nodes}x{gpus_per_node}",
                    coll_eff_cross=0.8, coll_eff_intra=0.9, p2p_eff=0.9)
