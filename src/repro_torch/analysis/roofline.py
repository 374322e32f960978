"""Three-term roofline from a dry trace: the port's twin of
``repro.analysis.roofline``.

    compute term    = FLOPs             / (chips × peak_FLOP/s)
    memory term     = HBM bytes         / (chips × HBM_bw)
    collective term = collective_bytes  / (chips × link_bw)

A dry trace (``analysis.ops``) counts one rank's step, so per-rank
quantities over per-card rates give the same seconds as the global
formulation above; both views are recorded.

Hardware constants (:data:`H100`): the H100 SXM5 80GB at 700 W, NVIDIA's
data sheet: 989.4 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, 80 GB, and 450 GB/s of NVLink 4 in one direction.  A mesh wider
than one 8-GPU node crosses the network between nodes (400 Gb/s a GPU,
50e9 B/s); this one ``link_bw`` does not model that, so the collective
term of a 256- or 512-rank mesh is a lower bound.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989.4e12      # dense bf16 per card (tensor cores)
    hbm_bw: float = 3.35e12           # bytes/s per card
    link_bw: float = 450e9            # bytes/s, NVLink 4, one direction
    hbm_bytes: float = 80e9           # HBM capacity


H100 = HW()


def model_flops(cfg, shape) -> int:
    """Useful (model) FLOPs per step: 6·N·D train, 2·N·D forward-only,
    with N = active params (MoE: experts scaled by top_k/E)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2 * n * tokens
    # decode: one token per sequence
    return 2 * n * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-rank quantities from the dry trace
    flops_per_device: float
    bytes_per_device: float
    coll_operand_bytes: int
    coll_wire_bytes: int
    # the trace's memory: arguments, outputs, the peak of live storages
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    # model-level
    model_flops_total: int
    by_kind: dict
    tensor_flops_per_device: float = 0.0
    peak_bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    hw: HW = H100

    # -- derived terms (seconds) ---------------------------------------------
    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return max(self.bytes_per_device, 0.0) / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_operand_bytes / self.hw.link_bw

    @property
    def collective_wire_s(self) -> float:
        return self.coll_wire_bytes / self.hw.link_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time model: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def hlo_flops_total(self) -> float:
        return self.flops_per_device * self.n_devices

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs — remat/redundancy waste detector."""
        return (self.model_flops_total / self.hlo_flops_total
                if self.hlo_flops_total else 0.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs over the roofline step time × fleet peak (perfect
        overlap assumed)."""
        denom = self.step_s * self.n_devices * self.hw.peak_flops
        return self.model_flops_total / denom if denom else 0.0

    @property
    def device_bytes(self) -> int:
        """Per-rank bytes: the traced peak of live storages (arguments
        included)."""
        return int(max(self.peak_bytes, self.argument_bytes))

    @property
    def fits(self) -> bool:
        return self.device_bytes <= self.hw.hbm_bytes

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "arch", "shape", "mesh", "n_devices", "flops_per_device",
            "bytes_per_device", "coll_operand_bytes", "coll_wire_bytes",
            "tensor_flops_per_device", "argument_bytes", "output_bytes",
            "temp_bytes", "peak_bytes", "model_flops_total")}
        d["by_kind"] = {k: list(v) for k, v in self.by_kind.items()}
        d["kernels"] = {k: list(v) for k, v in self.kernels.items()}
        for k in ("compute_s", "memory_s", "collective_s",
                  "collective_wire_s", "bound", "step_s", "useful_ratio",
                  "mfu", "device_bytes", "fits"):
            d[k] = getattr(self, k)
        return d

    def row(self) -> str:
        return (f"{self.arch:<22} {self.shape:<12} {self.mesh:<6} "
                f"c={self.compute_s:9.4f}s m={self.memory_s:9.4f}s "
                f"x={self.collective_s:9.4f}s -> {self.bound:<10} "
                f"useful={self.useful_ratio:6.3f} mfu={self.mfu:6.3%} "
                f"mem={self.device_bytes / 1e9:6.2f}GB"
                f"{'' if self.fits else ' OVER'}")


def roofline_from_trace(artifact, *, arch: str, shape, mesh_name: str,
                        n_devices: int, cfg=None, hw: HW = H100,
                        model_flops_total: int = None) -> RooflineReport:
    """The report of one traced call (``analysis.ops.Artifact``);
    ``shape`` a ``configs.ShapeConfig`` or a name (then give
    ``model_flops_total``)."""
    prof = artifact.profile
    if model_flops_total is None:
        model_flops_total = model_flops(cfg, shape)
    return RooflineReport(
        arch=arch, shape=getattr(shape, "name", shape), mesh=mesh_name,
        n_devices=n_devices, flops_per_device=prof.flops,
        bytes_per_device=prof.traffic_bytes,
        coll_operand_bytes=int(prof.operand_bytes),
        coll_wire_bytes=int(prof.wire_bytes),
        tensor_flops_per_device=prof.tensor_flops,
        argument_bytes=int(artifact.argument_bytes),
        output_bytes=int(artifact.output_bytes),
        temp_bytes=int(artifact.temp_bytes),
        peak_bytes=int(artifact.peak_bytes),
        model_flops_total=int(model_flops_total), by_kind=prof.by_kind,
        kernels=prof.kernels, hw=hw)


# alias used by drivers that already hold the pieces
def roofline_report(**kw) -> RooflineReport:
    return RooflineReport(**kw)


def load_reports(path: str) -> list:
    """Read the dry-run JSONL back into dict rows."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    return rows
