"""Three-term roofline model over compiled dry-run artifacts.

    compute    = HLO_FLOPs / (chips x peak_FLOP/s)
    memory     = HLO_bytes / (chips x HBM_bw)
    collective = collective_bytes / (chips x link_bw)

FLOPs/bytes come from ``compiled.cost_analysis()`` of the unrolled cost
variant; collective bytes from the HLO parser (trip-count aware).  The
analysis classifies the dominant term and reports
``MODEL_FLOPS = 6*N*D`` (dense; N_active for MoE) against HLO FLOPs to
expose remat/dispatch overheads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.hwgen.targets import H100, ChipSpec


@dataclasses.dataclass
class RooflineReport:
    cell: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    bound_s: float  # max of the three = modelled step latency
    model_flops: Optional[float] = None
    hlo_flops: Optional[float] = None
    useful_ratio: Optional[float] = None  # MODEL_FLOPS / HLO_FLOPs
    roofline_fraction: Optional[float] = None  # compute_s / bound_s

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    n_chips: int,
    chip: ChipSpec = H100,
    cell: str = "",
    model_flops: Optional[float] = None,
) -> RooflineReport:
    """All inputs are GLOBAL (whole-program) quantities; terms are
    per-chip times assuming perfect spatial balance."""
    compute_s = hlo_flops / (n_chips * chip.peak_flops_bf16)
    memory_s = hlo_bytes / (n_chips * chip.hbm_bandwidth)
    collective_s = collective_bytes / (n_chips * chip.ici_bandwidth)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    useful = model_flops / hlo_flops if (model_flops and hlo_flops) else None
    return RooflineReport(
        cell=cell,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        bound_s=bound,
        model_flops=model_flops,
        hlo_flops=hlo_flops,
        useful_ratio=useful,
        roofline_fraction=(compute_s / bound) if bound > 0 else None,
    )


def roofline_from_record(record: Dict, chip: ChipSpec = H100,
                         model_flops: Optional[float] = None) -> RooflineReport:
    """Build a report from a dry-run JSON record.

    NOTE on per-chip accounting: ``cost_analysis`` on the SPMD-partitioned
    executable reports the per-device program, so flops/bytes are already
    per-chip; we therefore pass n_chips=1 against per-chip peaks.
    Collective bytes from the HLO parser are per-device program bytes as
    well (each device executes the same collectives).
    """
    cost = record.get("cost", {})
    return roofline_terms(
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes_accessed", 0.0)),
        collective_bytes=float(record.get("collective_bytes", 0.0)),
        n_chips=1,
        chip=chip,
        cell=record.get("cell", ""),
        model_flops=model_flops,
    )
