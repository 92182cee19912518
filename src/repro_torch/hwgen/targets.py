"""Hardware target specifications (the port's analogue of the paper's
Raspberry Pi / Pico / FPGA backend descriptors): one H100 card, the
host's CPU, an edge NPU that is modelled, never run, and two H100 pods
(256 and 512 cards) that are laid out and counted on the host, never run.

The JAX package's TPU targets (``tpu_v5e``, ``tpu_v5e_pod``,
``tpu_v5e_2pod``) have no counterpart: the port carries no TPU rates, and
a spec that names one is refused at parse time (:data:`TPU_TARGETS`).

A TargetSpec bundles chip constants (for the roofline cost model) with a
mesh recipe and backend capabilities (for the reflection API, paper §VI).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float  # FLOP/s
    hbm_bandwidth: float  # B/s
    ici_bandwidth: float  # B/s per link
    hbm_bytes: int


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16 on the tensor cores,
# 3.35 TB/s of HBM3, 80 GB; NVLink 900 GB/s per card, 450 GB/s each way.
# The pod targets take the same constants, as the dry run's roofline does:
# NVIDIA's NVLink Switch System joins up to 256 H100s at that link rate
# (h100_pod); h100_2pod's "pod" axis would cross InfiniBand, which this
# one-rate model, like the reference's, does not tell apart
H100 = ChipSpec(
    name="h100",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    ici_bandwidth=450e9,
    hbm_bytes=80 * 1024 ** 3,
)

HOST_CPU = ChipSpec(
    name="host_cpu",
    peak_flops_bf16=1e11,  # nominal; host backend measures wall-clock instead
    hbm_bandwidth=20e9,
    ici_bandwidth=1e9,
    hbm_bytes=32 * 1024 ** 3,
)

# Edge-class accelerator (the paper's Raspberry-Pi/Pico deployment tier),
# the JAX package's constants: a single-chip NPU with modest compute but
# proportionally even less memory bandwidth, so its roofline crosses over
# at a much higher arithmetic intensity and candidates rank differently
# than on the datacenter part.  Nothing runs on it: it is measured by the
# roofline of the candidate's counted forward.
EDGE_NPU = ChipSpec(
    name="edge_npu",
    peak_flops_bf16=4e12,
    hbm_bandwidth=34e9,
    ici_bandwidth=0.25e9,
    hbm_bytes=8 * 1024 ** 3,
)

# the JAX package's TPU targets, which the port refuses by name
TPU_TARGETS = ("tpu_v5e", "tpu_v5e_pod", "tpu_v5e_2pod")


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    name: str
    chip: ChipSpec
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    # reflection API (paper §VI): capability set consulted by the
    # ModelBuilder so only backend-supported ops are sampled
    supported_ops: frozenset = frozenset()
    supports_pallas: bool = False
    measurement: str = "roofline"  # "roofline" | "wallclock"
    device: str = "cuda"  # where the candidate runs: "cuda" | "cpu"

    @property
    def n_chips(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n

    @property
    def mesh_scope(self) -> str:
        """Identity of the *compiled program* this target produces.

        Two targets sharing a mesh topology compile byte-identical
        executables — chip constants only enter the roofline arithmetic
        afterwards — so compile-derived cache entries are scoped by this
        string instead of the target name, letting cross-target sweeps
        reuse each other's compiles (see ``_CompiledEstimator``).  In the
        port a program is also bound to the device it runs on (an artifact
        holds the candidate's weights there), so the device is part of it.
        """
        return ("mesh:" + "x".join(str(s) for s in self.mesh_shape)
                + ":" + ",".join(self.mesh_axes) + "@" + self.device)

    def to_dict(self) -> Dict[str, Any]:
        """JSON form with the full chip constants, persisted into
        ``ExplorationReport``/``SweepReport`` so a report stays
        interpretable even after a target's registered constants are
        edited (the numbers that produced it travel with it)."""
        return {
            "name": self.name,
            "chip": dataclasses.asdict(self.chip),
            "mesh_shape": list(self.mesh_shape),
            "mesh_axes": list(self.mesh_axes),
            "n_chips": self.n_chips,
            "supported_ops": sorted(self.supported_ops),
            "supports_pallas": self.supports_pallas,
            "measurement": self.measurement,
            "device": self.device,
        }


_COMMON_OPS = frozenset({
    "linear", "conv1d", "maxpool", "avgpool", "identity", "global_avg_pool",
    "layernorm", "attention", "ssm",
})

TARGETS: Dict[str, TargetSpec] = {
    # one H100, timed on the card (CUDA events around eager forwards)
    "h100": TargetSpec(
        name="h100", chip=H100,
        mesh_shape=(1, 1), mesh_axes=("data", "model"),
        supported_ops=_COMMON_OPS, supports_pallas=True,
        measurement="wallclock", device="cuda",
    ),
    # the pods: the JAX package's tpu_v5e_pod and tpu_v5e_2pod meshes on
    # H100s; like edge_npu, counted on the host (the generator lays a
    # sharded program out over the fake process group on ``meta``) and
    # never run, so their device is the host's
    "h100_pod": TargetSpec(
        name="h100_pod", chip=H100,
        mesh_shape=(16, 16), mesh_axes=("data", "model"),
        supported_ops=_COMMON_OPS, supports_pallas=True,
        measurement="roofline", device="cpu",
    ),
    "h100_2pod": TargetSpec(
        name="h100_2pod", chip=H100,
        mesh_shape=(2, 16, 16), mesh_axes=("pod", "data", "model"),
        supported_ops=_COMMON_OPS, supports_pallas=True,
        measurement="roofline", device="cpu",
    ),
    # the host's CPU: the kernels' plain versions, timed by the host clock
    "host_cpu": TargetSpec(
        name="host_cpu", chip=HOST_CPU,
        mesh_shape=(1, 1), mesh_axes=("data", "model"),
        supported_ops=_COMMON_OPS, supports_pallas=False,
        measurement="wallclock", device="cpu",
    ),
    # the edge tier: host_cpu's mesh and device, so its mesh_scope is
    # host_cpu's and a sweep reuses host_cpu's counts and artifacts for it,
    # but roofline-measured against the EDGE_NPU constants
    "edge_npu": TargetSpec(
        name="edge_npu", chip=EDGE_NPU,
        mesh_shape=(1, 1), mesh_axes=("data", "model"),
        supported_ops=_COMMON_OPS, supports_pallas=False,
        measurement="roofline", device="cpu",
    ),
}


def get_target(name: str) -> TargetSpec:
    if name not in TARGETS:
        raise KeyError(f"unknown target {name!r}; available: {sorted(TARGETS)}")
    return TARGETS[name]


# Publish the built-in targets to the Explorer facade's registry so YAML
# experiments can name them; plugin targets register the same way
# (``register("target", "my_board", spec)``) without touching this dict.
from repro_torch.explorer.registry import TARGETS as _EXPLORER_TARGETS  # noqa: E402

for _name, _spec in TARGETS.items():
    _EXPLORER_TARGETS.register(_name, _spec)
del _name, _spec
