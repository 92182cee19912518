"""Gradient compression with error feedback, the JAX package's
``distributed/compression.py`` on the port.

Int8 block quantization: gradients are quantized per block of 256 (absmax
scale), dequantized, and the quantization residual is carried in an
error-feedback buffer and added before the next step (Karimireddy et al.,
2019).  ``compress_decompress`` models the numerics end to end around the
gradient path, as in the reference; on DTensor gradients its blocks run
over the flattened global tensor (each gradient is replicated for the
quantization and put back on its placements), so a mesh gives the
numbers the reference's jitted version gives.  ``compressed_psum`` is the
manual-collective path (the reference's, inside ``shard_map``): each
rank's gradients are quantized, summed as int32 over one mesh dim's
group with their scales, and dequantized.  Rounding is half to even on
both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from repro_torch.distributed.api import along, placed_like


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    block: int = 256
    dtype = torch.int8
    levels: int = 127


class GradientCompressor:
    def __init__(self, cfg: CompressionConfig = CompressionConfig()):
        self.cfg = cfg

    def init_state(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    def _blocks(self, g: torch.Tensor, compiled: bool = False):
        """``g`` flattened into blocks of ``cfg.block`` (zero-padded) and each
        block's absmax scale: absmax / levels, or with ``compiled`` absmax
        times the fp32 reciprocal of levels, which is what XLA makes of the
        reference's division by a constant inside a compiled program."""
        cfg = self.cfg
        flat = g.float().reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % cfg.block))
        blocks = flat.reshape(-1, cfg.block)
        amax = blocks.abs().amax(dim=1, keepdim=True)
        scale = amax * (1.0 / cfg.levels) if compiled else amax / cfg.levels
        return blocks, scale.clamp_min(1e-12)

    def _quantize(self, blocks, scale, dtype):
        levels = self.cfg.levels
        return torch.clamp(torch.round(blocks / scale), -levels, levels).to(dtype)

    def _quant_dequant_local(self, g: torch.Tensor) -> torch.Tensor:
        blocks, scale = self._blocks(g)
        deq = self._quantize(blocks, scale, self.cfg.dtype).float() * scale
        return deq.reshape(-1)[: g.numel()].reshape(g.shape)

    def _quant_dequant(self, g: torch.Tensor) -> torch.Tensor:
        return placed_like(along(self._quant_dequant_local, g, tuple(range(g.ndim))), g)

    def compress_decompress(self, grads: Mapping[str, torch.Tensor],
                            err_state: Optional[Mapping[str, torch.Tensor]]):
        """grads + err -> (quantized grads, new error state)."""
        if err_state is None:
            err_state = self.init_state(grads)
        new_g, new_e = {}, {}
        for k, g in grads.items():
            corrected = g.float() + err_state[k]
            deq = self._quant_dequant(corrected)
            new_g[k], new_e[k] = deq.to(g.dtype), corrected - deq
        return new_g, new_e

    def compressed_psum(self, grads: Mapping[str, torch.Tensor], mesh_dim,
                        mesh=None) -> Dict[str, torch.Tensor]:
        """Sum of each rank's gradients over the group of ``mesh_dim`` (a
        name or index of ``mesh``, by default the sharding context's),
        divided by the group's size: quantize, all-reduce the int32 blocks
        and the scales, dequantize with the mean scale.  Moves ~4x fewer
        bytes than an fp32 all-reduce.  A DTensor's local shard is summed
        and comes back with its placements.

        The scales are gathered and summed in rank order, as XLA's
        all-reduce sums them (a ring all-reduce over four ranks rounds
        otherwise); the int32 sum is exact in any order.  The reference
        runs inside ``shard_map`` under ``jit``, so its scale is the
        compiled one (:meth:`_blocks`)."""
        import torch.distributed as dist

        from repro_torch.distributed.api import current_mesh, is_dtensor

        mesh = mesh if mesh is not None else current_mesh()
        group = mesh.get_group(mesh_dim)
        n = dist.get_world_size(group)
        out = {}
        for k, g in grads.items():
            local = g.to_local() if is_dtensor(g) else g
            blocks, scale = self._blocks(local, compiled=True)
            q = self._quantize(blocks, scale, torch.int32)
            dist.all_reduce(q, group=group)
            scales = [torch.empty_like(scale) for _ in range(n)]
            dist.all_gather(scales, scale.contiguous(), group=group)
            ssum = scales[0]
            for s in scales[1:]:  # average the scales
                ssum = ssum + s
            deq = q.float() * (ssum / n)
            summed = deq.reshape(-1)[: local.numel()].reshape(local.shape).to(local.dtype) / n
            out[k] = (_from_local_like(summed, g) if is_dtensor(g) else summed)
        return out


def _from_local_like(local: torch.Tensor, like) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False)
