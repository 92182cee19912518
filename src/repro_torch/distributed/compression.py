"""Gradient compression with error feedback, the JAX package's
``distributed/compression.py`` on the port.

Int8 block quantization: gradients are quantized per block of 256 (absmax
scale), dequantized, and the quantization residual is carried in an
error-feedback buffer and added before the next step (Karimireddy et al.,
2019).  ``compress_decompress`` models the numerics end to end around the
gradient path, as in the reference; its manual-collective path
(``compressed_psum``, inside ``shard_map``) waits for the port's meshes
(ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    block: int = 256
    dtype = torch.int8
    levels: int = 127


class GradientCompressor:
    def __init__(self, cfg: CompressionConfig = CompressionConfig()):
        self.cfg = cfg

    def init_state(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    def _quant_dequant(self, g: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        flat = g.float().reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % cfg.block))
        blocks = flat.reshape(-1, cfg.block)
        scale = (blocks.abs().amax(dim=1, keepdim=True) / cfg.levels).clamp_min(1e-12)
        q = torch.clamp(torch.round(blocks / scale), -cfg.levels, cfg.levels).to(cfg.dtype)
        deq = q.float() * scale
        return deq.reshape(-1)[: g.numel()].reshape(g.shape)

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
