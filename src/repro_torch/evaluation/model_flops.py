"""MODEL_FLOPS = 6*N*D accounting (dense) / 6*N_active*D (MoE), the JAX
package's ``evaluation/model_flops.py`` on the port.

``N`` counts matmul-participating parameters: embeddings and learned
positional tables are excluded (gather, not matmul), the LM head is
included (tied heads therefore add the embed matrix back once).  MoE
expert weights (``w_up``, ``w_gate``, ``w_down``, not the dense branch)
are scaled by top_k/n_experts.  Counted on the meta device.

The JAX package scales a segment's stacked leaf (all its layers at once)
before rounding down; the port keeps one module a layer, so it sums a
segment's layers first and then scales, which rounds alike.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

from repro_torch.models.lm import LM
from repro_torch.models.specs import ModelSpec


def active_matmul_params(spec: ModelSpec) -> int:
    """Parameters participating in per-token matmuls, MoE-scaled."""
    model = LM(spec)
    stacked = {seg.name for seg in model.segments + model.enc_segments
               if seg.kind == "stack"}
    moe_scale = {(seg.name, f"sub_{i}"): sub.cfg.top_k / sub.cfg.n_experts
                 for seg in model.segments for i, sub in enumerate(seg.spec.subs)
                 if sub.kind == "moe"}

    active = 0
    # (segment, sub_<i>, leaf path) -> elements over the segment's layers
    groups: Dict[Tuple[str, ...], int] = defaultdict(int)
    for name, p in model.named_parameters():
        parts = name.split(".")
        n = p.numel()
        if parts[0] == "pos_embed":
            continue
        if parts[0] == "embed":
            if spec.tie_embeddings:
                active += n  # used once as the LM head matmul
            continue
        if parts[0] in stacked:  # <seg>.<layer>.subs.<i>.<rest>
            groups[(parts[0], f"sub_{parts[3]}", *parts[4:])] += n
        elif parts[0] == "shared":  # shared.subs.<i>.<rest>
            groups[("shared", f"sub_{parts[2]}", *parts[3:])] += n
        else:
            groups[tuple(parts)] += n
    for keys, n in groups.items():
        scale = 1.0
        if len(keys) >= 2 and keys[:2] in moe_scale:
            # router and dense residual within the moe params are always active
            if keys[-1] in ("w_up", "w_gate", "w_down") and "dense" not in keys:
                scale = moe_scale[keys[:2]]
        active += int(n * scale)
    return active


def model_flops(spec: ModelSpec, kind: str, batch: int, seq: int) -> float:
    """Global MODEL_FLOPS for one step of the given cell kind."""
    n = active_matmul_params(spec)
    if kind == "train":
        tokens = batch * seq
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = batch * seq
        return 2.0 * n * tokens
    if kind == "decode":
        tokens = batch * 1
        return 2.0 * n * tokens
    raise ValueError(kind)
