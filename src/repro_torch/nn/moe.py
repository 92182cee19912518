"""Mixture-of-Experts feed-forward with token-choice top-k routing.

Dispatch is gather-based, as in the JAX package: for every expert slot
``(e, c)`` the token that fills it is computed, and the tokens are
gathered into per-expert buffers; the combine is another gather.  The
work stays proportional to ``top_k * capacity_factor``, not to
``n_experts``.  Routing is per batch row: tokens never cross rows.

Ties are broken as the JAX package breaks them: ``jax.lax.top_k`` puts
the lower expert index first among equal probabilities, and the slot
assignment keeps the (token, choice) order within an expert (a stable
sort), so the same tokens win capacity on both sides.

Sums run in fp32 for the router, or in float64 when the weights are
float64 (:func:`repro_torch.nn.norms.acc`).

Supports dbrx-132b (16 experts, top-4) and arctic-480b (128 experts,
top-2, plus a dense residual MLP branch).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.api import constrain, local, placed_grad
from repro_torch.nn import initializers as init
from repro_torch.nn.mlp import ACTIVATIONS, MLPConfig, mlp_apply, mlp_init
from repro_torch.nn.norms import acc, acc_dtype
from repro_torch.nn.types import P


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    gated: bool = True
    dense_residual: bool = False  # arctic-style parallel dense MLP
    # 2D expert sharding: the experts over the model axis and d_ff over the
    # data axis (``expert_mlp``), in place of FSDP over d_model
    shard_ff: bool = False

    def capacity(self, seq: int) -> int:
        cap = int(self.top_k * seq * self.capacity_factor / self.n_experts)
        return max(1, min(seq, cap))

    @property
    def dense_cfg(self) -> MLPConfig:
        return MLPConfig(self.d_model, self.d_ff, self.activation,
                         gated=self.gated)


def moe_init(cfg: MoEConfig, generator=None, dtype=torch.float32):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    if cfg.shard_ff:
        up_axes, down_axes = ("experts", None, "expert_mlp"), ("experts", "expert_mlp", None)
    else:
        up_axes, down_axes = ("experts", "embed", "mlp"), ("experts", "mlp", "embed")
    params = {
        "w_router": P(init.scaled_normal(generator, (d, e), torch.float32), ("embed", None)),
        "w_up": P(init.scaled_normal(generator, (e, d, f), dtype, fan_in=d), up_axes),
        "w_down": P(init.scaled_normal(generator, (e, f, d), dtype, fan_in=f), down_axes),
    }
    if cfg.gated:
        params["w_gate"] = P(init.scaled_normal(generator, (e, d, f), dtype, fan_in=d),
                             up_axes)
    if cfg.dense_residual:
        params["dense"] = mlp_init(cfg.dense_cfg, generator, dtype)
    return params


def route_topk(router_logits: torch.Tensor, top_k: int):
    """Top-k routing.  router_logits: (B, S, E).

    Returns (expert_ids (B, S, K) int64, gates (B, S, K) renormalized,
    probs (B, S, E)).  Among equal probabilities the lower expert index
    comes first (``jax.lax.top_k``'s order; ``torch.topk`` promises none).
    """
    probs = torch.softmax(acc(router_logits), dim=-1)
    gates, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_ids = gates[..., :top_k], expert_ids[..., :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return expert_ids, gates, probs


def _slot_assignment(expert_ids: torch.Tensor, n_experts: int, capacity: int):
    """The gather plan for one batch of routed tokens.

    expert_ids: (B, S, K).  Choices are ordered row-major in (s, k), so
    earlier tokens win capacity.

    Returns:
      slot_token: (B, E, C) — the flat (s*K + k) choice filling each
                  expert slot, or -1.
      token_slot: (B, S, K) — each choice's capacity slot, or -1 when
                  dropped.
    """
    b, s, k = expert_ids.shape
    n = s * k
    dev = expert_ids.device
    flat = expert_ids.reshape(b, n)
    sort_idx = torch.argsort(flat, dim=-1, stable=True)  # ties keep (s, k) order
    sorted_experts = torch.gather(flat, 1, sort_idx)
    arange = torch.arange(n, device=dev)[None, :]
    experts = torch.arange(n_experts, device=dev)
    # (B, N, E): the first sorted index of each expert (n if absent)
    seg_start = torch.where(sorted_experts[:, :, None] == experts[None, None, :],
                            arange[:, :, None], n).amin(dim=1)
    pos_in_expert = arange - torch.gather(seg_start, 1, sorted_experts)
    c_idx = torch.arange(capacity, device=dev)[None, None, :]
    gather_idx = (seg_start[:, :, None] + c_idx).clamp(0, n - 1).reshape(b, -1)
    cand = torch.gather(sort_idx, 1, gather_idx).reshape(b, n_experts, capacity)
    cand_expert = torch.gather(sorted_experts, 1, gather_idx).reshape(b, n_experts, capacity)
    valid = (cand_expert == experts[None, :, None]) & (seg_start[:, :, None] + c_idx < n)
    slot_token = torch.where(valid, cand, -1)
    choice_slot_sorted = torch.where(pos_in_expert < capacity, pos_in_expert, -1)
    token_slot = torch.gather(choice_slot_sorted, 1, torch.argsort(sort_idx, dim=-1))
    return slot_token, token_slot.reshape(b, s, k)


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor, return_aux: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model); with ``return_aux``, also the
    load-balancing auxiliaries (Switch-style): ``load_balance_loss`` (E
    times the sum over experts of the mean router probability and the
    share of tokens routing to the expert) and ``dropped_fraction`` (the
    share of (token, choice) pairs past an expert's capacity)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = cfg.capacity(s)

    def route(xx, w):
        return route_topk(acc(xx) @ w.to(acc_dtype(xx)), k)

    # inside a sharding context the router runs on local shards with its
    # weight whole: DTensor (torch 2.11) cannot add the two gradients its
    # gates' normalization gives them in its own layouts
    expert_ids, gates, probs = local(route, x, params["w_router"],
                                     axes=(("batch", None, None), (None, None)))
    slot_token, token_slot = _slot_assignment(expert_ids, e, cap)

    # dispatch: gather tokens into (B, E, C, d)
    token_of_slot = slot_token.clamp_min(0) // k  # flat choice -> s
    buf = torch.gather(x, 1, token_of_slot.reshape(b, e * cap, 1).expand(-1, -1, d))
    buf = buf.reshape(b, e, cap, d) * (slot_token >= 0)[..., None].to(x.dtype)
    # experts outermost, the layout the batched matmuls take: each einsum
    # then runs without a permute (the copy it would make is made here
    # once), and a DTensor's shards keep the layout of its global strides
    buf = buf.transpose(0, 1).contiguous()

    # experts: (E, B, C, d) x (E, d, f)
    act = ACTIVATIONS[cfg.activation]
    up = torch.einsum("ebcd,edf->ebcf", buf, params["w_up"])
    if cfg.gated:
        h = act(torch.einsum("ebcd,edf->ebcf", buf, params["w_gate"])) * up
    else:
        h = act(up)
    out_buf = torch.einsum("ebcf,efd->ebcd", h, params["w_down"])

    # combine: each (token, choice) gathers its slot's output
    flat_out = out_buf.transpose(0, 1).reshape(b, e * cap, d)
    choice_slot = token_slot.reshape(b, s * k)
    flat_idx = (expert_ids.reshape(b, s * k) * cap + choice_slot).clamp_min(0)
    y = torch.gather(flat_out, 1, flat_idx[:, :, None].expand(-1, -1, d))
    y = y * (choice_slot >= 0)[..., None].to(y.dtype)
    y = (y.reshape(b, s, k, d) * gates[..., None].to(y.dtype)).sum(dim=2)
    if cfg.dense_residual:
        # the two branches meet batch-sharded and the dense branch's input
        # places its own gradient: DTensor (torch 2.11) refuses the dense
        # matmuls' gradient in the combine's sequence-sharded layout, and
        # cannot add their partial gradient of x to the routed one's shard
        dense = mlp_apply(params["dense"], cfg.dense_cfg, placed_grad(x))
        y = constrain(y, ("batch", None, None)) + constrain(dense, ("batch", None, None))
    if return_aux:
        me = probs.mean(dim=(0, 1))  # mean router probability per expert
        chosen = torch.nn.functional.one_hot(expert_ids, e).sum(dim=2) > 0
        ce = chosen.to(torch.float32).mean(dim=(0, 1))
        aux = {"load_balance_loss": e * (me * ce).sum(),
               "dropped_fraction": (token_slot < 0).to(torch.float32).mean()}
        return y.to(x.dtype), aux
    return y.to(x.dtype)
