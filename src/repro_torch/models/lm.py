"""LM executor: embedding -> layers -> final norm -> head, with batched
prefill and per-slot decode against preallocated caches.

Consecutive identical layers are grouped into *segments* as in the JAX
package, so parameter names line up (``seg_0.<layer>.subs.<i>.norm`` /
``.inner`` for the JAX tree's ``seg_0/sub_<i>/{norm,inner}`` stacked on
a leading layers axis).  Each segment is an ``nn.ModuleList`` of layers
run in a Python loop.  A weight-shared layer (zamba2's attention block)
is a segment of its own: the model holds one ``shared`` layer (the JAX
tree's ``params["shared"]``), registered once, which every shared
segment runs.

``LM(spec)`` lays out a skeleton on the meta device; :meth:`LM.init`
draws the weights on a generator's device, and
:func:`repro_torch.convert.lm_from_jax` loads the JAX package's weights.
The weights are frozen (``requires_grad=False``): evaluation and serving
build no autograd graph.  Training differentiates with respect to a
mapping of them instead (:func:`repro_torch.train.step.param_dict`, run
through ``torch.func.functional_call``).

The decode cache is a list with one dict per layer invocation, in the
order the layers run (so each run of the shared layer has its own),
``{"sub_<i>": ...}`` for each sub-block as in the JAX package: attention
``{"k", "v"}`` each ``(B, T, KH, D)``, Mamba2 ``{"conv", "state"}``,
mLSTM ``{"conv", "c", "n", "m"}``, sLSTM ``{"conv", "c", "n", "m",
"h"}``, ``{}`` for an mlp or moe, and for cross-attention the
encoder output's K/V ``{"k", "v"}`` each ``(B, T_enc, KH, D)``,
projected once by :meth:`LM.init_cache` (``enc_out=``; without it they
are empty and the sub-block adds zeros).  :meth:`LM.prefill` and
:meth:`LM.decode` update it in place (attention writes into its K/V; a
recurrent sub-block replaces its dict's tensors; the cross K/V stay as
they are).  Prefill of a recurrent kind loops its decode step over the
prompt, as the JAX package's ``lax.scan`` does.

An encoder-decoder model (whisper) has encoder segments ``enc_<i>``
and ``enc_final_norm``, run by :meth:`LM.encode` over frame embeddings;
a learned positional table ``pos_embed`` is shared by the encoder's
frames and the decoder's tokens.  A VLM (paligemma) passes
``prefix_embeds`` to :meth:`LM.forward`, which overwrite the first
embeddings.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                   create_selective_checkpoint_contexts)

from repro_torch.distributed.api import (constrain, current_mesh, current_rules, embedding,
                                         gathered, rebind)
from repro_torch.models.specs import LayerSpec, ModelSpec, SubBlock
from repro_torch.nn import attention as attn
from repro_torch.nn import initializers as init
from repro_torch.nn import mlp as mlp_mod
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import ssm as ssm_mod
from repro_torch.nn import xlstm as xlstm_mod
from repro_torch.nn.norms import NORM_APPLY, NORM_INIT
from repro_torch.nn.types import Axes, P, frozen, record_axes

Cache = List[Dict[str, Dict[str, torch.Tensor]]]
BATCH: Axes = ("batch", None, None)  # the residual stream's logical axes


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str  # "stack" | "shared"
    spec: LayerSpec
    count: int
    name: str


def build_segments(layers: Tuple[LayerSpec, ...], prefix: str = "seg") -> Tuple[Segment, ...]:
    segments = []
    i = 0
    while i < len(layers):
        spec = layers[i]
        if spec.shared:
            segments.append(Segment("shared", spec, 1, f"{prefix}_{len(segments)}"))
            i += 1
            continue
        j = i
        while j < len(layers) and layers[j] == spec and not layers[j].shared:
            j += 1
        segments.append(Segment("stack", spec, j - i, f"{prefix}_{len(segments)}"))
        i = j
    return tuple(segments)


# ---------------------------------------------------------------------------
# sub-block dispatch
# ---------------------------------------------------------------------------

def _sub_init(sub: SubBlock, generator, dtype):
    if sub.kind in ("attention", "cross_attention"):
        return attn.attention_init(sub.cfg, generator, dtype)
    if sub.kind == "mlp":
        return mlp_mod.mlp_init(sub.cfg, generator, dtype)
    if sub.kind == "moe":
        return moe_mod.moe_init(sub.cfg, generator, dtype)
    if sub.kind == "mamba2":
        return ssm_mod.mamba2_init(sub.cfg, generator, dtype)
    if sub.kind == "mlstm":
        return xlstm_mod.mlstm_init(sub.cfg, generator, dtype)
    if sub.kind == "slstm":
        return xlstm_mod.slstm_init(sub.cfg, generator, dtype)
    raise ValueError(sub.kind)


def _sub_apply(sub: SubBlock, params, x, positions, enc_out=None):
    if sub.kind == "attention":
        return attn.attention_apply(params, sub.cfg, x, positions=positions)
    if sub.kind == "cross_attention":
        # without an encoder output this is non-causal self-attention over
        # x, as in the JAX package
        return attn.attention_apply(params, sub.cfg, x, kv_x=enc_out)
    if sub.kind == "mlp":
        return mlp_mod.mlp_apply(params, sub.cfg, x)
    if sub.kind == "moe":
        return moe_mod.moe_apply(params, sub.cfg, x)
    if sub.kind == "mamba2":
        return ssm_mod.mamba2_apply(params, sub.cfg, x)
    if sub.kind == "mlstm":
        return xlstm_mod.mlstm_block_apply(params, sub.cfg, x)
    if sub.kind == "slstm":
        return xlstm_mod.slstm_block_apply(params, sub.cfg, x)
    raise ValueError(sub.kind)


def _sub_cache_init(sub: SubBlock, params, batch, max_seq, enc_out, dtype, device):
    if sub.kind == "attention":
        return attn.init_kv_cache(sub.cfg, batch, max_seq, dtype, device=device)
    if sub.kind == "cross_attention":
        if enc_out is not None:
            return attn.precompute_cross_kv(params, sub.cfg, enc_out, dtype)
        return attn.init_kv_cache(sub.cfg, batch, 0, dtype, device=device)
    if sub.kind == "mamba2":
        return ssm_mod.init_ssm_cache(sub.cfg, batch, dtype, device=device)
    if sub.kind == "mlstm":
        return xlstm_mod.init_mlstm_cache(sub.cfg, batch, dtype, device=device)
    if sub.kind == "slstm":
        return xlstm_mod.init_slstm_cache(sub.cfg, batch, dtype, device=device)
    return {}


def _sub_prefill(sub: SubBlock, params, x, cache, pos_offset):
    """Full-sequence forward that also fills the decode cache.  Attention
    runs the full-sequence kernel dispatch and writes the prompt's K/V in
    one shot; a recurrent kind ingests the prompt by looping its decode
    step, token by token, as the JAX package's ``lax.scan`` does."""
    if sub.kind == "attention":
        return attn.attention_prefill(params, sub.cfg, x, cache, pos_offset)[0]
    if sub.kind == "cross_attention":
        return attn.cross_attention_cached(params, sub.cfg, x, cache)
    if sub.kind in ("mlp", "moe"):
        return _sub_apply(sub, params, x, None)
    ys = [_sub_decode(sub, params, x[:, t:t + 1], cache, pos_offset + t)
          for t in range(x.shape[1])]
    return torch.cat(ys, dim=1)


def _sub_decode(sub: SubBlock, params, x, cache, pos):
    if sub.kind == "attention":
        return attn.attention_decode(params, sub.cfg, x, cache, pos)[0]
    if sub.kind == "cross_attention":  # the cross K/V are static in decode
        return attn.cross_attention_cached(params, sub.cfg, x, cache)
    if sub.kind in ("mlp", "moe"):
        return _sub_apply(sub, params, x, None)
    if sub.kind == "mamba2":
        y, new = ssm_mod.mamba2_decode(params, sub.cfg, x, cache)
    elif sub.kind == "mlstm":
        y, new = xlstm_mod.mlstm_block_decode(params, sub.cfg, x, cache)
    elif sub.kind == "slstm":
        y, new = xlstm_mod.slstm_block_apply(params, sub.cfg, x, cache=cache)
    else:
        raise ValueError(sub.kind)
    cache.update(new)
    return y


def _normed(kind: str, params, h: torch.Tensor) -> torch.Tensor:
    """The norm of the residual stream, kept batch-sharded inside a
    sharding context (the scale's FSDP sharding would otherwise move the
    result's model dim onto the data axis, a layout DTensor's views refuse
    downstream); the norm alone outside one."""
    return constrain(NORM_APPLY[kind](params, h), BATCH)


def _keep_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of matrix products without
    batch dims, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(layer: nn.Module, remat: bool, policy: Optional[str], h, positions, enc_out):
    """``layer(h, positions, enc_out)``.  Inside a sharding context each of
    the layer's weights is :func:`gathered` as the layer runs.  With
    ``remat`` the layer runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations, the gathered weights too, are made
    again in the backward.  The layer's parameters as bound now (a train
    step's, through ``functional_call``) are arguments of the function,
    which binds them again, so a recomputation, run after
    ``functional_call`` has put the module's own tensors back, uses the
    step's."""
    mesh, rules = current_mesh(), current_rules()
    if not remat and mesh is None:
        return layer(h, positions, enc_out)
    params = dict(layer.named_parameters())

    def run(params, h):
        # a recomputation runs in the autograd engine's thread (a card's
        # backward has its own), where the layer's mesh and rules are unset
        with rebind(mesh, rules):
            return torch.func.functional_call(
                layer, {k: gathered(v) for k, v in params.items()}, (h, positions, enc_out))

    if not remat:
        return run(params, h)
    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _keep_products)
    return checkpoint(run, params, h, use_reentrant=False, **kwargs)


# ---------------------------------------------------------------------------
# layer = sequence of pre-norm residual sub-blocks
# ---------------------------------------------------------------------------

class SubBlockModule(nn.Module):
    def __init__(self, sub: SubBlock, norm: Dict[str, torch.Tensor],
                 inner: Dict[str, torch.Tensor]):
        super().__init__()
        self.sub = sub
        self.norm = frozen(norm)
        self.inner = frozen(inner)


class Layer(nn.Module):
    def __init__(self, spec: LayerSpec, norm: str, d_model: int, generator, dtype):
        super().__init__()
        self.norm_kind = norm
        self.subs = nn.ModuleList([
            SubBlockModule(sub, NORM_INIT[norm](d_model, generator, dtype),
                           _sub_init(sub, generator, dtype))
            for sub in spec.subs])

    def _residual(self, h, run):
        for i, blk in enumerate(self.subs):
            # inside a sharding context each sub-block's input and output
            # are pinned to the residual stream's batch-sharded layout
            x = _normed(self.norm_kind, blk.norm, h)
            h = h + constrain(run(i, blk.sub, blk.inner, x), BATCH)
        return h

    def forward(self, h, positions, enc_out=None):
        return self._residual(h, lambda i, sub, p, x: _sub_apply(sub, p, x, positions,
                                                                  enc_out))

    def prefill(self, h, cache, pos_offset):
        return self._residual(h, lambda i, sub, p, x: _sub_prefill(
            sub, p, x, cache[f"sub_{i}"], pos_offset))

    def decode(self, h, cache, pos):
        return self._residual(h, lambda i, sub, p, x: _sub_decode(
            sub, p, x, cache[f"sub_{i}"], pos))

    def init_cache(self, batch, max_seq, enc_out, dtype,
                   device) -> Dict[str, Dict[str, torch.Tensor]]:
        return {f"sub_{i}": _sub_cache_init(blk.sub, blk.inner, batch, max_seq, enc_out,
                                            dtype, device)
                for i, blk in enumerate(self.subs)}


class LM(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.segments = build_segments(spec.layers)
        self.enc_segments = build_segments(spec.encoder_layers, prefix="enc")
        self._build(None, torch.float32)

    # -- init ---------------------------------------------------------------

    def _leaf(self, name: str, value: torch.Tensor) -> None:
        setattr(self, name, nn.Parameter(value, requires_grad=False))
        record_axes(self, name, value)

    def _build(self, generator: Optional[torch.Generator], dtype):
        spec = self.spec
        self._leaf("embed", P(init.normal(generator, (spec.vocab, spec.d_model), dtype,
                                          stddev=0.02), ("vocab", "embed")))
        if spec.positional == "learned":
            self._leaf("pos_embed", P(init.normal(generator, (spec.max_position, spec.d_model),
                                                  dtype, stddev=0.02), (None, "embed")))
        if not spec.tie_embeddings:
            self._leaf("head", P(init.normal(generator, (spec.d_model, spec.vocab), dtype,
                                             stddev=0.02), ("embed", "vocab")))
        self.final_norm = frozen(NORM_INIT[spec.norm](spec.d_model, generator, dtype))
        shared = [seg for seg in self.segments if seg.kind == "shared"]
        if shared:  # one module, however many segments run it
            self.shared = Layer(shared[0].spec, spec.norm, spec.d_model, generator, dtype)
        for seg in self.segments:
            if seg.kind == "stack":
                self.add_module(seg.name, nn.ModuleList([
                    Layer(seg.spec, spec.norm, spec.d_model, generator, dtype)
                    for _ in range(seg.count)]))
        if self.enc_segments:
            self.enc_final_norm = frozen(NORM_INIT[spec.norm](spec.d_model, generator, dtype))
            for seg in self.enc_segments:
                self.add_module(seg.name, nn.ModuleList([
                    Layer(seg.spec, spec.norm, spec.d_model, generator, dtype)
                    for _ in range(seg.count)]))

    def init(self, generator: torch.Generator, dtype=torch.float32) -> "LM":
        """Draw every weight on ``generator``'s device (the JAX package's
        distributions: normal(0.02) embeddings, truncated-normal
        fan_in^-1/2 matrices, unit norms).  Returns ``self``."""
        self._build(generator, dtype)
        return self

    def _runs(self, segments) -> List[Tuple[Segment, List[Layer]]]:
        """Each segment with its layers in the order they run."""
        return [(seg, [self.shared] if seg.kind == "shared" else list(getattr(self, seg.name)))
                for seg in segments]

    def layers(self) -> List[Layer]:
        """The layers in the order they run (the shared one at each of its
        segments)."""
        return [layer for _, run in self._runs(self.segments) for layer in run]

    # -- forward ------------------------------------------------------------

    def enc_layers(self) -> List[Layer]:
        """The encoder's layers in the order they run."""
        return [layer for _, run in self._runs(self.enc_segments) for layer in run]

    def _run_segments(self, segments, h, positions, enc_out=None) -> torch.Tensor:
        """The segments' layers over ``h``, the residual stream constrained
        to batch-sharded after each segment (a no-op outside a sharding
        context), each layer by :func:`_run_layer` (remat with
        ``spec.remat`` and grad enabled, the shared layer too)."""
        remat = self.spec.remat and torch.is_grad_enabled()
        for _, run in self._runs(segments):
            for layer in run:
                h = _run_layer(layer, remat, self.spec.remat_policy, h, positions, enc_out)
            h = constrain(h, BATCH)
        return h

    def _cached_segments(self, h, cache: Cache, step) -> torch.Tensor:
        """``step(layer, h, layer_cache)`` over the decoder's layers with
        their caches; after each stacked segment the residual stream is
        constrained as in the JAX package's prefill and decode."""
        if len(cache) != len(self.layers()):
            raise ValueError(f"cache has {len(cache)} layer entries, the model runs "
                             f"{len(self.layers())} layers")
        caches = iter(cache)
        for seg, run in self._runs(self.segments):
            for layer in run:
                h = step(layer, h, next(caches))
            if seg.kind == "stack":
                h = constrain(h, BATCH)
        return h

    def _embed(self, tokens: torch.Tensor, prefix_embeds=None) -> torch.Tensor:
        """Token embeddings (scaled by sqrt(d_model) when ``embed_scale``),
        the first ``prefix_embeds.shape[1]`` rows replaced by the prefix."""
        h = embedding(gathered(self.embed), tokens)
        if self.spec.embed_scale:
            h = h * (self.spec.d_model ** 0.5)
        if prefix_embeds is not None:
            npfx = prefix_embeds.shape[1]
            h = torch.cat([prefix_embeds.to(h.dtype), h[:, npfx:]], dim=1)
        return h

    def _add_positions(self, h: torch.Tensor, start: int = 0) -> torch.Tensor:
        """``h`` plus rows ``[start, start + S)`` of the learned table, when
        the spec has one."""
        if self.spec.positional != "learned":
            return h
        return h + self.pos_embed[start:start + h.shape[1]][None].to(h.dtype)

    def head_weight(self) -> Tuple[torch.Tensor, bool]:
        """(weight, transposed): logits = h @ w, or h @ w.T when transposed
        (tied embeddings)."""
        if self.spec.tie_embeddings:  # the embedding's second use
            return gathered(self.embed), True
        return gathered(self.head), False

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        h = _normed(self.spec.norm, self.final_norm, h)
        w, transposed = self.head_weight()
        logits = h @ (w.T if transposed else w)
        if self.spec.logit_softcap:
            c = self.spec.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder stack on precomputed frame embeddings (B, T, d_model)
        (the stub frontend) -> the encoder output (B, T, d_model)."""
        h = self._add_positions(frames)
        positions = torch.arange(h.shape[1], device=h.device)[None]
        h = self._run_segments(self.enc_segments, h, positions)
        return _normed(self.spec.norm, self.enc_final_norm, h)

    def _layers_out(self, tokens, positions, prefix_embeds, enc_out) -> torch.Tensor:
        h = self._add_positions(self._embed(tokens, prefix_embeds))
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        h = constrain(h, BATCH)
        return self._run_segments(self.segments, h, positions, enc_out)

    def forward(self, tokens: torch.Tensor, positions=None, *, prefix_embeds=None,
                enc_out=None) -> torch.Tensor:
        """Full-sequence forward (the JAX package's ``LM.apply``).
        tokens: (B, S) integer -> logits (B, S, vocab).  ``prefix_embeds``
        (B, P, d_model) overwrite the first P embeddings (a VLM's patch
        embeddings); ``enc_out`` (B, T, d_model), from :meth:`encode`, is
        what the cross-attention sub-blocks attend to."""
        return self._head(self._layers_out(tokens, positions, prefix_embeds, enc_out))

    def hidden(self, tokens: torch.Tensor, positions=None, *, prefix_embeds=None,
               enc_out=None) -> torch.Tensor:
        """Full-sequence forward -> the final normed hidden states (B, S,
        d_model), for :func:`repro_torch.train.loss.chunked_cross_entropy`
        with :meth:`head_weight`."""
        h = self._layers_out(tokens, positions, prefix_embeds, enc_out)
        return _normed(self.spec.norm, self.final_norm, h)

    # -- decode -------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int, dtype=torch.float32, *,
                   enc_out=None) -> Cache:
        """Fresh decode caches on the model's device, one dict per layer
        invocation: zeroed K/V and recurrent states, the stabilisers at
        -1e6, and each cross-attention's K/V projected from ``enc_out``
        (B, T, d_model) (empty without it)."""
        if max_seq > self.spec.max_position:
            raise ValueError(f"max_seq {max_seq} exceeds max_position "
                             f"{self.spec.max_position}")
        return [layer.init_cache(batch, max_seq, enc_out, dtype, self.embed.device)
                for layer in self.layers()]

    # the decode cache's logical axes by sub-block kind (the JAX package's)
    _CACHE_AXES = {
        "attention": {"k": ("batch", "kv_seq", "kv_heads", None),
                      "v": ("batch", "kv_seq", "kv_heads", None)},
        "cross_attention": {"k": ("batch", "kv_seq", "kv_heads", None),
                            "v": ("batch", "kv_seq", "kv_heads", None)},
        "mamba2": {"conv": ("batch", None, "mlp"), "state": ("batch", "heads", None, None)},
        "mlstm": {"conv": ("batch", None, "mlp"), "c": ("batch", "heads", "mlp", None),
                  "n": ("batch", "heads", "mlp"), "m": ("batch", "heads")},
        "slstm": {"conv": ("batch", None, None), "c": ("batch", "heads", "mlp"),
                  "n": ("batch", "heads", "mlp"), "m": ("batch", "heads", "mlp"),
                  "h": ("batch", "heads", "mlp")},
        "mlp": {},
        "moe": {},
    }

    def cache_axes(self) -> List[Dict[str, Dict[str, Axes]]]:
        """Logical-axis tree matching :meth:`init_cache`'s: one ``{sub_<i>:
        {leaf: axes}}`` a layer invocation, in the order the layers run."""
        return [{f"sub_{i}": dict(self._CACHE_AXES[blk.sub.kind])
                 for i, blk in enumerate(layer.subs)} for layer in self.layers()]

    def prefill(self, cache: Cache, tokens: torch.Tensor, pos_offset: int = 0):
        """Batched prefill: the whole prompt in one full-sequence forward
        that also fills the decode caches.  tokens: (B, S) integer.

        Returns (logits (B, S, vocab), cache); decoding continues from
        ``pos = pos_offset + S`` with :meth:`decode`.
        """
        h = self._add_positions(self._embed(tokens), pos_offset)
        h = self._cached_segments(h, cache, lambda layer, h, c: layer.prefill(h, c, pos_offset))
        return self._head(h), cache

    def decode(self, cache: Cache, tokens: torch.Tensor, pos):
        """One-step decode.  tokens: (B, 1) integer; pos: an int, or an
        integer tensor (B,) of per-sequence positions (continuous
        batching: each serving slot decodes at its own depth).

        Returns (logits (B, 1, vocab), cache).
        """
        h = self._embed(tokens)
        if self.spec.positional == "learned":
            if torch.is_tensor(pos) and pos.dim() == 1:  # per slot
                h = h + self.pos_embed[pos.to(h.device)][:, None].to(h.dtype)
            else:
                h = self._add_positions(h, int(pos))
        h = self._cached_segments(h, cache, lambda layer, h, c: layer.decode(h, c, pos))
        return self._head(h), cache
