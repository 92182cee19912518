"""Losses.  Cross-entropy upcasts logits to fp32 (float64 in a float64
step); a chunked variant computes the (B, S, vocab) logits a chunk of
positions at a time for 150k+ vocabularies.

The JAX package's ``chunked_cross_entropy`` also takes ``unroll``, which
only changes how XLA's cost analysis counts the scan in its dry run; the
port's loop over chunks has nothing to unroll, and its dry run
(``repro_torch.launch.dryrun``) counts every chunk as it runs.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.api import from_local, is_dtensor, to_local
from repro_torch.nn.norms import acc, acc_dtype


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """logits: (B, S, V); labels: (B, S) integer.  Mean over unmasked tokens."""
    logits = acc(logits)
    logz, gold = _terms(logits, labels)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(logits.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _terms(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, the label's logit) over the vocab of each position."""
    if _vocab_split(logits):
        return _split_terms(logits, labels)
    return torch.logsumexp(logits, dim=-1), _gold(logits, labels)


def _vocab_split(logits) -> bool:
    return is_dtensor(logits) and any(
        p.is_shard(logits.ndim - 1) and logits.device_mesh.size(i) > 1
        for i, p in enumerate(logits.placements))


def _split_terms(logits, labels):
    """:func:`_terms` of DTensor logits whose vocab the mesh splits, from
    each rank's shard (``torch.logsumexp``'s steps): the max, the sum of
    exponentials and the label's logit reduce the local vocab and combine
    through all-reduces of (B, S) partials.  The logits and their gradient
    stay on their shards, where DTensor's fused op (and the sums' backward)
    would gather the whole vocab on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    placed = tuple(Replicate() if p.is_partial() else p for p in logits.placements)
    rows = [Replicate() if p.is_shard(vdim) else p for p in placed]
    x = to_local(logits, placed)

    def combined(t, op):
        parts = [Partial(op) if p.is_shard(vdim) else r for p, r in zip(placed, rows)]
        return DTensor.from_local(t, mesh, parts, run_check=False).redistribute(mesh, rows)

    m = combined(x.detach().amax(dim=-1), "max").to_local()
    m = m.masked_fill(m.abs() == float("inf"), 0.0)
    logz = combined((x - m[..., None]).exp().sum(dim=-1), "sum").log() + from_local(m, mesh, rows)
    ids = distribute_tensor(torch.arange(logits.shape[-1], device=logits.device), mesh,
                            [Shard(0) if p.is_shard(vdim) else Replicate() for p in placed],
                            src_data_rank=None).to_local()
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lab = labels.long().redistribute(mesh, rows).to_local()
    gold = combined((x * (lab[..., None] == ids).to(x.dtype)).sum(dim=-1), "sum")
    return logz, gold


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit of its label.  On a DTensor, whose vocab may
    be sharded (DTensor's gather along a sharded dim leaves a masked
    partial sum it cannot reduce), it is the sum of the logits times the
    labels' one-hot made on the logits' own placements: no logit moves,
    and the sum is exact, as every other term is zero."""
    labels = labels.long()
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    placed = [p if p.is_shard() else Replicate() for p in logits.placements]
    ids = distribute_tensor(torch.arange(logits.shape[-1], device=logits.device), mesh,
                            [Shard(0) if p.is_shard(vdim) else Replicate() for p in placed],
                            src_data_rank=None).to_local()
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lab = labels.redistribute(mesh, [Replicate() if p.is_shard(vdim) else p
                                     for p in placed]).to_local()
    onehot = (lab[..., None] == ids).to(logits.dtype)
    return (logits * from_local(onehot, mesh, placed, shape=logits.shape)).sum(-1)


def chunked_cross_entropy(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor, *,
                          chunk: int = 1024, mask=None, transposed: bool = False):
    """Cross-entropy from the final hidden states, ``chunk`` positions of
    logits at a time (the reference's ``lax.scan`` over chunks).

    h: (B, S, D); head_w: (D, V), or (V, D) with ``transposed=True`` (tied
    embeddings).  S must be a multiple of ``chunk``.
    """
    b, s, d = h.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    dtype = acc_dtype(h)
    total = torch.zeros((), dtype=dtype, device=h.device)
    count = torch.zeros((), dtype=dtype, device=h.device)
    w = head_w.T if transposed else head_w
    for i in range(0, s, chunk):
        logits = acc(h[:, i:i + chunk] @ w)
        li = labels[:, i:i + chunk].long()
        mi = (torch.ones(li.shape, dtype=dtype, device=h.device) if mask is None
              else mask[:, i:i + chunk].to(dtype))
        logz, gold = _terms(logits, li)
        total = total + ((logz - gold) * mi).sum()
        count = count + mi.sum()
    return total / count.clamp_min(1.0)


def shift_labels(tokens: torch.Tensor):
    """Next-token prediction: labels[t] = tokens[t+1]; last position masked."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask
