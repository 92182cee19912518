"""Losses.  Cross-entropy upcasts logits to fp32 (float64 in a float64
step); a chunked variant computes the (B, S, vocab) logits a chunk of
positions at a time for 150k+ vocabularies.

The JAX package's ``chunked_cross_entropy`` also takes ``unroll``, which
only changes how XLA's cost analysis counts the scan (the dry run, ROADMAP
Queue 1 item 13); the port's loop over chunks has nothing to unroll.
"""
from __future__ import annotations

import torch

from repro_torch.nn.norms import acc, acc_dtype


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """logits: (B, S, V); labels: (B, S) integer.  Mean over unmasked tokens."""
    logits = acc(logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(logits.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


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
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li[..., None])[..., 0]
        total = total + ((logz - gold) * mi).sum()
        count = count + mi.sum()
    return total / count.clamp_min(1.0)


def shift_labels(tokens: torch.Tensor):
    """Next-token prediction: labels[t] = tokens[t+1]; last position masked."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask
