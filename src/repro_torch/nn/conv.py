"""1-D convolution / pooling primitives (channels-last at the public
functions: (B, L, C), as in the JAX package).

Used by the paper-native NAS search spaces (1-D convolutional
classifiers over sensor streams).  Weights are kept in PyTorch's own
layout, ``w`` as (C_out, C_in, K); the JAX package keeps (K, C_in, C_out)
and :func:`repro_torch.convert.candidate_from_jax` carries one into the
other.  Padding follows XLA: ``SAME`` pads ``max((out-1)*stride + k - L, 0)``
in all, the odd element on the right, which PyTorch's ``padding="same"``
cannot do for a stride above 1, so the pads are computed here.  Pools
are ``VALID``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers as init


def conv1d_init(generator, in_ch, out_ch, kernel_size, dtype=torch.float32,
                use_bias=True):
    params = {"w": init.scaled_normal(generator, (out_ch, in_ch, kernel_size),
                                      dtype, fan_in=kernel_size * in_ch)}
    if use_bias:
        params["b"] = init.zeros(generator, (out_ch,), dtype)
    return params


def same_pads(length, kernel_size, stride):
    """(left, right) padding of XLA's ``SAME`` along one axis."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


def conv1d_apply(params, x, stride=1, padding="SAME"):
    """x: (B, L, C_in) -> (B, L', C_out)."""
    w = params["w"]
    xt = x.transpose(1, 2)
    if padding == "SAME":
        xt = F.pad(xt, same_pads(x.shape[1], w.shape[2], stride))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, not {padding!r}")
    y = F.conv1d(xt, w, params.get("b"), stride=stride)
    return y.transpose(1, 2)


def conv1d_out_len(l, kernel_size, stride, padding="SAME"):
    if padding == "SAME":
        return -(-l // stride)
    return (l - kernel_size) // stride + 1


def maxpool1d(x, window=2, stride=None):
    stride = stride or window
    return F.max_pool1d(x.transpose(1, 2), window, stride).transpose(1, 2)


def avgpool1d(x, window=2, stride=None):
    stride = stride or window
    return F.avg_pool1d(x.transpose(1, 2), window, stride).transpose(1, 2)


def pool_out_len(l, window, stride=None):
    stride = stride or window
    return (l - window) // stride + 1


def global_avg_pool(x):
    return x.mean(dim=1)
