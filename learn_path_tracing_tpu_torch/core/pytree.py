"""Elementwise select over matching tensor dataclasses."""

from __future__ import annotations

import dataclasses

import torch


def tree_where(mask, a, b):
    """``torch.where`` over every tensor field of two dataclasses of one type.

    ``mask`` is broadcast against each field: a field of shape ``[N, ...]`` is
    selected with ``mask[N]`` reshaped to ``[N, 1, ...]`` as needed.
    """
    kw = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            kw[f.name] = tree_where(mask, x, y)
            continue
        m = mask
        while m.ndim < x.ndim:
            m = m[..., None]
        kw[f.name] = torch.where(m, x, y)
    return type(a)(**kw)
