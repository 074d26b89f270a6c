"""The collection a configuration serves, made on the device from ``--seed``.

A two-level mixture of unit vectors that stands for SigLIP image
embeddings of a lifelog (the configuration's ``data`` block gives every
number; ``PERF.md`` states the argument behind them):

    x = normalise(a*mu + b*topic + s*group + n*item)

with ``mu`` one direction shared by the whole collection (CLIP-family
embeddings fill a narrow cone), ``topic`` one of a few coarse scenes,
``group`` one burst of near-identical frames, ``item`` a frame's own
noise; all four are independent Gaussian directions of norm ~1, nearly
orthogonal at 1152 dimensions, so the expected cosines are
``a^2`` (unrelated), ``a^2 + b^2`` (same topic) and ``a^2 + b^2 + s^2``
(same group).  Items are laid out topic by topic and group by group; item
id = row.

The layout and the vectors come from the configuration's
``structure_seed``; ``--seed`` draws one random rotation (``rotation``)
of the whole collection, and the traffic turns its noise by the same one.
A rotation keeps every inner product, so each seed gives the index the
same leaves of the same sizes and the searches the same work, while every
value the program sees differs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CHUNK_ROWS = 1 << 17


def layout(spec: dict, n_items: int) -> tuple[np.ndarray, np.ndarray]:
    """(topic of each group, size of each group) in row order; the groups
    of topic 0 first.  Topic shares follow Zipf with ``topic_zipf``; group
    sizes are log-uniform in ``group_size`` (the last group of a topic
    takes what is left)."""
    rng = np.random.default_rng(spec["structure_seed"])
    t = int(spec["topics"])
    share = 1.0 / np.arange(1, t + 1) ** float(spec["topic_zipf"])
    sizes = np.floor(share / share.sum() * n_items).astype(np.int64)
    sizes[0] += n_items - sizes.sum()
    lo, hi = spec["group_size"]
    g_topic, g_size = [], []
    for topic, left in enumerate(sizes):
        while left > 0:
            g = int(round(math.exp(rng.uniform(math.log(lo), math.log(hi)))))
            g = min(g, int(left))
            g_topic.append(topic)
            g_size.append(g)
            left -= g
    return np.asarray(g_topic, np.int64), np.asarray(g_size, np.int64)


def _directions(gen: torch.Generator, n: int, dim: int, device) -> torch.Tensor:
    return torch.randn((n, dim), generator=gen, device=device) / math.sqrt(dim)


def rotation(seed: int, dim: int, device) -> torch.Tensor:
    """A random orthogonal [dim, dim] float32 matrix drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    a = torch.randn((dim, dim), generator=gen, device=device, dtype=torch.float64)
    qm, r = torch.linalg.qr(a)
    qm = qm * torch.sign(torch.diagonal(r))[None, :]  # Haar-distributed
    return qm.to(torch.float32)


@torch.no_grad()
def make(cfg: dict, rot: torch.Tensor, device) -> torch.Tensor:
    """The collection of ``cfg`` turned by ``rot`` (``rotation(seed)``):
    [n_items, dim] in the configuration's storage dtype, on ``device``."""
    spec = cfg["data"]
    n, dim = int(cfg["n_items"]), int(cfg["dim"])
    a, b, s, nz = (math.sqrt(spec[k]) for k in ("share_common", "share_topic", "share_group", "share_item"))
    g_topic, g_size = layout(spec, n)
    gen = torch.Generator(device=device).manual_seed(int(spec["structure_seed"]))
    mu = _directions(gen, 1, dim, device)
    topics = _directions(gen, int(g_topic.max()) + 1, dim, device)
    groups = _directions(gen, len(g_size), dim, device)
    group_of = torch.as_tensor(np.repeat(np.arange(len(g_size)), g_size), device=device)
    topic_of = torch.as_tensor(g_topic, device=device)[group_of]
    out = torch.empty((n, dim), dtype=getattr(torch, cfg["storage_dtype"]), device=device)
    for lo in range(0, n, CHUNK_ROWS):
        hi = min(lo + CHUNK_ROWS, n)
        x = nz * _directions(gen, hi - lo, dim, device)
        x += a * mu + b * topics[topic_of[lo:hi]] + s * groups[group_of[lo:hi]]
        x /= torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        out[lo:hi] = x @ rot
    return out
