"""The one traffic generator: a traffic file's parameters -> each client's
sessions, made on the device before the window opens.

A session is what one user does before moving on: ``queries_per_session``
requests, each a search of ``rows_per_request`` query rows followed by
``more_per_query`` continuations.  Each row looks for a hidden target item
of the collection: the query is the target plus Gaussian noise of norm
``noise[(h + r) % len(noise)] * |target|`` for request ``h`` of the
session and row ``r`` of the request, normalised.  A known-item task
(``rows_per_request`` 1) walks the noise list as its hints sharpen; a
batch (``queries_per_session`` 1) mixes every level in one request.  A
session's rows keep their targets across its requests.

The targets and the noise come from the traffic's ``structure_seed`` and
the client; the noise is turned by the run's rotation, as the collection
is (``collection.py``), so every seed sends the same requests in the
same order, of the same work, in other coordinates.  A client has
``pool_sessions`` sessions; one that runs out starts its pool again.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Request:
    queries: np.ndarray    # [rows, dim] float32, unit norm
    targets: np.ndarray    # [rows] the hidden items' ids


@torch.no_grad()
def sessions(spec: dict, data: torch.Tensor, rot: torch.Tensor, client: int, count: int) -> list[list[Request]]:
    """Client ``client``'s first ``count`` sessions over ``data`` ([n, dim]
    in storage dtype, on the device that makes them)."""
    dev = data.device
    rows, steps = int(spec["rows_per_request"]), int(spec["queries_per_session"])
    n, dim = data.shape
    gen = torch.Generator(device=dev).manual_seed(int(spec["structure_seed"]) * 1_000_003 + int(client))
    targets = torch.randint(0, n, (count, rows), generator=gen, device=dev)
    base = data[targets].float()                                             # [count, rows, dim]
    z = (torch.randn((count * steps * rows, dim), generator=gen, device=dev) @ rot).view(count, steps, rows, dim)
    noise = torch.as_tensor(spec["noise"], dtype=torch.float32, device=dev)
    level = noise[(torch.arange(steps, device=dev)[:, None] + torch.arange(rows, device=dev)[None, :]) % len(noise)]
    z *= (level[None, :, :, None] * torch.linalg.vector_norm(base, dim=-1)[:, None, :, None]
          / torch.linalg.vector_norm(z, dim=-1, keepdim=True))
    q = base[:, None] + z
    q = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).cpu().numpy()
    t = targets.cpu().numpy()
    return [[Request(q[s, h], t[s]) for h in range(steps)] for s in range(count)]


def pool(spec: dict, data: torch.Tensor, rot: torch.Tensor, client: int) -> list[list[Request]]:
    """A client's pool of sessions for the window."""
    return sessions(spec, data, rot, client, int(spec["pool_sessions"]))


def warmup(spec: dict, data: torch.Tensor, rot: torch.Tensor) -> list[list[Request]]:
    """Sessions of the same shape that no client of the window sends."""
    return sessions(spec, data, rot, 1 << 20, int(spec["warmup_sessions"]))
