"""The comparison that decides ``correct``.

Two parts, each a handful of numbers held to limits (the workload file's
``limits``; ``PERF.md`` gives the readings each was set from):

* What set-up derived, read back from the index's files (zarr v2: a
  ``.zarray`` JSON beside raw little-endian chunks, read here with numpy)
  and held to ``reference.py``'s derivation from the same collection:
  ``leader_mismatch`` (leaders that are not the seeded draw),
  ``structure_errors`` (an item or node missing or repeated, a stored row
  that is not its item's bytes), ``assign_gap`` (the worst amount, in
  float64 cosine distance, by which a stored parent or leaf is farther
  than the nearest one the descent could have taken).
* What the timed path served: ``bad_answers`` (an id outside the
  collection or repeated in a row's pages, a distance that is not finite,
  pages out of order), ``dist_err`` (the widest gap between a served
  distance and the float64 distance of its id), ``page_miss`` (the share
  of the reference's page entries missing from the served page).  The
  reference searches its own float64 build of the index; only where the
  stored parent or leaf is a rounding from the nearest (``TIE``) does the
  program's choice stand.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import reference as ref

EXACT = ("leader_mismatch", "structure_errors", "bad_answers")
# Two parents or leaves whose float64 distances differ by less than this
# are a tie to the float32 rounding of a sound build, which read gaps of
# at most 6.2e-7 (PERF.md §4): there the program's choice stands.
TIE = 1e-6


# ------------------------------------------------------------ the files
def read_array(root: Path, path: str) -> np.ndarray:
    """One raw-chunked zarr v2 array (chunks along the first axis)."""
    p = root / path
    meta = json.loads((p / ".zarray").read_text())
    shape, cr = meta["shape"], meta["chunks"][0]
    dt = np.dtype(meta["dtype"])
    tail = ".0" * (len(shape) - 1)
    parts = [np.frombuffer((p / f"{c}{tail}").read_bytes(), dtype=dt).reshape([cr] + shape[1:])
             for c in range(max(1, -(-shape[0] // cr)))]
    return np.concatenate(parts)[: shape[0]].reshape(shape)


def node_path(level: int, node: int) -> str:
    return "index_root" if level == 0 else f"lvl_{level}/node_{node:08d}"


def read_index(root: Path) -> ref.Index:
    """The index's structure as its files hold them."""
    info = json.loads((root / "info" / ".zattrs").read_text())
    nodes = [int(x) for x in info["nodes_per_level"]]
    L = int(info["levels"])
    children = [[read_array(root, f"{node_path(lv, j)}/ids").astype(np.int64) for j in range(nodes[lv - 1])]
                for lv in range(1, L)]
    members = [read_array(root, f"{node_path(L, j)}/ids").astype(np.int64) for j in range(nodes[-1])]
    leaders = read_array(root, "rep/item_ids").astype(np.int64)
    return ref.Index(leaders, nodes, children, members)


# ------------------------------------------------------------ the build
def _cover(lists: list[np.ndarray], n: int) -> tuple[int, np.ndarray]:
    """(errors, owner): entries outside [0, n) or not listed exactly once."""
    flat = np.concatenate(lists) if lists else np.zeros(0, np.int64)
    bad = int(((flat < 0) | (flat >= n)).sum())
    flat_ok = flat[(flat >= 0) & (flat < n)]
    counts = np.bincount(flat_ok, minlength=n)
    owner = np.full(n, -1, np.int64)
    own = np.repeat(np.arange(len(lists)), [len(x) for x in lists])[(flat >= 0) & (flat < n)]
    owner[flat_ok] = own
    return bad + int((counts != 1).sum()), owner


@torch.no_grad()
def build_numbers(data: torch.Tensor, cfg: dict, stored: ref.Index, *, root: Path | None,
                  seed: int, rows: int = 1 << 16, sample_leaves: int = 16) -> tuple[dict, ref.Index]:
    """leader_mismatch, structure_errors, assign_gap of a stored index
    against the collection ``data`` (storage dtype, on the device), and
    the index the reference searches: the float64 build's own parents and
    leaves, the stored one kept wherever it is within ``TIE`` of the
    nearest."""
    n = data.shape[0]
    n_leaders, nodes = ref.derive_shape(n, int(cfg["cluster_cap"]), int(cfg["levels"]))
    pos = ref.leader_draw(int(cfg["build_seed"]), n, n_leaders)
    out = {"leader_mismatch": int(len(stored.leaders) != n_leaders or stored.nodes != nodes)}
    if out["leader_mismatch"]:
        return {**out, "structure_errors": 1, "assign_gap": float("inf")}, ref.build(data, cfg, torch.float64)
    out["leader_mismatch"] = int((stored.leaders != pos).sum())
    dev = data.device
    lead = ref.unit(data[torch.as_tensor(pos, device=dev)], torch.float64)
    errors, gap = 0, 0.0
    parents, children = [], []
    for i, lists in enumerate(stored.children):
        e, parent = _cover(lists, nodes[i + 1])
        errors += e
        d = ref.cos_dist(lead[: nodes[i + 1]], lead[: nodes[i]])
        p = torch.as_tensor(np.maximum(parent, 0), device=dev)
        g = d[torch.arange(nodes[i + 1], device=dev), p] - d.min(dim=1).values
        gap = max(gap, float(g.max()))
        parents.append(p)
        keep = torch.as_tensor(parent >= 0, device=dev) & (g <= TIE)
        children.append(ref.group(torch.where(keep, p, d.argmin(dim=1)).cpu().numpy(), nodes[i]))
    e, leaf_of = _cover(stored.members, n)
    errors += e
    masks = [ref.child_mask(c, nodes[i + 1], dev) for i, c in enumerate(stored.children)]
    judged_masks = [ref.child_mask(c, nodes[i + 1], dev) for i, c in enumerate(children)]
    leaf_t = torch.as_tensor(np.maximum(leaf_of, 0), device=dev)
    judged_leaf = []
    for lo in range(0, n, rows):
        x = ref.unit(data[lo : lo + rows], torch.float64)
        d = ref.cos_dist(x, lead)
        r = torch.arange(len(x), device=dev)
        chain = [leaf_t[lo : lo + rows]]
        for p in reversed(parents):
            chain.insert(0, p[chain[0]])
        g = d[r, chain[0]] - d[:, : nodes[0]].min(dim=1).values
        for i, m in enumerate(masks):
            best = torch.where(m[chain[i]], d[:, : nodes[i + 1]], torch.inf).min(dim=1).values
            g = torch.maximum(g, d[r, chain[i + 1]] - best)
        gap = max(gap, float(g.max()))
        keep = torch.as_tensor(leaf_of[lo : lo + rows] >= 0, device=dev) & (g <= TIE)
        judged_leaf.append(torch.where(keep, chain[-1], ref.descend(d, nodes, judged_masks)).cpu().numpy())
    judged = ref.Index(pos.astype(np.int64), nodes, children, ref.group(np.concatenate(judged_leaf), n_leaders))
    if root is not None:
        rng = np.random.default_rng([int(seed) % (1 << 64), 7])
        host = lambda ids: data[torch.as_tensor(ids, device=dev)].cpu().numpy()
        checks = [(0, 0, pos[: nodes[0]])]
        checks += [(i + 1, j, pos[c]) for i, lists in enumerate(stored.children) for j, c in enumerate(lists)]
        L = len(nodes)
        checks += [(L, int(j), stored.members[j]) for j in rng.choice(n_leaders, min(sample_leaves, n_leaders), replace=False)]
        for level, node, ids in checks:
            emb = read_array(root, f"{node_path(level, node)}/embeddings")
            if emb.shape != (len(ids), data.shape[1]):
                errors += 1
                continue
            same = emb.view(np.uint8).reshape(len(ids), -1) == host(ids).view(np.uint8).reshape(len(ids), -1)
            errors += int((~same.all(axis=1)).sum())
    return {**out, "structure_errors": errors, "assign_gap": gap}, judged


# ------------------------------------------------------------ the pages
@torch.no_grad()
def page_numbers(reference: ref.Searcher, queries: np.ndarray, served: list[list[tuple]]) -> dict:
    """bad_answers, dist_err, page_miss of ``served`` ([rows] lists of
    (ids, dists) pages, in the order they were served) for ``queries``."""
    n = reference.data.shape[0]
    n_pages = len(served[0])
    want = reference.pages(queries, n_pages)
    qn = ref.unit(torch.as_tensor(queries, device=reference.data.device), torch.float64)
    bad, err, miss, total = 0, 0.0, 0, 0
    for r, (pages, rpages) in enumerate(zip(served, want)):
        ids = np.concatenate([np.asarray(p[0], np.int64) for p in pages])
        dists = np.concatenate([np.asarray(p[1], np.float64) for p in pages])
        ok = (ids >= 0) & (ids < n) & np.isfinite(dists)
        bad += int((~ok).sum()) + int(len(ids[ok]) - len(np.unique(ids[ok])))
        bad += int((np.diff(dists[ok]) < 0).sum())
        if ok.any():
            x = ref.unit(reference.data[torch.as_tensor(ids[ok], device=qn.device)], torch.float64)
            d64 = ref.cos_dist(qn[r : r + 1], x)[0].cpu().numpy()
            err = max(err, float(np.abs(dists[ok] - d64).max()))
        for (sid, _), (rid, _) in zip(pages, rpages):
            miss += len(np.setdiff1d(rid, np.asarray(sid, np.int64)))
            total += len(rid)
    return {"bad_answers": bad, "dist_err": err, "page_miss": miss / max(total, 1)}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit (exact ones at 0)."""
    out = {}
    for name, value in numbers.items():
        limit = 0 if name in EXACT else limits[name]
        out[name] = {"value": value, "limit": limit}
    return all(v["value"] <= v["limit"] for v in out.values()), out
