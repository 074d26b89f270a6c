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
  a step back in distance beyond those the reference's pages take),
  ``dist_err`` (the widest gap between a served distance and the float64
  distance of its id), ``page_miss`` (the share of the reference's page
  entries missing from the served page).  The
  reference searches its own float64 build of the index; only where the
  stored parent or leaf is a rounding from the nearest (``TIE``) does the
  program's choice stand.

A configuration with ``shards`` is a federation (``federation.json`` and a
directory of files for each shard): the three set-up numbers are taken
shard by shard, each against the reference's derivation of its own slice
(``reference.shard_bounds``) under its own leader draw, and summed (the
gap: the worst); ``routing_errors`` counts the shards missing from the
manifest or extra in it, and each entry whose item count is not the
number of items its shard's leaves hold, or whose router centroids are
not its shard's root rows to the manifest's 6 decimals.  The reference
routes as the program does, and where two router centroids of different
shards lie within ``TIE``, the program's split (recorded with each
search) stands.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import reference as ref

EXACT = ("leader_mismatch", "structure_errors", "bad_answers", "routing_errors")
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
            if emb.shape != (len(ids), data.shape[1]) or ((ids < 0) | (ids >= n)).any():
                errors += 1
                continue
            same = emb.view(np.uint8).reshape(len(ids), -1) == host(ids).view(np.uint8).reshape(len(ids), -1)
            errors += int((~same.all(axis=1)).sum())
    return {**out, "structure_errors": errors, "assign_gap": gap}, judged


MANIFEST = "federation.json"
# the manifest keeps each router value to 6 decimals: half of that, and
# float64's rounding of the comparison, is still the shard file's value
ROUTER_ROUND = 5e-7 * (1 + 1e-9)


def read_federation(root: Path) -> tuple[list[dict], list[ref.Index]]:
    """The manifest's shard entries, and each shard's structure as its
    files hold it (global ids)."""
    entries = json.loads((root / MANIFEST).read_text())["shards"]
    return entries, [read_index(root / e["path"]) for e in entries]


def index_numbers(data: torch.Tensor, cfg: dict, root: Path | None, seed: int, stored=None,
                  entries: list | None = None):
    """The set-up numbers of the configuration's index, and what the
    reference searches (an ``Index``, or a list of them for a
    federation).  ``stored`` (and a federation's manifest ``entries``):
    the structure to judge, where it is not read from the files under
    ``root``; without ``root`` the files' bytes and the manifest go
    unchecked."""
    if "shards" not in cfg:
        return build_numbers(data, cfg, stored if stored is not None else read_index(root), root=root, seed=seed)
    if stored is None:
        entries, stored = read_federation(root)
    bounds = ref.shard_bounds(data.shape[0], cfg["shards"])
    out = {"leader_mismatch": 0, "structure_errors": 0, "assign_gap": 0.0}
    judged = []
    for s, (lo, hi) in enumerate(bounds):
        if s >= len(stored):
            judged.append(ref.offset(ref.build(data[lo:hi], cfg, torch.float64), lo))
            continue
        st = stored[s]
        local = ref.Index(st.leaders - lo, st.nodes, st.children, [m - lo for m in st.members])
        where = None if root is None else root / entries[s]["path"]
        nums, j = build_numbers(data[lo:hi], cfg, local, root=where, seed=seed + s)
        for key in ("leader_mismatch", "structure_errors"):
            out[key] += nums[key]
        out["assign_gap"] = max(out["assign_gap"], nums["assign_gap"])
        judged.append(ref.offset(j, lo))
    if root is not None:
        out["routing_errors"] = abs(len(entries) - len(bounds)) + sum(
            _entry_errors(root / e["path"], e, st) for e, st in zip(entries, stored))
    return out, judged


def _entry_errors(shard: Path, entry: dict, stored: ref.Index) -> int:
    """1 where a manifest entry's item count or router centroids are not
    what its shard's files hold, else 0."""
    if int(entry.get("n_items", -1)) != sum(len(m) for m in stored.members):
        return 1
    root_rows = read_array(shard, f"{node_path(0, 0)}/embeddings").astype(np.float64)
    router = np.asarray(entry.get("router", []), np.float64)
    return int(router.shape != root_rows.shape or not bool((np.abs(router - root_rows) <= ROUTER_ROUND).all()))


def routes_by_shard(entries: list[dict], routes: list) -> list:
    """The program's splits ({shard name: b}) by shard position in the
    manifest; None where a search recorded none."""
    at = {e["name"]: s for s, e in enumerate(entries)}
    return [None if r is None else {at.get(name, -1): int(b) for name, b in r.items()} for r in routes]


# ------------------------------------------------------------ the pages
@torch.no_grad()
def page_numbers(reference, queries: np.ndarray, served: list[list[tuple]], routes: list | None = None) -> dict:
    """bad_answers, dist_err, page_miss of ``served`` ([rows] lists of
    (ids, dists) pages, in the order they were served) for ``queries``;
    ``routes``: a federation's recorded splits, for the reference's ties."""
    n = reference.data.shape[0]
    n_pages = len(served[0])
    want = reference.pages(queries, n_pages, routes)
    qn = ref.unit(torch.as_tensor(queries, device=reference.data.device), torch.float64)
    bad, err, miss, total = 0, 0.0, 0, 0
    for r, (pages, rpages) in enumerate(zip(served, want)):
        ids = np.concatenate([np.asarray(p[0], np.int64) for p in pages])
        dists = np.concatenate([np.asarray(p[1], np.float64) for p in pages])
        ok = (ids >= 0) & (ids < n) & np.isfinite(dists)
        bad += int((~ok).sum()) + int(len(ids[ok]) - len(np.unique(ids[ok])))
        # in distance order, but for as many steps back as the reference's
        # pages take: a federation's shard that opens more leaves while the
        # pages merge can find items nearer than those already served
        back = int((np.diff(np.concatenate([np.asarray(p[1], np.float64) for p in rpages])) < 0).sum())
        bad += max(0, int((np.diff(dists[ok]) < 0).sum()) - back)
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
