"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by name:

  BENCHMARK.json                       the cells, metrics and bounds
  portbench/configs/<config>.json      the deployment (``configs[].file``)
  portbench/traffic/<traffic>.json     the mix, read by ``traffic.py``
  portbench/limits/<cell>.json         the limits of the check
  portbench/held_out/<cell>.json       entries of a cell not yet proven
  portbench/metrics/<metric>.py        ``read(run) -> float | None``

A configuration's keys say what set-up builds and how it is opened: with
``"shards": {"n": 4, "split": "contiguous"}`` the collection is cut into
that many contiguous slices, each built as a shard of its own
(``build_federation``, fstore shards and a ``federation.json``), opened
by the same ``open_index(path, **open)``, which finds the manifest; the
counters sum the shards' stores, the check reads every shard against the
reference's derivation of its slice and the manifest against the shard
files, and the reference routes, splits ``b`` and merges the shards'
pages as ``reference.Federation`` says (``b_min``, ``top_m`` and
``probe_m`` from ``open``).  Without the key the configuration is one
index (``build_index``).

The program under test is ``repro_torch`` (from ``src/``), imported only
here and only inside functions.
"""
from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import math
import shutil
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import check, collection, reference, traffic
from .trace import WINDOW, Trace, from_profiler

ROOT = Path(__file__).resolve().parents[1]
GIB = float(1 << 30)


def log(what: str, t0: float) -> None:
    """One line on standard error: a phase of the run and the seconds
    since ``t0``."""
    print(f"portbench: {what} at {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    entry: dict       # the workload's entry of BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path = ROOT

    @staticmethod
    def find(name: str, root: Path = ROOT, held_out: bool = False) -> "Cell":
        """Cell ``name`` of BENCHMARK.json; with ``held_out``, also of
        ``portbench/held_out/<cell>.json`` (cells out of BENCHMARK.json
        until proven, which only the control and the tests run)."""
        bench = load_json(root / "BENCHMARK.json")
        if held_out:
            for f in sorted((root / "portbench" / "held_out").glob("*.json")):
                for key, entries in load_json(f).items():
                    if isinstance(entries, list):
                        bench[key] = bench[key] + entries
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
        here = root / "portbench"
        return Cell(name, entry, load_json(root / conf["file"]),
                    load_json(here / "traffic" / f"{entry['traffic']}.json"),
                    load_json(here / "limits" / f"{name}.json"), e2e, layer, root)


@dataclass
class Unit:
    """One search and its continuations, as served."""

    queries: np.ndarray                         # [rows, dim]
    pages: list = field(default_factory=list)   # per page: (ids [rows, k], dists [rows, k])
    routes: list | None = None                  # a federation's split of each row, {shard: b}


@dataclass
class Run:
    """What a run hands the per-layer readers."""

    cell: Cell
    counters: dict
    units: list
    latencies: dict
    window_s: float
    trace: Trace | None = None
    reference: reference.Searcher | reference.Federation | None = None

    @property
    def searches(self) -> int:
        return len(self.latencies["search"])


def read_metric(name: str, root: Path = ROOT):
    """The reader of per-layer metric ``name``: ``read(run) -> float | None``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", root / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _CountingScorer:
    """The leaf scorer, with the rows of every call that reaches its
    kernel (``min_rows`` and up) counted."""

    def __init__(self, scorer, min_rows: int):
        self._scorer, self._min_rows = scorer, min_rows
        self._lock = threading.Lock()
        self.rows: list[int] = []

    def __call__(self, q, emb, metric, sqnorms=None):
        if emb.shape[0] >= self._min_rows:
            with self._lock:
                self.rows.append(int(emb.shape[0]))
        return self._scorer(q, emb, metric, sqnorms)


def _open(cfg: dict, path: Path, device: str):
    """The configuration's searcher (``open_index(path, **cfg["open"])``,
    a ``scorer`` given by name: ``{"name": "kernel", ...}`` is
    ``make_kernel_scorer(...)``), its server, and the leaf-scorer counter
    (None where there is no leaf scorer)."""
    from repro_torch import core
    from repro_torch.launch.serve import Server

    kw, scorer = dict(cfg["open"]), None
    if "scorer" in kw:
        args = dict(kw["scorer"])
        make = getattr(core, f"make_{args.pop('name')}_scorer")
        scorer = kw["scorer"] = _CountingScorer(make(device=device, **args), int(args.get("min_rows", 0)))
    searcher = core.open_index(str(path), device=device, **kw)
    return searcher, Server(searcher, workers=int(cfg["workers"])), scorer


def _build(cfg: dict, host: np.ndarray, path: Path, device: str) -> None:
    """The configuration's index at ``path``: one index, or with
    ``shards`` a federation of fstore shards."""
    from repro_torch.core import ECPBuildConfig, build_federation, build_index

    bcfg = ECPBuildConfig(levels=int(cfg["levels"]), metric=cfg["metric"], cluster_cap=int(cfg["cluster_cap"]),
                          storage_dtype=cfg["storage_dtype"], seed=int(cfg["build_seed"]))
    if "shards" not in cfg:
        build_index(host, str(path), bcfg, device=device)
        return
    n_shards = len(reference.shard_bounds(len(host), cfg["shards"]))  # raises on a split it does not know
    build_federation(host, path, n_shards=n_shards, cfg=bcfg, backend="fstore", device=device)


def _counters(searcher, scorer, cfg: dict) -> dict:
    from repro_torch.kernels.distance_topk import ops

    out = {"distance_topk_launches": ops.launches["distance_topk"]}
    cache = getattr(searcher, "cache", None)
    if cache is not None:
        out.update(cache_hits=cache.hits, cache_misses=cache.misses)
    if "shards" in cfg:
        stores = [searcher.shard(name).store for name in searcher.shard_names]
    else:
        stores = [s for s in [getattr(searcher, "store", None)] if s is not None]
    if stores:
        out["store_bytes_read"] = sum(s.io.bytes_read for s in stores)
    if scorer is not None:
        out["scorer_rows"] = list(scorer.rows)
    return out


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for key, v in after.items():
        out[key] = v[len(before[key]):] if isinstance(v, list) else v - before[key]
    return out


def _serve(srv, req: traffic.Request, k: int, b: int, mores: int, unit: Unit, lat: dict, lock) -> None:
    q = req.queries[0] if len(req.queries) == 1 else req.queries
    t0 = time.perf_counter()
    with torch.profiler.record_function("portbench.search"):
        rs, sid = srv.search(q, k, b=b)
    t1 = time.perf_counter()
    unit.pages.append((np.atleast_2d(rs.ids).copy(), np.atleast_2d(rs.dists).copy()))
    routes = getattr(rs.query, "allocation", None)
    if routes is not None:
        unit.routes = routes if isinstance(routes, list) else [routes]
    times = []
    for _ in range(mores):
        t2 = time.perf_counter()
        with torch.profiler.record_function("portbench.more"):
            rs = srv.more(sid, k)
        times.append(time.perf_counter() - t2)
        unit.pages.append((np.atleast_2d(rs.ids).copy(), np.atleast_2d(rs.dists).copy()))
    srv.close(sid)
    with lock:
        lat["done"].append(t1)
        lat["search"].append((t1 - t0) * 1e3)
        lat["more"].extend(t * 1e3 for t in times)


def _client(srv, pool: list, deadline: float, cell: Cell, units: list, lat: dict, tally: dict, lock) -> None:
    k, b = int(cell.config["k"]), int(cell.config["b"])
    mores = int(cell.traffic["more_per_query"])
    for session in itertools.cycle(pool):
        for req in session:
            if time.perf_counter() >= deadline:
                return
            unit = Unit(req.queries)
            with lock:
                tally["attempted"] += 1 + mores
            try:
                _serve(srv, req, k, b, mores, unit, lat, lock)
            except Exception as e:  # a request that fails is counted, not fatal
                with lock:
                    tally["failed"] += max(1, 1 + mores - len(unit.pages))
                    tally["errors"].append(repr(e))
                continue
            with lock:
                units.append(unit)


def _window(srv, cell: Cell, pools: list, seconds: float):
    units, lat, tally = [], {"search": [], "more": [], "done": []}, {"attempted": 0, "failed": 0, "errors": []}
    lock = threading.Lock()
    with torch.profiler.record_function(WINDOW):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        threads = [threading.Thread(
            target=_client, name=f"portbench-client-{c}",
            args=(srv, pool, deadline, cell, units, lat, tally, lock))
            for c, pool in enumerate(pools)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _sync()
        window_s = time.perf_counter() - t0
    bins = np.bincount(((np.asarray(lat["done"]) - t0) // 5).astype(int)) if lat["done"] else []
    print(f"portbench: searches finished in each 5 s of the window: {list(map(int, bins))}", file=sys.stderr)
    for kind in ("search", "more"):
        if lat[kind]:
            print(f"portbench: {kind} ms p50 {percentile(lat[kind], 50):.3f} p95 {percentile(lat[kind], 95):.3f}"
                  f" of {len(lat[kind])}", file=sys.stderr)
    return units, lat, tally, window_s


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _warm(srv, cell: Cell, sessions: list) -> None:
    """Requests of the cell's own shapes, from sessions the window never
    sends, so that every kernel the window runs is built and loaded."""
    k, b = int(cell.config["k"]), int(cell.config["b"])
    mores = int(cell.traffic["more_per_query"])
    lock, lat = threading.Lock(), {"search": [], "more": [], "done": []}
    for session in sessions:
        for req in session:
            _serve(srv, req, k, b, mores, Unit(req.queries), lat, lock)
    _sync()


def _profiler(acts):
    """A profiler of every thread (the clients and the server's workers),
    where this torch can; else of the starting thread and the device."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=acts)
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def percentile(values, p: float) -> float:
    """The ``p``-th percentile of every value (linear between ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), p))


def _end_to_end(cell: Cell, lat: dict, units: list, window_s: float, peak: int, setup_s: float) -> dict:
    """The cell's end-to-end metrics; a name's part before the first dot
    says what it measures (``pages_per_s.file`` is ``pages_per_s``)."""
    pages = sum(len(u.queries) * len(u.pages) for u in units)
    values = {
        "search_p95_ms": percentile(lat["search"], 95) if lat["search"] else None,
        "pages_per_s": pages / window_s,
        "device_peak_gib": peak / GIB,
        "setup_s": setup_s,
    }
    out = {}
    for m in cell.end_to_end:
        v = values.get(m["name"].split(".")[0])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _compare(cell: Cell, host: np.ndarray, index_path: Path, units: list, seed: int, device: str):
    """The check: every number beside its limit, and the reference it
    searched with."""
    cfg = cell.config
    data = torch.as_tensor(host).to(device)
    queries, served, routes = _sample(units, int(cell.traffic["check_requests"]), seed)
    if "shards" in cfg:
        entries, stored = check.read_federation(index_path)
        for e, st in zip(entries, stored):
            sizes = [len(m) for m in st.members]
            print(f"portbench: shard {e['name']}: {sum(sizes)} items, {len(sizes)} leaves, "
                  f"the largest {max(sizes, default=0)} rows", file=sys.stderr)
        numbers, judged = check.index_numbers(data, cfg, index_path, seed, stored, entries)
        routes = check.routes_by_shard(entries, routes)
    else:
        numbers, judged = check.index_numbers(data, cfg, index_path, seed)
    searcher = reference.make_searcher(data, judged, cfg, torch.float64, tie=check.TIE)
    numbers.update(check.page_numbers(searcher, queries, served, routes))
    return numbers, searcher


def _sample(units: list, n: int, seed: int) -> tuple[np.ndarray, list, list]:
    """Up to ``n`` units drawn from the seed (all of them if fewer), as
    (queries [rows, dim], [rows] lists of (ids, dists) pages, [rows]
    splits or None)."""
    pick = units if len(units) <= n else [units[i] for i in sorted(
        np.random.default_rng([int(seed) % (1 << 64), 11]).choice(len(units), n, replace=False))]
    queries = np.concatenate([u.queries for u in pick])
    served = [[(p[0][r], p[1][r]) for p in u.pages] for u in pick for r in range(len(u.queries))]
    routes = [r for u in pick for r in (u.routes or [None] * len(u.queries))]
    return queries, served, routes


def run(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        workdir: Path, t_start: float | None = None, cell: Cell | None = None) -> tuple[dict, dict]:
    """One run of cell ``name``: (result line, checks).  ``workdir`` holds
    the index while the run lasts."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell if cell is not None else Cell.find(name)
    cfg = cell.config
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rot = collection.rotation(seed, int(cfg["dim"]), device)
    data = collection.make(cfg, rot, device)
    host = data.cpu().numpy()
    pools = [traffic.pool(cell.traffic, data, rot, c) for c in range(int(cell.traffic["clients"]))]
    warm = traffic.warmup(cell.traffic, data, rot)
    del data, rot
    log("collection and traffic made", t_start)
    index_path = workdir / "index"
    shutil.rmtree(index_path, ignore_errors=True)
    try:
        _build(cfg, host, index_path, device)
        log("index built", t_start)
        searcher, srv, scorer = _open(cfg, index_path, device)
        log("index opened", t_start)
        _warm(srv, cell, warm)
        log("warm", t_start)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = _counters(searcher, scorer, cfg)
        setup_s = time.perf_counter() - t_start
        gc.collect()
        gc.freeze()  # what set-up made stays out of the window's collections
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = _profiler(acts)
            prof.start()
        try:
            units, lat, tally, window_s = _window(srv, cell, pools, seconds)
        finally:
            if prof is not None:
                prof.stop()
        gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        counters = _delta(before, _counters(searcher, scorer, cfg))
        srv.shutdown()
        del searcher, srv, scorer
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        log("window closed", t_start)
        numbers, ref_searcher = _compare(cell, host, index_path, units, seed, device)
        log("checked", t_start)
    finally:
        shutil.rmtree(index_path, ignore_errors=True)
    correct, checks = check.decide(numbers, cell.limits)
    correct = correct and tally["failed"] == 0
    run_ = Run(cell, counters, units, lat, window_s, from_profiler(prof) if prof is not None else None,
               ref_searcher)
    if trace:
        log("trace read", t_start)
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": tally["attempted"], "failed": tally["failed"]}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], cell.root)(run_)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        dev_info.update(busy_s=run_.trace.busy_s, window_s=run_.trace.window_s)
        result["device"] = dev_info
        result["breakdown"] = run_.trace.breakdown()
    else:
        result["metrics"] = _end_to_end(cell, lat, units, window_s, peak, setup_s)
        result["device"] = dev_info
    result["checks"] = checks
    return result, {"errors": tally["errors"][:5]}
