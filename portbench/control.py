"""The control of a cell's check, and the collection's statistics.

    python3 portbench/control.py --workload packed.batch128 --seeds 11 12 13 [--precision tfloat32]

Puts the reference in the program's place at the cell's own size (a cell
of BENCHMARK.json or of ``held_out/``): it builds the index (a
federation: each shard) and serves as
many of the cell's requests as a run compares, every distance in
``--precision``, and holds what it served to the float64 reference by the
run's own check.  At ``tfloat32`` (the precision just below the
configuration's float32 with TF32 off) and at bfloat16 ``correct`` has to
come out false; at float64 it is the reference against itself.  Each seed
prints one JSON line with the numbers, the limits, and, at float64, the
collection's leaf sizes and recall@100 against an exact search.  The
benchmark's runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from portbench import check, collection, reference, traffic  # noqa: E402
from portbench.harness import Cell  # noqa: E402


def requests(cell: Cell, data: torch.Tensor, rot: torch.Tensor) -> list[np.ndarray]:
    """As many of the cell's requests (query rows) as a run compares, the
    clients' sessions taken in turn."""
    want = int(cell.traffic["check_requests"])
    pools = [traffic.pool(cell.traffic, data, rot, c) for c in range(int(cell.traffic["clients"]))]
    out = [r.queries for i in range(max(len(p) for p in pools)) for p in pools if i < len(p) for r in p[i]]
    return out[:want]


@torch.no_grad()
def exact_top(data: torch.Tensor, q: np.ndarray, k: int, rows: int = 1 << 17) -> np.ndarray:
    """Each query row's exact k nearest items by cosine (float32)."""
    qn = reference.unit(torch.as_tensor(q, device=data.device), torch.float32)
    best_d = torch.full((len(q), k), float("inf"), device=data.device)
    best_i = torch.zeros((len(q), k), dtype=torch.int64, device=data.device)
    for lo in range(0, data.shape[0], rows):
        d = 1.0 - qn @ reference.unit(data[lo : lo + rows], torch.float32).T
        d_all = torch.cat([best_d, d], 1)
        i_all = torch.cat([best_i, torch.arange(lo, lo + d.shape[1], device=data.device).expand(len(q), -1)], 1)
        top = torch.topk(d_all, k, dim=1, largest=False)
        best_d, best_i = top.values, torch.gather(i_all, 1, top.indices)
    return best_i.cpu().numpy()


def run_control(cell: Cell, seed: int, dtype, device: str, *, stats: bool = False) -> dict:
    cfg = cell.config
    rot = collection.rotation(seed, int(cfg["dim"]), device)
    data = collection.make(cfg, rot, device)
    federated = "shards" in cfg
    index = (reference.build_shards if federated else reference.build)(data, cfg, dtype)
    k = int(cfg["k"])
    n_pages = 1 + int(cell.traffic["more_per_query"])
    queries = np.concatenate(requests(cell, data, rot))
    served = reference.make_searcher(data, index, cfg, dtype).pages(queries, n_pages)
    numbers, judged = check.index_numbers(data, cfg, None, seed, stored=index)
    judge = reference.make_searcher(data, judged, cfg, torch.float64)
    numbers.update(check.page_numbers(judge, queries, served))
    correct, checks = check.decide(numbers, cell.limits)
    out = {"workload": cell.name, "seed": seed, "precision": str(dtype).replace("torch.", ""),
           "correct": correct, "checks": checks}
    if stats:
        indexes = index if federated else [index]
        sample = queries[:: max(1, len(queries) // 256)][:256]
        top = exact_top(data, sample, k)
        first = [p[0][0] for p in judge.pages(sample, 1)]
        out["leaf_rows"] = [leaf_rows(ix, cfg) for ix in indexes]
        out["recall_at_k"] = float(np.mean([len(np.intersect1d(a, t)) / k for a, t in zip(first, top)]))
        if federated:
            probed = np.array([len(s) for s in judge.splits(queries)])
            out["rows_probing"] = {str(m): int((probed == m).sum()) for m in range(1, len(indexes) + 1)}
        else:
            # the reference's pages are slices of the leaves a search opens:
            # they hold every page served only where those leaves hold n_pages * k rows
            out["opened_rows_min"] = int(min(sum(len(judged.members[j]) for j in leaves)
                                             for leaves in judge.opened(queries)))
        out["served_rows"] = n_pages * k
        g_topic, g_size = collection.layout(cfg["data"], int(cfg["n_items"]))
        topic_of = np.repeat(g_topic, g_size)
        out["topics_with_a_level1_node"] = [int(len(np.unique(topic_of[ix.leaders[: ix.nodes[0]]]))) for ix in indexes]
    return out


def leaf_rows(index: reference.Index, cfg: dict) -> dict:
    """An index's leaf sizes, and the float32 block packed mode would
    hold for it (every leaf padded to the largest)."""
    sizes = np.array([len(m) for m in index.members])
    return {"items": int(sizes.sum()), "leaves": len(sizes), "max": int(sizes.max()), "p50": float(np.median(sizes)),
            "p99": float(np.percentile(sizes, 99)), "over_cap": int((sizes > int(cfg["cluster_cap"])).sum()),
            "empty": int((sizes == 0).sum()), "packed_block_bytes": int(len(sizes) * sizes.max() * int(cfg["dim"]) * 4)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default=reference.TF32, choices=(reference.TF32, "bfloat16", "float64"))
    args = p.parse_args(argv)
    cell = Cell.find(args.workload, held_out=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        dtype = args.precision if args.precision == reference.TF32 else getattr(torch, args.precision)
        out = run_control(cell, seed, dtype, "cuda", stats=args.precision == "float64")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
