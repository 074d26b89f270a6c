"""The dry run on one device: trace every (arch x shape) cell at full size
without a card and without allocating, and read its peak memory and its
FLOPs.  The counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell on a 512-device fake CPU mesh and reads
XLA's memory analysis; here one device and torch's fake tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell is built with ``mesh_axes=None``; its meta args become fake
tensors inside one ``FakeTensorMode`` (shapes and dtypes, no storage), and
its ``fn`` runs once under
``torch.distributed._tools.mem_tracker.MemTracker`` (the peak of live
tensor bytes on the device, the args counted from the start) and
``torch.utils.flop_counter.FlopCounterMode`` (matrix products, and the
port's kernels through their custom ops' FLOP formulas).  The port's
optimizer and caches work in place, so a donated argument is counted
once.  The peak is the port's own trace, not a measurement: allocator
rounding and fragmentation and the CUDA context are not in it.

The fake tensors stand on the meta device, not on "cuda": a build of torch
without CUDA has no device guard for "cuda", and Python indexing of a fake
CUDA tensor needs one.  The kernels' wrappers send fake meta tensors down
the card's path, to their custom ops' fake kernels, so the trace is the one
a run on the card takes; the record counts each custom op's calls
(``kernel_calls``).

``--mesh single|multi|both``: the 40 cells on the production meshes
(16 x 16 = 256 ranks, 2 x 16 x 16 = 512), each traced as one rank of the
fake process group (``launch.mesh.process_group(backend="fake")``): the
cell is bound by ``lower_cell``, its args are that rank's shards (rank 0
by default: the first shard of an uneven cut is the largest, ceil(n /
ranks)), and its collectives run on fake tensors.  Per cell: the rank's
argument bytes, its traced peak, its FLOPs and its kernel calls (a
``retrieval_cand`` rank: one ``distance_topk``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from ..configs import ALL_CELLS, arch_shapes
from .cells import arg_leaves, build_cell, lower_cell, map_args

__all__ = ["H100_FIT_BYTES", "run_cell", "run_cell_mesh", "trace_cell", "trace_on_mesh", "main"]

MESH_RANKS = {"single": 256, "multi": 512}

# what a cell may trace to and still be run on one H100 (79.18 GiB usable):
# the rest is the CUDA context, the allocator's rounding and fragmentation
H100_FIT_BYTES = 72 * 2**30

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in arg_leaves(tree))


def _kernel_counter():
    """A dispatch mode that counts the calls of the port's custom ops (the
    kernels' launches on the card)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class KernelCalls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "repro_torch":
                self.calls[func.__name__.split(".")[0]] += 1
            return func(*args, **(kwargs or {}))

    return KernelCalls()


def trace_cell(cell, args=None, fn=None) -> dict:
    """Run ``cell.fn`` (or ``fn``) once on fake tensors shaped as
    ``cell.args`` (or ``args``): the traced peak of live bytes, the FLOPs
    and the custom ops' calls counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    # meta tensors a step makes itself (torch.tensor(..., device=x.device)) join the fake ones
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = lambda _name, t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        args = tuple(map_args(fake, a, pos=0) for a in (cell.args if args is None else args))
        tracker = MemTracker()
        tracker.track_external(*arg_leaves(args))
        flops = FlopCounterMode(display=False)
        kernels = _kernel_counter()
        # a serving step runs without autograd, as on the card; a train
        # step's value_and_grad turns it back on
        with tracker, flops, kernels, torch.no_grad():
            out = (fn or cell.fn)(*args)
        del out
        peak = max(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    return {"peak_bytes": int(peak), "flops_traced": int(flops.get_total_flops()),
            "kernel_calls": dict(kernels.calls), "trace_s": time.perf_counter() - t0}


def trace_on_mesh(cell, mesh) -> dict:
    """Trace this rank's step of ``cell`` (built with ``mesh``'s axis names)
    bound to ``mesh``: its args are the rank's shards (meta tensors)."""
    from ..distributed.elastic import map_specs
    from .mesh import local_shape

    local = map_specs(lambda t, ps: torch.empty(local_shape(t.shape, mesh, ps), dtype=t.dtype, device="meta"),
                      cell.args, cell.in_pspecs)
    return {"arg_bytes": _nbytes(local), "donated_bytes": sum(_nbytes(local[i]) for i in cell.donate),
            **trace_cell(cell, local, lower_cell(cell, mesh).step)}


def run_cell_mesh(arch: str, shape: str, mesh_name: str = "single", *, rank: int = 0,
                  verbose: bool = True) -> dict:
    """Trace ``arch`` x ``shape`` as rank ``rank`` of the fake process group
    on the production mesh ``mesh_name`` ("single": 16 x 16, "multi":
    2 x 16 x 16).  The record: the rank's argument bytes, traced peak,
    FLOPs and kernel calls, and ``fits_h100`` (that peak within
    ``H100_FIT_BYTES``)."""
    from .mesh import make_production_mesh, process_group

    with process_group(rank, MESH_RANKS[mesh_name], backend="fake"):
        mesh = make_production_mesh(mesh_name == "multi")
        cell = build_cell(arch, shape, mesh_axes=mesh.mesh_dim_names)
        rec = {"arch": arch, "shape": shape, "kind": cell.kind, "mesh": "x".join(map(str, mesh.shape)),
               "ranks": mesh.size(), "rank": rank, "coordinate": list(mesh.get_coordinate()),
               "n_params": int(cell.meta["n_params"]), "tokens": int(cell.meta.get("tokens", 0)),
               "pure_fsdp": bool(getattr(cell.meta["cfg"], "pure_fsdp", False)), **trace_on_mesh(cell, mesh)}
    rec["fits_h100"] = rec["peak_bytes"] <= H100_FIT_BYTES
    if verbose:
        print(f"[dryrun] {arch:28s} {shape:14s} mesh={rec['mesh']:9s} rank={rank:<3d} "
              f"args/rank={rec['arg_bytes'] / 2**30:8.3f}GiB peak/rank={rec['peak_bytes'] / 2**30:8.3f}GiB "
              f"flops/rank={rec['flops_traced']:.4e} kernels={rec['kernel_calls']} trace={rec['trace_s']:.1f}s",
              flush=True)
    return rec


def run_cell(arch: str, shape: str, *, batch: int | None = None, verbose: bool = True) -> dict:
    """Build ``arch`` x ``shape`` for one device (``batch``: the shape's
    batch replaced), trace it, and return the record: the reference's keys
    that mean something on one device and ``fits_h100`` (the traced peak
    within ``H100_FIT_BYTES``).  An LM cell traced at its shape's batch
    (``batch`` None) also records ``fit_batch``: the batch halved until the
    trace fits, down to the cell's microbatch count, and ``fit_peak_bytes``,
    its traced peak; both None where that does not fit."""
    cell = build_cell(arch, shape, mesh_axes=None, batch=batch)
    sh = dict(arch_shapes(arch)[shape])
    rec = {"arch": arch, "shape": shape, "kind": cell.kind,
           "batch": batch if batch is not None else sh.get("batch", sh.get("batch_nodes")),
           "n_params": int(cell.meta["n_params"]), "param_bytes": _nbytes(cell.args[0]),
           "arg_bytes": _nbytes(cell.args), "donated_bytes": sum(_nbytes(cell.args[i]) for i in cell.donate),
           "tokens": int(cell.meta.get("tokens", 0)), "n_candidates": int(cell.meta.get("n_candidates", 0)),
           **trace_cell(cell)}
    rec["fits_h100"] = rec["peak_bytes"] <= H100_FIT_BYTES
    if cell.meta["family"] == "lm" and batch is None:
        least = cell.meta["cfg"].microbatches if cell.kind == "train" else 1
        if rec["fits_h100"]:
            rec["fit_batch"], rec["fit_peak_bytes"] = rec["batch"], rec["peak_bytes"]
        else:
            rec["fit_batch"], rec["fit_peak_bytes"] = _fit_batch(arch, shape, rec, least)
    if verbose:
        print(f"[dryrun] {arch:28s} {shape:14s} batch={rec['batch']!s:<7} params={rec['n_params'] / 1e9:8.4f}B "
              f"args={rec['arg_bytes'] / 2**30:9.3f}GiB peak={rec['peak_bytes'] / 2**30:9.3f}GiB "
              f"fits={rec['fits_h100']!s:5s} fit_batch={rec.get('fit_batch', '-')!s:5s} "
              f"flops={rec['flops_traced']:.4e} trace={rec['trace_s']:.1f}s", flush=True)
    return rec


def _fit_batch(arch: str, shape: str, rec: dict, least: int) -> tuple[int | None, int | None]:
    """(the largest of batch/2, batch/4, ... not below ``least`` whose
    trace fits, its traced peak); (None, None) if ``least``'s does not:
    untraced when its args alone, live for the whole step, are over.  The
    peak grows about linearly in the batch, so the line through the traces
    at ``least`` and at the full batch says where to start; each candidate
    is traced."""
    peak = lambda b: trace_cell(build_cell(arch, shape, mesh_axes=None, batch=b))["peak_bytes"]
    if _nbytes(build_cell(arch, shape, mesh_axes=None, batch=least).args) > H100_FIT_BYTES:
        return None, None
    p0 = peak(least)
    if p0 > H100_FIT_BYTES:
        return None, None
    B = rec["batch"]
    per = (rec["peak_bytes"] - p0) / max(B - least, 1)
    b = B // 2
    while b > least and p0 + per * (b - least) > H100_FIT_BYTES:
        b //= 2
    while b > least:
        pb = peak(b)
        if pb <= H100_FIT_BYTES:
            return b, pb
        b //= 2
    return least, p0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Trace the cells on fake tensors: peak memory and FLOPs.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default=None,
                    help="trace the cells as one rank of the production mesh(es) instead of one device")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[3] / "dryrun_out"))
    args = ap.parse_args(argv)
    cells = (list(ALL_CELLS) if args.all
             else [(a, s) for a, s in ALL_CELLS if a == args.arch and args.shape in (None, s)])
    if not cells:
        raise SystemExit(f"no cells selected (arch={args.arch} shape={args.shape})")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.mesh:
        names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        for name in names:
            for arch, shape in cells:
                rec = run_cell_mesh(arch, shape, name)
                (out / f"dryrun_{name}_{arch}_{shape}.json").write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] {len(cells) * len(names)} mesh traces; records in {out}", flush=True)
        return 0
    recs = []
    for arch, shape in cells:
        rec = run_cell(arch, shape)
        (out / f"dryrun_{arch}_{shape}.json").write_text(json.dumps(rec, indent=1))
        recs.append(rec)
    print(f"[dryrun] {len(recs)} cells traced; {sum(r['fits_h100'] for r in recs)} fit one H100 "
          f"(peak <= {H100_FIT_BYTES / 2**30:.0f} GiB); records in {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
