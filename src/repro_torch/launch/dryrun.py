"""The dry run on one device: trace every (arch x shape) cell at full size
without a card and without allocating, and read its peak memory and its
FLOPs.  The counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell on a 512-device fake CPU mesh and reads
XLA's memory analysis; here one device and torch's fake tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k

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
a run on the card takes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from ..configs import ALL_CELLS, arch_shapes
from .cells import arg_leaves, build_cell, map_args

__all__ = ["H100_FIT_BYTES", "run_cell", "trace_cell", "main"]

# what a cell may trace to and still be run on one H100 (79.18 GiB usable):
# the rest is the CUDA context, the allocator's rounding and fragmentation
H100_FIT_BYTES = 72 * 2**30

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in arg_leaves(tree))


def trace_cell(cell) -> dict:
    """Run ``cell.fn`` once on fake tensors: the traced peak of live bytes
    and the FLOPs counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    # meta tensors a step makes itself (torch.tensor(..., device=x.device)) join the fake ones
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = lambda _name, t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        args = tuple(map_args(fake, a, pos=0) for a in cell.args)
        tracker = MemTracker()
        tracker.track_external(*arg_leaves(args))
        flops = FlopCounterMode(display=False)
        # a serving step runs without autograd, as on the card; a train
        # step's value_and_grad turns it back on
        with tracker, flops, torch.no_grad():
            out = cell.fn(*args)
        del out
        peak = max(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    return {"peak_bytes": int(peak), "flops_traced": int(flops.get_total_flops()),
            "trace_s": time.perf_counter() - t0}


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
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[3] / "dryrun_out"))
    args = ap.parse_args(argv)
    cells = (list(ALL_CELLS) if args.all
             else [(a, s) for a, s in ALL_CELLS if a == args.arch and args.shape in (None, s)])
    if not cells:
        raise SystemExit(f"no cells selected (arch={args.arch} shape={args.shape})")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
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
