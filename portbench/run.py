"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload packed.batch128 --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds ``src/repro_torch`` (the program)
and ``BENCHMARK.json``.  The last line of standard output is the result
(JSON); the numbers the check compared, each beside its limit, are the
last lines of standard error and the result's last key.  Exits non-zero,
with no result, without a CUDA card, without the program, or when the
JAX package or JAX is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# one host thread per library call: the serving threads already use the
# cores, and threads per call on top of them only add jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build cache of the program stays inside the checkout, at a fixed path
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import harness

    torch.set_num_threads(1)

    cell = harness.Cell.find(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: no program here (src/repro_torch is missing)", file=sys.stderr)
        return 2
    tmp = Path(os.environ.get("TMPDIR") or ROOT / "build" / "tmp") / "portbench" / args.workload
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        result, extra = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                    workdir=tmp, t_start=T0, cell=cell)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for err in extra["errors"]:
        print(f"portbench: a request failed: {err}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
