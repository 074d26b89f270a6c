"""Launch layer of the port: the cells (``cells.py``: one step and its
abstract inputs per arch x shape) and their dry run on fake tensors
(``dryrun.py``), the trainer (``train.py``), the request scheduler and the
server (counterparts of the reference's ``launch/cells.py``,
``dryrun.py``, ``train.py``, ``scheduler.py`` and ``serve.py``).  Lazy, like the reference's package:
importing it loads no module until a name is asked for."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Cell": "cells",
    "build_cell": "cells",
    "example_inputs": "cells",
    "make_train_step": "cells",
    "run_cell": "dryrun",
    "Server": "serve",
    "ServeStats": "serve",
    "LatencyRing": "serve",
    "DeadlinePolicy": "scheduler",
    "RequestScheduler": "scheduler",
    "SnapshotManager": "scheduler",
    "ServerOverloadedError": "scheduler",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
