"""Serving layer of the port: the request scheduler and the server
(counterparts of the reference's ``launch/scheduler.py`` and
``launch/serve.py``).  Lazy, like the reference's package: importing it
loads neither module until a name is asked for."""
from __future__ import annotations

import importlib

_EXPORTS = {
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
