"""Top-down eCP index construction (paper §3) — stable import site.

Re-exports the one-shot build of ``core/lifecycle.py``, as the reference's
``core/build.py`` does.
"""
from __future__ import annotations

from .lifecycle import ECPBuildConfig, build_index

__all__ = ["ECPBuildConfig", "build_index"]
