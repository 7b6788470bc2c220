"""App registry: plugin-path strings -> app callables."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from ..utils.native_build import ensure_plugins

_APPS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _APPS[name] = fn
        return fn
    return deco


def resolve(path: str) -> Callable:
    """``python:echo`` / ``echo`` -> registered app; ``pkg.mod:fn`` -> import;
    ``exec:/path/to/bin`` or a path to a real executable -> native plugin
    (runs the unmodified binary under the LD_PRELOAD interposer,
    process/native.py — the reference's `<plugin path=...>` equivalent).
    A native plugin first builds the port's preload shim and pool helper
    (utils/native_build.py); a build that fails raises."""
    import os
    if path.startswith("exec:"):
        from ..process.native import make_native_app
        ensure_plugins()
        return make_native_app(path[5:])
    if path.startswith("pool:") or (path.endswith(".so")
                                    and os.path.isfile(path)):
        # shared-object plugins are pooled: many dlmopen namespaces per
        # helper process (the reference's elf-loader model)
        from ..process.native import make_pooled_app
        ensure_plugins()
        return make_pooled_app(path[5:] if path.startswith("pool:") else path)
    name = path[7:] if path.startswith("python:") else path
    _ensure_builtins()
    if name in _APPS:
        return _APPS[name]
    if os.path.sep in path and os.path.isfile(path) and os.access(path, os.X_OK):
        from ..process.native import make_native_app
        ensure_plugins()
        return make_native_app(path)
    if ":" in name:
        mod, _, fn = name.partition(":")
        return getattr(importlib.import_module(mod), fn)
    raise ValueError(f"unknown program {path!r}; registered: {sorted(_APPS)}")


def _ensure_builtins() -> None:
    from . import (echo, filetransfer, tgen, phold, blast,  # noqa: F401
                   tor, bitcoin, httpd)  # noqa: F401
