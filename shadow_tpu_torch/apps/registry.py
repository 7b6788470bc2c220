"""App registry: plugin-path strings -> app callables."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

_APPS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _APPS[name] = fn
        return fn
    return deco


def resolve(path: str) -> Callable:
    """``python:echo`` / ``echo`` -> registered app; ``pkg.mod:fn`` -> import.
    Native plugins (``exec:``/``pool:``, a ``.so`` or an executable path)
    run under the JAX package's LD_PRELOAD interposer (process/native.py),
    which the port has not ported: they raise NotImplementedError."""
    import os
    name = path[7:] if path.startswith("python:") else path
    native = (path.startswith(("exec:", "pool:"))
              or (path.endswith(".so") and os.path.isfile(path)))
    if not native:
        _ensure_builtins()
        if name in _APPS:
            return _APPS[name]
        native = (os.path.sep in path and os.path.isfile(path)
                  and os.access(path, os.X_OK))
    if native:
        raise NotImplementedError(
            f"native plugin {path!r}: exec:/pool: plugins are not ported "
            "yet: ROADMAP A15")
    if ":" in name:
        mod, _, fn = name.partition(":")
        return getattr(importlib.import_module(mod), fn)
    raise ValueError(f"unknown program {path!r}; registered: {sorted(_APPS)}")


def _ensure_builtins() -> None:
    from . import (echo, filetransfer, tgen, phold, blast,  # noqa: F401
                   tor, bitcoin, httpd)  # noqa: F401
