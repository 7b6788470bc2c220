"""Task: a schedulable closure.

Mirrors the capability of the reference's refcounted Task
(core/work/task.c:24 ``task_new`` / :68 ``task_execute``): a callback bound to
an object and an argument.  Python's GC replaces the manual refcount/free-func
machinery; we keep the (callback, obj, arg) shape so call sites read the same.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class Task:
    __slots__ = ("callback", "obj", "arg", "name")

    def __init__(self, callback: Callable[[Any, Any], None], obj: Any = None,
                 arg: Any = None, name: str = ""):
        self.callback = callback
        self.obj = obj
        self.arg = arg
        self.name = name or getattr(callback, "__name__", "task")

    def execute(self) -> None:
        self.callback(self.obj, self.arg)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Task({self.name})"
