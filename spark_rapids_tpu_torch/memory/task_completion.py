"""Task-scoped completion callbacks with error isolation.

The port's copy of ``spark_rapids_tpu/memory/task_completion.py``
(``TaskScope`` :20, ``on_task_completion`` :46, ``task_scope`` :57): a
task scope runs its callbacks newest first when it exits, each isolated
so that one that raises cannot starve the rest, then raises one error
for them.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

_tls = threading.local()


class TaskScope:
    def __init__(self, task_id: int):
        self.task_id = task_id
        self._callbacks: List[Callable] = []

    def on_completion(self, fn: Callable) -> None:
        self._callbacks.append(fn)

    def _run_all(self) -> List[BaseException]:
        errors: List[BaseException] = []
        for fn in reversed(self._callbacks):   # newest first
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - isolate each
                errors.append(e)
        self._callbacks.clear()
        return errors


def current_task() -> Optional[TaskScope]:
    return getattr(_tls, "scope", None)


def on_task_completion(fn: Callable) -> bool:
    """Register against the current task; False when no task runs."""
    scope = current_task()
    if scope is None:
        return False
    scope.on_completion(fn)
    return True


class task_scope:
    """Context manager around one partition task."""

    _next_id = [0]
    _lock = threading.Lock()

    def __enter__(self) -> TaskScope:
        with task_scope._lock:
            task_scope._next_id[0] += 1
            tid = task_scope._next_id[0]
        self._prev = getattr(_tls, "scope", None)
        _tls.scope = TaskScope(tid)
        return _tls.scope

    def __exit__(self, exc_type, exc, tb):
        scope = _tls.scope
        _tls.scope = self._prev
        errors = scope._run_all()
        if errors and exc is None:
            raise RuntimeError(
                f"{len(errors)} task-completion callback(s) failed: "
                f"{errors[0]!r}") from errors[0]
        # with an exception in flight, the callbacks' errors are secondary
        return False
