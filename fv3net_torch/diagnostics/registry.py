"""Diagnostics registry (reference:
workflows/diagnostics/fv3net/diagnostics/_shared/registry.py:12-35):
named diagnostic functions computed over a common argument and merged,
with per-function failure isolation.

Host copy of ``fv3net_tpu/diagnostics/registry.py``.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Tuple

logger = logging.getLogger(__name__)


class Registry:
    def __init__(self, merge: Callable[[List[Tuple[str, Any]]], Any]):
        self.funcs: Dict[str, Callable] = {}
        self.merge = merge

    def register(self, name: str):
        def decorator(func):
            if name in self.funcs:
                raise ValueError(f"diagnostic {name!r} already registered")
            self.funcs[name] = func
            return func

        return decorator

    def compute(self, *args, allow_errors: bool = False, **kwargs) -> Any:
        outputs = []
        for name, func in self.funcs.items():
            try:
                outputs.append((name, func(*args, **kwargs)))
            except Exception:
                if not allow_errors:
                    raise
                logger.exception("diagnostic %s failed; skipping", name)
        return self.merge(outputs)
