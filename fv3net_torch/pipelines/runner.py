"""Data-parallel pipeline runner (a copy of
``fv3net_tpu/pipelines/runner.py``; reference: workflows/dataflow, the
Beam jobs' map over timesteps with
``retry.with_exponential_backoff``).

``run_pipeline(items, transform, sink)`` maps a transform over items
with a bounded thread pool, retries a failed item with exponential
backoff and records the failures that remain (dead letters) instead of
raising; ``summarize`` counts them.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ItemResult:
    key: Any
    ok: bool
    attempts: int
    seconds: float
    error: Optional[str] = None
    value: Any = None


def with_exponential_backoff(
    fn: Callable, num_retries: int = 7, base_delay: float = 0.1,
    max_delay: float = 30.0,
):
    """(reference budget/pipeline.py:15-17 semantics)"""

    def wrapped(*args, **kwargs):
        delay = base_delay
        for attempt in range(num_retries + 1):
            try:
                return fn(*args, **kwargs)
            except Exception:
                if attempt == num_retries:
                    raise
                time.sleep(delay)
                delay = min(delay * 2.0, max_delay)

    return wrapped


def run_pipeline(
    items: Sequence[Any],
    transform: Callable[[Any], Any],
    sink: Optional[Callable[[Any, Any], None]] = None,
    max_workers: int = 4,
    num_retries: int = 2,
    base_delay: float = 0.05,
) -> List[ItemResult]:
    """Map ``transform`` over items with a bounded worker pool (threads:
    the compute lives on the device / in C extensions, so the GIL is not
    the limiter), retrying failed items with exponential backoff and
    optionally passing each result to ``sink(key, value)``.

    Returns per-item results; raises nothing — failures are recorded,
    mirroring Beam's dead-letter accounting.
    """

    def one(item) -> ItemResult:
        t0 = time.time()
        delay = base_delay
        for attempt in range(1, num_retries + 2):
            try:
                value = transform(item)
                if sink is not None:
                    sink(item, value)
                return ItemResult(item, True, attempt, time.time() - t0,
                                  value=value)
            except Exception as e:  # noqa: BLE001 — dead-letter semantics
                if attempt == num_retries + 1:
                    logger.warning("pipeline item %s failed: %s", item, e)
                    return ItemResult(item, False, attempt,
                                      time.time() - t0, error=str(e))
                time.sleep(delay)
                delay *= 2.0
        raise AssertionError("unreachable")

    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(one, items))


def summarize(results: Sequence[ItemResult]) -> Dict[str, Any]:
    ok = [r for r in results if r.ok]
    failed = [r for r in results if not r.ok]
    return {
        "n_items": len(results),
        "n_ok": len(ok),
        "n_failed": len(failed),
        "failed_keys": [r.key for r in failed],
        "total_seconds": round(sum(r.seconds for r in results), 3),
    }
