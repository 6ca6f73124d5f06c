"""Exponential backoff with jitter for transient failures.

Capability parity: the reference wraps every cross-process call in
``GRPC_BACKOFF`` (reference scanner/util/grpc.h, used e.g.
worker.cpp:886) and its storehouse layer retries transient storage
errors.  One shared helper serves both the RPC client (UNAVAILABLE
channels) and the GCS backend (429/5xx).

Retries are no longer silent: each retry increments the live
``scanner_tpu_retry_attempts_total{site=...}`` counter (util/metrics.py),
and a final give-up after real retries logs at WARNING with the
accumulated backoff wait — an operator watching /metrics or the log sees
a flapping dependency before it becomes a job failure.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, TypeVar

from . import metrics as _mx
from .log import get_logger

T = TypeVar("T")

_log = get_logger("retry")

_M_RETRIES = _mx.registry().counter(
    "scanner_tpu_retry_attempts_total",
    "Transient-failure retries by call site (rpc:<method>, gcs, ...).",
    labels=["site"])
_M_BUDGET_DENIED = _mx.registry().counter(
    "scanner_tpu_retry_budget_exhausted_total",
    "Retries refused by the per-process retry budget (token bucket): "
    "the call fails fast instead of joining a retry storm.  Nonzero "
    "means the process is burning retries faster than successes "
    "replenish them — a dependency is down, not flapping.",
    labels=["site"])


class RetryBudget:
    """Per-process retry token bucket (the gRPC retry-throttling
    scheme): every retry withdraws one token, every overall success
    deposits `token_ratio`; retries are only allowed while the bucket
    sits above half capacity.  Per-call backoff handles *politeness*
    for an individual flap — the budget handles *aggregate* sanity: a
    whole worker fleet re-dialing a restarting master must converge to
    fail-fast instead of multiplying a storm, and the full-jitter
    delays (backoff_delays) decorrelate the survivors."""

    def __init__(self, max_tokens: float = 500.0,
                 token_ratio: float = 0.5):
        self.max_tokens = float(max_tokens)
        self.token_ratio = float(token_ratio)
        self._tokens = self.max_tokens
        self._lock = threading.Lock()

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self.max_tokens,
                               self._tokens + self.token_ratio)

    def take(self) -> bool:
        """Withdraw one retry token; False (no withdrawal) when the
        bucket is at or below half capacity — the caller should fail
        fast."""
        with self._lock:
            if self._tokens <= self.max_tokens / 2:
                return False
            self._tokens -= 1.0
            return True

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def reset(self) -> None:
        with self._lock:
            self._tokens = self.max_tokens


# the process-wide default budget every call_with_backoff shares;
# capacity 500 / floor 250 is far above anything a healthy process
# retries, while a sustained storm (thousands of retries, no
# successes) trips fail-fast within seconds
_BUDGET = RetryBudget()


def process_budget() -> RetryBudget:
    return _BUDGET


def backoff_delays(retries: int, base: float = 0.05, cap: float = 2.0,
                   rng: Optional[random.Random] = None):
    """Yield `retries` sleep durations: full-jitter exponential backoff
    (delay_i uniform in [0, min(cap, base * 2**i)]) — the AWS
    'full jitter' scheme, which decorrelates thundering herds."""
    r = rng or random
    for i in range(retries):
        yield r.uniform(0.0, min(cap, base * (2.0 ** i)))


def retry_until_deadline(fn: Callable[[], T], *,
                         is_transient: Callable[[Exception], bool],
                         deadline: float, base: float = 0.25,
                         cap: float = 2.0,
                         sleep: Callable[[float], None] = time.sleep,
                         rng: Optional[random.Random] = None,
                         label: str = "",
                         budget: Optional[RetryBudget] = None) -> T:
    """Like call_with_backoff, but bounded by a wall-clock `deadline`
    instead of an attempt count — for calls that must ride out a peer
    restart of UNKNOWN duration and are safe to repeat end-to-end
    (idempotent by design, e.g. the token-deduped NewJob admission:
    the server returns the already-admitted bulk on a repeat).  The
    shared process retry budget still applies, so a fleet-wide outage
    converges to fail-fast instead of a deadline-long storm."""
    r = rng or random
    budget = _BUDGET if budget is None else budget
    attempt = 0
    while True:
        try:
            result = fn()
            budget.on_success()
            return result
        except Exception as e:  # noqa: BLE001
            if not is_transient(e) or time.time() >= deadline:
                raise
            if not budget.take():
                _M_BUDGET_DENIED.labels(site=label or "other").inc()
                _log.warning(
                    "retry budget exhausted%s: failing fast after %d "
                    "deadline-bounded retries: %s: %s",
                    f" [{label}]" if label else "", attempt,
                    type(e).__name__, e)
                raise e from None
            attempt += 1
            _M_RETRIES.labels(site=label or "other").inc()
            from . import tracing as _tracing
            _tracing.add_event("retry", site=label or "other",
                               attempt=attempt,
                               error=f"{type(e).__name__}: "
                                     f"{str(e)[:120]}")
            # full jitter, capped — and never sleeping past the
            # deadline itself
            delay = r.uniform(0.0, min(cap, base * (2.0 ** min(
                attempt, 8))))
            sleep(min(delay, max(0.0, deadline - time.time())))


def call_with_backoff(fn: Callable[[], T], *,
                      is_transient: Callable[[Exception], bool],
                      retries: int = 4, base: float = 0.05,
                      cap: float = 2.0,
                      sleep: Callable[[float], None] = time.sleep,
                      rng: Optional[random.Random] = None,
                      label: str = "",
                      budget: Optional[RetryBudget] = None) -> T:
    """Run fn(); on a transient exception retry up to `retries` times with
    full-jitter exponential backoff.  Non-transient exceptions and the
    final transient failure propagate unchanged.  `label` names the call
    site in the retry counter and the give-up log line.  Every retry
    withdraws from `budget` (default: the shared process budget) and
    every overall success deposits back: when the process as a whole is
    retrying faster than it succeeds, remaining calls fail fast instead
    of stampeding a recovering dependency."""
    delays = backoff_delays(retries, base=base, cap=cap, rng=rng)
    budget = _BUDGET if budget is None else budget
    attempts = 0
    waited = 0.0
    while True:
        try:
            result = fn()
            budget.on_success()
            return result
        except Exception as e:  # noqa: BLE001
            if not is_transient(e):
                raise
            try:
                delay = next(delays)
            except StopIteration:
                if attempts:
                    # only after real retries: retries=0 callers (e.g.
                    # wait_for_server's own poll loop) stay quiet
                    _log.warning(
                        "giving up%s after %d retries (%.2fs accumulated "
                        "backoff): %s: %s",
                        f" [{label}]" if label else "", attempts, waited,
                        type(e).__name__, e)
                raise e from None
            if not budget.take():
                # the PROCESS is out of retry budget (a storm, not a
                # flap): fail fast instead of piling more redials onto
                # a recovering dependency
                _M_BUDGET_DENIED.labels(site=label or "other").inc()
                _log.warning(
                    "retry budget exhausted%s: failing fast after %d "
                    "local retries: %s: %s",
                    f" [{label}]" if label else "", attempts,
                    type(e).__name__, e)
                raise e from None
            attempts += 1
            waited += delay
            _M_RETRIES.labels(site=label or "other").inc()
            # transient retries become events on the active trace span:
            # the merged timeline shows which task's call flapped
            from . import tracing as _tracing
            _tracing.add_event("retry", site=label or "other",
                               attempt=attempts,
                               error=f"{type(e).__name__}: {str(e)[:120]}")
            sleep(delay)
