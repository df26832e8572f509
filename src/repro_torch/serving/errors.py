"""Structured serving error taxonomy + terminal finish reasons.

Production serving treats overload and partial failure as the common
case, so every way a request can end — or be refused entry — has one
canonical name here. Two kinds of outcome:

  * **Exceptions** (raised to the caller of ``submit()`` / ``run()``):

      code                  raised by                   meaning
      ----------------------------------------------------------------
      invalid_request       submit()/generate()         prompt/max_new
                                                        can't be served
      queue_full            submit(), overload="reject" bounded queue at
                                                        capacity
      deadline_unmeetable   submit(), overload="reject" estimated queue
                                                        wait > budget
      watchdog_timeout      internal retry loop         retries exhausted
                                                        on a step fault
      invariant             Scheduler.check_invariants  slot-state machine
                                                        corrupted
      shutting_down         FrontDoor.submit            door is draining
      deadline_exceeded     TokenStream.result          request shed on a
                                                        deadline
      cancelled             TokenStream.result          request cancelled
      request_failed        TokenStream.result          numerics / fault /
                                                        wall-timeout shed

    ``error_for_reason(reason)`` maps a terminal finish reason to the
    exception class the front door raises for it.

  * **Finish reasons** (``RequestState.finish_reason`` on terminal
    requests — the shed/termination side of the taxonomy):

      completed          reached max_new_tokens (status "done")
      cancelled          cancel(rid) — user abort, queued or mid-decode
      deadline_ttft      TTFT deadline expired while queued
      deadline_e2e       end-to-end deadline expired mid-decode
      shed_queue         bounded-queue admission control, overload="shed"
      shed_est_wait      estimated wait exceeded the admission budget
      numerics_nonfinite non-finite logits — quarantined out of the batch
      fault_unrecoverable step fault persisted past the retry budget
      run_wall_timeout   run(max_wall_s=...) guard fired

All reasons other than "completed" leave the request with status
"shed"; tokens produced before the terminal event are retained.
"""
from __future__ import annotations

from typing import Optional


class ServingError(Exception):
    """Base of the serving taxonomy; `code` is the stable identifier."""
    code = "serving"


class InvalidRequest(ServingError, ValueError):
    """Request can never be served (bad shape/budget) — reject at the door."""
    code = "invalid_request"


class QueueFull(ServingError):
    """Bounded admission queue at capacity (overload="reject")."""
    code = "queue_full"


class DeadlineUnmeetable(ServingError):
    """Estimated queue wait exceeds the admission budget."""
    code = "deadline_unmeetable"


class TransientFault(ServingError):
    """A retryable step failure (the watchdog retries with backoff)."""
    code = "transient_fault"


class WatchdogTimeout(ServingError):
    """Retry budget exhausted on a persistently failing step."""
    code = "watchdog_timeout"


class InvariantViolation(ServingError, AssertionError):
    """Scheduler slot-state machine / accounting corruption detected."""
    code = "invariant"


class DeadlineExceeded(ServingError):
    """A per-request TTFT or end-to-end deadline expired (the request
    was shed; raised by TokenStream.result() at the front door)."""
    code = "deadline_exceeded"


class RequestCancelled(ServingError):
    """The request was cancelled (cancel(rid)) before completing."""
    code = "cancelled"


class RequestFailed(ServingError):
    """The request terminated on a fault path (numerics quarantine,
    unrecoverable step fault, serve-loop wall timeout)."""
    code = "request_failed"


class ShuttingDown(ServingError):
    """The front door is draining — no new admissions."""
    code = "shutting_down"


# ---------------------------------------------------- finish reasons ------

REASON_COMPLETED = "completed"
REASON_CANCELLED = "cancelled"
REASON_DEADLINE_TTFT = "deadline_ttft"
REASON_DEADLINE_E2E = "deadline_e2e"
REASON_SHED_QUEUE = "shed_queue"
REASON_SHED_WAIT = "shed_est_wait"
REASON_NUMERICS = "numerics_nonfinite"
REASON_FAULT = "fault_unrecoverable"
REASON_WALL = "run_wall_timeout"

SHED_REASONS = (REASON_CANCELLED, REASON_DEADLINE_TTFT, REASON_DEADLINE_E2E,
                REASON_SHED_QUEUE, REASON_SHED_WAIT, REASON_NUMERICS,
                REASON_FAULT, REASON_WALL)


def error_for_reason(reason):
    """Map a terminal finish_reason to the taxonomy exception class a
    front-door stream raises for it — None for "completed". This is the
    over-the-wire surface of the scheduler's shed semantics: the same
    structured reason a co-located caller reads off RequestState."""
    return {
        REASON_COMPLETED: None,
        REASON_CANCELLED: RequestCancelled,
        REASON_DEADLINE_TTFT: DeadlineExceeded,
        REASON_DEADLINE_E2E: DeadlineExceeded,
        REASON_SHED_QUEUE: QueueFull,
        REASON_SHED_WAIT: DeadlineUnmeetable,
        REASON_NUMERICS: RequestFailed,
        REASON_FAULT: RequestFailed,
        REASON_WALL: RequestFailed,
    }.get(reason, RequestFailed)


def validate_request(prompt_len: int, max_new_tokens: int, *,
                     cache_len: int, window: Optional[int]) -> None:
    """Shared front-door validation for Scheduler.submit / Engine.generate.

    Rejects requests that would otherwise surface as a cache-splice
    shape error (or silent KV overwrite) deep in the decode path:
    the prompt plus every decode write must fit the per-slot cache
    extent when no rolling window bounds it.
    """
    if max_new_tokens < 1:
        raise InvalidRequest(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len < 1:
        raise InvalidRequest(f"empty prompt (length {prompt_len})")
    if window is None and prompt_len > cache_len:
        raise InvalidRequest(
            f"prompt length {prompt_len} exceeds cache_len {cache_len}")
    if window is None and prompt_len + max_new_tokens - 1 > cache_len:
        raise InvalidRequest(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) - 1 "
            f"= {prompt_len + max_new_tokens - 1} exceeds cache_len "
            f"{cache_len}; shrink the request or grow the cache")
