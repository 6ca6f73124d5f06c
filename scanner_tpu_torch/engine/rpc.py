"""Minimal gRPC plumbing: named methods with msgpack-serialized dict
payloads.

Capability parity: the reference's control plane (scanner/engine/rpc.proto
service Master/Worker + grpc glue in util/grpc.h).  Instead of protoc
codegen, methods are registered dynamically on a generic handler — the
message schema lives in the handlers, serialization is msgpack (numpy-aware,
via storage.metadata pack/unpack).
"""

from __future__ import annotations

import random as _random
import threading
import time
from concurrent import futures
from typing import Any, Callable, Dict, Optional

import grpc

from ..common import ScannerException
from ..storage.metadata import pack, unpack
from ..util import faults as _faults
from ..util import metrics as _mx
from ..util import tracing as _tracing
from ..util.log import get_logger
from ..util.retry import call_with_backoff

_log = get_logger("rpc")

# per-process jitter factor for the channel reconnect pacing below: a
# fleet of workers that all lost the same master would otherwise share
# identical backoff caps and redial in lockstep — every survivor of a
# master restart hitting the fresh listener in the same 100 ms window.
# One multiplicative draw per process (seeded from the default RNG, so
# distinct across forks) decorrelates the fleet; call-level full-jitter
# backoff (util/retry.py) plus the process retry budget handle the rest.
_RECONNECT_JITTER = _random.uniform(0.7, 1.3)

GRPC_OPTIONS = [
    ("grpc.max_send_message_length", 1 << 30),
    ("grpc.max_receive_message_length", 1 << 30),
    # cap the CHANNEL-level reconnect backoff (gRPC default maxes at
    # 120s): a client whose peer is down for a while — a worker riding
    # out a master restart, wait_for_server polling a still-booting
    # server — would otherwise accumulate minutes of redial delay and
    # stay UNAVAILABLE long after the peer is actually back.  Our own
    # call-level full-jitter backoff handles politeness; the channel
    # just needs to redial promptly (with the per-process jitter above
    # so a whole fleet does not redial on one clock).
    ("grpc.initial_reconnect_backoff_ms", int(100 * _RECONNECT_JITTER)),
    ("grpc.min_reconnect_backoff_ms", int(100 * _RECONNECT_JITTER)),
    ("grpc.max_reconnect_backoff_ms", int(2000 * _RECONNECT_JITTER)),
]

# server-side handler latency (includes msgpack (de)serialization, not
# network time) — the live flavor of the profiler's RPC spans
_M_RPC_LATENCY = _mx.registry().histogram(
    "scanner_tpu_rpc_latency_seconds",
    "Server-side RPC handler latency by method (deserialize + handler + "
    "serialize).",
    labels=["method"])

# high-frequency poll/liveness methods: their traceparent still
# propagates (handlers can read the current context) but no server span
# is minted per call — a 4 Hz status poll over a long bulk would churn
# the flight recorder with nothing a timeline needs
_SPAN_SKIP = frozenset({"Ping", "Heartbeat", "GetJobStatus",
                        "GetMetrics", "PokeWatchdog"})


class RpcError(ScannerException):
    pass


class _GenericService(grpc.GenericRpcHandler):
    def __init__(self, service_name: str,
                 methods: Dict[str, Callable[[dict], dict]],
                 tracer: Optional[_tracing.Tracer] = None):
        self._prefix = f"/{service_name}/"
        self._methods = methods
        self._tracer = tracer

    def _handle(self, short_name: str, method, req: dict) -> dict:
        """Re-establish the caller's trace context around the handler:
        the `_traceparent` payload key (injected by RpcClient.call) is
        popped before the handler sees the request, and a server span
        `rpc:<Method>` is opened under it — the cross-host hop in the
        assembled task timeline."""
        ctx = _tracing.parse_traceparent(req.pop(
            _tracing.TRACEPARENT_KEY, None))
        tracer = self._tracer
        if ctx is None or tracer is None or not _tracing.enabled():
            return method(req)
        if short_name in _SPAN_SKIP:
            with _tracing.use_context(tracer, ctx):
                return method(req)
        with _tracing.start_span(tracer, f"rpc:{short_name}",
                                 parent=ctx):
            return method(req)

    def service(self, handler_call_details):
        name = handler_call_details.method
        if not name.startswith(self._prefix):
            return None
        method = self._methods.get(name[len(self._prefix):])
        if method is None:
            return None

        short_name = name[len(self._prefix):]

        def unary(request: bytes, context) -> bytes:
            t0 = time.time()
            try:
                if _faults.ACTIVE:
                    _faults.inject("rpc.server.handle", detail=short_name)
                return pack(self._handle(short_name, method,
                                         unpack(request)))
            except Exception as e:  # noqa: BLE001
                # the server-side stack would otherwise be discarded:
                # only "type: msg" crosses the wire in the INTERNAL
                # status, which is useless for debugging a handler bug
                _log.exception("RPC %s failed server-side", short_name)
                context.set_code(grpc.StatusCode.INTERNAL)
                context.set_details(f"{type(e).__name__}: {e}")
                return b""
            finally:
                _M_RPC_LATENCY.labels(method=short_name).observe(
                    time.time() - t0)

        return grpc.unary_unary_rpc_method_handler(unary)


class RpcServer:
    """One gRPC server hosting one named service."""

    def __init__(self, service_name: str,
                 methods: Dict[str, Callable[[dict], dict]],
                 port: int = 0, max_workers: int = 8,
                 tracer: Optional[_tracing.Tracer] = None):
        # handler threads are named for their service, and the pool is
        # shut down with the server: an in-process cluster that stops
        # leaves no thread behind
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix=f"rpc-{service_name}")
        self._server = grpc.server(self._pool, options=GRPC_OPTIONS)
        self._server.add_generic_rpc_handlers(
            (_GenericService(service_name, methods, tracer=tracer),))
        self.port = self._server.add_insecure_port(f"0.0.0.0:{port}")
        if self.port == 0:
            raise RpcError(f"could not bind port {port}")

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        """Stop serving (in-flight calls get `grace` seconds), then
        release the handler threads.  Never joins them: stop may run
        on one of them (a handler that shuts its own server down)."""
        self._server.stop(grace).wait(grace + 5.0)
        self._pool.shutdown(wait=False)


class RpcClient:
    """Stub for a remote service; call(method, **payload) -> dict.

    Transient transport failures (UNAVAILABLE — connection refused/reset,
    the server not yet listening) are retried with full-jitter exponential
    backoff, the analog of the reference's GRPC_BACKOFF wrapper
    (scanner/util/grpc.h, worker.cpp:886).  Only UNAVAILABLE is retried by
    default: the request provably never reached the server, so retrying
    cannot double-execute a non-idempotent method like NextWork.
    """

    def __init__(self, address: str, service_name: str,
                 timeout: float = 30.0, retries: int = 3,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0):
        self.address = address
        self._service = service_name
        self._timeout = timeout
        self._retries = retries
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap
        self._channel = grpc.insecure_channel(address, options=GRPC_OPTIONS)

    @staticmethod
    def _transient(e: Exception) -> bool:
        return isinstance(e, grpc.RpcError) \
            and e.code() == grpc.StatusCode.UNAVAILABLE

    def call(self, method: str, timeout: Optional[float] = None,
             retries: Optional[int] = None, **payload) -> dict:
        fn = self._channel.unary_unary(
            f"/{self._service}/{method}",
            request_serializer=lambda x: x,
            response_deserializer=lambda x: x)
        # context propagation: the current span context (if any) rides
        # in the payload as `_traceparent`; the server glue pops it and
        # re-establishes the context around the handler, so one
        # trace_id follows a job across every hop with no handler
        # signature changing
        tp = _tracing.current_traceparent()
        if tp is not None:
            payload.setdefault(_tracing.TRACEPARENT_KEY, tp)
        req = pack(payload)
        # fault-plan selector detail: "<method>@<peer>" — method=/peer=
        # rule keys (and plain match= substrings) select per-RPC-method
        # and per-peer, so a plan can model an ASYMMETRIC partition
        # (this peer unreachable, others fine)
        detail = f"{method}@{self.address}"

        def attempt():
            # chaos hook fires per ATTEMPT (inside the backoff loop): an
            # injected UNAVAILABLE storm exercises the same retry path a
            # flapping network would
            if _faults.ACTIVE:
                _faults.inject("rpc.client.call", detail=detail)
            raw_reply = fn(req, timeout=timeout or self._timeout)
            if _faults.ACTIVE and _faults.take_duplicate(
                    "rpc.client.call", detail=detail):
                # duplicate delivery: the identical request hits the
                # server a second time and the first reply is dropped —
                # at-least-once semantics after an ambiguous timeout.
                # Only the server-side idempotency/dedup machinery
                # (RPC_CONTRACTS, NewJob admission tokens) may make
                # this safe; that is exactly what the drill verifies.
                raw_reply = fn(req, timeout=timeout or self._timeout)
            return raw_reply

        try:
            raw = call_with_backoff(
                attempt,
                is_transient=self._transient,
                retries=self._retries if retries is None else retries,
                base=self._backoff_base, cap=self._backoff_cap,
                # UNAVAILABLE retries become visible per method:
                # scanner_tpu_retry_attempts_total{site="rpc:NextWork"}
                label=f"rpc:{method}")
        except grpc.RpcError as e:
            raise RpcError(
                f"{self._service}.{method} @ {self.address}: "
                f"{e.code().name}: {e.details()}") from e
        return unpack(raw)

    def try_call(self, method: str, timeout: Optional[float] = None,
                 retries: Optional[int] = None, **payload) -> Optional[dict]:
        """call() that returns None on transport errors (for pings)."""
        try:
            return self.call(method, timeout=timeout, retries=retries,
                             **payload)
        except RpcError:
            return None
        except ValueError as e:
            # grpc raises ValueError ("Cannot invoke RPC on closed
            # channel!") after close() — treat a racing shutdown like any
            # other transport failure so ping/heartbeat threads die
            # quietly; any other ValueError is a real bug, let it surface
            if "closed channel" in str(e):
                return None
            raise

    def close(self) -> None:
        self._channel.close()


def wait_for_server(address: str, service: str, method: str = "Ping",
                    timeout: float = 10.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        # a FRESH channel per attempt: a channel first dialed while the
        # server was not yet listening can wedge in connection-refused
        # long after the server is up (observed under sandboxed network
        # stacks, where the reconnect path keeps failing while a new
        # channel connects instantly).  This loop is the retry policy,
        # so per-call retries stay off.
        c = RpcClient(address, service, timeout=2.0)
        try:
            if c.try_call(method, retries=0) is not None:
                return
        finally:
            c.close()
        # jittered poll: a fleet of workers waiting out one master
        # restart must not re-probe on a shared 250 ms clock
        time.sleep(_random.uniform(0.15, 0.35))
    raise RpcError(f"{service} at {address} not reachable "
                   f"after {timeout}s")
