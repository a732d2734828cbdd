"""HTTP inference front door (counterpart of
``paddle_tpu/serving/frontdoor.py``): OpenAI-style ``/v1/completions``
on the ops port.

* **wire protocol** — ``POST /v1/completions`` takes OpenAI-style JSON
  (``prompt`` as token ids: the repo has no tokenizer, so text is the
  space-joined id string) and answers a completion document, or streams
  Server-Sent Events (``stream: true``): one ``data:`` chunk a token, a
  final chunk carrying ``finish_reason``, then ``data: [DONE]``;
  ``GET /v1/models`` lists the model;
* **admission control** — a per-tenant token bucket (cost = prompt
  tokens + ``max_tokens``) sheds an over-budget tenant with 429 and a
  ``Retry-After`` before the request reaches the engine; a full
  scheduler queue answers 503 with the scheduler's own estimate
  (``QueueFullError.queue_depth``/``est_wait_s``);
* **identity** — the tenant comes off the wire (``Authorization: Bearer
  <key>`` through ``api_keys``, or the ``X-Tenant`` header) and rides
  the request into the scheduler's weighted-fair (lane, tenant) classes,
  the flight recorder's per-tenant goodput and the shed counters. The
  lane comes from the body's ``lane`` or ``X-Lane`` (one of
  :data:`LANES`).

Transport: the threaded standard-library server of
:class:`~.opsserver.OpsServer` — ``FrontDoor.mount(ops)`` adds the
routes to an ops server, so ``/metrics`` and ``/v1/completions`` share
one port (``FrontDoor.start()`` builds and owns one bound to
127.0.0.1). One OS thread a live connection; the SSE loop is a blocking
iterator over ``handle.stream()``. The front door never touches the
device: it enqueues work and drains host-side token queues.

Errors (all JSON; the server thread survives each): 400 malformed JSON,
oversized body, a bad ``prompt``, ``lane`` or ``max_tokens``, a
per-request ``top_k``/``top_p`` unlike the engine's, a prompt that can
never fit; 401 an unknown bearer key; 404 an unknown path; 429 a tenant
over its token budget (``serving_tenant_shed``); 503 a full queue or a
closed engine.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, Iterable, Optional, Tuple

from ..framework import metrics as _metrics
from ..framework.monitor import stat_add
from .scheduler import DeadlineExceeded, QueueFullError, RequestCancelled

__all__ = ["FrontDoor", "TokenBucket", "LANES"]

# the scheduler's admission lanes (weights live on the engine); the wire
# rejects anything else with 400 instead of minting ad-hoc classes
LANES = ("interactive", "batch")

_MODEL_ID = "paddle-tpu"


class TokenBucket:
    """Classic token bucket: ``burst`` capacity, ``rate`` tokens/s refill.

    ``try_take(cost)`` is the whole API: 0.0 means admitted (cost
    debited), a positive return is the seconds until the bucket could
    cover ``cost`` — the honest ``Retry-After``. A cost above ``burst``
    can never be admitted (the level is capped); the returned wait is
    computed as if the bucket were uncapped — always positive, so the
    caller always sheds — and a client that retries on schedule and
    still sees 429 should split the request. Thread-safe; monotonic
    clock."""

    __slots__ = ("rate", "burst", "_level", "_t", "_lock")

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"rate and burst must be > 0, got rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._level = float(burst)
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, cost: float) -> float:
        cost = float(cost)
        with self._lock:
            now = time.monotonic()
            self._level = min(self.burst,
                              self._level + (now - self._t) * self.rate)
            self._t = now
            if cost <= self._level:
                self._level -= cost
                return 0.0
            return (cost - self._level) / self.rate

    def __repr__(self):
        return f"<TokenBucket rate={self.rate}/s burst={self.burst}>"


class FrontDoor:
    """The OpenAI-style completions surface over one engine (or fleet).

    ``engine`` is anything with the ``submit(prompt_ids, max_new_tokens,
    **kwargs) -> handle`` contract (a ``GenerationEngine`` or an
    ``EngineFleet``). Admission knobs:

    * ``rate_tokens_per_s`` / ``burst_tokens`` — the default per-tenant
      token bucket (None = no rate limit);
    * ``tenant_limits`` — ``{tenant: (rate, burst)}`` overrides;
    * ``api_keys`` — ``{bearer_key: tenant}``; when set, a request with
      an ``Authorization: Bearer`` header MUST present a known key
      (401 otherwise). Requests without one fall back to ``X-Tenant``
      or ``default_tenant`` — key-only deployments should front this
      with their key requirement (this is a paper repro, not a vault).
    * ``max_body_bytes`` — requests with a larger Content-Length are
      refused with 400 before the body is read.

    Mount on an existing ops server (``door.mount(srv)``) or let
    ``door.start()`` build one::

        door = FrontDoor(engine, rate_tokens_per_s=500, burst_tokens=2000)
        srv = door.start()               # owns an OpsServer
        requests.post(srv.url + "/v1/completions", json={...})
        door.close()
    """

    def __init__(self, engine: Any, *,
                 rate_tokens_per_s: Optional[float] = None,
                 burst_tokens: Optional[float] = None,
                 tenant_limits: Optional[Dict[str, Tuple[float, float]]] = None,
                 api_keys: Optional[Dict[str, str]] = None,
                 default_tenant: str = "default",
                 default_max_tokens: int = 16,
                 max_body_bytes: int = 1 << 20,
                 registry: Optional[_metrics.MetricsRegistry] = None):
        self._engine = engine
        self._rate = None if rate_tokens_per_s is None \
            else float(rate_tokens_per_s)
        self._burst = float(burst_tokens) if burst_tokens is not None \
            else (None if self._rate is None else 4.0 * self._rate)
        self._tenant_limits = dict(tenant_limits or {})
        self._api_keys = dict(api_keys or {})
        self._default_tenant = str(default_tenant)
        self._default_max_tokens = int(default_max_tokens)
        self._max_body_bytes = int(max_body_bytes)
        self._registry = registry if registry is not None \
            else _metrics.registry()
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self._served = 0
        self._streamed = 0
        self._shed: Dict[str, int] = {}
        self._ops: Optional[Any] = None      # owned server, if start()ed

    # -- mounting ------------------------------------------------------------
    def mount(self, ops: Any) -> "FrontDoor":
        """Register this front door's routes in an
        :class:`~.opsserver.OpsServer` route table — completions and
        /metrics then share that server's process and port."""
        ops.add_route("POST", "/v1/completions", self._handle_completions)
        ops.add_route("GET", "/v1/models", self._handle_models)
        return self

    def start(self, host: str = "127.0.0.1", port: int = 0):
        """Build, mount on and start an owned ops server bound to the
        engine (health/tracez reflect it); returns the server — read
        ``srv.url`` for the base address. ``close()`` shuts it down."""
        from .opsserver import OpsServer
        if self._ops is None:
            self._ops = OpsServer(target=self._engine, host=host, port=port,
                                  registry=self._registry)
            self.mount(self._ops)
        return self._ops.start()

    def close(self) -> None:
        ops, self._ops = self._ops, None
        if ops is not None:
            ops.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- admission -----------------------------------------------------------
    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                if tenant in self._tenant_limits:
                    rate, burst = self._tenant_limits[tenant]
                elif self._rate is not None:
                    rate, burst = self._rate, self._burst
                else:
                    return None
                b = self._buckets[tenant] = TokenBucket(rate, burst)
            return b

    def _resolve_tenant(self, h) -> Tuple[Optional[str], Optional[str]]:
        """(tenant, None) or (None, error message) for a 401."""
        auth = h.headers.get("Authorization", "")
        if auth.startswith("Bearer ") and self._api_keys:
            key = auth[len("Bearer "):].strip()
            tenant = self._api_keys.get(key)
            if tenant is None:
                return None, "unknown API key"
            return tenant, None
        tenant = h.headers.get("X-Tenant")
        if tenant:
            return str(tenant).strip(), None
        return self._default_tenant, None

    def _count_shed(self, tenant: str, reason: str) -> None:
        stat_add("serving/tenant_shed")
        with self._lock:
            self._shed[tenant] = self._shed.get(tenant, 0) + 1
        try:
            self._registry.inc("serving_tenant_shed", 1,
                               tenant=tenant, reason=reason)
        except Exception:                                # noqa: BLE001
            pass

    # -- wire helpers --------------------------------------------------------
    @staticmethod
    def _reply(h, code: int, doc: Any,
               headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(doc, default=repr).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            h.send_header(k, str(v))
        h.end_headers()
        h.wfile.write(data)

    @classmethod
    def _reply_error(cls, h, code: int, message: str, etype: str,
                     headers: Optional[Dict[str, str]] = None,
                     **extra) -> None:
        cls._reply(h, code,
                   {"error": {"message": message, "type": etype, **extra}},
                   headers)

    def _read_body(self, h) -> Tuple[Optional[dict], Optional[str]]:
        """(parsed body, None) or (None, error) — the error is the 400
        message; an oversized Content-Length is refused UNREAD so a
        hostile body never buffers."""
        try:
            length = int(h.headers.get("Content-Length") or 0)
        except (TypeError, ValueError):
            return None, "invalid Content-Length"
        if length <= 0:
            return None, "a JSON body is required"
        if length > self._max_body_bytes:
            return None, (f"body of {length} bytes exceeds the "
                          f"{self._max_body_bytes} byte limit")
        raw = h.rfile.read(length)
        try:
            body = json.loads(raw)
        except (ValueError, UnicodeDecodeError) as e:
            return None, f"malformed JSON body: {e}"
        if not isinstance(body, dict):
            return None, "the JSON body must be an object"
        return body, None

    @staticmethod
    def _parse_prompt(body: dict) -> Tuple[Optional[list], Optional[str]]:
        prompt = body.get("prompt", body.get("prompt_ids"))
        if isinstance(prompt, int):
            prompt = [prompt]
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt):
            return None, ("'prompt' must be a non-empty list of token ids "
                          "(ints) — this serving stack is tokenizer-free")
        return prompt, None

    # -- finish-reason / documents -------------------------------------------
    @staticmethod
    def _finish_reason(handle, error: Optional[BaseException]) -> str:
        if isinstance(error, DeadlineExceeded):
            return "deadline"
        if isinstance(error, RequestCancelled):
            return "cancelled"
        if error is not None:
            return "error"
        eos = getattr(handle, "eos_token_id", None)
        toks = getattr(handle, "tokens", ())
        if eos is not None and toks and toks[-1] == eos:
            return "stop"
        return "length"

    @staticmethod
    def _completion_doc(rid: int, tokens: Iterable[int], n_prompt: int,
                        finish_reason: str) -> dict:
        toks = [int(t) for t in tokens]
        return {"id": f"cmpl-{rid}",
                "object": "text_completion",
                "model": _MODEL_ID,
                "choices": [{"index": 0,
                             "text": " ".join(str(t) for t in toks),
                             "token_ids": toks,
                             "finish_reason": finish_reason}],
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": len(toks),
                          "total_tokens": n_prompt + len(toks)}}

    # -- route handlers ------------------------------------------------------
    def _handle_models(self, h) -> None:
        self._reply(h, 200, {"object": "list",
                             "data": [{"id": _MODEL_ID, "object": "model",
                                       "owned_by": "paddle_tpu_torch"}]})

    def _handle_completions(self, h) -> None:
        tenant, auth_err = self._resolve_tenant(h)
        if auth_err is not None:
            self._reply_error(h, 401, auth_err, "invalid_api_key")
            return
        body, body_err = self._read_body(h)
        if body_err is not None:
            self._reply_error(h, 400, body_err, "invalid_request_error")
            return
        prompt, prompt_err = self._parse_prompt(body)
        if prompt_err is not None:
            self._reply_error(h, 400, prompt_err, "invalid_request_error")
            return
        lane = str(body.get("lane") or h.headers.get("X-Lane")
                   or "interactive")
        if lane not in LANES:
            self._reply_error(
                h, 400, f"lane must be one of {list(LANES)}, got {lane!r}",
                "invalid_request_error")
            return
        try:
            max_tokens = int(body.get("max_tokens",
                                      self._default_max_tokens))
        except (TypeError, ValueError):
            self._reply_error(h, 400, "'max_tokens' must be an int",
                              "invalid_request_error")
            return
        stream = bool(body.get("stream", False))

        # per-tenant token-bucket admission BEFORE the engine sees the
        # request: cost is the request's whole token footprint
        bucket = self._bucket(tenant)
        if bucket is not None:
            retry_s = bucket.try_take(len(prompt) + max(1, max_tokens))
            if retry_s > 0:
                self._count_shed(tenant, "rate_limit")
                self._reply_error(
                    h, 429,
                    f"tenant {tenant!r} is over its token budget; retry "
                    f"in {retry_s:.2f}s", "rate_limit_exceeded",
                    headers={"Retry-After": max(1, math.ceil(retry_s))},
                    retry_after_s=round(retry_s, 3), tenant=tenant)
                return

        kwargs: Dict[str, Any] = {"tenant": tenant, "lane": lane}
        for wire, kw in (("temperature", "temperature"),
                         ("do_sample", "do_sample"),
                         ("top_k", "top_k"), ("top_p", "top_p"),
                         ("eos_token_id", "eos_token_id"),
                         ("timeout_s", "timeout")):
            if body.get(wire) is not None:
                kwargs[kw] = body[wire]
        try:
            handle = self._engine.submit(prompt, max_tokens, **kwargs)
        except QueueFullError as e:
            self._count_shed(tenant, "queue_full")
            retry = getattr(e, "est_wait_s", None)
            self._reply_error(
                h, 503, str(e), "overloaded",
                headers={"Retry-After": max(1, math.ceil(retry))
                         if retry else 1},
                queue_depth=getattr(e, "queue_depth", None),
                est_wait_s=retry, tenant=tenant)
            return
        except (ValueError, TypeError) as e:
            self._reply_error(h, 400, str(e), "invalid_request_error")
            return
        except RuntimeError as e:
            # PoolCapacityError is a RuntimeError too — but capacity is
            # the CLIENT's prompt being too big: that one is a 400
            if type(e).__name__ == "PoolCapacityError":
                self._reply_error(h, 400, str(e), "invalid_request_error")
            else:
                self._reply_error(h, 503, str(e), "overloaded")
            return

        with self._lock:
            self._served += 1
            if stream:
                self._streamed += 1
        if stream:
            self._stream_response(h, handle, len(prompt))
        else:
            self._unary_response(h, handle, len(prompt))

    # -- response bodies -----------------------------------------------------
    def _unary_response(self, h, handle, n_prompt: int) -> None:
        # collect by draining the host-side stream queue: result() pads
        # the row and blocks on the whole request instead
        tokens, err = [], None
        try:
            for tok in handle.stream():
                tokens.append(int(tok))
        except (DeadlineExceeded, RequestCancelled) as e:
            err = e
        self._reply(h, 200, self._completion_doc(
            handle.id, tokens, n_prompt, self._finish_reason(handle, err)))

    def _stream_response(self, h, handle, n_prompt: int) -> None:
        """SSE over HTTP/1.0 connection-close framing: one ``data:``
        JSON chunk per token as the scheduler produces it, a final
        chunk with ``finish_reason`` + usage, then ``data: [DONE]``."""
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("X-Accel-Buffering", "no")
        h.end_headers()
        rid = f"cmpl-{handle.id}"

        def emit(doc: Any) -> None:
            h.wfile.write(b"data: " + json.dumps(doc).encode() + b"\n\n")
            h.wfile.flush()

        n, err = 0, None
        try:
            try:
                for tok in handle.stream():
                    emit({"id": rid, "object": "text_completion.chunk",
                          "model": _MODEL_ID,
                          "choices": [{"index": 0, "token_id": int(tok),
                                       "text": f"{int(tok)} ",
                                       "finish_reason": None}]})
                    n += 1
            except (DeadlineExceeded, RequestCancelled) as e:
                err = e
            emit({"id": rid, "object": "text_completion.chunk",
                  "model": _MODEL_ID,
                  "choices": [{"index": 0, "token_id": None, "text": "",
                               "finish_reason":
                               self._finish_reason(handle, err)}],
                  "usage": {"prompt_tokens": n_prompt,
                            "completion_tokens": n,
                            "total_tokens": n_prompt + n}})
            h.wfile.write(b"data: [DONE]\n\n")
            h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream: stop generating for it
            handle.cancel()

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"served": self._served,
                    "streamed": self._streamed,
                    "shed": dict(self._shed),
                    "shed_total": sum(self._shed.values()),
                    "tenants_seen": sorted(
                        set(self._buckets) | set(self._shed))}

    def __repr__(self):
        s = self.stats()
        return (f"<FrontDoor served={s['served']} "
                f"shed={s['shed_total']} engine={self._engine!r}>")
