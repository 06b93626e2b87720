"""HTTP frontend and SIGTERM drain of the serving stack.

The port of ``tensorflow_examples_tpu/serving/frontend.py``, on the same
JSON contract, so the reference's router fronts a port replica unchanged:

* ``POST /generate`` — body ``{"prompt": [ids], "max_new_tokens": n,
  "temperature": t, "top_k": k, "seed": s, "eos_id": id,
  "deadline_s": d, "slo": "interactive"|"batch"}`` (all but ``prompt``
  optional; ``"text"`` may replace ``prompt`` when the frontend has a
  tokenizer). Replies ``{"tokens": [...], "prompt_len": n,
  "truncated": null, "queue_wait_s": ..., "ttft_s": ..., "total_s": ...}``
  (and ``"text"`` with a tokenizer). A body's ``trace`` (the router's
  trace context) is parsed tolerantly: a malformed one turns tracing off
  for the request and never fails it; a traced request's replica-side
  spans come back in the reply under ``"trace_spans"``, on every POST
  verb. The router's and prober's ``request_id``, ``resume_from`` and
  ``probe`` are accepted and ignored.
* ``POST /classify`` — the same body; replies the top-``top_n``
  next-token distribution ``{"top": [{"token": id, "logprob": lp}, ...]}``.
* ``POST /prefill`` / ``POST /resume`` — the disaggregated hand-off pair
  (paged pool only). ``/prefill`` (optionally with ``skip_tokens``) runs
  the prompt to its first token and replies ``{"first_token": id,
  "pages": {...}}`` (``serving/scheduler.py``'s wire format);
  ``/resume`` takes the generate body plus ``pages`` and ``first_token``
  (up to ``_MAX_RESUME_BODY``) and continues the stream, token for token
  a mixed replica's. A failed import answers 400 or 503 and never
  re-prefills: falling back is the router's call.
* ``GET /metrics`` — the registry as Prometheus text, with the worst
  recent TTFT and e2e of traced requests as exemplars (``trace_id``).
* ``GET /health`` — JSON: draining flag, load, KV occupancy,
  ``post_warmup_recompiles``, ``warmed``, ``role``, the brownout level
  and transitions, the paged pool's prefix digest (and its bloom filter
  past the key cap) and, with a watchdog, the serve loop's phase. 503
  once draining.
* ``GET /window`` — the batcher's latest ``kind="serving"`` stats line.
* ``GET /series`` — the time-series store (``telemetry/timeseries.py``),
  sampled by the serving process's stats tick.

Status mapping: ``QueueFull`` (queue or brownout shed) -> 503 with
``"shed": true``, ``BlockExhausted`` -> 503 with ``"exhausted": true``,
``Draining`` -> 503 with ``"draining": true``; ``DeadlineExceeded`` and a
request timeout -> 504; a malformed body or any admission
``ValueError`` -> 400; anything else -> 500 naming the exception class.
Armed serve faults (``utils/faults.py``) drop POSTs at the transport
level or poison ``/health``.

:func:`run_until_preempted` serves until SIGTERM/SIGINT, then drains:
new submits get 503, every accepted request finishes, the port closes,
exit code 0; a second signal force-quits (``train/resilience.py``'s
``PreemptionGuard``).
"""

from __future__ import annotations

import concurrent.futures
import http.server
import json
import logging
import socket
import threading
import time

from tensorflow_examples_torch.serving.batcher import (
    ContinuousBatcher,
    DeadlineExceeded,
    Draining,
    QueueFull,
    Request,
)
from tensorflow_examples_torch.serving.paged_kv import BlockExhausted
from tensorflow_examples_torch.telemetry import timeseries as timeseries_mod
from tensorflow_examples_torch.telemetry.serve import json_safe, render_prometheus
from tensorflow_examples_torch.train.resilience import PreemptionGuard
from tensorflow_examples_torch.utils import faults as faults_mod

log = logging.getLogger(__name__)

_MAX_BODY = 1 << 20  # 1 MiB of JSON is already a pathological prompt
# A /resume body carries a whole prompt's pages: GPT-2 124M at f32 is
# 2 * 12 layers * 12 heads * 64 * 4 B = 72 KiB a token, ~100 MiB after
# base64 for a 1024-token prompt.
_MAX_RESUME_BODY = 256 << 20
_POST_PATHS = ("/generate", "/classify", "/prefill", "/resume")
_KNOWN_FIELDS = frozenset({
    "prompt", "text", "max_new_tokens", "temperature", "top_k", "seed", "eos_id",
    "deadline_s", "top_n", "slo", "request_id", "resume_from", "trace", "probe",
})


class _TrackingHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer that keeps its live client connections, so
    :meth:`ServingFrontend.abort` can reset them as a dying process
    would. The accept backlog is deep enough that a burst is shed with
    503s, not refused at connect."""

    request_queue_size = 128

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.conn_lock = threading.Lock()
        self.live_connections: set = set()

    def process_request(self, request, client_address):
        with self.conn_lock:
            self.live_connections.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self.conn_lock:
            self.live_connections.discard(request)
        super().shutdown_request(request)


def _request_from_body(body, *, kind: str = "generate", tokenizer=None) -> Request:
    """Validated JSON body -> :class:`Request` (raises ValueError with the
    reference's client-facing message on any malformed field)."""
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    prompt = body.get("prompt")
    if prompt is None and "text" in body:
        if tokenizer is None:
            raise ValueError("this server has no tokenizer; send token ids as 'prompt'")
        if not isinstance(body["text"], str):
            raise ValueError("'text' must be a string")
        prompt = tokenizer.encode(body["text"])
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool) for t in prompt)):
        raise ValueError("'prompt' must be a non-empty list of token ids")
    known = _KNOWN_FIELDS | ({"pages", "first_token"} if kind == "resume" else
                             {"skip_tokens"} if kind == "prefill" else set())
    unknown = set(body) - known
    if unknown:
        raise ValueError(f"unknown fields: {sorted(unknown)}")
    slo = body.get("slo", "interactive")
    if slo not in ("interactive", "batch"):
        raise ValueError("'slo' must be 'interactive' or 'batch'")
    pages = first_token = None
    if kind == "resume":
        pages = body.get("pages")
        if not isinstance(pages, dict):
            raise ValueError("'pages' must be the prefill replica's page payload object")
        first_token = body.get("first_token")
        if not isinstance(first_token, int) or isinstance(first_token, bool):
            raise ValueError("'first_token' must be a token id")

    def number(name, default, cls=float, minimum=None, maximum=None):
        v = body.get(name, default)
        if v is None:
            if default is None:  # nullable fields (eos_id, deadline_s)
                return None
            raise ValueError(f"'{name}' must be a number")
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"'{name}' must be a number")
        if cls is int and isinstance(v, float) and not v.is_integer():
            raise ValueError(f"'{name}' must be an integer")
        v = cls(v)
        if minimum is not None and v < minimum:
            raise ValueError(f"'{name}' must be >= {minimum}")
        if maximum is not None and v > maximum:
            raise ValueError(f"'{name}' must be <= {maximum}")
        return v

    return Request(
        prompt=[int(t) for t in prompt],
        max_new_tokens=number("max_new_tokens", 16, int, 1),
        temperature=number("temperature", 0.0, float, 0.0),
        top_k=number("top_k", 0, int, 0),
        seed=number("seed", 0, int, 0, maximum=2**31 - 1),
        eos_id=number("eos_id", None, int, 0),
        deadline_s=number("deadline_s", None, float, 0.0),
        kind=kind,
        classify_top_n=number("top_n", 5, int, 1),
        pages=pages,
        first_token=first_token,
        skip_tokens=number("skip_tokens", 0, int, 0) if kind == "prefill" else 0,
        slo=slo,
        trace=(body["trace"] if isinstance(body.get("trace"), dict)
               and isinstance(body["trace"].get("trace_id"), str)
               and body["trace"]["trace_id"] else None),
    )


class ServingFrontend:
    """One daemon-threaded HTTP server; request handlers block on batcher
    futures, scrape endpoints never do."""

    def __init__(self, batcher: ContinuousBatcher, *, port: int = 0,
                 bind_host: str = "127.0.0.1", tokenizer=None):
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.requested_port = int(port)
        self.bind_host = bind_host
        self.port: int | None = None
        self._httpd: _TrackingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # GET /series; the serving process's stats tick samples it.
        self.series = timeseries_mod.TimeSeriesStore(batcher.registry)

    @property
    def replica_id(self) -> int:
        """This stack's replica index in a fleet (0 standalone): the key
        the serve fault engine targets."""
        return int(getattr(self.batcher.engine, "replica_id", 0))

    # ------------------------------------------------------------ payloads

    def handle_request(self, body, *, kind: str = "generate") -> tuple[int, dict]:
        """(status, reply) for one POST body of ``kind`` (generate,
        classify, prefill or resume): the HTTP handler minus the socket."""
        try:
            req = _request_from_body(body, kind=kind, tokenizer=self.tokenizer)
        except ValueError as e:
            return 400, {"error": str(e)}
        timeout = self.batcher.engine.cfg.request_timeout_s
        try:
            result = self.batcher.submit(req).result(timeout=timeout)
        except Draining as e:
            return 503, {"error": str(e), "draining": True}
        except QueueFull as e:
            return 503, {"error": str(e), "retry": True, "shed": True}
        except BlockExhausted as e:
            # "exhausted" tells a capacity shed apart from a policy shed:
            # the router counts it against the replica's breaker.
            return 503, {"error": str(e), "retry": True, "shed": True, "exhausted": True}
        except DeadlineExceeded as e:
            return 504, {"error": str(e)}
        except ValueError as e:
            return 400, {"error": str(e)}
        except concurrent.futures.TimeoutError:
            return 504, {"error": f"request timed out after {timeout}s"}
        except Exception as e:  # noqa: BLE001 — surface, don't crash
            log.exception("request failed")
            return 500, {"error": f"{type(e).__name__}: {e}"}
        reply: dict = {
            "prompt_len": result.prompt_len,
            "truncated": result.truncated,
            "queue_wait_s": result.queue_wait_s,
            "ttft_s": result.ttft_s,
            "total_s": result.total_s,
        }
        if kind == "classify":
            reply["top"] = result.top
        elif kind == "prefill":
            reply["first_token"] = result.tokens[0]
            reply["pages"] = result.pages
        else:
            reply["tokens"] = result.tokens
            if self.tokenizer is not None:
                reply["text"] = self.tokenizer.decode(result.tokens)
        if result.spans:
            reply["trace_spans"] = result.spans
        return 200, reply

    def health_payload(self) -> tuple[int, dict]:
        batcher = self.batcher
        engine = batcher.engine
        pool = engine.pool
        body = {
            "ok": not batcher.draining,
            "draining": batcher.draining,
            "active_requests": batcher.active_requests,
            "queue_depth": batcher.queue_depth(),
            "slots": pool.num_slots,
            "kv_occupancy": pool.occupancy,
            "post_warmup_recompiles": engine.post_warmup_recompiles(),
            "warmed": engine.warmed,
            "role": engine.cfg.role,
            "brownout_level": int(batcher.brownout_level),
            "brownout_transitions": int(batcher._overload.transitions()),
        }
        if getattr(engine, "param_sharding_digest", None):
            # A sharded engine: the reference's SHARDING_KEYS.
            body["mesh_shape"] = engine.mesh_shape
            body["param_sharding_digest"] = engine.param_sharding_digest
        paged = getattr(pool, "paged_stats", None)
        if callable(paged):
            stats = paged()
            body["kv_block_occupancy"] = stats["kv_block_occupancy"]
            body["kv_slot_occupancy"] = stats["kv_slot_occupancy"]
            body["prefix_hit_rate"] = stats["prefix_hit_rate"]
        digest = getattr(pool, "prefix_digest", None)
        if callable(digest):
            # The affinity summary the router matches prompts against.
            d = digest()
            body["prefix_block_size"] = pool.block_size
            body["prefix_blocks"] = d["blocks"]
            body["prefix_chains"] = d["chains"]
            body["prefix_digest"] = d["keys"]
            body["digest_truncated"] = bool(d.get("truncated"))
            if d.get("bloom"):
                body["prefix_bloom"] = d["bloom"]
        wd = batcher._watchdog
        if wd is not None:
            status = wd.status()
            body.update(phase=status["phase"], phase_age_secs=status["phase_age_secs"],
                        stalled_secs=status["stalled_secs"])
        return (200 if body["ok"] else 503), body

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "ServingFrontend":
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, status, content_type, payload: bytes):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _send_json(self, status, obj):
                self._send(status, "application/json",
                           (json.dumps(json_safe(obj)) + "\n").encode())

            def do_POST(self):  # noqa: N802 - http.server contract
                path = self.path.split("?", 1)[0].rstrip("/")
                feng = faults_mod.serve_active()
                if feng is not None and feng.transport_fault(server.replica_id):
                    # Drop with no response bytes: the client sees a reset.
                    self.close_connection = True
                    return
                if path not in _POST_PATHS:
                    self._send_json(404, {"error": "POST endpoints: /generate /classify "
                                                   "/prefill /resume"})
                    return
                max_body = _MAX_RESUME_BODY if path == "/resume" else _MAX_BODY
                try:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                    except ValueError:
                        n = -1
                    if n < 0:
                        self._send_json(400, {"error": "bad Content-Length header"})
                        return
                    if n > max_body:
                        self._send_json(413, {"error": f"body exceeds {max_body} bytes"})
                        return
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as e:
                        self._send_json(400, {"error": f"bad JSON: {e}"})
                        return
                    self._send_json(*server.handle_request(body, kind=path[1:]))
                except ConnectionError:  # client went away mid-write
                    pass

            def do_GET(self):  # noqa: N802 - http.server contract
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        self._send(200, "text/plain; version=0.0.4; charset=utf-8",
                                   render_prometheus(server.batcher.registry,
                                                     exemplars=server.batcher.exemplars).encode())
                    elif path == "/health":
                        feng = faults_mod.serve_active()
                        if feng is not None and feng.health_fault(server.replica_id):
                            self._send(200, "application/json", b"<<<not json at all>>>")
                            return
                        self._send_json(*server.health_payload())
                    elif path == "/window":
                        self._send_json(200, server.batcher.stats_line())
                    elif path == "/series":
                        self._send_json(200, server.series.to_payload())
                    else:
                        self._send(404, "text/plain; charset=utf-8",
                                   b"GET: /metrics /health /window /series   "
                                   b"POST: /generate /classify /prefill /resume\n")
                except ConnectionError:
                    pass

            def log_message(self, fmt, *args):  # quiet under load
                log.debug("serving frontend: " + fmt, *args)

        self._httpd = _TrackingHTTPServer((self.bind_host, self.requested_port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serving-frontend", daemon=True)
        self._thread.start()
        log.info("serving frontend live on port %d", self.port)
        return self

    def url(self, path: str = "/generate") -> str:
        return f"http://{self.bind_host or '127.0.0.1'}:{self.port}{path}"

    def close(self) -> None:
        """Idempotent; stops accepting connections (in-flight handlers
        finish their writes)."""
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)

    def abort(self) -> None:
        """Die as a killed process would: stop listening and reset every
        in-flight client connection (callers see a transport failure,
        never an HTTP status). Safe from any thread."""
        with self._lock:
            httpd, self._httpd = self._httpd, None
            self._thread = None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except OSError:
            pass
        with httpd.conn_lock:
            conns = list(httpd.live_connections)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def run_until_preempted(frontend: ServingFrontend, *, poll_s: float = 0.2,
                        drain_timeout_s: float = 60.0, guard=None) -> int:
    """Serve until SIGTERM/SIGINT, then drain and return 0: the batcher
    refuses new work (503), every accepted request runs to completion,
    the port closes. A second signal force-quits. ``guard`` is anything
    with ``.install()`` and ``.requested`` (a test's stand-in)."""
    if guard is None:
        guard = PreemptionGuard()
    guard.install()
    batcher = frontend.batcher
    try:
        while not guard.requested:
            time.sleep(poll_s)
        log.warning("preemption requested: draining %d active + %d queued requests",
                    batcher.active_requests, batcher.queue_depth())
        batcher.registry.counter("serving/preemptions").inc()
        batcher.close(drain=True, timeout=drain_timeout_s)
        log.info("drain complete; shutting down frontend")
        return 0
    finally:
        frontend.close()
        if not batcher._stop.is_set():
            batcher.close(drain=False)
        if hasattr(guard, "uninstall"):
            guard.uninstall()
