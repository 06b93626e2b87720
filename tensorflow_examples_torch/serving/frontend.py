"""HTTP frontend of the serving stack.

The port of ``tensorflow_examples_tpu/serving/frontend.py`` for the
endpoints this slice serves, on the same JSON contract:

* ``POST /generate`` — body ``{"prompt": [ids], "max_new_tokens": n,
  "temperature": t, "top_k": k, "seed": s, "eos_id": id,
  "deadline_s": d}`` (all but ``prompt`` optional). Replies
  ``{"tokens": [...], "prompt_len": n, "truncated": null,
  "queue_wait_s": ..., "ttft_s": ..., "total_s": ...}``. The fields the
  reference's router and prober add (``slo``, ``request_id``,
  ``resume_from``, ``trace``, ``probe``) are accepted and ignored.
* ``GET /metrics`` — the registry as Prometheus text.
* ``GET /health`` — JSON: draining flag, active and queued requests, KV
  occupancy (plus block occupancy and prefix hit rate on the paged
  pool) and the engine's ``post_warmup_recompiles``. 503 once draining.

Status mapping: ``QueueFull``/``Draining``/``BlockExhausted`` -> 503,
``DeadlineExceeded`` and request timeout -> 504, admission
``ValueError``/bad JSON -> 400, anything else -> 500 naming the
exception class.
"""

from __future__ import annotations

import concurrent.futures
import http.server
import json
import logging
import threading

from tensorflow_examples_torch.serving.batcher import (
    ContinuousBatcher,
    DeadlineExceeded,
    Draining,
    QueueFull,
    Request,
)
from tensorflow_examples_torch.serving.paged_kv import BlockExhausted
from tensorflow_examples_torch.telemetry.serve import json_safe, render_prometheus

log = logging.getLogger(__name__)

_MAX_BODY = 1 << 20  # 1 MiB of JSON is already a pathological prompt
_KNOWN_FIELDS = {
    "prompt", "text", "max_new_tokens", "temperature", "top_k", "seed",
    "eos_id", "deadline_s", "slo", "request_id", "resume_from", "trace",
    "probe",
}


def _request_from_body(body) -> Request:
    """Validated JSON body -> :class:`Request` (raises ValueError with a
    client-facing message on any malformed field)."""
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    if "prompt" not in body and "text" in body:
        raise ValueError("this server has no tokenizer; send token ids as 'prompt'")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool) for t in prompt)):
        raise ValueError("'prompt' must be a non-empty list of token ids")
    unknown = set(body) - _KNOWN_FIELDS
    if unknown:
        raise ValueError(f"unknown fields: {sorted(unknown)}")
    if body.get("slo", "interactive") not in ("interactive", "batch"):
        raise ValueError("'slo' must be 'interactive' or 'batch'")

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
    )


class ServingFrontend:
    """One daemon-threaded ``ThreadingHTTPServer``; request handlers
    block on batcher futures, scrape endpoints never do."""

    def __init__(self, batcher: ContinuousBatcher, *, port: int = 0,
                 bind_host: str = "127.0.0.1"):
        self.batcher = batcher
        self.requested_port = int(port)
        self.bind_host = bind_host
        self.port: int | None = None
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def handle_request(self, body) -> tuple[int, dict]:
        """(status, reply) for one /generate body — the HTTP handler minus
        the socket."""
        try:
            req = _request_from_body(body)
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
        return 200, {
            "tokens": result.tokens,
            "prompt_len": result.prompt_len,
            "truncated": result.truncated,
            "queue_wait_s": result.queue_wait_s,
            "ttft_s": result.ttft_s,
            "total_s": result.total_s,
        }

    def health_payload(self) -> tuple[int, dict]:
        batcher, pool = self.batcher, self.batcher.engine.pool
        body = {
            "ok": not batcher.draining,
            "draining": batcher.draining,
            "active_requests": batcher.active_requests,
            "queue_depth": batcher.queue_depth(),
            "slots": pool.num_slots,
            "kv_occupancy": pool.occupancy,
            "post_warmup_recompiles": batcher.engine.post_warmup_recompiles(),
        }
        paged = getattr(pool, "paged_stats", None)
        if callable(paged):
            stats = paged()
            body["kv_block_occupancy"] = stats["kv_block_occupancy"]
            body["kv_slot_occupancy"] = stats["kv_slot_occupancy"]
            body["prefix_hit_rate"] = stats["prefix_hit_rate"]
        return (200 if body["ok"] else 503), body

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
                try:
                    if path != "/generate":
                        self._send_json(404, {"error": "POST endpoints: /generate"})
                        return
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                    except ValueError:
                        n = -1
                    if n < 0:
                        self._send_json(400, {"error": "bad Content-Length header"})
                        return
                    if n > _MAX_BODY:
                        self._send_json(413, {"error": f"body exceeds {_MAX_BODY} bytes"})
                        return
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as e:
                        self._send_json(400, {"error": f"bad JSON: {e}"})
                        return
                    self._send_json(*server.handle_request(body))
                except ConnectionError:  # client went away mid-write
                    pass

            def do_GET(self):  # noqa: N802 - http.server contract
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        self._send(200, "text/plain; version=0.0.4; charset=utf-8",
                                   render_prometheus(server.batcher.registry).encode())
                    elif path == "/health":
                        self._send_json(*server.health_payload())
                    else:
                        self._send(404, "text/plain; charset=utf-8",
                                   b"GET: /metrics /health   POST: /generate\n")
                except ConnectionError:
                    pass

            def log_message(self, fmt, *args):  # quiet under load
                log.debug("serving frontend: " + fmt, *args)

        self._httpd = http.server.ThreadingHTTPServer(
            (self.bind_host, self.requested_port), Handler)
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
        """Idempotent; stops accepting connections."""
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)
