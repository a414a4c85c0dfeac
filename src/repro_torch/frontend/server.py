"""Async HTTP/SSE front door over the orchestrator, stdlib only (the port
of ``repro.frontend.server``).

One asyncio server (hand-rolled HTTP/1.1: four routes need no web
framework) plus one *stepper thread* that owns the orchestrator's drive
loop. The event loop never blocks on a device step: handlers submit under
the orchestrator lock and then await an ``asyncio.Queue`` that the stepper
feeds through ``loop.call_soon_threadsafe``. With in-process replicas the
stepper thread runs their CUDA work; each engine step runs under
``torch.no_grad`` on the thread that calls it (``Engine._on_ranks``).

Routes:

  ``POST /generate``  body ``{"prompt": [ids...], "max_new_tokens": n,
                      "class": "interactive", "temperature": t,
                      "top_k": k, "top_p": p, "seed": s,
                      "session": "..."}`` →
                      ``text/event-stream``: one ``data: {"rid", "token"}``
                      event per token, then ``data: {"done": true,
                      "tokens": [...]}``. Typed admission failures map to
                      429 (retryable: budget/SLO, with ``Retry-After``) /
                      503 (draining, no live replica) / 400 (request can
                      never be served), JSON body carrying the
                      ``Rejection`` fields.
  ``GET /metrics``    merged Prometheus exposition (orchestrator +
                      every worker under ``worker=<i>`` labels).
  ``GET /plan``       the per-replica worker spec (plan dict, engine
                      knobs, init seed, smoke, device) + worker count:
                      clients rebuild an in-process reference from it.
  ``GET /healthz``    ``{"ok": true, "live_replicas": n}``.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.engine.scheduler import Rejection
from repro_torch.frontend.orchestrator import Orchestrator

_DONE = object()

#: Rejection reasons that are server-state, not client-error (503).
_UNAVAILABLE = {"draining", "no_live_replica"}


def status_for(rej: Rejection) -> int:
    if rej.reason in _UNAVAILABLE:
        return 503
    return 429 if rej.retryable else 400


class FrontendServer:
    def __init__(self, orch: Orchestrator, *, host: str = "127.0.0.1",
                 port: int = 8080, worker_spec: Optional[Dict] = None,
                 workers: int = 0, step_interval_s: float = 0.0,
                 step_time_hint_s: float = 0.5):
        self.orch = orch
        self.host = host
        self.port = port
        self.worker_spec = worker_spec or {}
        self.workers = workers
        self.step_interval_s = step_interval_s
        # Retry-After = retry_after_steps * this (measured once running)
        self.step_time_hint_s = step_time_hint_s
        self._queues: Dict[int, asyncio.Queue] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop = threading.Event()
        self._stepper: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None

    # ---- the drive loop (own thread; never on the event loop) -----------
    def _step_loop(self) -> None:
        while not self._stop.is_set():
            if self.orch.idle():
                time.sleep(0.005)
                continue
            t0 = time.monotonic()
            emitted = self.orch.step()
            dt = time.monotonic() - t0
            if dt > 0:
                # smooth measured step time into the Retry-After hint
                self.step_time_hint_s = \
                    0.8 * self.step_time_hint_s + 0.2 * dt
            done = [rid for rid in list(self._queues)
                    if self.orch.stream_done(rid)]
            if (emitted or done) and self._loop is not None:
                self._loop.call_soon_threadsafe(
                    self._deliver, list(emitted), done)
            if self.step_interval_s:
                time.sleep(self.step_interval_s)

    def _deliver(self, emitted, done) -> None:
        for rid, tok in emitted:
            q = self._queues.get(rid)
            if q is not None:
                q.put_nowait(tok)
        for rid in done:
            q = self._queues.get(rid)
            if q is not None:
                q.put_nowait(_DONE)

    # ---- HTTP plumbing ---------------------------------------------------
    @staticmethod
    async def _read_request(reader) -> Optional[Dict[str, Any]]:
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode("latin-1").split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", 0) or 0)
        if n:
            body = await reader.readexactly(n)
        return {"method": method, "path": path.split("?", 1)[0],
                "headers": headers, "body": body}

    @staticmethod
    def _response(status: int, body: bytes, content_type: str,
                  extra_headers: Dict[str, str] = {}) -> bytes:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests",
                  503: "Service Unavailable"}.get(status, "OK")
        head = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        head += [f"{k}: {v}" for k, v in extra_headers.items()]
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body

    def _json(self, status: int, obj: Dict,
              extra_headers: Dict[str, str] = {}) -> bytes:
        return self._response(status, json.dumps(obj).encode(),
                              "application/json", extra_headers)

    async def _handle(self, reader, writer) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            if req["method"] == "POST" and req["path"] == "/generate":
                await self._generate(req, writer)
            elif req["method"] == "GET" and req["path"] == "/metrics":
                text = await asyncio.to_thread(self.orch.metrics_text)
                writer.write(self._response(
                    200, text.encode(), "text/plain; version=0.0.4"))
            elif req["method"] == "GET" and req["path"] == "/plan":
                writer.write(self._json(200, {
                    **self.worker_spec, "workers": self.workers}))
            elif req["method"] == "GET" and req["path"] == "/healthz":
                writer.write(self._json(200, {
                    "ok": bool(self.orch.live()),
                    "live_replicas": len(self.orch.live()),
                    "draining": self.orch.draining}))
            else:
                writer.write(self._json(404, {"error": "not_found"}))
            await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _generate(self, req: Dict[str, Any], writer) -> None:
        try:
            body = json.loads(req["body"] or b"{}")
            prompt = [int(t) for t in body["prompt"]]
            max_new = int(body.get("max_new_tokens", 16))
        except (KeyError, TypeError, ValueError) as e:
            writer.write(self._json(400, {"error": "bad_request",
                                          "detail": str(e)}))
            return
        out = self.orch.submit(
            prompt, max_new, cls=body.get("class", "interactive"),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=int(body.get("seed", 0)),
            session=body.get("session"))
        if isinstance(out, Rejection):
            status = status_for(out)
            headers = {}
            if out.retry_after_steps is not None:
                headers["Retry-After"] = str(max(int(
                    out.retry_after_steps * self.step_time_hint_s), 1))
            writer.write(self._json(status, {
                "error": out.reason, "detail": out.detail,
                "retry_after_steps": out.retry_after_steps}, headers))
            return
        rid = out
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = q
        head = ["HTTP/1.1 200 OK", "Content-Type: text/event-stream",
                "Cache-Control: no-cache", "Connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        tokens = []
        try:
            while True:
                item = await q.get()
                if item is _DONE:
                    break
                tokens.append(int(item))
                writer.write(
                    f"data: {json.dumps({'rid': rid, 'token': item})}"
                    "\n\n".encode())
                await writer.drain()
            done = {"done": True, "rid": rid, "tokens": tokens}
            writer.write(f"data: {json.dumps(done)}\n\n".encode())
            await writer.drain()
        finally:
            self._queues.pop(rid, None)

    # ---- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stepper = threading.Thread(target=self._step_loop,
                                         name="frontend-stepper",
                                         daemon=True)
        self._stepper.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    def shutdown(self, drain: bool = True) -> None:
        """Stop the stepper, drain the orchestrator, close the listener.
        Callable from any thread (the SIGTERM handler)."""
        self._stop.set()
        if self._stepper is not None:
            self._stepper.join(30.0)
        self.orch.shutdown(drain=drain)
        if self._loop is not None and self._server is not None:
            self._loop.call_soon_threadsafe(self._server.close)


def run_server(orch: Orchestrator, *, host: str = "127.0.0.1",
               port: int = 8080, worker_spec: Optional[Dict] = None,
               workers: int = 0,
               install_signal_handlers: bool = True) -> None:
    """Blocking entry point of ``launch.serve --http``: serve until
    SIGTERM/SIGINT, then drain (finish the streams in flight, flush
    host-tier spills, join the workers) and return. The signal handlers
    are installed only when called from the main thread, the one thread
    a signal handler may be set from."""
    import signal

    srv = FrontendServer(orch, host=host, port=port,
                         worker_spec=worker_spec, workers=workers)

    async def _main():
        await srv.start()
        print(f"[frontend] serving on http://{srv.host}:{srv.port} "
              f"({workers} worker processes, "
              f"{len(orch.replicas)} replicas)", flush=True)
        stopping = asyncio.Event()
        if install_signal_handlers and \
                threading.current_thread() is threading.main_thread():
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stopping.set)
        await stopping.wait()
        print("[frontend] SIGTERM: draining...", flush=True)
        await asyncio.to_thread(srv.shutdown, True)
        print("[frontend] drained; workers joined", flush=True)

    asyncio.run(_main())
