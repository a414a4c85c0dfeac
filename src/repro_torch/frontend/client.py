"""Stdlib SSE client for the front-end server, plus a bit-exactness
verifier (the port of ``repro.frontend.client``).

Used two ways:

  * as a library (``generate`` / ``generate_many``) by tests and
    ``chip_smoke.py``;
  * as a command::

        PYTHONPATH=src python -m repro_torch.frontend.client --port 8080 \\
            --requests 8 --concurrency 4 --verify

    which fires concurrent streaming requests and, with ``--verify``,
    rebuilds the server's per-replica engine **in process** (its spec
    from ``GET /plan``: plan, engine knobs, seed, smoke, device) and
    asserts every streamed token sequence equals the in-process run's.

Everything is stdlib (``http.client`` and threads), apart from the
verifier's in-process engine.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class HTTPError(RuntimeError):
    def __init__(self, status: int, body: Dict[str, Any]):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


def _sse_events(resp) -> List[Dict[str, Any]]:
    """Parse a complete SSE response body into its data payloads."""
    events = []
    buf = b""
    while True:
        chunk = resp.read(4096)
        if not chunk:
            break
        buf += chunk
    for block in buf.decode().split("\n\n"):
        for line in block.splitlines():
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    return events


def generate(host: str, port: int, prompt: List[int],
             max_new_tokens: int, *, cls: str = "interactive",
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: int = 0, session: Optional[str] = None,
             timeout_s: float = 600.0) -> Dict[str, Any]:
    """One streaming request. Returns ``{"rid", "tokens", "events",
    "ttft_s", "total_s"}``; raises :class:`HTTPError` on 4xx/5xx with
    the structured rejection body attached."""
    body: Dict[str, Any] = {"prompt": prompt,
                            "max_new_tokens": max_new_tokens, "class": cls,
                            "temperature": temperature, "top_k": top_k,
                            "top_p": top_p, "seed": seed}
    if session is not None:
        body["session"] = session
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        t0 = time.monotonic()
        conn.request("POST", "/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise HTTPError(resp.status,
                            json.loads(resp.read().decode() or "{}"))
        events = _sse_events(resp)
        total_s = time.monotonic() - t0
    finally:
        conn.close()
    token_events = [e for e in events if "token" in e]
    done = [e for e in events if e.get("done")]
    if not done:
        raise RuntimeError("stream ended without a done event")
    return {"rid": done[0]["rid"], "tokens": done[0]["tokens"],
            "events": events, "n_streamed": len(token_events),
            "ttft_s": total_s if token_events else float("inf"),
            "total_s": total_s}


def get_json(host: str, port: int, path: str) -> Dict[str, Any]:
    conn = http.client.HTTPConnection(host, port, timeout=60.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return json.loads(resp.read().decode())
    finally:
        conn.close()


def get_text(host: str, port: int, path: str) -> str:
    conn = http.client.HTTPConnection(host, port, timeout=60.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.read().decode()
    finally:
        conn.close()


def generate_many(host: str, port: int,
                  requests: List[Dict[str, Any]],
                  concurrency: int = 4) -> List[Dict[str, Any]]:
    """Fire ``requests`` (kwargs for :func:`generate`) with at most
    ``concurrency`` concurrent SSE streams; results in request order.
    A rejected request's slot holds its :class:`HTTPError`."""
    results: List[Any] = [None] * len(requests)
    sem = threading.Semaphore(concurrency)

    def worker(idx: int, kw: Dict[str, Any]) -> None:
        with sem:
            try:
                results[idx] = generate(host, port, **kw)
            except (HTTPError, RuntimeError, OSError) as e:
                results[idx] = e

    threads = [threading.Thread(target=worker, args=(i, kw))
               for i, kw in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def smoke_requests(n: int, *, prompt_len: int = 12,
                   max_new: int = 8) -> List[Dict[str, Any]]:
    """Deterministic request mix shared by the client and its in-process
    verifier: greedy and sampled, varying prompts/lengths/seeds."""
    reqs = []
    for i in range(n):
        prompt = [(7 * i + j) % 251 + 1 for j in range(prompt_len + i % 3)]
        reqs.append(dict(prompt=prompt, max_new_tokens=max_new + i % 4,
                         temperature=0.0 if i % 2 == 0 else 0.8,
                         top_k=0 if i % 2 == 0 else 40, seed=17 + i))
    return reqs


def verify_against_inprocess(host: str, port: int,
                             results: List[Dict[str, Any]],
                             requests: List[Dict[str, Any]]) -> None:
    """Rebuild the server's per-replica engine in this process (plan
    from ``GET /plan``) and assert every streamed token sequence is
    bit-identical to the in-process gateway-path baseline."""
    from repro_torch.frontend.orchestrator import Orchestrator
    from repro_torch.frontend.worker import LocalReplica

    spec = get_json(host, port, "/plan")
    spec.pop("workers", None)
    ref = Orchestrator([LocalReplica(0, spec)])
    rids = []
    for kw in requests:
        kw = dict(kw)
        prompt = kw.pop("prompt")
        max_new = kw.pop("max_new_tokens")
        rid = ref.submit(prompt, max_new, **kw)
        assert isinstance(rid, int), f"reference rejected: {rid}"
        rids.append(rid)
    got = ref.run()
    ref.shutdown(drain=False)
    for kw, res, rid in zip(requests, results, rids):
        assert not isinstance(res, Exception), f"HTTP request failed: {res}"
        want = got[rid]
        if res["tokens"] != want:
            raise AssertionError(
                f"stream mismatch for prompt {kw['prompt'][:4]}...: "
                f"http={res['tokens']} inprocess={want}")
    print(f"[client] verify: {len(results)} streams bit-identical "
          "to in-process baseline")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--verify", action="store_true",
                    help="bit-compare streams against an in-process "
                         "rebuild of the server's engine")
    ap.add_argument("--metrics-out", default="",
                    help="write a /metrics scrape to this file")
    args = ap.parse_args(argv)

    health = get_json(args.host, args.port, "/healthz")
    print(f"[client] healthz: {health}")
    reqs = smoke_requests(args.requests, max_new=args.max_new)
    t0 = time.monotonic()
    results = generate_many(args.host, args.port, reqs,
                            concurrency=args.concurrency)
    dt = time.monotonic() - t0
    failures = [r for r in results if isinstance(r, Exception)]
    toks = sum(len(r["tokens"]) for r in results
               if not isinstance(r, Exception))
    print(f"[client] {len(results) - len(failures)}/{len(results)} streams "
          f"ok, {toks} tokens in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} "
          "tok/s aggregate)")
    for r in failures:
        print(f"[client]   failure: {r}")
    if args.metrics_out:
        text = get_text(args.host, args.port, "/metrics")
        with open(args.metrics_out, "w") as f:
            f.write(text)
        print(f"[client] wrote /metrics scrape to {args.metrics_out}")
    if failures:
        return 1
    if args.verify:
        verify_against_inprocess(args.host, args.port, results, reqs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
