"""Worker replicas behind the engine-API boundary (the port of
``repro.frontend.worker``).

Three layers share one implementation of the boundary
(``frontend.protocol``):

  * ``EngineHost``: one ``repro_torch.engine.Engine`` behind the
    rid-keyed add/step/preempt surface. All device state lives here.
  * ``LocalReplica``: an ``EngineHost`` in the calling process, for tests
    and benchmarks that want the orchestrator's policy without processes
    (and for ``--workers 0``).
  * ``ProcReplica``: an ``EngineHost`` in a child process started with the
    ``spawn`` method (a forked child cannot use CUDA), driven over a
    ``multiprocessing`` pipe; ``worker_main`` is the child's entry point.
    Every worker draws its weights from the spec's ``init_seed`` on its
    own device (``factory.build_model``: a seeded ``torch.Generator``
    gives the same bits in every process), so the replicas hold the same
    weights without shipping them. Each holds its own CUDA context; on
    one card the workers' steps time-slice the card.

``EngineHost(spec, model=...)`` and ``LocalReplica(i, spec, model=...)``
take a prebuilt ``Model`` in-process instead (e.g. the JAX package's
weights through ``factory.from_jax_params``); a spawned worker always
draws its own.

``ProcReplica.step_send`` / ``step_recv`` are split so the orchestrator
fans a step out to every worker before it collects any reply.

Nothing at module level imports torch: the child unpickles this module
before it builds anything.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from repro_torch.frontend import protocol
from repro_torch.frontend.protocol import ReplicaDead, StepResult


def weights_digest(model) -> str:
    """A digest of the model's parameter bits, computed on their device:
    each tensor's raw bit patterns as integers, summed with position
    weights in int64 (wrapping), then hashed on the host. Two models with
    the same digest hold the same bits (up to a hash collision)."""
    import hashlib

    import torch

    chunk = 1 << 22
    h = hashlib.sha256()
    weights = None
    for name, t in sorted(model.named_parameters()):
        flat = t.detach().contiguous().reshape(-1)
        bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
        if weights is None or weights.device != bits.device:
            weights = torch.arange(1, chunk + 1, dtype=torch.int64,
                                   device=bits.device)
        sums = [int((bits[i:i + chunk].to(torch.int64)
                     * weights[:min(chunk, bits.numel() - i)]).sum())
                for i in range(0, bits.numel(), chunk)]
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype}:{sums}".encode())
    return h.hexdigest()


class EngineHost:
    """One engine behind the rid-keyed boundary surface."""

    def __init__(self, spec: Dict[str, Any], model=None):
        from repro_torch import obs
        from repro_torch.configs import registry as arch_registry
        from repro_torch.engine import Engine, EngineConfig
        from repro_torch.engine.engine import resolve_device
        from repro_torch.models.factory import build_model
        from repro_torch.plan import ExecutionPlan

        plan = ExecutionPlan.from_dict(spec["plan"])
        device = resolve_device(spec.get("device"))
        get_cfg = (arch_registry.get_smoke if spec.get("smoke", True)
                   else arch_registry.get)
        cfg = get_cfg(plan.arch)
        eng_kw = dict(spec.get("eng") or {})
        if spec.get("prefill_chunk"):
            eng_kw["prefill_chunk"] = spec["prefill_chunk"]
        self.registry = obs.Registry()
        self.tracer = obs.Tracer(enabled=bool(spec.get("trace")))
        if model is None:
            model = build_model(cfg, device=device,
                                seed=int(spec.get("init_seed", 0)))
        elif model.device != device or model.cfg != cfg:
            raise ValueError(f"model ({model.cfg.name} on {model.device}) "
                             f"does not fit the spec ({cfg.name} on "
                             f"{device})")
        self.model = model
        self.engine = Engine(model, plan, EngineConfig(**eng_kw),
                             registry=self.registry, tracer=self.tracer)
        self._reported: set = set()

    # ---- boundary calls --------------------------------------------------
    def add(self, rid: int, req_wire: Dict[str, Any]) -> Optional[Dict]:
        req = protocol.request_from_wire(req_wire)
        rej = self.engine.add_request(req)
        return None if rej is None else protocol.rejection_to_wire(rej)

    def step(self) -> StepResult:
        emitted = [(protocol.rid_for(uid), tok)
                   for uid, tok in self.engine.step()]
        sched = self.engine.scheduler
        finished = [protocol.rid_for(uid) for uid in sched.finished
                    if uid not in self._reported]
        self._reported.update(protocol.uid_for(r) for r in finished)
        outstanding = sum(r.prompt_len + r.max_new_tokens
                          for r in sched.queue)
        outstanding += sum(
            s.req.prompt_len + s.req.max_new_tokens - len(s.out)
            for s in sched.active())
        return protocol.pack_step(
            emitted, finished,
            free_slots=sum(1 for s in sched.slots if s is None),
            queued=len(sched.queue), active=len(sched.active()),
            outstanding_tokens=outstanding)

    def preempt(self, rid: int) -> Optional[Dict[str, Any]]:
        resume = self.engine.preempt(protocol.uid_for(rid))
        return None if resume is None else protocol.request_to_wire(resume)

    def idle(self) -> bool:
        return self.engine.idle()

    def flush(self) -> None:
        self.engine.connector.flush()

    def metrics_text(self) -> str:
        return self.registry.render_prometheus()

    def trace_events(self) -> List[Dict[str, Any]]:
        return self.tracer.events()

    def digest(self) -> str:
        return weights_digest(self.model)


def worker_main(conn, spec: Dict[str, Any]) -> None:
    """The child process's entry point: build the engine, then serve the
    pipe until ``shutdown`` or EOF. A build failure is sent back as an
    error rather than left to hang the parent."""
    try:
        host = EngineHost(spec)
    except Exception as e:
        conn.send(("error", f"{type(e).__name__}: {e}"))
        conn.close()
        return
    conn.send(("ready", os.getpid()))
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        op, args = msg[0], msg[1:]
        try:
            if op == "add":
                conn.send(("rej", host.add(*args)))
            elif op == "step":
                conn.send(("step", host.step()))
            elif op == "preempt":
                conn.send(("req", host.preempt(*args)))
            elif op == "flush":
                host.flush()
                conn.send(("ok", None))
            elif op == "idle":
                conn.send(("bool", host.idle()))
            elif op == "metrics":
                conn.send(("text", host.metrics_text()))
            elif op == "trace":
                conn.send(("events", host.trace_events()))
            elif op == "digest":
                conn.send(("text", host.digest()))
            elif op == "shutdown":
                conn.send(("ok", None))
                break
            else:
                conn.send(("error", f"unknown op {op!r}"))
        except Exception as e:          # keep serving after a bad request
            conn.send(("error", f"{type(e).__name__}: {e}"))
    conn.close()


class LocalReplica:
    """The boundary surface over an in-process ``EngineHost``."""

    def __init__(self, index: int, spec: Dict[str, Any], model=None):
        self.index = index
        self.host = EngineHost(spec, model=model)
        self.alive = True
        self.last: Optional[StepResult] = None
        self._pending = False

    def add(self, rid: int, req_wire: Dict[str, Any]) -> Optional[Dict]:
        return self.host.add(rid, req_wire)

    def step_send(self) -> None:
        self._pending = True

    def step_recv(self) -> StepResult:
        assert self._pending, "step_recv without step_send"
        self._pending = False
        self.last = self.host.step()
        return self.last

    def preempt(self, rid: int) -> Optional[Dict[str, Any]]:
        return self.host.preempt(rid)

    def idle(self) -> bool:
        return self.host.idle()

    def flush(self) -> None:
        self.host.flush()

    def metrics_text(self) -> str:
        return self.host.metrics_text()

    def trace_events(self) -> List[Dict[str, Any]]:
        return self.host.trace_events()

    def digest(self) -> str:
        return self.host.digest()

    def shutdown(self) -> None:
        self.alive = False

    def kill(self) -> None:
        self.alive = False


class ProcReplica:
    """The boundary surface over a spawned worker process. ``start_s`` is
    the seconds from the spawn to the worker's ready message (its
    interpreter, torch, the model and the engine)."""

    def __init__(self, index: int, spec: Dict[str, Any], *,
                 start_timeout_s: float = 300.0):
        import multiprocessing as mp
        import time

        ctx = mp.get_context("spawn")
        self.index = index
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=worker_main, args=(child, spec),
                                daemon=True)
        t0 = time.monotonic()
        self.proc.start()
        child.close()
        self.alive = True
        self.last: Optional[StepResult] = None
        self._pending = False
        if not self.conn.poll(start_timeout_s):
            self.kill()
            raise ReplicaDead(index, "worker did not come up")
        try:
            tag, payload = self.conn.recv()
        except (EOFError, OSError) as e:
            self.kill()
            raise ReplicaDead(index, f"worker died during startup: {e}")
        if tag != "ready":
            self.kill()
            raise ReplicaDead(index, str(payload))
        self.pid = payload
        self.start_s = time.monotonic() - t0

    # ---- plumbing --------------------------------------------------------
    def _send(self, *msg) -> None:
        if not self.alive:
            raise ReplicaDead(self.index, "already dead")
        try:
            self.conn.send(msg)
        except (BrokenPipeError, OSError) as e:
            self.alive = False
            raise ReplicaDead(self.index, str(e))

    def _recv(self, expect: str):
        try:
            tag, payload = self.conn.recv()
        except (EOFError, OSError) as e:
            self.alive = False
            raise ReplicaDead(self.index, str(e))
        if tag == "error":
            raise RuntimeError(f"replica {self.index}: {payload}")
        if tag != expect:
            raise RuntimeError(
                f"replica {self.index}: expected {expect!r}, got {tag!r}")
        return payload

    def _rpc(self, expect: str, *msg):
        self._send(*msg)
        return self._recv(expect)

    # ---- boundary calls --------------------------------------------------
    def add(self, rid: int, req_wire: Dict[str, Any]) -> Optional[Dict]:
        return self._rpc("rej", "add", rid, req_wire)

    def step_send(self) -> None:
        self._send("step")
        self._pending = True

    def step_recv(self) -> StepResult:
        assert self._pending, "step_recv without step_send"
        self._pending = False
        self.last = self._recv("step")
        return self.last

    def preempt(self, rid: int) -> Optional[Dict[str, Any]]:
        return self._rpc("req", "preempt", rid)

    def idle(self) -> bool:
        return self._rpc("bool", "idle")

    def flush(self) -> None:
        self._rpc("ok", "flush")

    def metrics_text(self) -> str:
        return self._rpc("text", "metrics")

    def trace_events(self) -> List[Dict[str, Any]]:
        return self._rpc("events", "trace")

    def digest(self) -> str:
        return self._rpc("text", "digest")

    def shutdown(self, timeout_s: float = 30.0) -> None:
        if self.alive:
            try:
                self._rpc("ok", "shutdown")
            except (ReplicaDead, RuntimeError):
                pass
            self.alive = False
        self.proc.join(timeout_s)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5.0)

    def kill(self) -> None:
        """Hard-kill the worker process. The client side stays nominally
        alive: the next call hits the broken pipe and raises
        ReplicaDead, as a real crash surfaces."""
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10.0)
