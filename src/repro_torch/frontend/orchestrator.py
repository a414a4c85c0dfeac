"""The serving orchestrator: routing, admission, streaming, preemption
and failover over a fleet of worker replicas (the port of
``repro.frontend.orchestrator``).

The process that talks to users (through ``frontend.server``) and never
touches a device: it drives replicas (``LocalReplica`` or
``ProcReplica``, the boundary is the same) through the engine API and owns
every piece of cross-replica policy:

  * **routing**: the gateway's ``Router`` over replica load (the
    orchestrator's own outstanding-token bookkeeping; no scheduler walk
    crosses the pipe), with liveness: a dead worker leaves the eligible
    set at once.
  * **admission**: priority classes (``frontend.slo.PriorityClass``) with
    per-class outstanding-token budgets and an SLO-priced TTFT check;
    failures are typed ``Rejection``s the HTTP layer maps to 429/503.
  * **preemption**: when a higher-priority request is stuck queued behind
    a full replica, the lowest-priority preemptible stream there is
    preempted (``Engine.preempt``: its valid KV blocks go to the prefix
    cache) and its resume request queued behind the waiting work; it
    continues as the uninterrupted stream would. At most one preemption
    a replica a step.
  * **failover**: a replica death (EOF mid-step) re-admits its live
    streams on the survivors from the orchestrator's own state: resume
    prompt = original prompt + the tokens streamed so far.
  * **observability**: per-class TTFT histograms and front-end counters
    in its own registry. ``frontend_ttft_seconds`` runs from submission
    to the step reply that carries the first token: a deliberate change
    of the JAX metric, whose stamp before the replies are collected
    leaves out the step that computes the token. ``metrics_text()``
    merges every worker's scrape under ``worker=<i>`` labels
    (``obs.merge_prometheus_text``), and ``shutdown`` folds the workers'
    trace events into the orchestrator's tracer (``Tracer.extend``).

``steps`` counts ticks; each stream records the tick it was submitted at
(``_Stream.submitted_step``, i.e. before that step ran) and its session,
and ``deaths`` the tick at which each replica death was noticed: what a
replay of the same traffic needs to reproduce every batch the replicas
ran (``chip_smoke.replay``, which holds worker processes' streams against
in-process replicas). No serving path reads them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch import obs
from repro_torch.engine.scheduler import Rejection, Request
from repro_torch.frontend import protocol
from repro_torch.frontend.protocol import ReplicaDead
from repro_torch.frontend.slo import (PriorityClass, SLOAdmission,
                                      default_classes)
from repro_torch.gateway.router import Router


@dataclasses.dataclass
class _Stream:
    rid: int
    req: Request                   # original request (resume source)
    cls: PriorityClass
    replica: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    cursor: int = 0
    done: bool = False
    submitted_t: float = 0.0
    first_token_t: Optional[float] = None
    preemptions: int = 0
    resumed: int = 0               # tokens emitted before the last resume
    submitted_step: int = 0        # the tick before which it was admitted
    session: Optional[str] = None

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.tokens)


class _ReplicaView:
    """What the router sees of a replica: load only (the tries live in
    other processes; prefix-aware routing would cost an RPC per probe)."""

    def __init__(self, orch: "Orchestrator", index: int):
        self._orch, self._index = orch, index

    def outstanding_tokens(self) -> int:
        return self._orch._outstanding(self._index)


class Orchestrator:
    def __init__(self, replicas, *, classes: Optional[
            Dict[str, PriorityClass]] = None,
            slo: Optional[SLOAdmission] = None, preempt: bool = False,
            registry: Optional[obs.Registry] = None,
            tracer: Optional[obs.Tracer] = None,
            max_steps: int = 100_000):
        self.replicas = list(replicas)
        self.classes = classes if classes is not None else default_classes()
        self.slo = slo
        self.preempt_enabled = preempt
        self.registry = registry if registry is not None else obs.Registry()
        # a tracer of its own: shutdown extends it with worker events
        self.tracer = tracer if tracer is not None \
            else obs.Tracer(enabled=False)
        self.max_steps = max_steps
        self.steps = 0
        self.deaths: List[Tuple[int, int]] = []      # (tick, replica)
        self.router = Router(
            [_ReplicaView(self, i) for i in range(len(self.replicas))],
            prefix_aware=False)
        self.streams: Dict[int, _Stream] = {}
        self.draining = False
        self._rid = 0
        self._lock = threading.RLock()
        self._worker_metrics: Dict[int, str] = {}    # last scrape per worker
        self.registry.histogram(
            "frontend_ttft_seconds",
            "Submit -> first streamed token, by priority class",
            buckets=obs.TTFT_BUCKETS)
        self.registry.counter(
            "frontend_rejections_total", "Admission rejections by reason")
        self.registry.counter(
            "frontend_preemptions_total", "Priority preemptions by class")
        self.registry.counter(
            "frontend_failovers_total",
            "Streams re-admitted after a replica death")
        self.registry.counter(
            "frontend_tokens_streamed_total", "Tokens streamed by class")
        self.registry.gauge(
            "frontend_live_replicas", "Workers currently routable").set(
            len(self.replicas))

    # ---- bookkeeping -----------------------------------------------------
    def _outstanding(self, i: int) -> int:
        return sum(len(s.req.tokens) + s.remaining
                   for s in self.streams.values()
                   if s.replica == i and not s.done)

    def _class_outstanding(self, name: str) -> int:
        return sum(s.remaining for s in self.streams.values()
                   if s.cls.name == name and not s.done)

    def live(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas) if r.alive]

    def _reject(self, rej: Rejection) -> Rejection:
        self.registry.get("frontend_rejections_total").inc(reason=rej.reason)
        return rej

    # ---- admission -------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int, *,
               cls: str = "interactive", temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               session: Optional[str] = None) -> Union[int, Rejection]:
        """Admit one request; returns its rid, or a typed Rejection."""
        with self._lock:
            if self.draining:
                return self._reject(Rejection(
                    "draining", "orchestrator is draining"))
            pc = self.classes.get(cls)
            if pc is None:
                return self._reject(Rejection(
                    "unknown_class",
                    f"unknown priority class {cls!r}; have "
                    f"{sorted(self.classes)}"))
            if not self.router.live_eligible():
                return self._reject(Rejection(
                    "no_live_replica", "every worker replica is dead",
                    retry_after_steps=1))
            if pc.budget_tokens:
                out = self._class_outstanding(cls)
                if out + max_new_tokens > pc.budget_tokens:
                    return self._reject(Rejection(
                        "class_budget_exhausted",
                        f"class {cls!r} holds {out} outstanding tokens of a "
                        f"{pc.budget_tokens}-token budget",
                        retry_after_steps=max(
                            out + max_new_tokens - pc.budget_tokens, 1)))
            i = self.router.route(
                _RouteProbe(prompt, max_new_tokens), session)
            if self.slo is not None and pc.slo_ttft_ms:
                rej = self.slo.check(
                    prompt_len=len(prompt), slo_ttft_ms=pc.slo_ttft_ms,
                    queued_tokens=self._outstanding(i))
                if rej is not None:
                    self.router.routed[i] -= 1
                    return self._reject(rej)
            rid = self._rid
            self._rid += 1
            req = Request(uid=protocol.uid_for(rid), tokens=list(prompt),
                          max_new_tokens=max_new_tokens,
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          seed=seed, priority=cls)
            try:
                rej_wire = self.replicas[i].add(
                    rid, protocol.request_to_wire(req))
            except ReplicaDead:
                self._on_death(i)
                self._readmit_orphans()
                return self._reject(Rejection(
                    "no_live_replica", f"replica {i} died during admission",
                    retry_after_steps=1))
            if rej_wire is not None:
                return self._reject(protocol.rejection_from_wire(rej_wire))
            self.streams[rid] = _Stream(rid=rid, req=req, cls=pc, replica=i,
                                        submitted_t=time.monotonic(),
                                        submitted_step=self.steps,
                                        session=session)
            return rid

    # ---- the drive loop --------------------------------------------------
    def _preempt_tick(self) -> None:
        """One preemption decision per replica per step: if a
        higher-priority stream is stuck *queued* (no first token) on a
        replica with no free slot, spill the worst lower-priority
        preemptible stream there and re-queue its resume behind the
        waiting work."""
        for i, rep in enumerate(self.replicas):
            if not rep.alive or rep.last is None or rep.last.free_slots:
                continue
            here = [s for s in self.streams.values()
                    if s.replica == i and not s.done]
            waiting = [s for s in here if s.first_token_t is None]
            if not waiting:
                continue
            best_rank = min(s.cls.rank for s in waiting)
            victims = [s for s in here
                       if s.first_token_t is not None and s.cls.preemptible
                       and s.cls.rank > best_rank and s.remaining > 0]
            if not victims:
                continue
            victim = max(victims, key=lambda s: (s.cls.rank, s.remaining,
                                                 s.rid))
            try:
                resume_wire = rep.preempt(victim.rid)
                if resume_wire is None:
                    continue
                rej = rep.add(victim.rid, resume_wire)
            except ReplicaDead:
                self._on_death(i)
                continue
            if rej is not None:
                # cannot re-queue (should not happen: the resume request
                # shrank); leave a loud trail rather than lose the stream
                raise RuntimeError(
                    f"preempted rid {victim.rid} rejected on re-admit: "
                    f"{rej}")
            victim.preemptions += 1
            victim.resumed = len(victim.tokens)
            self.registry.get("frontend_preemptions_total").inc(
                cls=victim.cls.name)

    def _on_death(self, i: int) -> None:
        """Replica ``i`` is gone: stop routing to it. Its orphaned
        streams are re-admitted by :meth:`_readmit_orphans` — deferred,
        because re-admitting inline would interleave an ``add`` RPC with
        a step reply still in flight on a survivor's pipe."""
        self.router.mark_dead(i)
        self.replicas[i].alive = False
        self.deaths.append((self.steps, i))
        self.registry.get("frontend_live_replicas").set(len(self.live()))

    def _readmit_orphans(self) -> None:
        """Re-admit every live stream stranded on a dead replica, on the
        least-loaded survivor, from orchestrator-side state: resume
        prompt = original prompt + tokens streamed so far. Only called
        when no step RPC is pending on any survivor."""
        orphans = [s for s in self.streams.values()
                   if not s.done and not self.replicas[s.replica].alive]
        for s in orphans:
            resume = s.req if not s.tokens else dataclasses.replace(
                s.req, tokens=list(s.req.tokens) + s.tokens,
                max_new_tokens=s.remaining)
            while True:
                live = self.router.live_eligible()
                if not live:
                    raise RuntimeError(
                        "all replicas dead with streams in flight")
                j = min(live, key=lambda k: (self._outstanding(k), k))
                try:
                    rej = self.replicas[j].add(
                        s.rid, protocol.request_to_wire(resume))
                except ReplicaDead:
                    self._on_death(j)
                    continue
                if rej is not None:
                    raise RuntimeError(
                        f"failover re-admit of rid {s.rid} rejected: {rej}")
                s.replica = j
                s.resumed = len(s.tokens)
                self.registry.get("frontend_failovers_total").inc()
                break

    def step(self) -> List[Tuple[int, int]]:
        """One orchestrator tick: preemption policy, then one engine step
        on every busy replica — fanned out first (``step_send``), then
        collected (``step_recv``), so worker processes genuinely overlap.

        Returns this tick's (rid, token) emissions."""
        with self._lock:
            # notice externally-killed replicas the router still trusts
            for i, rep in enumerate(self.replicas):
                if not rep.alive and i not in self.router.dead:
                    self._on_death(i)
            if self.preempt_enabled:
                self._preempt_tick()
            busy = [i for i in self.live() if self._outstanding(i) > 0]
            for i in busy:
                try:
                    self.replicas[i].step_send()
                except ReplicaDead:
                    self._on_death(i)
            emitted: List[Tuple[int, int]] = []
            for i in busy:
                rep = self.replicas[i]
                if not rep.alive:
                    continue
                try:
                    res = rep.step_recv()
                except ReplicaDead:
                    self._on_death(i)
                    continue
                # stamped when the reply that carries the tokens is in
                now = time.monotonic()
                for rid, tok in res.emitted:
                    s = self.streams.get(rid)
                    if s is None or s.replica != i:
                        continue          # late echo from a failed-over rid
                    s.tokens.append(tok)
                    emitted.append((rid, tok))
                    self.registry.get("frontend_tokens_streamed_total").inc(
                        cls=s.cls.name)
                    if s.first_token_t is None:
                        s.first_token_t = now
                        self.registry.get("frontend_ttft_seconds").observe(
                            now - s.submitted_t, cls=s.cls.name)
                for rid in res.finished:
                    s = self.streams.get(rid)
                    if s is not None and s.replica == i:
                        s.done = True
            self._readmit_orphans()    # every pending step reply is drained
            self.steps += 1
            return emitted

    def take(self, rid: int) -> List[int]:
        """Drain tokens streamed for ``rid`` since the last take."""
        with self._lock:
            s = self.streams[rid]
            out = s.tokens[s.cursor:]
            s.cursor += len(out)
            return out

    def stream_done(self, rid: int) -> bool:
        with self._lock:
            return self.streams[rid].done

    def idle(self) -> bool:
        with self._lock:
            return all(s.done for s in self.streams.values())

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[int, List[int]]:
        """Drive until every submitted stream finishes; returns
        {rid -> full token stream}."""
        limit = max_steps or self.max_steps
        n = 0
        while not self.idle():
            self.step()
            n += 1
            if n > limit:
                raise RuntimeError(
                    f"orchestrator did not drain in {limit} steps")
        return {rid: list(s.tokens) for rid, s in self.streams.items()}

    # ---- drain / shutdown ------------------------------------------------
    def shutdown(self, drain: bool = True,
                 max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Stop admission, optionally finish in-flight streams, flush
        staged host-tier spills, fold worker traces/metrics into the
        orchestrator's, and join every worker process."""
        with self._lock:
            self.draining = True
        if drain and not self.idle():
            self.run(max_steps)
        with self._lock:
            for i in self.live():
                rep = self.replicas[i]
                try:
                    rep.flush()
                    self._worker_metrics[i] = rep.metrics_text()
                    self.tracer.extend(rep.trace_events())
                except (ReplicaDead, RuntimeError):
                    self._on_death(i)
            for rep in self.replicas:
                rep.shutdown()
            return {rid: list(s.tokens)
                    for rid, s in self.streams.items()}

    # ---- metrics ---------------------------------------------------------
    def metrics_text(self) -> str:
        """One Prometheus exposition for the whole deployment: the
        orchestrator's own registry plus every worker's scrape merged
        under ``worker=<i>`` labels. Dead/shut-down workers contribute
        their last successful scrape."""
        with self._lock:
            for i in self.live():
                try:
                    self._worker_metrics[i] = \
                        self.replicas[i].metrics_text()
                except (ReplicaDead, RuntimeError):
                    self._on_death(i)
            merged = obs.Registry()
            obs.merge_prometheus_text(
                merged, self.registry.render_prometheus())
            for i, text in sorted(self._worker_metrics.items()):
                obs.merge_prometheus_text(merged, text, worker=str(i))
            return merged.render_prometheus()

    def ttft_quantile(self, q: float, cls: Optional[str] = None) -> float:
        h = self.registry.get("frontend_ttft_seconds")
        return h.quantile(q, cls=cls) if cls else h.quantile(q)


class _RouteProbe:
    """Duck-typed request for Router.route (load-only routing)."""

    def __init__(self, tokens: List[int], max_new_tokens: int):
        self.tokens = tokens
        self.prompt_len = len(tokens)
        self.max_new_tokens = max_new_tokens
