"""The serving gateway: several engine replicas behind one router (the
port of ``repro.gateway.gateway``).

One ``Gateway`` owns N ``Engine`` replicas built from one shared
``kind='decode'`` plan (its ``replicas`` and ``prefix_cache`` knobs), or
from one plan per role (``plan.make_role_plans``). Requests enter through
prefix-aware, load-aware routing with session affinity
(``gateway.router``), are served by the replicas' continuous batching,
and stream back per request: ``step()`` returns the (uid, token) pairs
emitted that tick and ``take(uid)`` drains a request's stream so far.

**One card.** The JAX gateway gives each replica a disjoint slice of the
devices. Here every replica lives on the one card: each is its own
``Engine`` with its own page pool, prefix cache and KV connector, and all
share one ``Model``, as the JAX replicas share one parameter tree. A
replica of SP degree > 1 runs its ranks as its own ``ThreadMesh`` (the
engine builds it from its plan, as ``submeshes`` does); a plan's
``n_devices`` is the rank count of each replica.
The replicas step one after the other on the caller's thread.

**Disaggregated serving** (``plans=[...]`` with roles): ``role='prefill'``
replicas take new requests as 1-token ``handoff`` twins, emit the first
token and stop; the gateway then exports the prompt KV through the
replica's KV connector (card -> pinned host), injects it into the
least-loaded ``role='decode'`` replica (host -> card) and lets decode
continue there (``Engine.take_handoffs``, ``export_kv``,
``release_handoff``, ``add_prefilled``). The streams equal a unified
replica's: the decode engine resumes from the exact pages the prefill
wrote, and sampling is keyed by (seed, position), not by the engine.

The replicas share one ``obs.Registry`` under ``{replica=i}`` labels, and
the ``gateway/route``, ``gateway/handoff`` and ``gateway/step`` spans go
to the gateway's tracer. The JAX gateway's ``xla_compiles`` and
``pallas_fallbacks`` (and ``metrics_dict``'s ``pallas_fallbacks`` key)
have no counterpart: eager PyTorch traces nothing, and the port's kernels
have no fallback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch import obs
from repro_torch.engine import Engine, EngineConfig, Rejection, Request
from repro_torch.gateway.router import Router
from repro_torch.models.factory import Model


def submeshes(plans):
    """One rank mesh per plan: the plan's ``ThreadMesh`` (None at one
    rank). Every replica's ranks are threads on the same card, so the
    meshes share no state."""
    return [p.build_mesh() for p in plans]


def replica_meshes(plan, replicas: int):
    """One mesh per replica of a single shared plan."""
    return submeshes([plan] * replicas)


class Gateway:
    """add_request / step / take / collect driver over N engine replicas."""

    def __init__(self, model: Model, plan, eng: EngineConfig = EngineConfig(),
                 registry: Optional[obs.Registry] = None,
                 tracer: Optional[obs.Tracer] = None, plans=None):
        if plans:
            self.plans = list(plans)
            plan = plan if plan is not None else self.plans[0]
            key = {(p.page_size, p.decode_batch, p.seq_len, p.kernel_impl,
                    p.arch) for p in self.plans}
            if len(key) != 1:
                raise ValueError(
                    "disaggregated role plans must agree on page_size/"
                    "decode_batch/seq_len/kernel (the KV handoff is only "
                    f"exact between identical engines); got {key}")
        else:
            if plan.role != "unified":
                raise ValueError(
                    "a single-plan gateway is role='unified'; build one "
                    "plan per role (plan.make_role_plans) and pass "
                    "plans=[...] to disaggregate")
            self.plans = [plan] * max(plan.replicas, 1)
        self.plan = plan
        self.replicas = len(self.plans)
        self.roles = [p.role for p in self.plans]
        # prefill/unified replicas take new requests; handoffs land on
        # decode replicas (or unified ones when none are dedicated)
        self._entry = [i for i, r in enumerate(self.roles)
                       if r in ("prefill", "unified")]
        self._decode_targets = \
            [i for i, r in enumerate(self.roles) if r == "decode"] or \
            [i for i, r in enumerate(self.roles) if r == "unified"]
        if not self._entry:
            raise ValueError("no prefill or unified replica to admit "
                             "requests")
        if "prefill" in self.roles and not self._decode_targets:
            raise ValueError("prefill replicas need a decode (or unified) "
                             "replica to hand finished prompts to")
        self.registry = registry if registry is not None else obs.Registry()
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.engines: List[Engine] = [
            Engine(model, p, eng, registry=self.registry,
                   labels={"replica": str(i)}, tracer=self.tracer)
            for i, p in enumerate(self.plans)]
        self.cfg = self.engines[0].cfg
        self.router = Router(self.engines,
                             prefix_aware=bool(plan.prefix_cache),
                             eligible=self._entry)
        self._owner: Dict[str, int] = {}
        self._streams: Dict[str, List[int]] = {}
        self._cursor: Dict[str, int] = {}
        # disaggregation state: the original request by uid while its
        # 1-token prefill twin runs, and uid -> decode replica after it
        self._pending_handoff: Dict[str, Request] = {}
        self._handoff_dst: Dict[str, int] = {}
        self.handoffs = 0
        self.wall_s = 0.0
        self.max_steps = eng.max_steps
        self.draining = False

    # ---- request lifecycle ---------------------------------------------
    def add_request(self, req: Request, session: Optional[str] = None,
                    replica: Optional[int] = None) -> Union[int, Rejection]:
        """Route and enqueue; returns the replica index, or a typed
        :class:`Rejection` (a draining gateway or an unserveable request;
        never a raise, so an HTTP layer can answer 429/503). ``replica``
        pins the choice (a replay of recorded placements)."""
        if self.draining:
            return Rejection("draining",
                             "gateway is draining: not accepting requests")
        if not self.router.live_eligible():
            return Rejection("no_live_replica",
                             "no live replica can admit requests",
                             retry_after_steps=1)
        with self.tracer.span("gateway/route", cat="gateway", uid=req.uid):
            i = self.router.route(req, session) if replica is None \
                else replica
        if replica is not None:
            self.router.routed[i] += 1
        if self.roles[i] == "prefill":
            # the prefill replica runs a 1-token twin; the original budget
            # and sampling state resume on the decode replica at handoff
            twin = dataclasses.replace(req, max_new_tokens=1, handoff=True)
            rej = self.engines[i].add_request(twin)
            if rej is not None:
                return rej
            self._pending_handoff[req.uid] = req
        else:
            rej = self.engines[i].add_request(req)
            if rej is not None:
                return rej
        self.registry.counter(
            "gateway_requests_routed_total",
            "Requests routed to each replica").inc(replica=str(i))
        self._owner[req.uid] = i
        self._streams[req.uid] = []
        self._cursor[req.uid] = 0
        return i

    def preempt(self, uid: str) -> Optional[Request]:
        """Take ``uid`` out of whichever replica holds it and return its
        resume request (``Engine.preempt``: re-admitting it, anywhere,
        continues the stream)."""
        i = self._owner.get(uid)
        if i is None:
            return None
        return self.engines[i].preempt(uid)

    def _drain_handoffs(self) -> None:
        """Move every finished prefill-role prompt to a decode replica:
        export its KV pages to the host, inject them into the least-loaded
        decode target, release the prefill slot. Export strictly precedes
        release: releasing first could recycle the pages mid-copy."""
        for i, engine in enumerate(self.engines):
            if self.roles[i] != "prefill":
                continue
            for st in engine.take_handoffs():
                uid = st.req.uid
                orig = self._pending_handoff.pop(uid)
                with self.tracer.span("gateway/handoff", cat="gateway",
                                      uid=uid):
                    if orig.max_new_tokens <= 1:
                        # the prefill stream is already the whole response
                        engine.release_handoff(st)
                        continue
                    blocks = engine.export_kv(st)
                    j = min(self._decode_targets,
                            key=lambda k: (self.router.load(k), k))
                    self.engines[j].add_prefilled(orig, st.out[0], blocks)
                    engine.release_handoff(st)
                self._handoff_dst[uid] = j
                self._owner[uid] = j
                self.handoffs += 1
                self.registry.counter(
                    "gateway_handoffs_total",
                    "Prefill->decode KV handoffs").inc(replica=str(j))

    def step(self) -> List[Tuple[str, int]]:
        """One tick: step every replica with work; returns this tick's
        (uid, token) emissions (also appended to the per-request
        streams)."""
        t0 = time.monotonic()
        emitted: List[Tuple[str, int]] = []
        with self.tracer.span("gateway/step", cat="gateway"):
            for engine in self.engines:
                if not engine.idle():
                    emitted.extend(engine.step())
            self._drain_handoffs()
        for uid, tok in emitted:
            self._streams[uid].append(tok)
        self.wall_s += time.monotonic() - t0
        self.registry.gauge(
            "gateway_wall_seconds",
            "Host wall time spent inside gateway.step()").set(self.wall_s)
        return emitted

    def take(self, uid: str) -> List[int]:
        """The tokens streamed for ``uid`` since the last take."""
        cur = self._cursor.get(uid, 0)
        out = self._streams.get(uid, [])[cur:]
        self._cursor[uid] = cur + len(out)
        return out

    def idle(self) -> bool:
        return all(e.idle() for e in self.engines)

    def run(self, max_steps: Optional[int] = None) -> Dict[str, List[int]]:
        limit = max_steps or self.max_steps
        n = 0
        while not self.idle():
            emitted = self.step()
            if not emitted and not any(
                    e.scheduler.active() or e.scheduler.prefilled
                    for e in self.engines):
                # nothing decoding and nothing admissible: eviction was
                # already tried, so no later step can make progress
                raise RuntimeError(
                    "gateway stalled: queued requests cannot be admitted "
                    "(pool exhausted by live sequences?)")
            n += 1
            if n > limit:
                raise RuntimeError(f"gateway did not drain in {limit} steps")
        return self.collect()

    def collect(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for engine in self.engines:
            out.update(engine.collect())
        # a handed-off uid finishes on both sides (the prefill replica's
        # 1-token twin and the decode replica's stream): the decode side
        # wins whatever the replica order
        for uid, j in self._handoff_dst.items():
            done = self.engines[j].collect()
            if uid in done:
                out[uid] = done[uid]
        return out

    def reset(self) -> None:
        """Drop requests, pools and prefix caches on every replica and
        clear the router's affinity map."""
        for engine in self.engines:
            engine.reset()
        self.router = Router(self.engines,
                             prefix_aware=bool(self.plan.prefix_cache),
                             eligible=self._entry)
        self._owner.clear()
        self._streams.clear()
        self._cursor.clear()
        self._pending_handoff.clear()
        self._handoff_dst.clear()
        self.handoffs = 0
        self.wall_s = 0.0
        self.draining = False

    def shutdown(self, drain: bool = True,
                 max_steps: Optional[int] = None) -> Dict[str, List[int]]:
        """Stop accepting requests. ``drain=True`` finishes every request
        in flight first (the loop of :meth:`run`); then each replica's
        staged host-tier spills are committed. Returns the finished
        streams; a second call does nothing more."""
        self.draining = True
        if drain and not self.idle():
            self.run(max_steps)
        for engine in self.engines:
            engine.connector.flush()
        return self.collect()

    # ---- metrics --------------------------------------------------------
    def compiles(self) -> Tuple[int, int]:
        """(prefill, decode) compile counters summed over the replicas
        (both 0: eager PyTorch compiles nothing, ``engine.engine``)."""
        return (sum(e.metrics.prefill_compiles for e in self.engines),
                sum(e.metrics.decode_compiles for e in self.engines))

    def latency_quantiles(self) -> Dict[str, float]:
        """Gateway-wide p50/p95/p99 TTFT and inter-token gap: with no
        label filter the histograms' quantiles pool every replica's
        buckets."""
        out: Dict[str, float] = {}
        for short, metric in (("ttft", "serve_ttft_seconds"),
                              ("intertoken", "serve_intertoken_seconds")):
            h = self.registry.get(metric)
            for q in (0.5, 0.95, 0.99):
                out[f"{short}_p{int(q * 100)}_s"] = h.quantile(q)
            out[f"{short}_count"] = h.count()
        return out

    def metrics_dict(self) -> Dict[str, object]:
        per = [e.metrics.to_dict() for e in self.engines]
        tokens = sum(m["tokens_out"] for m in per)
        computed = sum(m["prefill_tokens_computed"] for m in per)
        cached = sum(m["prefill_tokens_cached"] for m in per)
        prompt = computed + cached
        return {
            "replicas": self.replicas,
            "roles": list(self.roles),
            "tokens_out": tokens,
            "wall_s": self.wall_s,
            "tokens_per_s": tokens / self.wall_s if self.wall_s > 0 else 0.0,
            "prefill_tokens_computed": computed,
            "prefill_tokens_cached": cached,
            "prefix_hit_rate": cached / prompt if prompt else 0.0,
            "prefix_evictions": sum(m["prefix_evictions"] for m in per),
            "routed": list(self.router.routed),
            "affinity_hits": self.router.affinity_hits,
            "handoffs": self.handoffs,
            "per_replica": per,
        }

    def stats(self) -> Dict[str, object]:
        """``metrics_dict`` plus the replicas' host tiers summed; also sets
        the ``gateway_host_tier_hit_rate`` gauge, so every scrape carries
        it."""
        d = self.metrics_dict()
        per = [e.connector.stats() for e in self.engines]
        agg = {k: sum(t[k] for t in per) for k in (
            "resident_pages", "resident_bytes", "spill_pages",
            "spill_bytes", "reload_pages", "reload_bytes",
            "handoff_out_pages", "handoff_in_pages", "spills_skipped",
            "host_evicted_pages", "hit_tokens", "lookup_tokens")}
        agg["enabled"] = any(e.connector.enabled for e in self.engines)
        agg["hit_rate"] = agg["hit_tokens"] / agg["lookup_tokens"] \
            if agg["lookup_tokens"] else 0.0
        self.registry.gauge(
            "gateway_host_tier_hit_rate",
            "Fraction of non-device-cached lookup tokens served from the "
            "pinned-host KV tier, over all replicas").set(agg["hit_rate"])
        d["host_tier"] = {**agg, "per_replica": per}
        return d


def build_gateway(arch: str, *, smoke: bool = True, c: Optional[int] = 1,
                  data: int = 1, n_devices: Optional[int] = None,
                  replicas: int = 1, prefix_cache: bool = True,
                  host_tier_bytes: int = 0, roles=None,
                  eng: EngineConfig = EngineConfig(),
                  model: Optional[Model] = None, init_seed: int = 0,
                  kernel: Optional[str] = None, block: Optional[str] = None,
                  plan=None, plans=None, device=None,
                  registry: Optional[obs.Registry] = None,
                  tracer: Optional[obs.Tracer] = None) -> Gateway:
    """Build a gateway on ``device`` (default: the CUDA card, raising if
    there is none), the counterpart of ``engine.build_engine``: resolve a
    serve plan of ``n_devices`` ranks a replica (default ``data``: SP
    degree 1) and build the replicas on it. ``roles=['prefill',
    'decode']`` disaggregates (one plan per role via
    ``plan.make_role_plans``; ``replicas`` is then ignored);
    ``host_tier_bytes`` sizes each replica's pinned-host KV tier (needs
    ``prefix_cache``). ``model`` supplies the weights (e.g.
    ``factory.from_jax_params``), else they are drawn from ``init_seed``
    on the device; every replica shares them."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.engine.engine import resolve_device
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_role_plans, make_serve_plan

    device = resolve_device(device)
    cfg = arch_registry.get_smoke(arch) if smoke else arch_registry.get(arch)
    n_dev = data if n_devices is None else n_devices
    if plan is None and plans is None:
        kw = dict(arch=arch, n_devices=n_dev, data=data, c=c,
                  decode_batch=eng.max_slots, page_size=eng.page_size,
                  max_len=eng.max_len, kernel_impl=kernel, block_impl=block,
                  prefix_cache=prefix_cache, host_tier_bytes=host_tier_bytes)
        if roles:
            plans = make_role_plans(cfg, roles=roles, **kw)
        else:
            plan = make_serve_plan(cfg, replicas=replicas, **kw)
    if model is None:
        model = build_model(cfg, device=device, seed=init_seed)
    elif model.device != device:
        raise ValueError(f"model lives on {model.device}, gateway on "
                         f"{device}")
    return Gateway(model, plan, eng, registry=registry, tracer=tracer,
                   plans=plans)
