"""The serving engine: continuous batching over the paged KV cache (the
port's counterpart of ``repro.engine.engine``).

The engine owns two kinds of state:

  * **device** — the model and every rank's page pools
    (``paged_cache.init_pools``: ``pages_per_shard`` pages each), on the
    card unless the caller asks for the CPU;
  * **host** — the ``Scheduler`` (slots, page free lists, page table, FIFO
    queue), the prefix cache, the KV connector and its host tier,
    sampling's keys and the metrics and spans (``obs``), on the thread that
    calls ``step()``.

``step()`` is one driver iteration: advance every in-flight chunked
prefill by one chunk, admit queued requests into free slots (each
admission runs its first chunk, the whole prompt when chunking is off),
then one decode step for every slot whose prefill has completed, then
evict finished requests. Outputs are identical to serving each request
alone for dense stacks: attention, MLP and sampling are row-independent and
page content is per slot. A MoE stack's stream depends on its batch, as the
JAX engine's does: expert capacity couples the tokens of one prefill and
the rows of one decode step (the inactive slots' zero tokens among them).
So a MoE stack refuses chunked prefill and prefix caching (the host tier
needs the latter), as the JAX engine does.

A prompt's leading chunk runs the full-forward prefill and inserts its K/V
into the slot's pages; every later chunk, and the uncached suffix of a
prefix-cache hit (``plan.prefix_cache``: ``gateway.prefix_cache`` shares
the hit pages), runs the *suffix* prefill (``serve.step.lm_prefill_paged``)
that reads the pages already written in place. The prompt's full blocks are
offered to the prefix cache after its last chunk.

The pinned-host KV tier (the plan's ``host_tier_bytes > 0``, which needs
the prefix cache; ``engine.kv_connector``): a page the prefix cache evicts
is spilled to host memory, committed at the top of the next step, and
reloaded into fresh pages when a later prompt's chain hits it, before its
suffix prefill. The engine always builds the connector, so its registry
holds the JAX engine's ``kv_transfer_*`` / ``host_tier_*`` series; the
same transfers carry the disaggregated prefill -> decode handoff
(``take_handoffs``, ``export_kv``, ``release_handoff``,
``add_prefilled``). ``preempt`` takes a request out and returns the
request that resumes it; with the prefix cache its valid blocks are
registered first, so the resume prefill mostly hits.

Device steps run on every rank of the plan (``_on_ranks``): on one rank
(``SingleComm``) when the plan has one device, else as the threads of the
plan's ``ThreadMesh`` (``plan.build_mesh``: data x C*C*R ranks on one
card or on the CPU), each with its own ``Runtime`` over its rank's
communicator, its own pool shard and its own parameter tree: the model's
weights as the plan's sharding rules store them on that rank
(``models.factory.shard_params``: views, no copies; the whole leaves at
one rank). The rank runtimes are the JAX
engine's: ``train.step.make_runtime`` on the plan's run config with
``batch_axes=()`` and the contiguous sequence layout, so StarTrail's team
gathers and sub-rings run in the prefill, B4's and B6's partials merge
across ranks, and data replicas compute the same batch. Every rank
samples (``engine.sampling``: vocab-parallel greedy, or temperature, top-k
and top-p with gumbel noise keyed by the request's seed, the token's
position and the rank); the ranks' tokens cross as an all-gather over the
whole mesh each step, and every rank raises if one rank's differ. A
request's first token folds its key with ``prompt_len``, a decode step's
with ``cache_len + 1``, so a request's stream does not depend on its batch
or on how its prompt was chunked.

**Ranks as processes** (``comm`` a ``dist.comm.ProcessComm``,
``dist.procs.ProcessMesh`` or ``torchrun`` launching them): SPMD, one
``Engine`` in every rank process, each serving its own rank alone over its
``ProcessComm`` with its own pool shard and only its parameter shards (the
model is its ``models.factory.rank_model``). No process sees another
rank's memory, so whatever one process read across ranks is a collective
here: the first-token hidden state is rank 0's, all-gathered; the
connector's page reads are ``paged_cache.read_pages_rank``'s psum over the
SP axes and its writes ``write_pages_rank``'s owned pages. The host state
(scheduler, prefix cache, the connector's host tier, metrics) is replicated:
the scheduler reads no clock and no random source, so **every rank must be
given the same requests (``add_request``, ``preempt``, ``add_prefilled``)
before the same ``step()``**, and then takes the same decisions and runs
the same collectives. A rank fed otherwise raises (the token check, or a
collective signature mismatch) instead of hanging. These cross-rank reads
are bookkeeping a ``ThreadMesh`` engine does in shared memory, so they stay
out of the ledger (``CommLedger.uncounted``) and both communicators'
ledgers count the same bytes. The caller chooses the lead rank that
prints, dumps metrics and traces (``launch.serve --backend``: rank 0).

Metrics live in an ``obs.Registry`` (``EngineMetrics``: the JAX engine's
names and kinds, under the engine's ``labels``: the gateway's replicas
share one registry as ``{replica=i}``) and
spans go to an ``obs.Tracer``: an async ``request`` span per request,
``engine/step``, ``engine/prefill``, ``engine/prefill_chunk``,
``engine/host_reload``, ``engine/handoff_inject`` and ``engine/decode``.
Both are written on the thread that calls ``step()`` only; rank threads
never touch them.

Dense prompts and chunks are prefilled at their own length, padded at the
end to a multiple of ``P_sp * comm_chunks`` when P_sp > 1 so that every
rank holds an equal contiguous slice and every ring transfer splits
evenly: the JAX engine pads to power-of-two buckets for its jit caches, but
eager PyTorch compiles nothing and the kernels mask ragged edges. So
``prefill_compiles`` / ``decode_compiles`` keep their names in
``EngineMetrics`` and stay 0. A MoE stack's prompt is padded with zero
tokens to the JAX bucket, ``bucket_pow2(prompt_len, lcm(P_sp,
page_size))``: the padding competes for expert capacity (capacity is
reckoned from the padded token count), so only the JAX bucket gives the
JAX stream. The chunk size keeps the JAX rule:
``prefill_chunk`` rounded up to a power-of-two multiple of
``lcm(P_sp, page_size)``, so chunk boundaries are page-aligned.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.dist.sharding import DATA_AXIS, MESH_AXES
from repro_torch.engine import kv_connector, paged_cache, sampling
from repro_torch.engine.scheduler import (Rejection, Request, Scheduler,
                                          SlotState, bucket_pow2)
from repro_torch.models import transformer
from repro_torch.models.factory import Model, RankParams, run_on_ranks
from repro_torch.models.runtime import Runtime
from repro_torch.serve import kv_cache
from repro_torch.train import step as train_step


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4          # decode batch width (slots)
    page_size: int = 8          # tokens per KV page
    pages_per_shard: int = 128  # pool capacity per SP shard
    max_len: int = 512          # max prompt_len + max_new_tokens
    max_steps: int = 100_000    # runaway guard for run()
    prefill_chunk: int = 0      # > 0: prefill prompts in chunks


class EngineMetrics:
    """Registry-backed engine metrics (the JAX ``EngineMetrics``).

    Keeps the attribute interface the engine uses (``m.steps += 1``,
    ``to_dict()``, ``reset(keep_compiles=True)``) while each field lives as
    a series in an ``obs.Registry``: counter-kind fields render as
    ``engine_*_total`` counters, level-kind fields as gauges, and the TTFT
    and inter-token histograms (the pinned ``obs.TTFT_BUCKETS`` /
    ``obs.INTERTOKEN_BUCKETS``) ride in the same registry. The port adds
    two gauges, the host seconds spent in prefill and in decode steps; each
    of those intervals ends with the sampled tokens copied to the host, so
    it includes the device work. The compile counters stay 0 (module doc).
    Every series is written and read under ``labels`` (the gateway's
    ``{replica=i}``), so several engines share one registry.
    """

    # attribute -> (metric name, kind, python type)
    _SPECS = {
        "steps": ("engine_steps_total", "counter", int),
        "decode_steps": ("engine_decode_steps_total", "counter", int),
        "prefills": ("engine_prefills_total", "counter", int),
        "finished": ("engine_requests_finished_total", "counter", int),
        "tokens_out": ("engine_tokens_out_total", "counter", int),
        "prefill_chunks": ("engine_prefill_chunks_total", "counter", int),
        "prefill_compiles": ("engine_prefill_compiles_total", "counter",
                             int),
        "decode_compiles": ("engine_decode_compiles_total", "counter", int),
        "transfer_compiles": ("engine_transfer_compiles_total", "counter",
                              int),
        "occupancy_sum": ("engine_occupancy_sum", "gauge", float),
        "peak_pages": ("engine_peak_pages", "gauge", int),
        "pages_total": ("engine_pages_total", "gauge", int),
        "wall_s": ("engine_wall_seconds", "gauge", float),
        "prefill_tokens_computed": ("engine_prefill_tokens_computed_total",
                                    "counter", int),
        "prefill_tokens_cached": ("engine_prefill_tokens_cached_total",
                                  "counter", int),
        "prefill_tokens_host": ("engine_prefill_tokens_host_total",
                                "counter", int),
        "prefix_evictions": ("engine_prefix_evictions", "gauge", int),
        "handoffs_out": ("engine_handoffs_out_total", "counter", int),
        "handoffs_in": ("engine_handoffs_in_total", "counter", int),
        "preemptions": ("engine_preemptions_total", "counter", int),
        "prefill_wall_s": ("engine_prefill_wall_seconds", "gauge", float),
        "decode_wall_s": ("engine_decode_wall_seconds", "gauge", float),
    }
    _HISTOGRAMS = ("serve_ttft_seconds", "serve_intertoken_seconds")

    def __init__(self, registry: Optional[obs.Registry] = None,
                 labels: Optional[Dict[str, str]] = None, **initial):
        reg = registry if registry is not None else obs.Registry()
        object.__setattr__(self, "registry", reg)
        object.__setattr__(self, "labels", dict(labels or {}))
        for metric, kind, _ in self._SPECS.values():
            if kind == "counter":
                reg.counter(metric)
            else:
                reg.gauge(metric)
        reg.histogram("serve_ttft_seconds",
                      "Request admission -> first emitted token",
                      buckets=obs.TTFT_BUCKETS)
        reg.histogram("serve_intertoken_seconds",
                      "Gap between consecutive emitted tokens of a request",
                      buckets=obs.INTERTOKEN_BUCKETS)
        for name, v in initial.items():
            setattr(self, name, v)

    def __getattr__(self, name):
        spec = self._SPECS.get(name)
        if spec is None:
            raise AttributeError(name)
        metric, _, typ = spec
        return typ(self.registry.get(metric).value(**self.labels))

    def __setattr__(self, name, value) -> None:
        spec = self._SPECS.get(name)
        if spec is None:
            raise AttributeError(f"EngineMetrics has no field {name!r}")
        metric, _, typ = spec
        self.registry.get(metric).set(typ(value), **self.labels)

    def reset(self, keep_compiles: bool = True) -> None:
        pc, dc, tc = (self.prefill_compiles, self.decode_compiles,
                      self.transfer_compiles)
        for name in self._SPECS:
            setattr(self, name, 0)
        for name in self._HISTOGRAMS:
            self.registry.get(name).reset(**self.labels)
        if keep_compiles:
            self.prefill_compiles, self.decode_compiles = pc, dc
            self.transfer_compiles = tc

    def to_dict(self) -> Dict[str, float]:
        d = {name: getattr(self, name) for name in self._SPECS}
        d["occupancy"] = (self.occupancy_sum / self.decode_steps
                          if self.decode_steps else 0.0)
        d["page_utilization"] = (self.peak_pages / self.pages_total
                                 if self.pages_total else 0.0)
        d["tokens_per_s"] = (self.tokens_out / self.wall_s
                             if self.wall_s > 0 else 0.0)
        prompt = self.prefill_tokens_computed + self.prefill_tokens_cached
        d["prefix_hit_rate"] = (self.prefill_tokens_cached / prompt
                                if prompt else 0.0)
        return d

    def observe_ttft(self, seconds: float) -> None:
        self.registry.get("serve_ttft_seconds").observe(seconds,
                                                        **self.labels)

    def observe_intertoken(self, seconds: float) -> None:
        self.registry.get("serve_intertoken_seconds").observe(
            seconds, **self.labels)

    def latency_quantiles(self) -> Dict[str, float]:
        """p50/p95/p99 TTFT and inter-token gap (host seconds) from the
        fixed buckets."""
        out = {}
        for short, metric in (("ttft", "serve_ttft_seconds"),
                              ("intertoken", "serve_intertoken_seconds")):
            h = self.registry.get(metric)
            for q in (0.5, 0.95, 0.99):
                out[f"{short}_p{int(q * 100)}_s"] = h.quantile(
                    q, **self.labels)
            out[f"{short}_count"] = h.count(**self.labels)
        return out


class Engine:
    """Continuous-batching serving engine (add_request / step / collect).

    ``plan`` (``plan.make_serve_plan``) supplies the ranks (its
    ``ThreadMesh`` when it has more than one device), the arrangement, the
    decode slot count, the page size, the capacity, the prefix cache and
    the kernel knobs; ``model`` the parameters and the device. With
    ``comm`` a ``ProcessComm`` of the plan's mesh this engine is that rank
    process's alone (module doc): ``model`` is its ``rank_model``.
    ``on_prefill``, when set, is called with ``(uid, hidden)`` as each
    prompt's prefill completes, where ``hidden`` is the (1, 1, D)
    next-token hidden state (rank 0's) its first token is sampled from.
    ``registry`` holds the metrics (a private registry by default), under
    ``labels`` (the gateway's ``{replica=i}``; the connector's series
    too); ``tracer`` records the spans (``obs.NULL_TRACER`` by default).
    """

    def __init__(self, model: Model, plan,
                 eng: EngineConfig = EngineConfig(),
                 registry: Optional[obs.Registry] = None,
                 labels: Optional[Dict[str, str]] = None,
                 tracer: Optional[obs.Tracer] = None, comm=None):
        cfg = model.cfg
        ok, why = paged_cache.supported(cfg)
        if not ok:
            raise NotImplementedError(f"repro_torch.engine: {cfg.name}: {why}")
        if not plan.decode_batch or not plan.page_size:
            raise ValueError("engine plans need the serving face "
                             "(decode_batch/page_size > 0): build them with "
                             "plan.make_serve_plan")
        eng = dataclasses.replace(
            eng, max_slots=plan.decode_batch, page_size=plan.page_size,
            max_len=plan.seq_len)
        self.moe = transformer.has_moe(cfg)
        if self.moe and eng.prefill_chunk > 0:
            # a chunk's tokens would compete for expert capacity without
            # the rest of the prompt: chunked != monolithic
            raise NotImplementedError(
                f"repro_torch.engine: {cfg.name}: chunked prefill is unsound "
                "for MoE stacks (expert capacity couples a chunk's tokens "
                "to the rest of the prompt)")
        if self.moe and plan.prefix_cache:
            raise NotImplementedError(
                f"repro_torch.engine: {cfg.name}: prefix caching is unsound "
                "for MoE stacks (capacity couples prefix KV to the suffix)")
        self.model, self.plan, self.eng, self.cfg = model, plan, eng, cfg
        self.device = model.device
        self.sp = plan.sp_size
        if comm is None:
            self.mesh = plan.build_mesh()
        else:
            plan.check_runnable()
            got = (comm.c, comm.r, comm.data, comm.placement)
            want = (plan.c, plan.r, plan.data, plan.placement)
            if got != want:
                raise ValueError(f"the ProcessComm's (c, r, data, placement) "
                                 f"{got} are not the plan's {want}")
            self.mesh = None
        # the rank runtime on one card or this process's rank; a
        # ThreadMesh's ranks swap in their comms
        rt = train_step.make_runtime(model, plan.run_config(),
                                     plan.shape_config(), comm)
        self.rt = dataclasses.replace(
            rt, batch_axes=(), st_cfg=dataclasses.replace(
                rt.st_cfg, seq_scheme="contiguous"))
        n_ranks = self.mesh.size if self.mesh is not None else 1
        # each rank's parameter tree under the plan's rules, views of the
        # model's tensors, built at the rank's first step (_on_ranks)
        self._params: List[Optional[RankParams]] = [None] * n_ranks
        self.pools: List[Dict[str, torch.Tensor]] = [
            paged_cache.init_pools(cfg, eng.pages_per_shard, eng.page_size,
                                   self.device) for _ in range(n_ranks)]
        # prompts pad to this multiple (module doc)
        self._quantum = (self.sp * self.rt.st_cfg.comm_chunks
                         if self.sp > 1 else 1)
        base = math.lcm(self.sp, eng.page_size)
        self._chunk = (bucket_pow2(max(eng.prefill_chunk, base), base)
                       if eng.prefill_chunk > 0 else 0)
        self._prefilling: List[SlotState] = []
        self.on_prefill: Optional[Callable[[str, torch.Tensor], None]] = None
        self.metrics = EngineMetrics(
            registry, labels, pages_total=self.sp * eng.pages_per_shard)
        self.registry = self.metrics.registry
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self._arrival: Dict[str, float] = {}
        self._last_emit: Dict[str, float] = {}
        self._req_spans: Dict[str, Optional[str]] = {}
        self.ttft_s: Dict[str, float] = {}
        if comm is None:
            # the pools of every rank holding each SP shard, data replica 0
            # first: the host-link transfers' view (paged_cache.read_pages)
            where = self._on_ranks(
                lambda rt, *_: (rt.comm.axis_index(DATA_AXIS), rt.sp_rank()))
            self._shards: List[List[Dict[str, torch.Tensor]]] = [
                [] for _ in range(self.sp)]
            for rank in sorted(range(n_ranks), key=lambda i: where[i]):
                self._shards[where[rank][1]].append(self.pools[rank])

            def read_fn(idx):
                return paged_cache.read_pages(self._shards, idx)

            def write_fn(idx, data):
                paged_cache.write_pages(self._shards, idx, data)
        else:
            # a rank process holds its own pool: the pages cross by
            # collectives (module doc)
            def read_fn(idx):
                return paged_cache.read_pages_rank(self.rt, self.pools[0],
                                                   idx)

            def write_fn(idx, data):
                paged_cache.write_pages_rank(self.rt, self.pools[0], idx,
                                             data)
        self._cost_memo: Dict[int, float] = {}
        self._spill_memo: Dict[int, bool] = {}
        self.connector = kv_connector.KVConnector(
            read_fn=read_fn, write_fn=write_fn,
            bucket=kv_connector.TRANSFER_BUCKET, page_size=eng.page_size,
            pages_per_shard=eng.pages_per_shard,
            page_bytes=sum(t[:, 0].numel() * t.element_size()
                           for t in self.pools[0].values()),
            capacity_bytes=plan.host_tier_bytes,
            spill_fn=self._spill_worthwhile, registry=self.registry,
            labels=labels, device=self.device)
        self._handoff_ready: List[SlotState] = []
        self.scheduler = self._new_scheduler()

    def _new_scheduler(self) -> Scheduler:
        sched = Scheduler(max_slots=self.eng.max_slots,
                          page_size=self.eng.page_size, sp=self.sp,
                          pages_per_shard=self.eng.pages_per_shard,
                          max_len=self.eng.max_len)
        sched.connector = self.connector
        if self.plan.prefix_cache:
            from repro_torch.gateway.prefix_cache import PrefixCache

            sched.prefix_cache = PrefixCache(
                sched.pool, page_size=self.eng.page_size, sp=self.sp,
                cost_fn=self._recompute_cost,
                connector=(self.connector if self.connector.enabled
                           else None))
        return sched

    def _recompute_cost(self, chain_tokens: int) -> float:
        """Eviction ranking: seconds to prefill a chain cold."""
        c = self._cost_memo.get(chain_tokens)
        if c is None:
            from repro_torch.plan import cost as plan_cost

            c = plan_cost.prefill_step_cost(
                self.cfg, prompt_len=chain_tokens, sp=self.sp,
                page_size=self.eng.page_size)["total_s"]
            self._cost_memo[chain_tokens] = c
        return c

    def _spill_worthwhile(self, chain_tokens: int) -> bool:
        """Under host-tier pressure: does the transfer round trip beat
        recomputing this chain (``plan.cost.spill_decision``)?"""
        v = self._spill_memo.get(chain_tokens)
        if v is None:
            from repro_torch.plan import cost as plan_cost

            v = bool(plan_cost.spill_decision(
                self.cfg, chain_tokens=chain_tokens, sp=self.sp,
                page_size=self.eng.page_size)["spill"])
            self._spill_memo[chain_tokens] = v
        return v

    @property
    def prefix_cache(self):
        return self.scheduler.prefix_cache

    # ---- request lifecycle ---------------------------------------------
    def add_request(self, req: Request) -> Optional[Rejection]:
        """Queue ``req``. Returns ``None`` on success or a typed
        :class:`Rejection` for an unserveable request."""
        rej = self.scheduler.validate(req)
        if rej is not None:
            return rej
        self.scheduler.queue.append(req)
        self._arrival[req.uid] = time.monotonic()
        self._req_spans[req.uid] = self.tracer.async_begin(
            "request", uid=req.uid, prompt_len=req.prompt_len,
            max_new=req.max_new_tokens)
        return None

    def preempt(self, uid: str) -> Optional[Request]:
        """Take ``uid`` out of the engine, keeping its progress, and return
        the *resume request* to add later (here or on another engine);
        ``None`` if the uid is neither queued nor active here, or holds a
        handoff slot (its exported KV is pinned until released).

        The resume request's prompt is ``tokens + out`` with the remaining
        budget: sampling folds the prefill's key with ``prompt_len`` and a
        decode step's with ``cache_len + 1``, so the resumed stream
        continues as the uninterrupted one would, up to bf16 near-ties
        (the tail block is recomputed by a prefill where the original run
        wrote it with decode steps). With the prefix cache, the slot's
        complete valid KV blocks are registered in the trie first, so the
        resume prefill is mostly a cache hit; under pressure those blocks
        spill to the host tier like any cached chain.
        """
        for i, r in enumerate(self.scheduler.queue):
            if r.uid == uid:                 # still queued: nothing started
                del self.scheduler.queue[i]
                self._arrival.pop(uid, None)
                self.tracer.async_end(
                    "request", self._req_spans.pop(uid, None), preempted=True)
                self.metrics.preemptions += 1
                return r
        st = next((s for s in self.scheduler.active() if s.req.uid == uid),
                  None)
        if st is None or st.req.handoff:
            return None
        req = st.req
        seq = list(req.tokens) + [int(t) for t in st.out]
        # KV is valid through max(cache_len, prefill_pos): decode keeps
        # cache_len, a mid-chunk prefill only prefill_pos. pending_reload
        # blocks hold nothing until _advance_prefill lands them, so a slot
        # that never ran a chunk registers nothing new (its device-hit
        # prefix is already in the trie)
        valid = max(st.cache_len, st.prefill_pos)
        pc = self.prefix_cache
        if pc is not None and not st.pending_reload:
            full = valid // self.eng.page_size
            if full > 0:
                pc.insert(pc.hashes(seq)[:full], st.pages[:full])
        if st in self._prefilling:
            self._prefilling.remove(st)
        remaining = req.max_new_tokens - len(st.out)
        self.scheduler.finish(st.slot, self.metrics.steps)
        self.scheduler.finished.pop(uid, None)    # not finished: preempted
        self.metrics.preemptions += 1
        self._arrival.pop(uid, None)
        self._last_emit.pop(uid, None)
        self.tracer.async_end("request", self._req_spans.pop(uid, None),
                              preempted=True, tokens=len(st.out))
        if not st.out:
            return req
        return dataclasses.replace(req, tokens=seq, max_new_tokens=remaining)

    def _finish_request(self, st: SlotState) -> None:
        self.scheduler.finish(st.slot, self.metrics.steps)
        self.metrics.finished += 1
        uid = st.req.uid
        self._arrival.pop(uid, None)
        self._last_emit.pop(uid, None)
        self.tracer.async_end("request", self._req_spans.pop(uid, None),
                              tokens=len(st.out))

    def collect(self) -> Dict[str, List[int]]:
        """uid -> generated tokens, for every finished request."""
        return {uid: list(st.out)
                for uid, st in self.scheduler.finished.items()}

    def reset(self) -> None:
        """Drop all requests and cache contents (the prefix cache and the
        host tier too) and zero every rank's pools."""
        for pools in self.pools:
            for t in pools.values():
                t.zero_()
        self.connector.reset()
        self.scheduler = self._new_scheduler()
        self._prefilling = []
        self._handoff_ready = []
        self._arrival.clear()
        self._last_emit.clear()
        self._req_spans.clear()
        self.ttft_s.clear()
        self.metrics.reset(keep_compiles=True)
        self.metrics.pages_total = self.scheduler.pages_total()

    # ---- device work ----------------------------------------------------
    def _on_ranks(self, fn, rt: Optional[Runtime] = None) -> List:
        """``fn(rank_rt, rank_pools, rank_params)`` on every rank under
        ``no_grad``, results in rank order (module doc;
        ``models.factory.run_on_ranks``): one entry, this rank's, in a rank
        process. ``rt`` (default the engine's) is the template whose
        communicator each ``ThreadMesh`` rank's replaces."""
        return run_on_ranks(
            self.mesh, rt or self.rt, self.model, self._params,
            lambda rank_rt, rank, tree: fn(rank_rt, self.pools[rank], tree))

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _padded(self, tokens: List[int]) -> torch.Tensor:
        """(1, S) tokens zero-padded to a multiple of the prompt quantum
        (a MoE stack's to the JAX bucket first), on the device."""
        n = len(tokens)
        if self.moe:
            n = bucket_pow2(n, math.lcm(self.sp, self.eng.page_size))
        n = -(-n // self._quantum) * self._quantum
        buf = np.zeros((1, n), np.int64)
        buf[0, :len(tokens)] = tokens
        return self._tensor(buf, torch.int64)

    @staticmethod
    def _rank_slice(rt, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice of (1, S) tokens."""
        s_loc = tokens.shape[1] // rt.sp_size()
        return tokens[:, rt.sp_rank() * s_loc:(rt.sp_rank() + 1) * s_loc]

    def _prefill_rank(self, rt, tree, tokens, n_real: int):
        """This rank's ``lm_prefill`` of the padded prompt ``tokens`` (1, S)
        of ``n_real`` real tokens: (hidden (1, 1, D), its slice's cache,
        ``serve.kv_cache``'s)."""
        from repro_torch.serve import step as serve_step

        S = tokens.shape[1]
        rt = dataclasses.replace(rt, st_cfg=dataclasses.replace(
            rt.st_cfg, seq_len=S))
        prompt_len = (None if S == n_real else
                      torch.full((1,), n_real, dtype=torch.int32,
                                 device=tokens.device))
        return serve_step.lm_prefill(
            rt, tree, self._rank_slice(rt, tokens), self.cfg,
            prompt_len=prompt_len, return_hidden=True)

    def prefill_hidden(self, tokens: List[int], rt: Optional[Runtime] = None):
        """The next-token hidden state (1, 1, D) and the prefill K/V stacks
        (L, 1, len(tokens), Hkv, hd) of one prompt, under ``rt`` (default
        the engine's runtime) on every rank: rank 0's hidden state, the
        ranks' K/V slices joined in sequence order (an all-gather over the
        SP axes, off the ledger), on this rank (rank 0 of a
        ``ThreadMesh``)."""
        padded = self._padded(tokens)
        n = len(tokens)

        def rank_fn(r, _, tree):
            last, cache = self._prefill_rank(r, tree, padded, n)
            with r.comm.ledger.uncounted():
                kv = tuple(r.all_gather_model(t, axis=2)[:, :, :n]
                           for t in kv_cache.kv_stacks(cache))
            return self._rank0(r, last), kv

        return self._on_ranks(rank_fn, rt)[0]

    @staticmethod
    def _rank0(rt, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank: an all-gather over the whole mesh,
        off the ledger (module doc)."""
        with rt.comm.ledger.uncounted():
            return rt.comm.all_gather(x[None], MESH_AXES, 0)[0]

    @staticmethod
    def _agreed(rt, toks: torch.Tensor) -> np.ndarray:
        """This rank's sampled ``toks`` on the host, once every rank's
        have been seen equal: an all-gather over the whole mesh, off the
        ledger. Every rank raises if one rank's differ (module doc)."""
        with rt.comm.ledger.uncounted():
            every = rt.comm.all_gather(toks[None], MESH_AXES, 0)
        every = every.cpu().numpy()
        if (every != every[0]).any():
            raise RuntimeError(f"the ranks sampled different tokens: {every}")
        return every[0]

    def _row_params(self, reqs: List[Optional[Request]]
                    ) -> Dict[str, torch.Tensor]:
        """(B,) device tensors of the rows' temperature, top_k and top_p;
        a row without a request (padding) is greedy."""
        return {"temperature": self._tensor(
                    [r.temperature if r else 0.0 for r in reqs],
                    torch.float32),
                "top_k": self._tensor([r.top_k if r else 0 for r in reqs],
                                      torch.int32),
                "top_p": self._tensor([r.top_p if r else 1.0 for r in reqs],
                                      torch.float32)}

    def _advance_prefill(self, st: SlotState
                         ) -> Optional[Tuple[torch.Tensor, int]]:
        """Run one prefill chunk of ``st`` (the whole remaining prompt when
        chunking is off). Returns the next-token hidden state (1, 1, D) and
        the first token when the prompt completes, else None.

        A leading chunk (``prefill_pos == 0``) runs the full-forward prefill
        and inserts its K/V into the slot's pages; every later chunk is a
        suffix prefill with ``cached_len = prefill_pos``, reading the pages
        earlier chunks (or the prefix cache) populated in place. Only the
        final chunk's token is kept; a sampled one folds its key with
        ``prompt_len``, as the monolithic path does, so chunking never
        changes the stream. Host-tier hits are reloaded into their fresh
        pages first (``engine/host_reload``), inside ``prefill_wall_s``.
        """
        from repro_torch.serve import step as serve_step

        t0 = time.monotonic()
        req = st.req
        m = self.metrics
        if st.pending_reload:
            # land the host-tier hits' KV before any forward reads it
            with self.tracer.span("engine/host_reload", cat="engine",
                                  uid=req.uid, blocks=len(st.pending_reload)):
                self.connector.reload(st.pending_reload)
            m.prefill_tokens_host += st.host_len
            st.pending_reload = []
        start = st.prefill_pos
        end = req.prompt_len if not self._chunk \
            else min(start + self._chunk, req.prompt_len)
        final = end == req.prompt_len
        table_row = self.scheduler.table[st.slot]
        tokens = self._padded(req.tokens[start:end])
        ps = self.eng.page_size
        sampled = final and req.temperature > 0.0
        if sampled:
            params = self._row_params([req])
            keys = [sampling.fold_in(sampling.seed_key(req.seed),
                                     req.prompt_len)]

        def rank_fn(rt, pools, tree):
            if start:
                last = serve_step.lm_prefill_paged(
                    rt, tree, self._rank_slice(rt, tokens), self.cfg,
                    prompt_len=end, cached_len=start, pools=pools,
                    table_row=table_row, page_size=ps)
            else:
                last, cache = self._prefill_rank(rt, tree, tokens, end)
                paged_cache.insert_prompt(rt, pools,
                                          *kv_cache.kv_stacks(cache),
                                          table_row, end, ps)
            if not final:
                return None
            if sampled:
                tok = sampling.sample(rt, tree.head, last, self.cfg,
                                      keys=keys, **params)[0]
            else:
                tok = sampling.greedy(rt, tree.head, last, self.cfg)[0]
            return self._rank0(rt, last), self._agreed(rt, tok)

        out = self._on_ranks(rank_fn)[0]
        result = None
        if final:
            result = (out[0], int(out[1][0]))
        st.prefill_pos = end
        m.prefill_tokens_computed += end - start
        m.prefill_chunks += 1
        m.prefill_wall_s += time.monotonic() - t0
        return result

    def _complete_prefill(self, st: SlotState, last: torch.Tensor, tok: int,
                          emitted: List[Tuple[str, int]]) -> None:
        """Emit the first token ``tok`` sampled from ``last``, offer the
        prompt's full blocks to the prefix cache and start the slot's
        decode."""
        m = self.metrics
        if self.on_prefill is not None:
            self.on_prefill(st.req.uid, last)
        self._prefilling.remove(st)
        self.scheduler.register_prefix(st)
        m.prefill_tokens_cached += st.cached_len
        st.cache_len = st.req.prompt_len
        st.out.append(tok)
        st.first_token_step = m.steps
        emitted.append((st.req.uid, tok))
        m.prefills += 1
        m.tokens_out += 1
        now = time.monotonic()
        arrived = self._arrival.get(st.req.uid)
        if arrived is not None:
            m.observe_ttft(now - arrived)
            self.ttft_s[st.req.uid] = now - arrived
        self._last_emit[st.req.uid] = now
        if st.done:
            if st.req.handoff:
                # keep the slot and its pages' refs until the caller exports
                # the prompt KV: finishing here could recycle the pages
                self._handoff_ready.append(st)
                m.handoffs_out += 1
            else:
                self._finish_request(st)

    # ---- disaggregated prefill -> decode handoff ------------------------
    def take_handoffs(self) -> List[SlotState]:
        """Slots whose handoff prefill has finished (prompt KV still
        pinned). The caller must ``export_kv`` then ``release_handoff``
        each one."""
        out, self._handoff_ready = self._handoff_ready, []
        return out

    def export_kv(self, st: SlotState) -> List[Dict[str, torch.Tensor]]:
        """The slot's prompt-KV pages on the host, in block order. The
        partial tail block rides along: positions past ``prompt_len`` are
        never read (validity is positional)."""
        nb_kv = math.ceil(st.req.prompt_len / self.eng.page_size)
        return self.connector.export(st.pages[:nb_kv])

    def release_handoff(self, st: SlotState) -> None:
        """Drop the handoff slot after its KV has been exported."""
        self._finish_request(st)

    def add_prefilled(self, req: Request, first_token: int,
                      blocks: List[Dict[str, torch.Tensor]]) -> None:
        """Decode-side entry point: queue a request whose prompt KV
        (``export_kv`` of another engine) and first token came from a
        prefill engine. No TTFT is observed here: the prefill engine
        emitted the first token."""
        self.scheduler.enqueue_prefilled(req, first_token, blocks)

    def _decode(self, active: List[SlotState], width: int) -> np.ndarray:
        """One decode step of every slot; the sampling operands go in only
        when some active row samples (the JAX engine's ``sampled``
        switch), padding rows decode greedily."""
        from repro_torch.serve import step as serve_step

        t0 = time.monotonic()
        B = self.eng.max_slots
        tokens = np.zeros((B, 1), np.int64)
        cache_len = np.zeros((B,), np.int32)
        act = np.zeros((B,), bool)
        rows: List[Optional[Request]] = [None] * B
        for st in active:
            tokens[st.slot, 0] = st.out[-1]
            cache_len[st.slot] = st.cache_len
            act[st.slot] = True
            rows[st.slot] = st.req
        samp = None
        if any(st.req.temperature > 0.0 for st in active):
            samp = self._row_params(rows)
            samp["seeds"] = [r.seed if r is not None and r.temperature > 0.0
                             else None for r in rows]
        paged = paged_cache.PagedTables(
            table=np.ascontiguousarray(self.scheduler.table[:, :, :width]),
            cache_len=cache_len, active=act, page_size=self.eng.page_size,
            device=self.device)
        tokens_d = self._tensor(tokens, torch.int64)
        cache_len_d = self._tensor(cache_len, torch.int32)
        tok = self._on_ranks(lambda rt, pools, tree: self._agreed(
            rt, serve_step.lm_decode_step(
                rt, tree, pools, tokens_d, self.cfg, cache_len_d, paged,
                sampling=samp)))[0]
        self.metrics.decode_wall_s += time.monotonic() - t0
        return tok

    # ---- driver ---------------------------------------------------------
    def step(self) -> List[Tuple[str, int]]:
        """One driver iteration: advance in-flight chunked prefills (one
        chunk each), admit (one chunk for each admission), then one decode
        step for every slot whose prefill has completed. Returns the
        (uid, token) pairs emitted this step."""
        with self.tracer.span("engine/step", cat="engine",
                              step=self.metrics.steps):
            return self._step_inner()

    def _step_inner(self) -> List[Tuple[str, int]]:
        t0 = time.monotonic()
        emitted: List[Tuple[str, int]] = []
        m = self.metrics
        tracer = self.tracer
        # commit the spills the previous step's evictions staged: host-tier
        # entries become hittable only once their copy has landed
        self.connector.flush()
        # the handoff inbox: prompts prefilled on another engine enter with
        # their exported pages and first token, skipping the prefill
        for st, tok, blocks in self.scheduler.admit_prefilled(m.steps):
            with tracer.span("engine/handoff_inject", cat="engine",
                             uid=st.req.uid, blocks=len(blocks)):
                nb_kv = math.ceil(st.req.prompt_len / self.eng.page_size)
                self.connector.inject(st.pages[:nb_kv], blocks)
            st.cache_len = st.req.prompt_len
            st.prefill_pos = st.req.prompt_len
            st.out.append(tok)
            st.first_token_step = m.steps
            m.handoffs_in += 1
            self._last_emit[st.req.uid] = time.monotonic()
            if st.done:                      # a 1-token budget
                self._finish_request(st)
        # chunked prefills admitted on earlier steps go before this step's
        # admissions (FIFO progress)
        for st in list(self._prefilling):
            with tracer.span("engine/prefill_chunk", cat="engine",
                             uid=st.req.uid, start=st.prefill_pos):
                done = self._advance_prefill(st)
            if done is not None:
                self._complete_prefill(st, *done, emitted)
        while True:
            # one at a time: each admission registers its prompt blocks
            # before the next is matched, so a burst sharing a prefix hits
            # the cache (a chunked prompt registers after its last chunk)
            batch = self.scheduler.admit(m.steps, limit=1)
            if not batch:
                break
            st = batch[0]
            self._prefilling.append(st)
            with tracer.span("engine/prefill", cat="engine",
                             uid=st.req.uid, prompt_len=st.req.prompt_len,
                             cached_len=st.cached_len):
                done = self._advance_prefill(st)
            if done is not None:
                self._complete_prefill(st, *done, emitted)
        if self.prefix_cache is not None:
            m.prefix_evictions = self.prefix_cache.evicted_pages

        # decode: slots whose prefill has completed (a mid-chunk slot holds
        # pages but has no token stream yet; a finished handoff slot only
        # awaits its export)
        active = [st for st in self.scheduler.active()
                  if st.cache_len > 0 and not st.done]
        if active:
            width = self.scheduler.decode_width()
            with tracer.span("engine/decode", cat="engine", width=width,
                             active=len(active)):
                tok = self._decode(active, width)
            now = time.monotonic()
            for st in active:
                t = int(tok[st.slot, 0])
                st.out.append(t)
                st.cache_len += 1
                emitted.append((st.req.uid, t))
                m.tokens_out += 1
                last = self._last_emit.get(st.req.uid)
                if last is not None:
                    m.observe_intertoken(now - last)
                self._last_emit[st.req.uid] = now
                if st.done:
                    self._finish_request(st)
            m.decode_steps += 1
            m.occupancy_sum += len(active) / self.eng.max_slots

        m.peak_pages = max(m.peak_pages, self.scheduler.pages_in_use())
        m.steps += 1
        m.wall_s += time.monotonic() - t0
        return emitted

    def idle(self) -> bool:
        return not self.scheduler.queue and not self.scheduler.prefilled \
            and not self.scheduler.active()

    def run(self, max_steps: Optional[int] = None) -> Dict[str, List[int]]:
        """Drive until every queued/running request finishes."""
        limit = max_steps or self.eng.max_steps
        n = 0
        while not self.idle():
            emitted = self.step()
            if not emitted and not self.scheduler.active():
                raise RuntimeError(
                    f"engine stalled with {len(self.scheduler.queue)} queued "
                    "requests and no admissible slot/pages")
            n += 1
            if n > limit:
                raise RuntimeError(f"engine did not drain in {limit} steps")
        return self.collect()


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; there is no silent CPU fallback. A CUDA
    device comes back with its index (``cuda`` -> ``cuda:0``), the form a
    tensor's ``.device`` reports, so the two compare equal."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def build_engine(arch: str, *, smoke: bool = True, c: Optional[int] = 1,
                 data: int = 1, eng: EngineConfig = EngineConfig(),
                 model: Optional[Model] = None, init_seed: int = 0,
                 kernel: Optional[str] = None, block: Optional[str] = None,
                 plan=None, device=None,
                 registry: Optional[obs.Registry] = None,
                 tracer: Optional[obs.Tracer] = None, comm=None) -> Engine:
    """Build the engine on ``device`` (default: the CUDA card, raising if
    there is none) for ``plan``, or for a serve plan of ``data`` replicas
    at SP degree 1 when none is given. A plan of SP degree > 1 runs its
    ranks as ``ThreadMesh`` threads on that one device, or, with ``comm``
    a ``ProcessComm`` of the plan's mesh, this rank process's engine alone
    (``Engine``; ``device`` then the rank's). ``model`` supplies the
    weights (e.g. ``factory.from_jax_params``; a rank process's
    ``factory.rank_model``); else they are drawn from ``init_seed`` on the
    device, the weights of a one-process engine there, of which a rank
    process keeps only its shards. ``kernel`` / ``block`` pick the
    paged-decode and ring-block implementations ('ref' | 'cuda');
    ``registry`` and ``tracer`` go to the ``Engine``."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.models.factory import build_model, build_rank_model
    from repro_torch.plan import make_serve_plan

    device = resolve_device(device)
    cfg = arch_registry.get_smoke(arch) if smoke else arch_registry.get(arch)
    if plan is None:
        plan = make_serve_plan(
            cfg, arch=arch, n_devices=data, data=data, c=c,
            decode_batch=eng.max_slots, page_size=eng.page_size,
            max_len=eng.max_len, kernel_impl=kernel, block_impl=block)
    if model is None:
        model = (build_model(cfg, device=device, seed=init_seed)
                 if comm is None else build_rank_model(
                     cfg, comm, plan.sharding_rules, device, init_seed))
    elif model.device != device:
        raise ValueError(f"model lives on {model.device}, engine on {device}")
    return Engine(model, plan, eng, registry=registry, tracer=tracer,
                  comm=comm)
