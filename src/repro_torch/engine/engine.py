"""The serving engine: continuous batching over the paged KV cache (the
port's counterpart of ``repro.engine.engine``).

The engine owns two kinds of state:

  * **device** — the model and every rank's page pools
    (``paged_cache.init_pools``: ``pages_per_shard`` pages each), on the
    card unless the caller asks for the CPU;
  * **host** — the ``Scheduler`` (slots, page free lists, page table, FIFO
    queue), the prefix cache and sampling's bookkeeping, on the thread
    that calls ``step()``.

``step()`` is one driver iteration: advance every in-flight chunked
prefill by one chunk, admit queued requests into free slots (each
admission runs its first chunk, the whole prompt when chunking is off),
then one decode step for every slot whose prefill has completed, then
evict finished requests. Outputs are identical to serving each request
alone: attention, MLP and sampling are row-independent and page content is
per slot.

A prompt's leading chunk runs the full-forward prefill and inserts its K/V
into the slot's pages; every later chunk, and the uncached suffix of a
prefix-cache hit (``plan.prefix_cache``: ``gateway.prefix_cache`` shares
the hit pages), runs the *suffix* prefill (``serve.step.lm_prefill_paged``)
that reads the pages already written in place. The prompt's full blocks are
offered to the prefix cache after its last chunk.

Device steps run on every rank of the plan (``_on_ranks``): on one rank
(``SingleComm``) when the plan has one device, else as the threads of the
plan's ``ThreadMesh`` (``plan.build_mesh``: data x C*C*R ranks on one
card or on the CPU), each with its own ``Runtime`` over its rank's
communicator and its own pool shard. The rank runtimes are the JAX
engine's: ``train.step.make_runtime`` on the plan's run config with
``batch_axes=()`` and the contiguous sequence layout, so StarTrail's team
gathers and sub-rings run in the prefill, B4's and B6's partials merge
across ranks, and data replicas compute the same batch. The ranks share
one copy of the weights (the port stores parameters whole). Each rank
samples greedily (vocab-parallel, ties to the lowest token id); every
rank's tokens must be equal, and the engine raises if they are not.

What the engine does not port raises ``NotImplementedError`` naming the
ROADMAP item: temperature sampling, the host tier, disaggregated handoff
and preemption, and ranks on several cards.

Prompts and chunks are prefilled at their own length, padded at the end to
a multiple of ``P_sp * comm_chunks`` when P_sp > 1 so that every rank holds
an equal contiguous slice and every ring transfer splits evenly: the JAX
engine pads to power-of-two buckets for its jit caches, but eager PyTorch
compiles nothing and the kernels mask ragged edges. So
``prefill_compiles`` / ``decode_compiles`` keep their names in
``EngineMetrics`` and stay 0. The chunk size keeps the JAX rule:
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

from repro_torch.engine import paged_cache, sampling
from repro_torch.engine.scheduler import (Rejection, Request, Scheduler,
                                          SlotState, bucket_pow2)
from repro_torch.models.factory import Model
from repro_torch.models.runtime import Runtime
from repro_torch.train import step as train_step


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch.engine: {what} is not ported yet (ROADMAP.md §A)")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4          # decode batch width (slots)
    page_size: int = 8          # tokens per KV page
    pages_per_shard: int = 128  # pool capacity per SP shard
    max_len: int = 512          # max prompt_len + max_new_tokens
    max_steps: int = 100_000    # runaway guard for run()
    prefill_chunk: int = 0      # > 0: prefill prompts in chunks
    host_tier_bytes: int = 0    # > 0 (pinned-host KV tier) is not ported


class EngineMetrics:
    """Dict-backed engine metrics with the JAX engine's field names
    (``m.steps += 1``, ``to_dict()``, ``reset(keep_compiles=True)``), plus
    the host seconds spent in prefill and in decode steps. Each of those
    intervals ends with the sampled tokens copied to the host, so it
    includes the device work."""

    FIELDS = {
        "steps": int, "decode_steps": int, "prefills": int, "finished": int,
        "tokens_out": int, "prefill_chunks": int, "prefill_compiles": int,
        "decode_compiles": int, "transfer_compiles": int,
        "occupancy_sum": float, "peak_pages": int, "pages_total": int,
        "wall_s": float, "prefill_tokens_computed": int,
        "prefill_tokens_cached": int, "prefill_tokens_host": int,
        "prefix_evictions": int, "handoffs_out": int, "handoffs_in": int,
        "preemptions": int, "prefill_wall_s": float, "decode_wall_s": float,
    }

    def __init__(self, **initial):
        object.__setattr__(self, "_v", {k: t() for k, t in
                                        self.FIELDS.items()})
        object.__setattr__(self, "ttft_s", [])
        object.__setattr__(self, "intertoken_s", [])
        for name, v in initial.items():
            setattr(self, name, v)

    def __getattr__(self, name):
        try:
            return self.__dict__["_v"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value) -> None:
        if name not in self.FIELDS:
            raise AttributeError(f"EngineMetrics has no field {name!r}")
        self._v[name] = self.FIELDS[name](value)

    def reset(self, keep_compiles: bool = True) -> None:
        keep = {k: self._v[k] for k in ("prefill_compiles", "decode_compiles",
                                        "transfer_compiles")}
        for name, typ in self.FIELDS.items():
            self._v[name] = typ()
        if keep_compiles:
            self._v.update(keep)
        self.ttft_s.clear()
        self.intertoken_s.clear()

    def to_dict(self) -> Dict[str, float]:
        d = dict(self._v)
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
        self.ttft_s.append(seconds)

    def observe_intertoken(self, seconds: float) -> None:
        self.intertoken_s.append(seconds)

    def latency_quantiles(self) -> Dict[str, float]:
        """p50/p95/p99 TTFT and inter-token gap (host seconds)."""
        out = {}
        for short, xs in (("ttft", self.ttft_s),
                          ("intertoken", self.intertoken_s)):
            for q in (50, 95, 99):
                out[f"{short}_p{q}_s"] = (float(np.percentile(xs, q))
                                          if xs else 0.0)
            out[f"{short}_count"] = len(xs)
        return out


class Engine:
    """Continuous-batching serving engine (add_request / step / collect).

    ``plan`` (``plan.make_serve_plan``) supplies the ranks (its
    ``ThreadMesh`` when it has more than one device), the arrangement, the
    decode slot count, the page size, the capacity, the prefix cache and
    the kernel knobs; ``model`` the parameters and the device.
    ``on_prefill``, when set, is called with ``(uid, hidden)`` as each
    prompt's prefill completes, where ``hidden`` is the (1, 1, D)
    next-token hidden state (rank 0's) its first token is sampled from.
    """

    def __init__(self, model: Model, plan,
                 eng: EngineConfig = EngineConfig()):
        cfg = model.cfg
        ok, why = paged_cache.supported(cfg)
        if not ok:
            raise NotImplementedError(f"repro_torch.engine: {cfg.name}: {why}")
        if not plan.decode_batch or not plan.page_size:
            raise ValueError("engine plans need the serving face "
                             "(decode_batch/page_size > 0): build them with "
                             "plan.make_serve_plan")
        if eng.host_tier_bytes > 0 or plan.host_tier_bytes > 0:
            raise _unported("the pinned-host KV tier (host_tier_bytes > 0)")
        eng = dataclasses.replace(eng, max_slots=plan.decode_batch,
                                  page_size=plan.page_size,
                                  max_len=plan.seq_len)
        self.model, self.plan, self.eng, self.cfg = model, plan, eng, cfg
        self.device = model.device
        self.sp = plan.sp_size
        self.mesh = plan.build_mesh()
        # the rank runtime on one card; every rank's swaps in its comm
        rt = train_step.make_runtime(model, plan.run_config(),
                                     plan.shape_config())
        self.rt = dataclasses.replace(
            rt, batch_axes=(), st_cfg=dataclasses.replace(
                rt.st_cfg, seq_scheme="contiguous"))
        n_ranks = self.mesh.size if self.mesh is not None else 1
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
        self.metrics = EngineMetrics(pages_total=self.sp
                                     * eng.pages_per_shard)
        self._arrival: Dict[str, float] = {}
        self._last_emit: Dict[str, float] = {}
        self.ttft_s: Dict[str, float] = {}
        self.scheduler = self._new_scheduler()

    def _new_scheduler(self) -> Scheduler:
        sched = Scheduler(max_slots=self.eng.max_slots,
                          page_size=self.eng.page_size, sp=self.sp,
                          pages_per_shard=self.eng.pages_per_shard,
                          max_len=self.eng.max_len)
        if self.plan.prefix_cache:
            from repro_torch.gateway.prefix_cache import PrefixCache

            sched.prefix_cache = PrefixCache(
                sched.pool, page_size=self.eng.page_size, sp=self.sp)
        return sched

    @property
    def prefix_cache(self):
        return self.scheduler.prefix_cache

    # ---- request lifecycle ---------------------------------------------
    def add_request(self, req: Request) -> Optional[Rejection]:
        """Queue ``req``. Returns ``None`` on success or a typed
        :class:`Rejection` for an unserveable request."""
        if req.temperature > 0.0:
            raise _unported("temperature > 0 sampling (the JAX engine keys "
                            "its gumbel noise with threefry)")
        if req.handoff:
            raise _unported("disaggregated prefill->decode handoff")
        rej = self.scheduler.validate(req)
        if rej is not None:
            return rej
        self.scheduler.queue.append(req)
        self._arrival[req.uid] = time.monotonic()
        return None

    def preempt(self, uid: str):
        raise _unported("priority preemption")

    def _finish_request(self, st: SlotState) -> None:
        self.scheduler.finish(st.slot, self.metrics.steps)
        self.metrics.finished += 1
        self._arrival.pop(st.req.uid, None)
        self._last_emit.pop(st.req.uid, None)

    def collect(self) -> Dict[str, List[int]]:
        """uid -> generated tokens, for every finished request."""
        return {uid: list(st.out)
                for uid, st in self.scheduler.finished.items()}

    def reset(self) -> None:
        """Drop all requests and cache contents (the prefix cache too) and
        zero every rank's pools."""
        for pools in self.pools:
            for t in pools.values():
                t.zero_()
        self.scheduler = self._new_scheduler()
        self._prefilling = []
        self._arrival.clear()
        self._last_emit.clear()
        self.ttft_s.clear()
        self.metrics.reset(keep_compiles=True)
        self.metrics.pages_total = self.scheduler.pages_total()

    # ---- device work ----------------------------------------------------
    def _on_ranks(self, fn, rt: Optional[Runtime] = None) -> List:
        """``fn(rank_rt, rank_pools)`` on every rank under ``no_grad``,
        results in rank order (module doc). ``rt`` (default the engine's)
        is the template whose communicator each rank's replaces."""
        rt = rt or self.rt

        def body(comm, pools):
            with torch.no_grad():   # grad mode is per thread
                return fn(rt if comm is None
                          else dataclasses.replace(rt, comm=comm), pools)

        if self.mesh is None:
            return [body(None, self.pools[0])]
        return self.mesh.run(lambda comm: body(comm, self.pools[comm.rank]))

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _padded(self, tokens: List[int]) -> torch.Tensor:
        """(1, S) tokens zero-padded to a multiple of the prompt quantum,
        on the device."""
        n = -(-len(tokens) // self._quantum) * self._quantum
        buf = np.zeros((1, n), np.int64)
        buf[0, :len(tokens)] = tokens
        return self._tensor(buf, torch.int64)

    @staticmethod
    def _rank_slice(rt, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice of (1, S) tokens."""
        s_loc = tokens.shape[1] // rt.sp_size()
        return tokens[:, rt.sp_rank() * s_loc:(rt.sp_rank() + 1) * s_loc]

    def _prefill_rank(self, rt, tokens, n_real: int):
        """This rank's ``lm_prefill`` of the padded prompt ``tokens`` (1, S)
        of ``n_real`` real tokens: (hidden (1, 1, D), (k, v) stacks of its
        slice)."""
        from repro_torch.serve import step as serve_step

        S = tokens.shape[1]
        rt = dataclasses.replace(rt, st_cfg=dataclasses.replace(
            rt.st_cfg, seq_len=S))
        prompt_len = (None if S == n_real else
                      torch.full((1,), n_real, dtype=torch.int32,
                                 device=tokens.device))
        return serve_step.lm_prefill(
            rt, self.model, self._rank_slice(rt, tokens), self.cfg,
            prompt_len=prompt_len, return_hidden=True)

    def prefill_hidden(self, tokens: List[int], rt: Optional[Runtime] = None):
        """The next-token hidden state (1, 1, D) and the prefill K/V stacks
        (L, 1, len(tokens), Hkv, hd) of one prompt, under ``rt`` (default
        the engine's runtime) on every rank; rank 0's hidden state, the
        ranks' K/V slices of the first replica joined in sequence order."""
        padded = self._padded(tokens)
        out = self._on_ranks(
            lambda r, _: self._prefill_rank(r, padded, len(tokens)), rt)
        ks, vs = zip(*(kv for _, kv in out[:self.sp]))
        n = len(tokens)
        return out[0][0], (torch.cat(ks, 2)[:, :, :n],
                           torch.cat(vs, 2)[:, :, :n])

    @staticmethod
    def _sampled(toks: List[torch.Tensor]) -> np.ndarray:
        """Rank 0's tokens, on the host; raises if another rank's differ
        (module doc)."""
        every = torch.stack(toks).cpu().numpy()
        if (every != every[0]).any():
            raise RuntimeError(f"the ranks sampled different tokens: {every}")
        return every[0]

    def _advance_prefill(self, st: SlotState
                         ) -> Optional[Tuple[torch.Tensor, int]]:
        """Run one prefill chunk of ``st`` (the whole remaining prompt when
        chunking is off). Returns the next-token hidden state (1, 1, D) and
        the greedy first token when the prompt completes, else None.

        A leading chunk (``prefill_pos == 0``) runs the full-forward prefill
        and inserts its K/V into the slot's pages; every later chunk is a
        suffix prefill with ``cached_len = prefill_pos``, reading the pages
        earlier chunks (or the prefix cache) populated in place.
        """
        from repro_torch.serve import step as serve_step

        t0 = time.monotonic()
        req = st.req
        start = st.prefill_pos
        end = req.prompt_len if not self._chunk \
            else min(start + self._chunk, req.prompt_len)
        final = end == req.prompt_len
        table_row = self.scheduler.table[st.slot]
        tokens = self._padded(req.tokens[start:end])
        ps = self.eng.page_size

        def rank_fn(rt, pools):
            if start:
                last = serve_step.lm_prefill_paged(
                    rt, self.model, self._rank_slice(rt, tokens), self.cfg,
                    prompt_len=end, cached_len=start, pools=pools,
                    table_row=table_row, page_size=ps)
            else:
                last, (k_stack, v_stack) = self._prefill_rank(rt, tokens,
                                                              end)
                paged_cache.insert_prompt(rt, pools, k_stack, v_stack,
                                          table_row, end, ps)
            tok = (sampling.greedy(rt, self.model.head, last, self.cfg)[0]
                   if final else None)
            return last, tok

        out = self._on_ranks(rank_fn)
        result = None
        if final:
            result = (out[0][0], int(self._sampled([t for _, t in out])[0]))
        st.prefill_pos = end
        m = self.metrics
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
            self._finish_request(st)

    def _decode(self, active: List[SlotState]) -> np.ndarray:
        from repro_torch.serve import step as serve_step

        t0 = time.monotonic()
        width = self.scheduler.decode_width()
        B = self.eng.max_slots
        tokens = np.zeros((B, 1), np.int64)
        cache_len = np.zeros((B,), np.int32)
        act = np.zeros((B,), bool)
        for st in active:
            tokens[st.slot, 0] = st.out[-1]
            cache_len[st.slot] = st.cache_len
            act[st.slot] = True
        paged = paged_cache.PagedTables(
            table=np.ascontiguousarray(self.scheduler.table[:, :, :width]),
            cache_len=cache_len, active=act, page_size=self.eng.page_size,
            device=self.device)
        tokens_d = self._tensor(tokens, torch.int64)
        cache_len_d = self._tensor(cache_len, torch.int32)
        out = self._on_ranks(lambda rt, pools: serve_step.lm_decode_step(
            rt, self.model, pools, tokens_d, self.cfg, cache_len_d, paged))
        tok = self._sampled(out)
        self.metrics.decode_wall_s += time.monotonic() - t0
        return tok

    # ---- driver ---------------------------------------------------------
    def step(self) -> List[Tuple[str, int]]:
        """One driver iteration: advance in-flight chunked prefills (one
        chunk each), admit (one chunk for each admission), then one decode
        step for every slot whose prefill has completed. Returns the
        (uid, token) pairs emitted this step."""
        t0 = time.monotonic()
        emitted: List[Tuple[str, int]] = []
        m = self.metrics
        # chunked prefills admitted on earlier steps go before this step's
        # admissions (FIFO progress)
        for st in list(self._prefilling):
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
            done = self._advance_prefill(st)
            if done is not None:
                self._complete_prefill(st, *done, emitted)
        if self.prefix_cache is not None:
            m.prefix_evictions = self.prefix_cache.evicted_pages

        # decode: slots whose prefill has completed (a mid-chunk slot holds
        # pages but has no token stream yet)
        active = [st for st in self.scheduler.active()
                  if st.cache_len > 0 and not st.done]
        if active:
            tok = self._decode(active)
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
        return not self.scheduler.queue and not self.scheduler.active()

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
                 plan=None, device=None) -> Engine:
    """Build the engine on ``device`` (default: the CUDA card, raising if
    there is none) for ``plan``, or for a serve plan of ``data`` replicas
    at SP degree 1 when none is given; a plan of SP degree > 1 runs its
    ranks as ``ThreadMesh`` threads on that one device. ``model``
    supplies the weights (e.g. ``factory.from_jax_params``); else they are
    drawn from ``init_seed`` on the device. ``kernel`` / ``block`` pick the
    paged-decode and ring-block implementations ('ref' | 'cuda')."""
    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    device = resolve_device(device)
    cfg = registry.get_smoke(arch) if smoke else registry.get(arch)
    if plan is None:
        plan = make_serve_plan(
            cfg, arch=arch, n_devices=data, data=data, c=c,
            decode_batch=eng.max_slots, page_size=eng.page_size,
            max_len=eng.max_len, kernel_impl=kernel, block_impl=block)
    if model is None:
        model = build_model(cfg, device=device, seed=init_seed)
    elif model.device != device:
        raise ValueError(f"model lives on {model.device}, engine on {device}")
    return Engine(model, plan, eng)
