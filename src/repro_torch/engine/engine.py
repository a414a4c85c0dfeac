"""The serving engine: continuous batching over the paged KV cache (the
port's counterpart of ``repro.engine.engine``).

The engine owns three kinds of state:

  * **device** — the model and this rank's page pools
    (``paged_cache.init_pools``), on the card unless the caller asks for
    the CPU;
  * **host** — the ``Scheduler`` (slots, page free lists, page table, FIFO
    queue);

``step()`` is one driver iteration: admit queued requests into free slots
(each admission = one prefill + paged insert + first greedy token), then
one decode step for every active slot, then evict finished requests.
Outputs are identical to serving each request alone: attention, MLP and
sampling are row-independent and page content is per slot.

This slice serves greedy requests on one rank (``SingleComm``, P = 1).
What it does not port raises ``NotImplementedError`` naming the ROADMAP
item: temperature sampling, chunked prefill, the prefix cache, the host
tier, disaggregated handoff and preemption, and P > 1 across cards.

Prompts are prefilled at their own length: the JAX engine pads them to
power-of-two buckets for its jit caches, but eager PyTorch compiles
nothing and the kernels mask ragged edges. So ``prefill_compiles`` /
``decode_compiles`` keep their names in ``EngineMetrics`` and stay 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.startrail import StarTrailConfig
from repro_torch.dist.comm import SingleComm
from repro_torch.engine import paged_cache, sampling
from repro_torch.engine.scheduler import (Rejection, Request, Scheduler,
                                          SlotState)
from repro_torch.models.factory import Model
from repro_torch.models.runtime import Runtime


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
    prefill_chunk: int = 0      # > 0 (chunked prefill) is not ported
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
        d["prefix_hit_rate"] = 0.0
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

    ``plan`` (``plan.make_serve_plan``) supplies the decode slot count, the
    page size, the capacity and the kernel knobs; ``model`` the parameters
    and the device.
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
        if plan.sp_size != 1:
            raise _unported(f"SP degree {plan.sp_size} across cards (the "
                            "multi-process NCCL/gloo communicator)")
        if plan.prefix_cache:
            raise _unported("the prefix cache (repro.gateway)")
        if eng.prefill_chunk > 0:
            raise _unported("chunked prefill (prefill_chunk > 0)")
        if eng.host_tier_bytes > 0 or plan.host_tier_bytes > 0:
            raise _unported("the pinned-host KV tier (host_tier_bytes > 0)")
        eng = dataclasses.replace(eng, max_slots=plan.decode_batch,
                                  page_size=plan.page_size,
                                  max_len=plan.seq_len)
        self.model, self.plan, self.eng, self.cfg = model, plan, eng, cfg
        self.device = model.device
        self.sp = plan.sp_size
        self.rt = Runtime(
            comm=SingleComm(), st_cfg=StarTrailConfig(
                seq_len=plan.seq_len, seq_scheme="contiguous", causal=True,
                window=cfg.window, block_impl=plan.block_impl,
                block_skip=plan.block_skip),
            kernel_impl=plan.kernel_impl, device=self.device)
        self.pools = paged_cache.init_pools(cfg, eng.pages_per_shard,
                                            eng.page_size, self.device)
        self.metrics = EngineMetrics(pages_total=self.sp
                                     * eng.pages_per_shard)
        self._arrival: Dict[str, float] = {}
        self._last_emit: Dict[str, float] = {}
        self.ttft_s: Dict[str, float] = {}
        self.scheduler = self._new_scheduler()

    def _new_scheduler(self) -> Scheduler:
        return Scheduler(max_slots=self.eng.max_slots,
                         page_size=self.eng.page_size, sp=self.sp,
                         pages_per_shard=self.eng.pages_per_shard,
                         max_len=self.eng.max_len)

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
        """Drop all requests and zero the pools."""
        for t in self.pools.values():
            t.zero_()
        self.scheduler = self._new_scheduler()
        self._arrival.clear()
        self._last_emit.clear()
        self.ttft_s.clear()
        self.metrics.reset(keep_compiles=True)
        self.metrics.pages_total = self.scheduler.pages_total()

    # ---- device work ----------------------------------------------------
    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def prefill_hidden(self, tokens: List[int], rt: Optional[Runtime] = None):
        """The next-token hidden state (1, 1, D) and the prefill K/V stacks
        (L, 1, len(tokens), Hkv, hd) of one prompt, under ``rt`` (default
        the engine's runtime)."""
        from repro_torch.serve import step as serve_step

        rt = rt or self.rt
        rt = dataclasses.replace(rt, st_cfg=dataclasses.replace(
            rt.st_cfg, seq_len=len(tokens)))
        with torch.no_grad():
            return serve_step.lm_prefill(
                rt, self.model, self._tensor([tokens], torch.int64), self.cfg,
                return_hidden=True)

    def _prefill(self, st: SlotState) -> int:
        """Prefill the whole prompt of ``st``, insert its K/V into the slot's
        pages and return the first greedy token."""
        t0 = time.monotonic()
        req = st.req
        last, (k_stack, v_stack) = self.prefill_hidden(req.tokens)
        with torch.no_grad():
            paged_cache.insert_prompt(
                self.rt, self.pools, k_stack, v_stack,
                self.scheduler.table[st.slot], req.prompt_len,
                self.eng.page_size)
            tok = sampling.greedy(self.rt, self.model.head, last, self.cfg)
        tok = int(tok[0, 0].item())
        m = self.metrics
        st.prefill_pos = req.prompt_len
        m.prefill_tokens_computed += req.prompt_len
        m.prefill_chunks += 1
        m.prefill_wall_s += time.monotonic() - t0
        return tok

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
        with torch.no_grad():
            tok = serve_step.lm_decode_step(
                self.rt, self.model, self.pools,
                self._tensor(tokens, torch.int64), self.cfg,
                self._tensor(cache_len, torch.int32), paged)
        tok = tok.cpu().numpy()
        self.metrics.decode_wall_s += time.monotonic() - t0
        return tok

    # ---- driver ---------------------------------------------------------
    def step(self) -> List[Tuple[str, int]]:
        """One driver iteration: admit (prefill each admission), then one
        decode step for every decoding slot. Returns the (uid, token) pairs
        emitted this step."""
        t0 = time.monotonic()
        emitted: List[Tuple[str, int]] = []
        m = self.metrics
        while True:
            batch = self.scheduler.admit(m.steps, limit=1)
            if not batch:
                break
            st = batch[0]
            tok = self._prefill(st)
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
    """Resolve a one-card serve plan and build the engine on ``device``
    (default: the CUDA card, raising if there is none). ``model`` supplies
    the weights (e.g. ``factory.from_jax_params``); else they are drawn
    from ``init_seed`` on the device. ``kernel`` / ``block`` pick the
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
