"""Priority classes and SLO-priced admission (the port of
``repro.frontend.slo``).

A :class:`PriorityClass` is the orchestrator's unit of policy: its
``rank`` orders preemption (lower rank = higher priority, preempts higher
ranks), ``budget_tokens`` caps the class's outstanding decode budget (a
runaway batch queue cannot starve interactive admission), and
``slo_ttft_ms`` arms the priced admission check.

:class:`SLOAdmission` prices a request's TTFT **analytically** from the
planner's cost model (``plan.cost.serve_slo_cost``: this prompt's prefill
plus the work queued ahead of it at the replica's decode rate). A request
whose priced TTFT misses its class SLO is refused at admission with a
429-shaped :class:`Rejection` carrying a ``retry_after_steps`` hint.
``calibration`` scales the analytical seconds to the measured machine
(the model prices FLOPs and bytes on the card's datasheet roofline; a
host-bound step is far slower, so a deployment calibrates once from a
measured decode step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.engine.scheduler import Rejection


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    name: str
    rank: int                      # 0 = highest priority
    slo_ttft_ms: float = 0.0       # 0 = no admission-time TTFT pricing
    budget_tokens: int = 0         # outstanding-token cap; 0 = unlimited
    preemptible: bool = False      # may be spilled for lower-rank work


def default_classes() -> Dict[str, PriorityClass]:
    return {
        "interactive": PriorityClass("interactive", rank=0),
        "batch": PriorityClass("batch", rank=1, preemptible=True),
    }


def parse_classes(spec: str, slo_ttft_ms: float = 0.0,
                  budget_tokens: int = 0) -> Dict[str, PriorityClass]:
    """``--priority-classes`` parser: comma-separated class names, listed
    highest-priority first. The first class carries the ``--slo-ttft-ms``
    target (interactive traffic is what has a TTFT SLO) and optional
    budget; every class after the first is preemptible."""
    names = [n.strip() for n in spec.split(",") if n.strip()]
    if not names:
        raise ValueError("--priority-classes needs at least one class name")
    out: Dict[str, PriorityClass] = {}
    for rank, name in enumerate(names):
        out[name] = PriorityClass(
            name, rank=rank,
            slo_ttft_ms=slo_ttft_ms if rank == 0 else 0.0,
            budget_tokens=budget_tokens if rank == 0 else 0,
            preemptible=rank > 0)
    return out


class SLOAdmission:
    """Analytical TTFT pricing at admission, from the planner cost model."""

    def __init__(self, cfg, *, sp: int, page_size: int, decode_batch: int,
                 kernel: str = "ref", calibration: float = 1.0):
        self.cfg = cfg
        self.sp = sp
        self.page_size = page_size
        self.decode_batch = decode_batch
        self.kernel = kernel
        self.calibration = calibration

    def price(self, *, prompt_len: int, queued_tokens: int
              ) -> Dict[str, float]:
        from repro_torch.plan import cost as plan_cost

        d = plan_cost.serve_slo_cost(
            self.cfg, prompt_len=prompt_len, queued_tokens=queued_tokens,
            sp=self.sp, page_size=self.page_size,
            decode_batch=self.decode_batch, kernel=self.kernel)
        return {k: (v * self.calibration if k.endswith("_s") else v)
                for k, v in d.items()}

    def check(self, *, prompt_len: int, slo_ttft_ms: float,
              queued_tokens: int) -> Optional[Rejection]:
        """None when the priced TTFT meets the SLO, else the 429."""
        if slo_ttft_ms <= 0:
            return None
        d = self.price(prompt_len=prompt_len, queued_tokens=queued_tokens)
        if d["ttft_s"] * 1000.0 <= slo_ttft_ms:
            return None
        # the queue drains at ~decode_batch tokens per step: estimate how
        # many steps until the queued share of the estimate has drained
        # enough for the prompt's own prefill to fit the SLO
        slack_s = max(d["ttft_s"] - slo_ttft_ms / 1000.0, 0.0)
        steps = max(int(math.ceil(slack_s / max(d["decode_step_s"], 1e-9))),
                    1)
        return Rejection(
            "slo_ttft_unattainable",
            f"priced TTFT {d['ttft_s'] * 1000:.1f}ms > SLO "
            f"{slo_ttft_ms:.0f}ms with {queued_tokens} tokens queued ahead",
            retry_after_steps=steps)
