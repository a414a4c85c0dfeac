"""repro_torch.plan — the ExecutionPlan of a training or serving run
(``plan.plan``)."""

from repro_torch.plan.plan import ExecutionPlan, make_plan, make_serve_plan

__all__ = ["ExecutionPlan", "make_plan", "make_serve_plan"]
