"""repro_torch.plan — the serving ExecutionPlan (``plan.plan``)."""

from repro_torch.plan.plan import ExecutionPlan, make_serve_plan

__all__ = ["ExecutionPlan", "make_serve_plan"]
