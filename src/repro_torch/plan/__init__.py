"""repro_torch.plan — the execution-plan layer: ``ExecutionPlan`` (plan.py)
is what every entry point builds its mesh and runtime from; ``cost`` ranks
the legal (C, R) / scheme arrangements analytically (paper eqs. 2-4);
``autotune`` refines the top of the ranking with measured steps and
persists the winner."""

from repro_torch.plan import autotune, cost
from repro_torch.plan.plan import (ExecutionPlan, make_plan, make_role_plans,
                                   make_serve_plan, plan_path)

__all__ = ["ExecutionPlan", "make_plan", "make_serve_plan",
           "make_role_plans", "plan_path", "cost", "autotune"]
