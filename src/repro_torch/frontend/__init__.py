"""repro_torch.frontend — the process-separated serving front end (the
port of ``repro.frontend``).

An :class:`Orchestrator` drives worker replicas (in-process
``LocalReplica`` or spawned ``ProcReplica``) through the small engine-API
boundary of :mod:`repro_torch.frontend.protocol`, with an asyncio
HTTP/SSE server on top (:mod:`repro_torch.frontend.server`).

Attribute access is lazy: a spawned worker unpickles
``repro_torch.frontend.worker`` before it builds anything, so nothing here
imports torch or the engine eagerly.
"""

_EXPORTS = {
    "Orchestrator": "repro_torch.frontend.orchestrator",
    "EngineHost": "repro_torch.frontend.worker",
    "LocalReplica": "repro_torch.frontend.worker",
    "ProcReplica": "repro_torch.frontend.worker",
    "worker_main": "repro_torch.frontend.worker",
    "StepResult": "repro_torch.frontend.protocol",
    "ReplicaDead": "repro_torch.frontend.protocol",
    "make_worker_spec": "repro_torch.frontend.protocol",
    "PriorityClass": "repro_torch.frontend.slo",
    "SLOAdmission": "repro_torch.frontend.slo",
    "default_classes": "repro_torch.frontend.slo",
    "parse_classes": "repro_torch.frontend.slo",
    "FrontendServer": "repro_torch.frontend.server",
    "run_server": "repro_torch.frontend.server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
