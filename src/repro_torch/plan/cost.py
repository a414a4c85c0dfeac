"""The scheme half of the analytical cost model (the port of
``repro.plan.cost``, lines 33-139): the legal communication arrangements
at one sequence-parallel degree P and their per-device communication
volumes (paper eqs. 2-4).

At P there is a family of arrangements: the StarTrail (C, R)
factorisations with P = C^2 * R and either axis placement, the plain ring
(C = 1), and DeepSpeed-Ulysses' all-to-all scheme, legal only while the
head counts divide P (the limit ``core.ulysses`` enforces).
``comm_volumes`` prices one attention layer's forward per device and is a
faithful copy of the JAX function: it ranks arrangements, and
``obs.commlog`` holds the communicator's measured bytes against it.

Not ported yet (ROADMAP.md §A): the time model (``rank_arrangements``,
``choose_microbatches``, ``choose_comm_chunks``, the serving SLO cost),
which needs ``core/scheduler.py`` and an H100 ``roofline/hw.py``; so
``plan.make_plan(c=None)`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.topology import valid_c_values

SCHEMES = ("startrail", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class Arrangement:
    """One point of the (scheme, C, placement) tuning space at fixed P."""

    scheme: str                 # 'startrail' | 'ring' (C=1) | 'ulysses'
    c: int
    r: int
    placement: str = "team_inner"

    @property
    def key(self) -> str:
        if self.scheme == "startrail":
            return f"startrail_c{self.c}_{self.placement}"
        return self.scheme


def num_attention_layers(cfg: ModelConfig) -> int:
    n = sum(1 for i in range(cfg.num_layers)
            if cfg.mixer_on_layer(i) == "attn")
    if cfg.encdec:
        n += cfg.num_encoder_layers + cfg.num_layers  # self + cross attention
    return n


def ulysses_supported(cfg: ModelConfig, sp: int) -> bool:
    """Ulysses heads-divisibility limit: SP must divide Hq and Hkv."""
    return cfg.num_heads % sp == 0 and cfg.num_kv_heads % sp == 0


def check_scheme(cfg: ModelConfig, sp: int, scheme: str) -> None:
    """Raise (with the wording of ``core.ulysses``) for illegal schemes."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if scheme == "ulysses" and not ulysses_supported(cfg, sp):
        raise ValueError(
            f"Ulysses requires head counts divisible by SP degree: "
            f"Hq={cfg.num_heads}, Hkv={cfg.num_kv_heads}, SP={sp} "
            f"(the paper's scalability limit)")


def enumerate_arrangements(cfg: ModelConfig, sp: int) -> List[Arrangement]:
    """All legal arrangements at sequence-parallel degree ``sp``."""
    out: List[Arrangement] = []
    for c in valid_c_values(sp):
        r = sp // (c * c)
        if c == 1:
            out.append(Arrangement("ring", 1, r))
        else:
            for placement in ("team_inner", "ring_inner"):
                out.append(Arrangement("startrail", c, r, placement))
    if ulysses_supported(cfg, sp):
        out.append(Arrangement("ulysses", 1, sp))
    return out


def comm_volumes(cfg: ModelConfig, shape: ShapeConfig, sp: int,
                 arr: Arrangement, *, batch: Optional[int] = None,
                 dtype_bytes: int = 2) -> Dict[str, float]:
    """Per-device bytes for one attention layer's forward.

    StarTrail (paper eqs. 3-4, with the JAX implementation's R ring
    permutes: the chunks tour the full ring so the backward reuses the
    placement):

      team all-gather:    (C-1) * B * N/P * (Hq + 2*Hkv) * dh * bytes
      placement ppermute: 2 * B * (C*N/P) * Hkv * dh * bytes      (Alg. 2)
      sub-ring ppermute:  R  * [the same chunk]                   (eq. 4)
      reduce-scatter:     (C-1) * B * N/P * Hq * dh * 4           (f32 combine)

    Ring is the C=1 point (no team collectives). Ulysses is the two
    all-to-all pairs: q/k/v seq->head then o head->seq, each moving
    (P-1)/P of the local tensor.
    """
    b = shape.global_batch if batch is None else batch
    n = shape.seq_len
    dh = cfg.head_dim_
    q_h = cfg.num_heads * dh
    kv_h = cfg.num_kv_heads * dh
    s_local = n / sp
    c, r = arr.c, arr.r

    if arr.scheme == "ulysses":
        a2a = (sp - 1) / sp * b * s_local * (2 * q_h + 2 * kv_h) * dtype_bytes
        return {"team_allgather": 0.0, "placement_p2p": 0.0,
                "ring_p2p": 0.0, "combine_rs": 0.0, "all_to_all": a2a,
                "total": a2a}

    chunk = 2 * b * (c * s_local) * kv_h * dtype_bytes   # one team's K/V
    vols = {
        "team_allgather": (c - 1) * b * s_local * (q_h + 2 * kv_h)
        * dtype_bytes,
        "placement_p2p": chunk if c > 1 else 0.0,
        "ring_p2p": r * chunk,
        "combine_rs": (c - 1) * b * s_local * q_h * 4.0,
        "all_to_all": 0.0,
    }
    vols["total"] = sum(vols.values())
    return vols
