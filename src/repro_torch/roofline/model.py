"""Three-term roofline of a dry-run record (the port's counterpart of
``repro.roofline.model``), on the card's constants (``roofline.hw``):

    compute    = FLOPs_per_device / hw.PEAK_FLOPS_BF16
    memory     = bytes_accessed_per_device / hw.HBM_BW
    collective = collective_bytes_per_device / hw.NVLINK_BW

The record is ``launch.dryrun``'s (its fields are the JAX record's): the
FLOPs come from ``FlopCounterMode`` over a trace of the step on the meta
device, the bytes from every op's inputs and outputs, the collective
bytes from the trace communicator's log (each collective's result shape
per device, the JAX HLO parse's convention). The dominant term is the
bottleneck; MODEL_FLOPS / traced FLOPs measures how much of the traced
compute is useful (catches recompute and redundancy).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Optional

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, model_flops_per_token
from repro_torch.roofline import hw


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_device: float
    hlo_flops_per_device: float
    useful_ratio: float
    peak_gib: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the bound's time."""
        ideal = self.model_flops_per_device / hw.PEAK_FLOPS_BF16
        return ideal / max(self.bound_s, 1e-30)


def from_record(rec: Dict) -> Optional[Roofline]:
    if rec.get("status") != "ok":
        return None
    n_dev = rec["devices"]
    cfg = registry.get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    fpt = model_flops_per_token(cfg)
    if rec["kind"] == "train":
        # forward (2) + backward (4) = 6ND; fpt includes the 6
        tokens = shape.global_batch * shape.seq_len
        model_flops = fpt * tokens
    elif rec["kind"] == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = fpt / 3.0 * tokens            # forward only: 2ND
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        model_flops = fpt / 3.0 * tokens
    model_flops_dev = model_flops / n_dev

    compute_s = rec["flops_per_device"] / hw.PEAK_FLOPS_BF16
    memory_s = rec["bytes_accessed_per_device"] / hw.HBM_BW
    collective_s = rec["collectives"]["total_bytes"] / hw.NVLINK_BW
    hlo_flops = max(rec["flops_per_device"], 1e-9)
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops_per_device=model_flops_dev,
        hlo_flops_per_device=rec["flops_per_device"],
        useful_ratio=model_flops_dev / hlo_flops,
        peak_gib=rec["memory"]["peak_bytes_per_device"] / 2**30,
    )


def load_all(results_dir: pathlib.Path):
    out = []
    for f in sorted(pathlib.Path(results_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        rec["_file"] = f.name
        out.append(rec)
    return out


def format_table(records) -> str:
    rows = ["| arch | shape | mesh | C | compute s | memory s | collective s "
            "| dominant | useful | peak GiB | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for rec in records:
        if rec.get("status") == "skipped":
            rows.append(f"| {rec['arch']} | {rec['shape']} | - | - | - | - | "
                        f"- | SKIP | - | - | - |")
            continue
        r = from_record(rec)
        if r is None:
            rows.append(f"| {rec['arch']} | {rec['shape']} | "
                        f"{rec.get('mesh','?')} | {rec.get('c','?')} | ERR "
                        f"| | | | | | |")
            continue
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {rec.get('c')} "
            f"| {r.compute_s:.4f} | {r.memory_s:.4f} | {r.collective_s:.4f} "
            f"| {r.dominant} | {r.useful_ratio:.2f} | {r.peak_gib:.2f} "
            f"| {r.roofline_fraction:.3f} |")
    return "\n".join(rows)
