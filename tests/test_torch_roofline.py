"""repro_torch's ``roofline/model.py`` and ``roofline/hw.py`` against the
JAX package.

* ``from_record`` and ``format_table`` equal the JAX ones on the same
  records with both ``hw`` modules patched to one set of constants (the
  port's NVLink rate in the JAX table's ICI link's place): inline records
  of every kind, status and dominant term (as
  ``tests/test_ssm_and_roofline.py`` builds them), and the frozen JAX
  record of h2o-danube-1.8b at decode_32k (``test_torch_dryrun``).
* Unpatched, the port prices a record on the card's constants: compute on
  ``PEAK_FLOPS_BF16``, memory on ``HBM_BW``, collectives on ``NVLINK_BW``,
  and no TPU number appears in ``roofline/model.py``.
* ``load_all`` reads a directory of records as JAX's does.
"""

import dataclasses
import json
import pathlib

import jax  # noqa: F401  (both frameworks share the test process)
import pytest

from repro.roofline import hw as jax_hw
from repro.roofline import model as jax_model
from repro_torch.roofline import hw
from repro_torch.roofline import model
from test_torch_dryrun import JAX_RECORD

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rec(arch="minitron-8b", shape="train_4k", kind="train", status="ok",
         flops=2e14, nbytes=1e9, coll=1e8, peak=8 * 2**30, devices=256):
    return {"status": status, "arch": arch, "shape": shape, "mesh": "16x16",
            "kind": kind, "devices": devices, "c": 2,
            "flops_per_device": flops, "bytes_accessed_per_device": nbytes,
            "collectives": {"total_bytes": coll},
            "memory": {"peak_bytes_per_device": peak}}


RECORDS = [
    _rec(),                                                 # compute
    _rec(shape="prefill_32k", kind="prefill", flops=1e9, nbytes=5e12),
    _rec(arch="h2o-danube-1.8b", shape="decode_32k", kind="decode",
         flops=1e6, nbytes=1e6, coll=5e11),                 # collective
    _rec(arch="xlstm-1.3b", shape="long_500k", kind="decode", flops=0.0),
    {"arch": "h2o-danube-1.8b", "shape": "long_500k", "status": "skipped",
     "skipped": "why"},
    {"arch": "minitron-8b", "shape": "train_4k", "status": "error",
     "mesh": "2x16x16", "c": 2},
    JAX_RECORD,
]


@pytest.fixture
def same_constants(monkeypatch):
    for name, value in (("PEAK_FLOPS_BF16", 197e12), ("HBM_BW", 819e9)):
        monkeypatch.setattr(hw, name, value)
        monkeypatch.setattr(jax_hw, name, value)
    monkeypatch.setattr(hw, "NVLINK_BW", 50e9)
    monkeypatch.setattr(jax_hw, "ICI_BW_PER_LINK", 50e9)


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_from_record_matches_jax(same_constants, i):
    rec = RECORDS[i]
    got, want = model.from_record(rec), jax_model.from_record(rec)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.dominant, got.bound_s, got.roofline_fraction) == \
        (want.dominant, want.bound_s, want.roofline_fraction)


def test_format_table_matches_jax(same_constants):
    assert model.format_table(RECORDS) == jax_model.format_table(RECORDS)
    assert [r.dominant for r in map(model.from_record, RECORDS[:3])] == \
        ["compute", "memory", "collective"]


def test_the_card_prices_the_terms():
    r = model.from_record(JAX_RECORD)
    assert r.compute_s == JAX_RECORD["flops_per_device"] / 989e12
    assert r.memory_s == JAX_RECORD["bytes_accessed_per_device"] / 3.35e12
    assert r.collective_s == \
        JAX_RECORD["collectives"]["total_bytes"] / 450e9
    assert hw.HBM_BYTES == 80 * 2**30
    assert r.peak_gib < hw.HBM_BYTES / 2**30
    text = (ROOT / "src/repro_torch/roofline/model.py").read_text()
    for tpu in ("ICI_BW_PER_LINK", "197e12", "819e9", "50e9", "v5e"):
        assert tpu not in text, tpu


def test_load_all_reads_a_directory(tmp_path):
    for i, rec in enumerate(RECORDS):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(rec))
    got = model.load_all(tmp_path)
    assert got == jax_model.load_all(tmp_path)
    assert [r["_file"] for r in got] == [f"{i:02d}.json"
                                        for i in range(len(RECORDS))]
