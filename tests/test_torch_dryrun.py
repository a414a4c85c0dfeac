"""repro_torch's dry run (``launch/dryrun.py``: the step traced on the meta
device) against the JAX package's (``repro.launch.dryrun``: XLA's AOT
compile), and the pieces it stands on: the trace communicator
(``dist.comm.TraceComm``) and the kernels' meta rules (``kernels.meta``).

* Smoke h2o-danube-1.8b on 8 devices (data 2, C 2), one local plan per
  step kind, both packages' records (JAX's ``lower_cell(plan=...)`` in one
  child process with 8 forced host devices, started by the first test):
  the same keys, recursively; ``plan``, ``kind``, ``devices``, ``mesh``,
  ``n_periods`` and ``memory.argument_bytes`` equal; ``output_bytes``
  equal but for XLA's output tuple (8 bytes an output buffer, pinned);
  every collective kind's per-period count and extrapolated bytes equal,
  the training step's all-reduces apart (XLA's combiner merges them and
  the jitted step reduces the gradient norm across devices, pinned); the
  training step here at ``remat='none'``: under ``attn_out`` the port's
  recompute gathers each layer's seven FSDP weights again, which XLA
  keeps from the forward (pinned). ``flops_per_device`` lies within 0.9
  to 1.0 of JAX's (measured 0.938 prefill, 0.937 decode, 0.955 train):
  ``FlopCounterMode`` counts the matmuls, XLA's cost analysis every
  elementwise op too.
* The full-size cell: h2o-danube-1.8b at decode_32k on the single pod
  (256 devices, C = 2), the port's record against a frozen copy of the
  JAX one (``JAX_RECORD``, not read from ``results/dryrun/``, which a JAX
  test rewrites): the plan dict field for field, ``devices``,
  ``n_periods``, ``memory.argument_bytes`` and the per-period collective
  counts equal; the collective bytes equal once the port's bf16
  collectives are counted at f32 width, as XLA's CPU compile carries them
  (pinned).
* A trace counts every loop iteration, so the depth extrapolation equals
  the full-depth trace; every family's three steps trace at smoke size
  (no step reads a value on the host).
* Each kernel's meta rule gives its plain version's output shapes and
  dtypes and charges the FLOPs ``FlopCounterMode`` counts for the plain
  version on an unmasked tile, raises where the kernel raises, and under
  ``'cuda'`` no plain version runs in a trace (full-size h2o decode,
  prefill and the P = 1 train step that ``chip_smoke.py`` runs).
* ``main()`` in process: ``[ok]`` and a record whose peak fits the card
  (which the JAX package's ``roofline.model.from_record`` reads),
  a multi-pod cell recorded as an error naming ROADMAP.md §A item 1, and
  ``--autotune --device cpu``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks share the test process)
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding
from repro_torch.dist.comm import TraceComm, ThreadMesh
from repro_torch.kernels import dispatch, meta, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode, paged_prefill
from repro_torch.launch import dryrun
from repro_torch.models.factory import shard_params
from repro_torch.plan import autotune, make_plan

ARCH = "h2o-danube-1.8b"
SMOKE = {"train": (64, 4), "prefill": (64, 4), "decode": (64, 4)}
MESH = dict(n_devices=8, data=2, c=2)
FLOPS_RATIO = (0.9, 1.0)          # port / JAX flops_per_device (doc)

# the JAX package's record of the cell (``python -m repro.launch.dryrun
# --arch h2o-danube-1.8b --shape decode_32k``), frozen
JAX_RECORD = {'arch': 'h2o-danube-1.8b',
 'shape': 'decode_32k',
 'mesh': '16x16',
 'kind': 'decode',
 'plan': {'arch': 'h2o-danube-1.8b',
          'shape': 'decode_32k',
          'seq_len': 32768,
          'global_batch': 128,
          'n_devices': 256,
          'kind': 'decode',
          'data': 16,
          'pod': 1,
          'scheme': 'startrail',
          'c': 2,
          'placement': 'team_inner',
          'seq_scheme': 'contiguous',
          'block_impl': 'ref',
          'block_skip': True,
          'remat': 'attn_out',
          'microbatches': 1,
          'sharding_rules': 'default',
          'grad_compression': 'none',
          'mesh_kind': 'production',
          'unroll_scans': False,
          'pipeline_scan': True,
          'comm_chunks': 1,
          'decode_batch': 0,
          'page_size': 0,
          'kernel_impl': 'ref',
          'replicas': 1,
          'prefix_cache': False,
          'role': 'unified',
          'host_tier_bytes': 0,
          'r': 4,
          'sp_size': 16},
 'c': 2,
 'rules': 'default',
 'remat': 'attn_out',
 'placement': 'team_inner',
 'devices': 256,
 'n_periods': 24,
 'compile_s': 1.3,
 'flops_per_device': 41416833792.0,
 'bytes_accessed_per_device': 18237181696.0,
 'collectives': {'total_bytes': 2007171168.0,
                 'bytes_by_kind': {'all-gather': 1983447040,
                                   'all-reduce': 2097248,
                                   'reduce-scatter': 21626880},
                 'count_by_kind_one_period': {'all-gather': 12,
                                              'all-reduce': 7,
                                              'reduce-scatter': 3}},
 'raw_full_depth': {'flops': 3130350848.0,
                    'bytes': 7565198848.0,
                    'coll_total': 122964064.0,
                    'coll_by_kind': {'all-gather': 121896960,
                                     'all-reduce': 165984,
                                     'reduce-scatter': 901120},
                    'coll_counts': {'all-gather': 12,
                                    'all-reduce': 7,
                                    'reduce-scatter': 3}},
 'shallow': {'k1': {'flops': 1526976256.0,
                    'bytes': 799328000.0,
                    'coll_total': 122964064.0,
                    'coll_by_kind': {'all-gather': 121896960,
                                     'all-reduce': 165984,
                                     'reduce-scatter': 901120},
                    'coll_counts': {'all-gather': 12,
                                    'all-reduce': 7,
                                    'reduce-scatter': 3}},
             'k2': {'flops': 3261317888.0,
                    'bytes': 1557495552.0,
                    'coll_total': 204886112.0,
                    'coll_by_kind': {'all-gather': 202833920,
                                     'all-reduce': 249952,
                                     'reduce-scatter': 1802240},
                    'coll_counts': {'all-gather': 22,
                                    'all-reduce': 10,
                                    'reduce-scatter': 6}}},
 'memory': {'argument_bytes': 1067269152,
            'output_bytes': 1006633016,
            'temp_bytes': 2278140704,
            'alias_bytes': 0,
            'peak_bytes_per_device': 4352042872},
 'status': 'ok'}


CASES = {"train": ("train", "none"), "train_attn_out": ("train", "attn_out"),
         "prefill": ("prefill", "attn_out"), "decode": ("decode", "attn_out")}


def _plan(make, cfg, case, **impl):
    kind, remat = CASES[case]
    seq, batch = SMOKE[kind]
    return make(cfg, ShapeConfig("smoke", seq, batch, kind), arch=ARCH,
                remat=remat, **MESH, **impl)


def jax_records():
    """The JAX records of every case (run in the child process)."""
    from repro.configs import registry as jax_registry
    from repro.configs.base import ShapeConfig as JaxShapeConfig
    from repro.launch import dryrun as jax_dryrun
    from repro.plan import make_plan as jax_make_plan

    global ShapeConfig
    ShapeConfig = JaxShapeConfig
    cfg = jax_registry.get_smoke(ARCH)
    return {case: jax_dryrun.lower_cell(ARCH, "smoke", plan=_plan(
        jax_make_plan, cfg, case)) for case in CASES}


_JAX_CHILD = r"""
import json, sys
import jax
jax.devices()          # 8 host devices before repro.launch.dryrun asks 512
sys.path.insert(0, "tests")
from test_torch_dryrun import jax_records
json.dump(jax_records(), open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_recs(tmp_path_factory):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path_factory.mktemp("dryrun") / "records.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CHILD, str(path)],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    state = {}

    def load():
        if "want" not in state:
            _, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            state["want"] = json.loads(path.read_text())
        return state["want"]

    try:
        yield load
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


_PORT = {}


def _port(case):
    if case not in _PORT:
        plan = _plan(make_plan, registry.get_smoke(ARCH), case,
                     block_impl="ref", kernel_impl="ref")
        _PORT[case] = dryrun.lower_cell(ARCH, "smoke", plan=plan)
    return _PORT[case]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("coll_by_kind", "coll_counts",
                                             "bytes_by_kind",
                                             "count_by_kind_one_period"):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def _n_outputs(case):
    """The step's output buffers in the JAX compile: the parameter leaves,
    the AdamW moments, its step and the three metrics in training; the
    next tokens and the cache's K and V in serving."""
    from repro.configs import registry as jax_registry
    from repro.models.factory import build_model as jax_build_model

    if CASES[case][0] == "train":
        n = len(jax.tree.leaves(jax_build_model(
            jax_registry.get_smoke(ARCH)).abstract()))
        return 3 * n + 1 + 3
    return 3


@pytest.mark.parametrize("case", ["train", "prefill", "decode"])
def test_record_matches_jax(jax_recs, case):
    got, want = _port(case), jax_recs()[case]
    assert _keys(got) == _keys(want)
    for k in ("plan", "kind", "devices", "mesh", "n_periods", "c", "rules",
              "remat", "placement"):
        assert got[k] == want[k], k
    mem, mem_j = got["memory"], want["memory"]
    assert mem["argument_bytes"] == mem_j["argument_bytes"]
    assert mem["output_bytes"] + 8 * _n_outputs(case) == \
        mem_j["output_bytes"]
    coll, coll_j = got["collectives"], want["collectives"]
    skip = {"all-reduce"} if case == "train" else set()
    for k in ("count_by_kind_one_period", "bytes_by_kind"):
        assert {n: v for n, v in coll[k].items() if n not in skip} == \
            {n: v for n, v in coll_j[k].items() if n not in skip}, k
    ratio = got["flops_per_device"] / want["flops_per_device"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio
    assert got["shallow"]["k1"]["flops"] < got["shallow"]["k2"]["flops"]


def test_xla_output_tuple_is_eight_bytes_a_buffer(jax_recs):
    """Pinned XLA difference (ROADMAP.md §C): the compiled step's output
    size counts its output tuple's index table, 8 bytes an output buffer,
    which the port's outputs do not have."""
    for case in ("train", "prefill", "decode"):
        diff = jax_recs()[case]["memory"]["output_bytes"] \
            - _port(case)["memory"]["output_bytes"]
        assert diff == 8 * _n_outputs(case) > 0, case


def test_xla_combines_the_train_steps_all_reduces(jax_recs):
    """Pinned XLA difference (ROADMAP.md §C): XLA's all-reduce combiner
    merges the step's psums into tuple all-reduces, and the jitted step
    sums the gradient norm's per-device parts with all-reduces of its own
    (the port takes the norm over the unique shards in one process), so
    the per-period all-reduce counts and bytes differ; every other kind is
    equal (``test_record_matches_jax``)."""
    got = _port("train")["collectives"]
    want = jax_recs()["train"]["collectives"]
    n, n_j = (c["count_by_kind_one_period"]["all-reduce"]
              for c in (got, want))
    assert n_j < n, (n, n_j)
    assert got["bytes_by_kind"]["all-reduce"] != \
        want["bytes_by_kind"]["all-reduce"]


def test_recompute_gathers_the_layer_weights_again(jax_recs):
    """Pinned difference (ROADMAP.md §C): under ``remat='attn_out'`` the
    port's recompute runs the layer's forward again, FSDP weight gathers
    included (seven a layer: wq, wk, wv, wo, w1, w2, w3), where XLA keeps
    the forward's gathered weights for the backward. The rest of the
    all-gathers, and every reduce-scatter and permute, are equal."""
    got = _port("train_attn_out")["collectives"]
    want = jax_recs()["train_attn_out"]["collectives"]
    model = dryrun._meta_model(registry.get_smoke(ARCH))
    layouts = model.partition("default")
    shards = shard_params(model, TraceComm(c=2, r=1, data=2), "default")
    # each FSDP leaf of layer 0, gathered whole over the data axis
    fsdp = [n for n in layouts if n.startswith("layers.0.")
            and "data" in sharding.mentioned(layouts[n])]
    assert len(fsdp) == 7
    per_layer = sum(shards.named[n].numel() * MESH["data"] * 4
                    for n in fsdp)
    n_periods = _port("train_attn_out")["n_periods"]
    assert got["count_by_kind_one_period"]["all-gather"] - \
        want["count_by_kind_one_period"]["all-gather"] == 7
    assert got["bytes_by_kind"]["all-gather"] - \
        want["bytes_by_kind"]["all-gather"] == n_periods * per_layer
    for kind in ("reduce-scatter", "collective-permute"):
        for k in ("count_by_kind_one_period", "bytes_by_kind"):
            assert got[k][kind] == want[k][kind], (kind, k)


def _as_xla_on_the_cpu(comm):
    """``dryrun._collectives`` with bf16 collectives at f32 width."""
    out = {"total_bytes": 0, "bytes_by_kind": {}, "count_by_kind": {}}
    for _, kind, nbytes, _, _, dtype in comm.log:
        nbytes *= 2 if dtype == torch.bfloat16 else 1
        out["bytes_by_kind"][kind] = out["bytes_by_kind"].get(kind, 0) \
            + nbytes
        out["count_by_kind"][kind] = out["count_by_kind"].get(kind, 0) + 1
        out["total_bytes"] += nbytes
    return out


def _ref_cell():
    """The JAX record's plan: the production cell with the plain
    versions (JAX resolves its kernels to 'ref' on the CPU)."""
    plan = dataclasses.replace(dryrun.plan_for_cell(ARCH, "decode_32k"),
                               block_impl="ref", kernel_impl="ref")
    return dryrun.lower_cell(ARCH, "decode_32k", plan=plan)


def test_full_size_cell_matches_the_frozen_jax_record(monkeypatch):
    """h2o-danube-1.8b at decode_32k, single pod, C = 2, the plain
    versions (the JAX record's ``'ref'``): the plan field for field,
    devices, periods, argument bytes and per-period collective counts
    equal; the collective bytes equal with bf16 collectives counted at
    f32 width (pinned, ROADMAP.md §C: XLA's CPU compile carries bf16
    collectives in f32, so its bytes are twice the card's)."""
    rec = _ref_cell()
    assert rec["plan"] == JAX_RECORD["plan"]
    for k in ("arch", "shape", "mesh", "kind", "c", "rules", "remat",
              "placement", "devices", "n_periods"):
        assert rec[k] == JAX_RECORD[k], k
    assert rec["memory"]["argument_bytes"] == \
        JAX_RECORD["memory"]["argument_bytes"]
    assert rec["collectives"]["count_by_kind_one_period"] == \
        JAX_RECORD["collectives"]["count_by_kind_one_period"]
    assert _keys(rec) | {"status"} == _keys(JAX_RECORD)
    for kind, b in rec["collectives"]["bytes_by_kind"].items():
        assert b < JAX_RECORD["collectives"]["bytes_by_kind"][kind], kind
    monkeypatch.setattr(dryrun, "_collectives", _as_xla_on_the_cpu)
    rec = _ref_cell()
    assert rec["collectives"]["bytes_by_kind"] == \
        JAX_RECORD["collectives"]["bytes_by_kind"]
    assert rec["collectives"]["total_bytes"] == \
        JAX_RECORD["collectives"]["total_bytes"]


def test_full_size_cell_memory_and_flops_differences_are_pinned():
    """The full-size cell's memory and FLOPs against the frozen JAX
    record, each difference with its cause (ROADMAP.md §C):

    * alias: JAX's decode step donates nothing (its jit has no
      ``donate_argnums``), so XLA aliases 0 B and writes the updated cache
      to fresh output buffers; the port updates its cache in place, so its
      alias bytes are the cache's (K and V, 1 006 632 960 B).
    * temp: XLA's CPU compile upcasts each stacked bf16 argument its layer
      loop reads to f32 whole (its buffer assignment: ``wrapped_convert``
      of f32[24, 8, 2048, 8, 80] for K and for V, and of every stacked
      layer weight), twice the bytes of the cache and the layer weights,
      2 131 968 000 B of its 2 278 140 704 B. What remains, the loop's
      working set (146 172 704 B), is within 0.8-1.0 of the port's temp
      (0.892 measured). So JAX's peak is the port's plus the cache (not
      aliased), the upcasts and that remainder's excess.
    * FLOPs: XLA's cost analysis counts elementwise operations too,
      ``FlopCounterMode`` only the matmuls and attention calls: the
      port's count is 0.743 of XLA's here (0.94-0.96 at smoke size,
      ``FLOPS_RATIO``)."""
    rec = _ref_cell()
    got, want = rec["memory"], JAX_RECORD["memory"]
    plan = dryrun.plan_for_cell(ARCH, "decode_32k")
    shards = shard_params(dryrun._meta_model(registry.get(ARCH)),
                          TraceComm(plan.c, plan.r, plan.data),
                          plan.sharding_rules)
    layer_bytes = sum(t.numel() * t.element_size()
                      for n, t in shards.named.items()
                      if n.startswith("layers."))
    cache_bytes = got["alias_bytes"]
    assert want["alias_bytes"] == 0 and cache_bytes == 1006632960
    # the next tokens beside the cache; XLA's tuple index, 8 B a buffer
    assert got["output_bytes"] - cache_bytes == 32
    assert want["output_bytes"] - got["output_bytes"] == 3 * 8
    upcasts = 2 * (cache_bytes + layer_bytes)
    assert upcasts == 2131968000
    rest = want["temp_bytes"] - upcasts
    assert 0.8 <= got["temp_bytes"] / rest <= 1.0, (got["temp_bytes"], rest)
    assert want["peak_bytes_per_device"] - got["peak_bytes_per_device"] == \
        cache_bytes + upcasts + rest - got["temp_bytes"] + 3 * 8
    ratio = rec["flops_per_device"] / JAX_RECORD["flops_per_device"]
    assert 0.74 <= ratio <= 0.75, ratio


def test_xla_counts_elementwise_flops_and_flop_counter_does_not():
    """The cause of the FLOPs difference, on one softmax: XLA's cost
    analysis charges it FLOPs, ``FlopCounterMode`` none."""
    import jax.numpy as jnp

    x = jnp.ones((8, 128), jnp.float32)
    ca = jax.jit(jax.nn.softmax).lower(x).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    assert ca["flops"] >= 8 * 128
    mode = FlopCounterMode(display=False)
    with mode:
        torch.softmax(torch.ones(8, 128), -1)
    assert mode.get_total_flops() == 0


@pytest.mark.parametrize("case", ["train", "prefill", "decode"])
def test_extrapolation_equals_the_full_depth_trace(case):
    rec = _port(case)
    raw = rec["raw_full_depth"]
    assert rec["flops_per_device"] == raw["flops"]
    assert rec["bytes_accessed_per_device"] == raw["bytes"]
    assert rec["collectives"]["total_bytes"] == raw["coll_total"]
    assert rec["collectives"]["bytes_by_kind"] == raw["coll_by_kind"]


@pytest.mark.parametrize("arch", registry.ASSIGNED_ARCHS)
def test_every_family_traces_its_three_steps(arch):
    """Every arch's smoke train, prefill and decode steps trace on 8
    devices (data 2, C 2) with the plain versions: no step reads a value
    on the host. The arguments are the rank's parameter shards plus its
    batch (train: and the AdamW state) or its cache and tokens, the peak
    is JAX's formula, and a model of equal periods extrapolates to its
    full-depth trace."""
    cfg = registry.get_smoke(arch)
    for kind in ("train", "prefill", "decode"):
        plan = make_plan(cfg, ShapeConfig("smoke", 64, 4, kind), arch=arch,
                         block_impl="ref", kernel_impl="ref", **MESH)
        rec = dryrun.lower_cell(arch, "smoke", plan=plan)
        mem = rec["memory"]
        assert mem["peak_bytes_per_device"] == mem["argument_bytes"] + \
            mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
        assert mem["argument_bytes"] > mem["alias_bytes"] >= 0, kind
        assert mem["temp_bytes"] > 0 and rec["flops_per_device"] > 0
        assert rec["flops_per_device"] == rec["raw_full_depth"]["flops"], \
            kind
        assert rec["collectives"]["total_bytes"] == \
            rec["raw_full_depth"]["coll_total"], kind


# ---------------------------------------------------------------------------
# the kernels' meta rules
# ---------------------------------------------------------------------------

B, SQ, SK, HQ, HKV, D, PS, W = 2, 8, 16, 4, 2, 32, 4, 4


def _blocks(device, dtype=torch.float32, d=D):
    g = torch.Generator().manual_seed(0)

    def t(*shape, dt=dtype):
        x = torch.randn(*shape, generator=g).to(dt)
        return x.to(device) if device == "cpu" else torch.empty(
            shape, dtype=dt, device="meta")

    q, do = t(B, SQ, HQ, d), t(B, SQ, HQ, d)
    k, v = t(B, SK, HKV, d), t(B, SK, HKV, d)
    o_acc = t(B, SQ, HQ, d, dt=torch.float32)
    lse = t(B, HQ, SQ, dt=torch.float32)
    pos_q = torch.arange(SQ, dtype=torch.int32).to(device)
    pos_k = torch.arange(SK, dtype=torch.int32).to(device)
    bq = torch.arange(SQ, dtype=torch.int32)[None].repeat(B, 1).to(device)
    bk = torch.arange(SK, dtype=torch.int32)[None].repeat(B, 1).to(device)
    return dict(q=q, k=k, v=v, do=do, o_acc=o_acc, lse=lse, pos_q=pos_q,
                pos_k=pos_k, bq=bq, bk=bk)


def _paged(device, dtype=torch.float32, d=D, sq=1):
    pages = B * W
    shape_q, shape_p = (B, sq, HQ, d), (pages, PS, HKV, d)
    if device == "meta":
        q, pk, pv = (torch.empty(s, dtype=dtype, device="meta")
                     for s in (shape_q, shape_p, shape_p))
    else:
        g = torch.Generator().manual_seed(1)
        q, pk, pv = (torch.randn(*s, generator=g).to(dtype)
                     for s in (shape_q, shape_p, shape_p))
    table = torch.arange(pages, dtype=torch.int32).reshape(B, W).to(device)
    cl = torch.full((B,), W * PS - 1, dtype=torch.int32).to(device)
    return q, pk, pv, table, cl


# name -> (fn(inputs) -> outputs, FLOPs per pair and query head / D)
def _calls(x):
    m = dict(causal=False)
    return {
        "B1": (lambda: fa.flash_attention_fwd(
            x["q"], x["k"], x["v"], x["pos_q"], x["pos_k"], **m), 4),
        "B2": (lambda: fa.flash_attention_fwd(
            x["q"], x["k"], x["v"], x["pos_q"], x["pos_k"], x["o_acc"],
            x["lse"], **m), 4),
        "B3": (lambda: fa.flash_attention_bwd(
            x["q"], x["k"], x["v"], x["do"], x["lse"], x["lse"],
            x["pos_q"], x["pos_k"], **m), 10),
        "B5": (lambda: dispatch.block_fwd(
            x["q"], x["k"], x["v"], x["bq"], x["bk"], impl="cuda", **m), 4),
        "B7": (lambda: dispatch.block_bwd(
            x["q"], x["k"], x["v"], x["do"], x["lse"], x["lse"], x["bq"],
            x["bk"], impl="cuda", **m), 10),
    }


def _flops_of(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["B1", "B2", "B3", "B5", "B7"])
def test_block_meta_rules_match_the_plain_versions(name):
    """Output shapes and dtypes of the plain version (CPU), and the FLOPs
    ``FlopCounterMode`` counts for it on an unmasked tile."""
    fn_cpu, _ = _calls(_blocks("cpu"))[name]
    fn_meta, _ = _calls(_blocks("meta"))[name]
    charged = []
    with meta.charging(lambda *a: charged.append(a)):
        got = fn_meta()
    want = fn_cpu()
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    assert [c[0] for c in charged] == [name]
    assert charged[0][1] == _flops_of(fn_cpu)


@pytest.mark.parametrize("name", ["B4", "B6"])
def test_paged_meta_rules_match_the_plain_versions(name):
    kernel = {"B4": paged_decode.paged_decode_attention,
              "B6": paged_prefill.paged_prefill_attention}[name]
    sq = 1 if name == "B4" else SQ

    def call(args):
        q, pk, pv, table, cl = args
        return kernel(q, pk, pv, table, cl, 0, sp=1, page_size=PS)

    charged = []
    with meta.charging(lambda *a: charged.append(a)):
        got = call(_paged("meta", sq=sq))
    want = call(_paged("cpu", sq=sq))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert charged[0][0] == name
    # every slot of the table visible: the plain version's count
    assert charged[0][1] == _flops_of(lambda: call(_paged("cpu", sq=sq)))
    kv = 2 * B * W * PS * HKV * D * 4
    assert charged[0][2] == kv + meta.io_bytes(*got, *_paged(
        "meta", sq=sq)[:1], *_paged("meta", sq=sq)[3:])


def test_meta_rules_raise_where_the_kernels_raise():
    """Head size 16 raises in every kernel; B4 and B6 charge at head size
    256 (GPT-3B's, which their kernels take) as the other kernels do, and
    B4 at 34 query heads on 2 kv heads (G = 17, past one 16-row slab) and
    pages of 128; no launch is counted."""
    before = dict(fa.LAUNCHES)
    x = _blocks("meta", d=16)
    for name, (fn, _) in _calls(x).items():
        with pytest.raises(ValueError, match="head_dim 16"):
            fn()
    charged = []
    with meta.charging(lambda *a: charged.append(a)):
        for kernel, sq in ((paged_decode.paged_decode_attention, 1),
                           (paged_prefill.paged_prefill_attention, SQ)):
            q, pk, pv, table, cl = _paged("meta", d=256, sq=sq)
            o, lse = kernel(q, pk, pv, table, cl, 0, sp=1, page_size=PS)
            assert o.shape == (B, sq, q.shape[2], 256)
        q = torch.empty((B, 1, 34, D), device="meta")
        pk = torch.empty((B * W, 128, 2, D), device="meta")
        table = torch.zeros((B, W), dtype=torch.int32, device="meta")
        cl = torch.zeros((B,), dtype=torch.int32, device="meta")
        o, lse = paged_decode.paged_decode_attention(q, pk, pk, table, cl, 0,
                                                     sp=1, page_size=128)
        assert o.shape == (B, 1, 34, D) and lse.shape == (B, 34, 1)
    assert [c[0] for c in charged] == ["B4", "B6", "B4"]
    assert charged[0][1] == 4 * 256 * HQ * B * W * PS
    assert charged[2][1] == 4 * D * 34 * B * W * 128
    assert fa.LAUNCHES == before


def test_cuda_traces_run_no_plain_version(monkeypatch):
    """Under 'cuda' the kernels enter the trace only through their meta
    rules: with every plain attention raising, full-size h2o traces its
    decode_32k and prefill_32k cells and the P = 1 train step of
    ``chip_smoke.py``'s train phase (seq 4096, 4 microbatches), the
    charges landing on B5 (the decode step's (B, S) positions), B2 and
    B3."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran in a 'cuda' trace")

    for fn in ("block_attention", "block_attention_bwd"):
        monkeypatch.setattr(ref, fn, refuse)
    names = []
    orig = meta.charge

    def charge(name, *a):
        names.append(name)
        return orig(name, *a)

    monkeypatch.setattr(meta, "charge", charge)
    rec = dryrun.lower_cell(ARCH, "decode_32k")
    assert rec["plan"]["kernel_impl"] == "cuda" and set(names) == {"B5"}
    names.clear()
    cfg = registry.get(ARCH)
    plan = make_plan(cfg, ShapeConfig("train_4k_b4", 4096, 4, "train"),
                     arch=ARCH, c=1, microbatches=4)
    costs, mem = dryrun.trace_step(cfg, plan)
    assert set(names) == {"B2", "B3"}
    assert names.count("B2") == 2 * names.count("B3") == \
        2 * cfg.num_layers * 4
    params = sum(p.numel() for p in dryrun._meta_model(cfg).parameters())
    assert mem["argument_bytes"] == params * (2 + 4 + 4) + 4 + 2 * 4 * 4096 * 4
    assert mem["alias_bytes"] == params * 10 + 4
    names.clear()
    rec = dryrun.lower_cell(ARCH, "prefill_32k")
    assert rec["kind"] == "prefill" and set(names) == {"B2"}


# ---------------------------------------------------------------------------
# the trace communicator and the CLI
# ---------------------------------------------------------------------------

def test_trace_comm_shapes_log_and_autograd():
    """Result shapes of a real mesh's collectives; the log in result bytes
    with the group size; the backward the ThreadMesh's transposes, logged
    as backward; size-one groups and identity permutes logged."""
    comm = TraceComm(c=2, r=1, data=2)
    assert (comm.size, comm.sp_size, comm.axis_size("data")) == (8, 4, 2)
    x = torch.empty((2, 4, 8), device="meta", requires_grad=True)
    y = comm.all_gather(x, "sp_team", 1)
    assert y.shape == (2, 8, 8)
    z = comm.psum_scatter(y, ("sp_grp", "sp_team"), 1)
    assert z.shape == (2, 2, 8)
    a = comm.all_to_all(x, "data", 2, 1)
    assert a.shape == (2, 8, 4)
    assert comm.ppermute(x, "sp_ring", [(0, 0)]) is x
    (z.sum() + a.sum()).backward()
    kinds = [(e[1], e[2], e[3], e[4]) for e in comm.log]
    assert kinds[:4] == [("all-gather", 512, 2, "forward"),
                         ("reduce-scatter", 128, 4, "forward"),
                         ("all-to-all", 256, 2, "forward"),
                         ("collective-permute", 256, 1, "forward")]
    assert sorted(k[0] for k in kinds[4:]) == \
        ["all-gather", "all-to-all", "reduce-scatter"]
    assert all(k[3] == "backward" for k in kinds[4:])
    assert x.grad.shape == x.shape
    with pytest.raises(ValueError, match="carries no gradient"):
        comm.pmax(x, "data")
    assert comm.run(lambda c: c.rank) == [0]
    assert isinstance(ThreadMesh(2, 1, 2).size, int)


def test_main_in_process(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    recs = dryrun.main(["--arch", ARCH, "--shape", "decode_32k"])
    out = capsys.readouterr().out
    name = f"{ARCH}__decode_32k__single__c2"
    assert f"[ok] {name} peak=" in out and "fits 80GiB" in out
    rec = json.loads((tmp_path / f"{name}.json").read_text())
    assert rec["status"] == "ok" and recs[0]["plan"] == rec["plan"]
    from repro.roofline import model as jax_model

    assert jax_model.from_record(rec).peak_gib == \
        rec["memory"]["peak_bytes_per_device"] / 2**30
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", ARCH, "--shape", "decode_32k",
                     "--multi-pod"])
    rec = json.loads((tmp_path / f"{ARCH}__decode_32k__multi__c2.json")
                     .read_text())
    assert rec["status"] == "error" and "§A item 1" in rec["error"]
    assert "[error]" in capsys.readouterr().out
    rec = dryrun.run_and_save(ARCH, "long_500k")
    assert rec["status"] == "ok"          # h2o's sliding window takes it
    rec = dryrun.run_and_save("minitron-8b", "long_500k")
    assert rec["status"] == "skipped"


def test_autotune_mode(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(autotune, "RESULTS", tmp_path)
    out = dryrun.main(["--autotune", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[autotune] winner=" in text and str(tmp_path) in text
    assert out["measured"][0]["measured_s"] < \
        out["measured"][-1]["measured_s"]
