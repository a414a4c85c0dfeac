"""Hardware constants of the port's target card, one NVIDIA H100 (the
counterpart of ``repro.roofline.hw``, which holds the TPU v5e's).

Every figure is NVIDIA's datasheet figure for the NVIDIA H100 80GB HBM3
(SXM5) at its full 700 W power limit: dense rates, no sparsity. A card set
below 700 W runs slower under load (``nvidia-smi --query-gpu=power.limit``).
The names the cost model reads are the JAX package's, so ``plan.cost``
and ``core.scheduler`` read the same formulas; ``HOST_LINK_BW`` prices the
host KV tier's spills and reloads (``plan.cost.kv_transfer_cost``);
``HBM_BYTES`` is the memory the dry run's fits check holds a cell's
peak against (``launch.dryrun``, ``roofline.model``).
"""

# H100 SXM5 80GB, 700 W, datasheet: bf16 tensor-core peak, dense (FLOP/s)
PEAK_FLOPS_BF16 = 989e12
# H100 SXM5 80GB, 700 W, datasheet: f32 peak outside the tensor cores
PEAK_FLOPS_F32 = 67e12
# H100 SXM5 80GB, 700 W, datasheet: HBM3 bandwidth (bytes/s)
HBM_BW = 3.35e12
# H100 SXM5 80GB, 700 W, datasheet: NVLink 4, 900 GB/s per GPU in both
# directions, 450e9 bytes/s each way (the JAX table's ICI_BW_PER_LINK)
NVLINK_BW = 450e9
# H100 SXM5 80GB, datasheet: PCIe Gen5 x16 host interface, 128 GB/s in
# both directions, 64e9 bytes/s each way (the host KV tier's d2h and h2d)
HOST_LINK_BW = 64e9
# H100 SXM5 80GB, 700 W, datasheet: 80 GB of HBM3 on the card, counted as
# the JAX table counts its 16 GiB (binary units)
HBM_BYTES = 80 * 2**30
