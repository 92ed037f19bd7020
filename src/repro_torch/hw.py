"""The card's constants: the counterpart of ``repro/hw.py``, one source for
every rate, size and count the port's roofline, dry run, kernel plans and
``chip_smoke.py`` read.

:class:`ChipSpec` keeps the JAX package's field names wherever the H100
has a counterpart:

  - ``peak_bf16_flops``: the dense bf16 tensor-core rate (wgmma);
  - ``peak_int8_ops``: the dense int8 tensor-core rate (fp8 runs at the same);
  - ``hbm_bytes``: device memory as ``torch.cuda.get_device_properties(0).total_memory``
    reads it (what CUDA leaves a process, not the 80 GiB of the stacks);
  - ``hbm_bw``: HBM3's rate;
  - ``vmem_bytes``: the TPU core's vector memory stands where an SM's shared
    memory does: the most one block may take (227 KiB; the SM has 228);
  - ``ici_bw_per_link`` and ``ici_links``: the TPU's inter-chip links stand
    where NVLink 4's do, 18 links of 25 GB/s each way.

The fields after them are the card's alone: the TF32, f32, int32 and fp8
rates, shared memory an SM, the SM count, and the NIC that joins 8-card
nodes (one 400 Gb/s port a card).  ``mxu_dim`` and ``clock_hz`` are left
out: a TPU's systolic array has one edge and its clock is derived from it,
where an H100's tensor cores take several tile shapes (m64nNk16 for wgmma)
and its clock moves with the power limit, so no one number stands for
either.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float        # FLOP/s, dense bf16 on the tensor cores
    peak_int8_ops: float          # OP/s, dense int8 on the tensor cores
    hbm_bytes: int                # device memory a process sees
    hbm_bw: float                 # bytes/s
    vmem_bytes: int               # shared memory one block may take
    ici_bw_per_link: float        # bytes/s each way, one NVLink link
    ici_links: int                # NVLink links a card
    peak_tf32_flops: float = 0.0  # FLOP/s, dense TF32 on the tensor cores
    peak_f32_flops: float = 0.0   # FLOP/s, f32 on the CUDA cores
    peak_int32_ops: float = 0.0   # OP/s, int32 multiply-adds on the CUDA cores
    peak_fp8_flops: float = 0.0   # FLOP/s, dense fp8 on the tensor cores
    smem_per_sm_bytes: int = 0    # shared memory an SM holds
    sm_count: int = 0
    nic_bw: float = 0.0           # bytes/s each way, a card's NIC between nodes
    node_size: int = 1            # cards a node joins by NVLink

    @property
    def nvlink_bw(self) -> float:
        """Bytes/s each way from one card to the others of its node: every
        link at once, as NVSwitch gives any peer."""
        return self.ici_bw_per_link * self.ici_links


H100_SXM = ChipSpec(
    name="NVIDIA H100 80GB HBM3",
    peak_bf16_flops=989e12,
    peak_int8_ops=1979e12,
    hbm_bytes=85_017_493_504,
    hbm_bw=3.35e12,
    vmem_bytes=227 * 1024,
    ici_bw_per_link=25e9,
    ici_links=18,
    peak_tf32_flops=495e12,
    peak_f32_flops=67e12,
    peak_int32_ops=33.5e12,
    peak_fp8_flops=1979e12,
    smem_per_sm_bytes=228 * 1024,
    sm_count=132,
    nic_bw=50e9,
    node_size=8,
)

DEFAULT_CHIP = H100_SXM

#: the bf16 matmul planner's assumed achievable memory rate
#: (``kernels/matmul.py`` ``plan``): below HBM3's 3.35 TB/s, read off the
#: streaming kernel's sweep, not a property of the card
MATMUL_PLAN_BYTES_S = 3.0e12
