"""Paper Table III on the port: the efficiency of registered roles against the
plain host CPU.

    PYTHONPATH=src python -m repro_torch.bench.table3_efficiency [--device cpu] [--n 100]

The port's copy of the JAX package's ``benchmarks/table3_efficiency.py``.
The paper compares its FPGA roles with a plain ARM Cortex-A53 in operations
a cycle.  Here each of the paper's four roles, loaded on the device (its
hand-written kernel on the card, under ``cuda-strict``), is called n times
and the device synchronised before the clock is read; the same role's
plain per-op numpy version is timed on the host (:func:`numpy_baseline`,
the JAX script's).  Operations a cycle are the role's operations
(:func:`flops`: two a multiply-add) over the measured seconds at a nominal
host clock of :data:`HOST_HZ`, both sides at the same clock.

``h100_target_us`` (where the JAX script reads the TPU's MXU) is the least
time ``hw.H100_SXM`` allows the role's work: the larger of its operations
at the rate its kernel computes at and its bytes (each input read once, the
output written once) at 3.35 TB/s.  The f32 roles run 3xTF32 (three TF32
products a product) on the tensor cores, so their operations count three
times at ``peak_tf32_flops``; the int16 convolutions multiply-add in int32
on the CUDA cores, at ``peak_int32_ops``.  At these sizes the byte time
decides both.  Every time is the device's and the host's own: the rows are
reported, not compared.  Imports no JAX.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch import paper_roles
from repro_torch.bench import common
from repro_torch.core.hsa import hsa_init, hsa_shut_down
from repro_torch.core.ledger import OverheadLedger
from repro_torch.hw import H100_SXM
from repro_torch.paper_roles import FC_DIM, IMG

HOST_HZ = 3.0e9          # the nominal host clock for operations a cycle


def flops(name: str) -> float:
    """The role's operations: two a multiply-add."""
    if name.startswith(("role1", "role2")):
        return 2.0 * FC_DIM ** 3
    if "conv5x5" in name:
        return 2.0 * (IMG - 4) ** 2 * 25
    return 2.0 * (IMG - 2) ** 2 * 9 * 2


def role_bytes(name: str) -> float:
    """Bytes the role's kernel must move: x and w read, the output written
    (an f32 product; an int16 image and filter to an int32 map)."""
    if name.startswith(("role1", "role2")):
        return 4.0 * 3 * FC_DIM ** 2
    kh, f = (5, 1) if "5x5" in name else (3, 2)
    oh = IMG - kh + 1
    return 2.0 * (IMG * IMG + kh * kh * f) + 4.0 * oh * oh * f


def h100_target_us(name: str) -> float:
    """The least µs the H100 allows the role (see the module docstring)."""
    if name.startswith(("role1", "role2")):
        ops_s = 3 * flops(name) / H100_SXM.peak_tf32_flops
    else:
        ops_s = flops(name) / H100_SXM.peak_int32_ops
    return max(ops_s, role_bytes(name) / H100_SXM.hbm_bw) * 1e6


def numpy_baseline(name: str, args) -> float:
    """The plain per-op host version, timed a call (seconds)."""
    n = 50
    if name.startswith(("role1", "role2")):
        a, b = (np.asarray(x.cpu(), np.float32) for x in args)
        t = time.perf_counter()
        for _ in range(n):
            a @ b
        return (time.perf_counter() - t) / n
    (x,) = args
    xi = np.asarray(x.cpu(), np.int32)[0, :, :, 0]
    kh = 5 if "5x5" in name else 3
    f = 1 if "5x5" in name else 2
    w = np.ones((kh, kh, f), np.int32)
    t = time.perf_counter()
    for _ in range(n):
        oh, ow = xi.shape[0] - kh + 1, xi.shape[1] - kh + 1
        acc = np.zeros((oh, ow, f), np.int32)
        for di in range(kh):
            for dj in range(kh):
                acc += xi[di:di + oh, dj:dj + ow, None] * w[di, dj]
    return (time.perf_counter() - t) / n


def rows(n: int = 100, *, device="cuda", model=None, params=None) -> dict[str, tuple[str, str]]:
    """Every row, metric -> (value, derived), formatted as the JAX script
    formats them (``h100_target_us`` for its ``tpu_target_opc``), on
    ``device`` (``model``'s where one is given; it serves nothing here)."""
    dev = model.device if model is not None else torch.device(device)
    hsa_shut_down()
    sys_ = hsa_init(num_regions=4, ledger=OverheadLedger(), device=dev)
    out = {}
    try:
        with common.policy(dev):
            roles = paper_roles.make_paper_roles(sys_.library, device=dev)
            sys_.library.synthesize_all()
            for name, (role, args) in roles.items():
                exe = role.load()
                exe(*args)                               # warm
                common.sync(dev)
                t = time.perf_counter()
                for _ in range(n):
                    exe(*args)
                common.sync(dev)
                accel_s = (time.perf_counter() - t) / n
                base_s = numpy_baseline(name, args)
                ops = flops(name)
                out[name] = (f"{accel_s * 1e6:.1f}",
                             f"op_cycle_increase={base_s / accel_s:.2f};"
                             f"base_us={base_s * 1e6:.1f};"
                             f"opc_base={ops / (base_s * HOST_HZ):.2f};"
                             f"opc_accel={ops / (accel_s * HOST_HZ):.2f};"
                             f"h100_target_us={h100_target_us(name):.3f}")
    finally:
        hsa_shut_down()
    return out


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Every row is measured: nothing to compare (``complete``: each role
    has its row)."""
    missing = [r for r in ("role1_fc", "role2_fc_barrier", "role3_conv5x5", "role4_conv3x3")
               if r not in got]
    if complete and missing:
        raise AssertionError(f"table3: no row for {missing}")


if __name__ == "__main__":
    sys.exit(common.main("table3", __doc__, rows, check, n=100))
