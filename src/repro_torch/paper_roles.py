"""The paper's four roles, sized per §IV, as the port builds them.

Role 1: fully connected (float32), generic: the weight is an operand.
Role 2: fully connected with barrier (float32): the same function as a
        distinct op, so it occupies its own region, dispatched behind a
        barrier-AND packet.
Role 3: conv 5×5, 1 filter, fixed weights (int16).
Role 4: conv 3×3, 2 filters, fixed weights (int16).

Inputs and weights are drawn from ``numpy.random.default_rng(seed)`` in the
order the JAX package's ``benchmarks/common.py`` draws them, so at the same
seed both packages' roles get the same numbers and the same keys, names and
region-image digests.  :func:`fc_fixed_role` adds the weight-specialised FC
role of §IV (the role planner's alternative to role 1).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import FIXED_WEIGHT, GLOBAL_REGISTRY, KernelImpl
from repro_torch.core.roles import ArgSpec, Role, RoleLibrary
from repro_torch.kernels import conv2d as conv2d_k
from repro_torch.kernels import matmul as matmul_k

FC_DIM = 256
IMG = 64


def make_paper_roles(lib: RoleLibrary, *, seed: int = 0,
                     device: "str | torch.device" = "cuda") -> dict[str, tuple[Role, tuple]]:
    """name -> (role, its concrete arguments on ``device``).  Role 1's
    implementation is the registry's ``cuda`` ``matmul`` (the CUDA kernel's
    wrapper, which runs its plain version on CPU tensors); roles 3 and 4 are fixed-weight conv roles
    (:func:`repro_torch.kernels.conv2d.conv2d_fixed_weight`), registered
    under their own op names as the JAX package registers them."""
    import repro_torch.kernels.ops  # noqa: F401  (registers the kernels)

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    roles: dict[str, tuple[Role, tuple]] = {}

    fc_impl = GLOBAL_REGISTRY.resolve("matmul", "cuda", ("cuda",))
    barrier_impl = KernelImpl(op="fc_barrier", device_kind="any", source=fc_impl.source,
                              fn=fc_impl.fn, footprint=fc_impl.footprint)
    GLOBAL_REGISTRY.register(barrier_impl, allow_override=True)
    x = torch.tensor(rng.normal(size=(FC_DIM, FC_DIM)), dtype=torch.float32, device=device)
    w = torch.tensor(rng.normal(size=(FC_DIM, FC_DIM)), dtype=torch.float32, device=device)
    a = ArgSpec((FC_DIM, FC_DIM), torch.float32)
    roles["role1_fc"] = (lib.make_role(fc_impl, (a, a), name="role1_fc", device=device), (x, w))
    roles["role2_fc_barrier"] = (
        lib.make_role(barrier_impl, (a, a), name="role2_fc_barrier", device=device), (x, w))

    w5 = torch.tensor(rng.integers(-8, 8, size=(5, 5, 1, 1)), dtype=torch.int16)
    w3 = torch.tensor(rng.integers(-8, 8, size=(3, 3, 1, 2)), dtype=torch.int16)
    xi = torch.tensor(rng.integers(-100, 100, size=(1, IMG, IMG, 1)), dtype=torch.int16,
                      device=device)
    xa = ArgSpec((1, IMG, IMG, 1), torch.int16)
    for name, wfix in (("role3_conv5x5", w5), ("role4_conv3x3", w3)):
        impl = KernelImpl(
            op=name, device_kind="any", source=fc_impl.source,
            fn=conv2d_k.conv2d_fixed_weight(wfix), specialization=FIXED_WEIGHT,
            footprint=conv2d_k.footprint(1, wfix.shape[0], wfix.shape[1], wfix.shape[3]),
        )
        GLOBAL_REGISTRY.register(impl, allow_override=True)
        roles[name] = (lib.make_role(impl, (xa,), name=name, device=device), (xi,))
    return roles


def fc_fixed_role(lib: RoleLibrary, w: torch.Tensor, *,
                  device: "str | torch.device" = "cuda") -> Role:
    """The FC role with its weight fixed (paper §IV): ``matmul_fixed_weight``
    of ``w``, a role of ``x`` [FC_DIM, K] alone that holds ``w`` on the card
    while resident."""
    impl = KernelImpl(op="fc", device_kind="any", source="cuda",
                      fn=matmul_k.matmul_fixed_weight(w.cpu()), specialization=FIXED_WEIGHT,
                      footprint=matmul_k.footprint(f32=True))
    return lib.make_role(impl, (ArgSpec((FC_DIM, w.shape[0]), w.dtype),), name="role1_fc_fixed",
                         device=device)
