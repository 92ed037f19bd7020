"""Roles and the paper-role kernels of the port against the JAX package, on
the CPU.

- The role lifecycle: ``synthesize``/``load``/``unload``, ``load_count``,
  ``resident`` (device memory held: a fixed weight bound at load),
  ``RoleLibrary.synthesize_all`` under the ledger's ``SETUP``.
- ``conv2d``: the port's oracle (``ref.conv2d``) and the kernel's plain
  version against JAX's ``ref.conv2d`` and the Pallas ``conv2d`` in
  interpret mode — the paper's role 3 and 4 shapes at 64x64, B = 2, Cin 4
  and F 8 in f32; int16 exactly (sums past 2^31 wrap on both sides), f32
  within 1e-5.  ``conv2d_fixed_weight`` is bitwise the generic wrapper.
- the f32 ``matmul``: the plain path against the Pallas ``matmul`` in
  interpret mode within 2e-4 (the JAX package's own tolerance);
  ``matmul_fixed_weight`` bitwise ``matmul``.
- the paper's four roles built through the port's ``RoleLibrary`` and run
  through its queue and executor (``run_packet_sync``) give the JAX roles'
  outputs on the same inputs.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
from repro.core import ledger as jledger
from repro.core import roles as jroles
from repro.kernels import conv2d as jconv
from repro.kernels import matmul as jmatmul
from repro.kernels import ref as jref
from repro_torch import paper_roles
from repro_torch.core import hsa as thsa
from repro_torch.core import ledger as tledger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.registry import FIXED_WEIGHT, GLOBAL_REGISTRY, KernelImpl
from repro_torch.core.roles import ONLINE, ArgSpec, Role, RoleLibrary
from repro_torch.kernels import conv2d as conv_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# role lifecycle
# ---------------------------------------------------------------------------


def test_role_lifecycle_and_setup_ledger():
    ledger = tledger.OverheadLedger()
    lib = RoleLibrary(ledger=ledger)
    impl = GLOBAL_REGISTRY.resolve("matmul", "cuda", ("cuda",))
    a = ArgSpec((8, 16), torch.float32)
    w = ArgSpec((16, 8), torch.float32)
    role = lib.make_role(impl, (a, w), name="fc", device="cpu")
    assert lib.make_role(impl, (a, w), device="cpu") is role          # keyed by signature
    assert str(role.key) == "matmul[8x16float32,16x8float32]"
    assert not role.resident and role.load_count == 0
    total = lib.synthesize_all()
    assert total >= 0 and role.synthesis_s is not None
    assert ledger.stat(tledger.SETUP).count == 1
    role.load()
    assert role.resident and role.load_count == 1
    role.load()                                                        # idempotent
    assert role.load_count == 1
    x = torch.randn(8, 16)
    wt = torch.randn(16, 8)
    torch.testing.assert_close(role(x, wt), ref.matmul(x, wt), rtol=0, atol=0)
    role.unload()
    assert not role.resident
    role(x, wt)                                                        # reloads on demand
    assert role.load_count == 2
    fp = role.footprint()
    assert fp["arg_bytes"] == (8 * 16 + 16 * 8) * 4 and fp["smem_bytes"] > 0


def test_fixed_weight_role_holds_its_weight_while_resident():
    w = torch.tensor(np.random.default_rng(0).integers(-8, 8, (3, 3, 1, 2)), dtype=torch.int16)
    impl = KernelImpl(op="conv3", device_kind="any", source="cuda",
                      fn=conv_k.conv2d_fixed_weight(w), specialization=FIXED_WEIGHT)
    role = Role(impl, (ArgSpec((1, 12, 12, 1), torch.int16),), device="cpu", source=ONLINE)
    assert role.key.specialization == FIXED_WEIGHT and role.resident_bytes() == 0
    rm = RegionManager(1, ledger=tledger.OverheadLedger())
    rm.ensure_resident(role)                      # online: synthesized at first load
    assert role.resident and role.resident_bytes() == w.numel() * 2
    x = torch.tensor(np.random.default_rng(1).integers(-50, 50, (1, 12, 12, 1)),
                     dtype=torch.int16)
    assert torch.equal(role(x), conv_k.conv2d(x, w))
    rm.flush()
    assert not role.resident and role.resident_bytes() == 0


def test_role_signature_is_checked_at_synthesis():
    impl = GLOBAL_REGISTRY.resolve("conv2d", "cuda", ("cuda",))
    role = Role(impl, (ArgSpec((1, 8, 8, 1), torch.int16),), device="cpu")
    with pytest.raises(TypeError, match="does not take"):
        role.synthesize()


def test_dispatch_trace_feeds_the_planner_the_ops_of_a_run():
    """``registry.define`` registers a role's implementation; a
    ``DispatchTrace`` records each resolved op, as the JAX package's does."""
    from repro_torch.core import dispatch
    from repro_torch.core.registry import KernelRegistry

    reg = KernelRegistry()

    @reg.define("fc", source="torch", device_kind="any")
    def fc(x, w):
        return x @ w

    reg.define("fc", source="cuda", specialization=FIXED_WEIGHT)(fc)
    trace = dispatch.DispatchTrace()
    x = torch.ones(2, 2)
    with dispatch.use(registry=reg, prefer=("torch",), trace=trace):
        for _ in range(3):
            dispatch.op("fc", x, x)
    assert trace.op_counts() == {"fc": 3}
    assert trace.events[0] == ("fc", "fc:torch:generic")
    assert reg.resolve("fc", "cuda", ("cuda",), specialization=FIXED_WEIGHT).name == \
        "fc:cuda:fixed_weight"


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

CONV_CASES = [
    # (B, H, W, Cin, kh, kw, F, dtype)
    (1, 64, 64, 1, 5, 5, 1, "int16"),        # paper role 3
    (1, 64, 64, 1, 3, 3, 2, "int16"),        # paper role 4
    (2, 20, 20, 1, 3, 3, 2, "int16"),        # B = 2
    (2, 20, 20, 4, 3, 3, 8, "float32"),      # Cin 4, F 8
    (1, 32, 32, 1, 5, 5, 1, "float32"),      # examples/multi_tenant.py's f32 roles
    (1, 32, 32, 1, 3, 3, 1, "float32"),
    (2, 17, 23, 3, 2, 4, 3, "int16"),        # a filter outside the unrolled sizes
    # the kernel's strip (4 pixels) and filter-chunk (1, 2, 4, 8) edges:
    # W - kw + 1 not a multiple of 4, F = 3 and 5
    (2, 13, 19, 1, 3, 3, 3, "int16"),
    (1, 21, 30, 1, 5, 5, 5, "float32"),
    (3, 9, 70, 2, 3, 3, 5, "int16"),
    (2, 18, 67, 1, 3, 3, 3, "float32"),
]


def _conv_inputs(B, H, W, Cin, kh, kw, F, dtype, seed=0, big=False):
    rng = np.random.default_rng(seed)
    if dtype == "int16":
        hi = 32767 if big else 100
        x = rng.integers(-hi, hi, (B, H, W, Cin)).astype(np.int16)
        w = rng.integers(-(hi if big else 8), hi if big else 8, (kh, kw, Cin, F)).astype(np.int16)
    else:
        x = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
        w = rng.normal(size=(kh, kw, Cin, F)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_conv2d_matches_jax(case):
    x, w = _conv_inputs(*case)
    want_ref = np.asarray(jref.conv2d(jnp.asarray(x), jnp.asarray(w)))
    want_pallas = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got_ref = ref.conv2d(_t(x), _t(w)).numpy()
    got_plain = conv_k.plain_conv2d(_t(x), _t(w)).numpy()
    got_wrapper = conv_k.conv2d(_t(x), _t(w)).numpy()
    for got in (got_ref, got_plain, got_wrapper):
        assert got.dtype == want_ref.dtype and got.shape == want_ref.shape
        if case[-1] == "int16":
            np.testing.assert_array_equal(got, want_ref)
            np.testing.assert_array_equal(got, want_pallas)
        else:
            np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


def test_conv2d_int32_sums_wrap_as_jax():
    """int16 extremes over 25 taps sum past 2^31: every version wraps as XLA."""
    x, w = _conv_inputs(1, 16, 16, 1, 5, 5, 2, "int16", big=True)
    exact = np.zeros((1, 12, 12, 2), np.int64)
    for di in range(5):
        for dj in range(5):
            exact += np.einsum("bhwc,cf->bhwf", x[:, di:di + 12, dj:dj + 12].astype(np.int64),
                               w[di, dj].astype(np.int64))
    assert np.abs(exact).max() > 2**31                       # the case overflows
    want = np.asarray(jref.conv2d(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(want, exact.astype(np.int32))   # JAX wraps mod 2^32
    np.testing.assert_array_equal(ref.conv2d(_t(x), _t(w)).numpy(), want)
    np.testing.assert_array_equal(conv_k.plain_conv2d(_t(x), _t(w)).numpy(), want)


@pytest.mark.parametrize("kh,f", [(5, 1), (3, 2)])
def test_conv2d_fixed_weight_equals_generic(kh, f):
    x, w = _conv_inputs(1, 64, 64, 1, kh, kh, f, "int16", seed=3)
    fixed = conv_k.conv2d_fixed_weight(_t(w))
    assert fixed.__name__ == jconv.conv2d_fixed_weight(jnp.asarray(w)).__name__
    assert torch.equal(fixed(_t(x)), conv_k.conv2d(_t(x), _t(w)))
    bound = fixed.bind("cpu")
    assert torch.equal(bound(_t(x)), fixed(_t(x)))


# ---------------------------------------------------------------------------
# f32 matmul and its fixed-weight role
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (64, 128, 32)])
def test_f32_matmul_matches_pallas(m, k, n, activation):
    rng = np.random.default_rng(m + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jmatmul.matmul(jnp.asarray(x), jnp.asarray(w), activation=activation,
                                     interpret=True))
    got = mm_k.matmul(_t(x), _t(w), activation=activation)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_matmul_fixed_weight_equals_matmul():
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(256, 256)).astype(np.float32))
    w = _t(rng.normal(size=(256, 256)).astype(np.float32))
    fixed = mm_k.matmul_fixed_weight(w)
    assert fixed.__name__ == jmatmul.matmul_fixed_weight(jnp.asarray(w.numpy())).__name__
    assert torch.equal(fixed(x), mm_k.matmul(x, w))
    silu = mm_k.matmul_fixed_weight(w, activation="silu")
    assert torch.equal(silu(x), mm_k.matmul(x, w, activation="silu"))


# ---------------------------------------------------------------------------
# the paper's four roles through the port's queue and executor
# ---------------------------------------------------------------------------


def _jax_paper_roles():
    spec = importlib.util.spec_from_file_location("_paper_common", ROOT / "benchmarks/common.py")
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)             # a fresh module: its RNG restarts at 0
    return common.make_paper_roles(jroles.RoleLibrary(ledger=jledger.OverheadLedger()))


def test_paper_roles_through_queue_match_jax():
    want = {name: np.asarray(role(*args)) for name, (role, args) in _jax_paper_roles().items()}
    ledger = tledger.OverheadLedger()
    sys_ = thsa.HsaSystem(num_regions=2, ledger=ledger, device="cpu")
    agent = sys_.default_agent
    roles = paper_roles.make_paper_roles(sys_.library, seed=0, device="cpu")
    sys_.library.synthesize_all()
    q, ex = sys_.queue_of(agent), sys_.executor_of(agent)
    got = {}
    for name in ("role1_fc", "role3_conv5x5", "role2_fc_barrier", "role4_conv3x3", "role1_fc"):
        role, args = roles[name]
        out = thsa.run_packet_sync(ex, q, q.dispatch(role.key, *args, producer="opencl"))
        if name in got:                       # a hit runs the same kernel: bitwise
            assert torch.equal(out, got[name])
        got[name] = out
    for name, value in got.items():
        if name.startswith("role1") or name.startswith("role2"):
            np.testing.assert_allclose(value.numpy(), want[name], rtol=2e-4, atol=2e-4)
        else:
            assert value.dtype == torch.int32
            np.testing.assert_array_equal(value.numpy(), want[name])
    rm = sys_.regions_of(agent)
    # four roles through two regions: reconfigurations equal the misses
    assert ledger.stat(tledger.RECONFIG).count == rm.stats.misses >= 4
    sys_.shutdown()
