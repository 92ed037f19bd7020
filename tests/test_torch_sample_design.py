"""The sampler kernel's design (``csrc/sample.cu``), held on the CPU through
its plain models in ``repro_torch/kernels/sample.py``.

- The pre-test: each bucket's bounds of the Gumbel term hold for every one
  of the 2^23 values the uniform takes, with room to spare against the
  exact (f64) term, far more than ``logf``'s last ulp; ``l * c_dn`` and
  ``l * c_up`` bracket ``l / T`` as f32 divides it (inf, NaN, -0, 1e30,
  subnormals); no element whose exact score beats or ties another's is
  ruled out by the other's lower bound (adversarial pairs); the row's draw
  survives on rows with NaN, +inf, all -inf, equal and huge logits; the
  planted fault (no margin) drops the winner of ``chip_smoke.py``'s
  pre-test row.
- The split rule fills the H100's 132 SMs at B = 1, 8 and 16 at every
  vocabulary the card's checks time.
- The split and merge: the splits partition a row at every alignment, the
  64-bit keys order as ``better()``, and the draw equals ``plain_sample``'s
  at every split count on rows with NaN, two +inf, all -inf and equal
  logits.
- The whole design (pre-test survivors, split, merge) against
  ``jax.random.categorical``.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import sample as sample_k
from repro_torch.serve import sampling

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

T = 0.7
H100_SMS = 132
VOCABS = sorted({V for _, V in sample_k.SHAPES})
#: the kernel's logf and PyTorch's each lie within an ulp or so of the true
#: log, so the computed Gumbel term within a few ulps of 16 (~2e-6) of the
#: exact one; the bounds must clear the f64 term by far more than that
ROOM = sample_k.MARGIN / 2


def _rows(kind: str, B: int = 4, V: int = 5003, seed: int = 0):
    """(logits, keys, counts) of ``B`` rows of a kind, from numpy."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    keys = rng.integers(-2**31, 2**31 - 1, (B, 2)).astype(np.int32)
    counts = rng.integers(0, 1000, B).astype(np.int32)
    j = np.sort(rng.choice(V, 2, replace=False))
    if kind == "nan":
        logits[:, j] = np.nan
    elif kind == "two_inf":
        logits[:, j] = np.inf
    elif kind == "all_neg_inf":
        logits[:] = -np.inf
    elif kind == "equal":
        logits[:] = 1.0
    elif kind == "huge":
        logits = (rng.standard_normal((B, V)) * 1e30).astype(np.float32)
        logits[:, j] = 3e30
    elif kind == "peaked":
        logits[:, j[0]] += 25.0
    elif kind == "inf_and_nan":
        logits[:, j[0]] = np.inf
        logits[:, j[1]] = np.nan
        logits[:, : j[0]] = -np.inf
    return torch.from_numpy(logits), torch.from_numpy(keys), torch.from_numpy(counts)


def _draw(logits, keys, counts) -> torch.Tensor:
    tok = torch.zeros(len(keys), dtype=torch.int32)
    sampling.plain_sample(logits, keys, counts, torch.ones(len(keys), dtype=torch.int32), tok, T)
    return tok.long()


def _bits(keys, counts, V):
    return sampling.random_bits_32(sampling.fold_in(keys, counts), V)


# ---------------------------------------------------------------------------
# the pre-test
# ---------------------------------------------------------------------------


def test_gumbel_bounds_hold_at_every_uniform_value():
    """Over all 2^23 values of the uniform's mantissa m: its bucket's bounds
    hold the f32 term (as the kernel computes it) and clear the exact f64
    term by ``ROOM``, while the f32 term strays from the f64 one by far
    less (so the kernel's logf, within an ulp of the true log too, stays
    inside); the buckets run from the largest term (bucket 0) down."""
    upper, lower = sample_k.gumbel_bounds()
    assert upper.shape == lower.shape == (sample_k.BUCKETS,)
    assert bool((upper >= lower).all())
    stray = 0.0
    last = None
    for lo in range(0, 2**23, 2**21):
        m = torch.arange(lo, lo + 2**21, dtype=torch.int64)
        k = sample_k.bucket_of(m << 9).long()
        assert int(k.min()) >= 0 and int(k.max()) < sample_k.BUCKETS
        assert bool((k[1:] <= k[:-1]).all()) and (last is None or int(k[0]) <= last)
        last = int(k[-1])
        f = m.double() * 2.0**-23
        g32 = sample_k._gumbel_f32(f.float()).double()
        g64 = -torch.log(-torch.log(torch.clamp_min(f + sampling.TINY, sampling.TINY)))
        up, dn = upper[k].double(), lower[k].double()
        assert bool((up >= g32).all()) and bool((dn <= g32).all())
        assert float((up - g64).min()) > ROOM and float((g64 - dn).min()) > ROOM
        stray = max(stray, float((g32 - g64).abs().max()))
    assert stray < ROOM / 8
    assert int(sample_k.bucket_of(torch.tensor([(2**23 - 1) << 9]))) == 0
    assert int(sample_k.bucket_of(torch.tensor([0]))) == sample_k.BUCKETS - 1


def test_model_constants_are_the_kernels():
    """The plain model's bucket layout, margin, block size and split cap are
    the ones ``csrc/sample.cu`` is compiled with (read from its source), so
    the proofs above hold for the kernel that ships; ``chip_smoke.py``'s tie
    tolerance is the sweep's."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "sample.cu").read_text()
    names = {"kThreads": "THREADS", "kMaxSplits": "MAX_SPLITS", "kBucketShift": "BUCKET_SHIFT",
             "kFirstBucket": "FIRST_BUCKET", "kBuckets": "BUCKETS", "kMargin": "MARGIN"}
    got: dict = {}
    for name in names:
        m = re.search(rf"constexpr (?:int|float) {name} = ([^;]+);", src)
        assert m is not None, name
        expr = re.sub(r"(\d+\.\d*)f\b", r"\1", m.group(1))
        assert re.fullmatch(r"[\w\s.()+\-*/<>]+", expr), expr
        got[name] = eval(expr, {"__builtins__": {}}, dict(got))
    assert {names[n]: v for n, v in got.items()} == {v: getattr(sample_k, v)
                                                      for v in names.values()}
    assert sample_k.TIE_ULPS == cs.SAMPLE_TIE_ULPS


@pytest.mark.parametrize("name", ["no_pretest", "no_merge", "no_hash"])
def test_sweep_ablation_edits_the_kernel_source_once(name):
    """Each part ``sample_sweep.py --ablate`` takes out is one edit that
    applies at exactly one place of ``csrc/sample.cu`` as it ships."""
    from repro_torch.kernels import sample_sweep

    old, new = sample_sweep.ABLATIONS[name]
    src = (ROOT / "src" / "repro_torch" / "csrc" / "sample.cu").read_text()
    assert src.count(old) == 1 and old != new


@pytest.mark.parametrize("temperature", [0.7, 1.0, 0.3, 2.5, 1e-3, 1e-30, 3e38])
def test_logit_bounds_bracket_the_division(temperature):
    """l * c_dn and l * c_up, each rounded once in f32, bracket l / T as f32
    divides it, at every magnitude, both zeros, both infinities and NaN."""
    c_up, c_dn = sample_k.scale_bounds(temperature)
    assert c_dn < c_up
    rng = np.random.default_rng(1)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1e30, 3.4e38, -3.4e38,
                        1e-45, -1e-45, 1e-40, 1.17549435e-38, 1.0, -1.0, 0.7, 15.0],
                       dtype=np.float32)
    l = np.concatenate([special, (rng.standard_normal(20000) * 10.0 ** rng.integers(-40, 38, 20000))
                        .astype(np.float32)])
    with np.errstate(all="ignore"):
        q = l / np.float32(temperature)
        a, c = l * c_up, l * c_dn
    lo, hi = np.minimum(a, c), np.maximum(a, c)
    nan = np.isnan(l)
    assert np.isnan(q[nan]).all() and np.isnan(lo[nan]).all() and np.isnan(hi[nan]).all()
    assert (lo[~nan] <= q[~nan]).all() and (q[~nan] <= hi[~nan]).all()
    # the torch model gives the same bounds
    got_lo, got_hi = sample_k.score_bounds(torch.from_numpy(l), torch.zeros(len(l)), temperature)
    bnd = sample_k.gumbel_bounds()
    k = int(sample_k.bucket_of(torch.zeros(1)))
    with np.errstate(all="ignore"):
        assert np.array_equal((lo + bnd[1][k].numpy()), got_lo.numpy(), equal_nan=True)
        assert np.array_equal((hi + bnd[0][k].numpy()), got_hi.numpy(), equal_nan=True)


def _adversarial_elements():
    """Elements (l, bits) over every bucket (its first and last mantissa and
    one between) and logits: +-inf, NaN, 0, ties, |l/T| up to 1e30."""
    m = []
    for k in range(sample_k.BUCKETS):
        inside = torch.arange(2**23, dtype=torch.int64)[::997]
        inside = inside[sample_k.bucket_of(inside << 9) == k]
        if len(inside):
            m += [int(inside[0]), int(inside[-1]), int(inside[len(inside) // 2])]
    m += [0, 1, 2**23 - 1, 2**23 - 2, 2**22]
    ls = [0.0, -0.0, 1.0, -1.0, 10.0, 10.0, 1e30, -1e30, 2e30, np.inf, -np.inf, np.nan, 3.3,
          1e-38, 5.5]
    grid_m = torch.tensor(m, dtype=torch.int64).repeat(len(ls))
    grid_l = torch.tensor(ls, dtype=torch.float32).repeat_interleave(len(m))
    return grid_l, grid_m << 9


def test_pretest_never_rejects_an_element_that_beats_or_ties_another():
    """For every pair (e, o) of adversarial elements: where e's exact score
    beats or ties o's, or is NaN, e's upper bound does not lie below o's
    lower bound (the kernel's threshold is some element's lower bound, so
    the draw is never ruled out)."""
    l, bits = _adversarial_elements()
    lb, ub = sample_k.score_bounds(l, bits, T)
    score = -torch.log(-torch.log(sampling.uniform(bits))) + l / torch.tensor(T)
    lb = torch.where(lb.isnan(), -float("inf"), lb)   # fmaxf passes NaN bounds by
    # the largest lower bound among the elements e beats or ties: sorted by score
    num = ~score.isnan()
    s, order = score[num].sort()
    below = lb[num][order].cummax(0).values
    at = torch.searchsorted(s, score[num], right=True) - 1
    assert not bool((ub[num] < below[at]).any())
    assert not bool((ub[~num] < lb.max()).any())
    assert bool((lb <= score).logical_or(score.isnan()).all())
    assert bool((score <= ub).logical_or(score.isnan()).all())


@pytest.mark.parametrize("kind", ["random", "nan", "two_inf", "all_neg_inf", "equal", "huge",
                                  "peaked", "inf_and_nan"])
@pytest.mark.parametrize("V", [5003, 32001])
def test_pretest_keeps_the_draw(kind, V):
    """The row's draw survives the pre-test (against the row's largest lower
    bound, the strongest threshold the kernel reaches), and the survivors'
    draw is the plain version's; few elements survive a row of N(0, 4)."""
    logits, keys, counts = _rows(kind, V=V)
    want = _draw(logits, keys, counts)
    keep = sample_k.pretest(logits, _bits(keys, counts, V), T)
    assert bool(keep[torch.arange(len(want)), want].all())
    scores = sampling.scores(keys, counts, logits, T)
    assert torch.equal(sample_k.plain_split_merge(scores, 1, keep=keep), want)
    if kind == "random":
        assert int(keep.sum()) <= 4 * len(want)


def test_no_margin_fault_drops_the_winner_of_the_pretest_row():
    """``chip_smoke.py``'s pre-test row: the winner is the element with the
    largest Gumbel draw, its l/T 15 below the row's maximum; the pre-test
    keeps it, and without its margin drops it for a runner-up in its own
    16 bytes (so the kernel's threshold holds that runner-up's bound when
    it tests the winner)."""
    for V in (128256, 32001):
        key = torch.tensor([12345, -678], dtype=torch.int32)
        logits, count, w = cs.sample_winner_row(torch, sampling, sample_k, V, T, key, 0)
        keys, counts = key[None], torch.tensor([count], dtype=torch.int32)
        assert int(_draw(logits[None], keys, counts)[0]) == w
        g = -torch.log(-torch.log(sampling.uniform(_bits(keys, counts, V)[0])))
        assert int(g.argmax()) == w
        lt = logits / torch.tensor(T)
        assert float(lt.max() - lt[w]) == pytest.approx(15.0, abs=1e-4)
        bits = _bits(keys, counts, V)
        assert bool(sample_k.pretest(logits[None], bits, T)[0, w])
        dropped = ~sample_k.pretest(logits[None], bits, T, margin=False)[0]
        assert bool(dropped[w])
        scores = sampling.scores(keys, counts, logits[None], T)
        fault = sample_k.plain_split_merge(scores, 1, keep=~dropped[None])
        assert int(fault[0]) != w and w // 4 == int(fault[0]) // 4


# ---------------------------------------------------------------------------
# the split rule, the split and the merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("V", VOCABS)
def test_split_rule_covers_the_card(B, V):
    """B x splits blocks cover the H100's SMs at every served batch and
    vocabulary, within the kernel's cap, each split at least MIN_SPLIT
    logits."""
    splits = sample_k.splits_for(B, V)
    assert B * splits >= H100_SMS
    assert 1 <= splits <= sample_k.MAX_SPLITS
    assert V // splits >= sample_k.MIN_SPLIT - 4


@pytest.mark.parametrize("V", [1, 3, 4, 5, 7, 1000, 32001, 49155, 128256])
def test_split_ranges_partition_every_row(V):
    """At every alignment and split count the splits cover the row in order,
    each logit once."""
    for phase in range(4):
        for splits in (1, 2, 3, 7, 33, 264, 1024):
            ranges = sample_k.split_ranges(V, splits, phase)
            assert len(ranges) == splits
            pos = 0
            for lo, hi in ranges:
                if hi > lo:
                    assert lo == pos
                    pos = hi
            assert pos == V


def test_merge_keys_order_as_better():
    """The 64-bit key's order is ``better()``'s: the larger score, NaN above
    all, the smaller index on ties, -0 equal to +0."""
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 1.0, -2.5, 1e30, np.nan],
                    dtype=np.float32)
    keys = sample_k.merge_keys(torch.from_numpy(vals)[None])[0]

    def better(a, ia, b, ib):
        na, nb = np.isnan(a), np.isnan(b)
        if na or nb:
            return na and (not nb or ia < ib)
        return a > b or (a == b and ia < ib)

    for i in range(len(vals)):
        for j in range(len(vals)):
            if i != j:
                assert (keys[i] > keys[j]) == better(vals[i], i, vals[j], j)


@pytest.mark.parametrize("kind", ["random", "nan", "two_inf", "all_neg_inf", "equal",
                                  "inf_and_nan"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 33, 264, 1024])
def test_split_merge_gives_plain_sample(kind, splits):
    """Each split's best key, merged by the largest, is plain_sample's draw,
    at every alignment of the rows (V odd: rows start at every phase)."""
    logits, keys, counts = _rows(kind, B=4, V=5003)
    want = _draw(logits, keys, counts)
    scores = sampling.scores(keys, counts, logits, T)
    keep = sample_k.pretest(logits, _bits(keys, counts, 5003), T)
    for phase in range(4):
        assert torch.equal(sample_k.plain_split_merge(scores, splits, phase), want)
        assert torch.equal(sample_k.plain_split_merge(scores, splits, phase, keep), want)


# ---------------------------------------------------------------------------
# the whole design against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("V", [1001, 5003, 49155])
def test_design_draw_equals_jax_categorical(V):
    """The pre-test's survivors, split 33 ways and merged, draw
    ``jax.random.categorical(fold_in(key, t), logits / T)``'s token wherever
    the two best scores lie apart (XLA's log and PyTorch's may part by an
    ulp)."""
    logits, keys, counts = _rows("random", B=8, V=V, seed=3)
    scores = sampling.scores(keys, counts, logits, T)
    got = sample_k.plain_split_merge(
        scores, 33, 0, sample_k.pretest(logits, _bits(keys, counts, V), T))
    clear = sample_k.scores_apart(scores)
    assert bool(clear.any())
    for b in range(8):
        key = jnp.asarray(keys[b].numpy().view(np.uint32))
        sub = jax.random.fold_in(key, int(counts[b]))
        want = int(jax.random.categorical(sub, jnp.asarray(logits[b].numpy()) / jnp.float32(T)))
        if bool(clear[b]):
            assert int(got[b]) == want
