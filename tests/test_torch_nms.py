"""Greedy-NMS suppression of the PyTorch port against the JAX package.

The plain version (`greedy_nms_mask`, and `greedy_nms_keep` on CPU tensors)
must give a keep mask EQUAL to JAX `greedy_nms_mask(pairwise_iou(...))`:
no tolerance.  The CUDA kernel is held to the same plain version on the
card by `chip_smoke.py`.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from objectdetection_ssd_tpu.infer import postprocess as jpost
from objectdetection_ssd_tpu.ops import boxes as jboxes
from objectdetection_ssd_torch.infer import nms_cuda
from objectdetection_ssd_torch.infer.postprocess import greedy_nms_mask
from objectdetection_ssd_torch.ops.boxes import pairwise_iou

torch.set_num_threads(2)

THR = 0.45


def _jax_keep(boxes, valid, thr=THR):
    iou = jboxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes))
    return np.asarray(jpost.greedy_nms_mask(iou, jnp.asarray(valid), thr,
                                            unrolled=False))


def _port_keep(boxes, valid, thr=THR):
    keep = nms_cuda.greedy_nms_keep(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), thr)
    return keep.numpy()


def _random_sets(seed, b, k, invalid_share=0.2):
    """Clustered boxes (so many pairs overlap), sorted-score order implied
    by position, with a share of invalid slots."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (b, 20, 4, 2))
    pick = rng.integers(0, 4, (b, 20, k))
    cxy = np.take_along_axis(centers, pick[..., None], axis=2)
    cxy = cxy + rng.normal(0, 0.04, (b, 20, k, 2))
    wh = rng.uniform(0.1, 0.3, (b, 20, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    valid = rng.uniform(size=(b, 20, k)) >= invalid_share
    return boxes.astype(np.float32), valid


def crafted_sets():
    """(name, boxes (n, K, 4), valid (n, K)) edge cases."""
    f32 = np.float32
    cases = []
    # IoU exactly 0.45 in f32: [0,0,1,1] vs [0,0,0.45,1] -> inter 0.45,
    # union 1.45 - 0.45 -> 0.45f; `>=` must suppress.
    cases.append(("iou_exactly_thr",
                  np.array([[[0, 0, 1, 1], [0, 0, 0.45, 1]]], f32),
                  np.array([[True, True]])))
    # Chain: A suppresses B, B (suppressed) must not suppress C.
    cases.append(("chain",
                  np.array([[[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0],
                             [0.5, 0.0, 1.5, 1.0]]], f32),
                  np.array([[True, True, True]])))
    cases.append(("all_invalid",
                  np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], f32), (1, 8, 1)),
                  np.zeros((1, 8), bool)))
    # Duplicates: the first valid copy survives, every later copy goes.
    cases.append(("duplicates",
                  np.tile(np.array([[0.2, 0.2, 0.6, 0.7]], f32), (1, 6, 1)),
                  np.array([[False, True, True, False, True, True]])))
    # An invalid top box never acts.
    cases.append(("invalid_never_acts",
                  np.array([[[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0]]],
                           f32),
                  np.array([[False, True]])))
    # Zero-area boxes: two equal ones give union 0 and IoU 0/0 = NaN, which
    # suppresses nothing; the last box repeats the third.
    cases.append(("zero_area",
                  np.array([[[0.2, 0.2, 0.2, 0.5], [0.2, 0.2, 0.2, 0.5],
                             [0.1, 0.1, 0.4, 0.4], [0.3, 0.3, 0.3, 0.3],
                             [0.1, 0.1, 0.4, 0.4]]], f32),
                  np.ones((1, 5), bool)))
    return cases


@pytest.mark.parametrize("k", [8, 64, 200])
def test_plain_matches_jax_random(k):
    boxes, valid = _random_sets(seed=k, b=2, k=k)
    got = _port_keep(boxes, valid)
    want = _jax_keep(boxes, valid)
    np.testing.assert_array_equal(got, want)
    assert (valid & ~got).any()          # something was suppressed


@pytest.mark.parametrize("case", crafted_sets(), ids=lambda c: c[0])
def test_plain_matches_jax_crafted(case):
    _, boxes, valid = case
    np.testing.assert_array_equal(_port_keep(boxes, valid),
                                  _jax_keep(boxes, valid))


def test_crafted_expected_masks():
    got = {name: _port_keep(b, v)[0].tolist()
           for name, b, v in crafted_sets()}
    assert got["iou_exactly_thr"] == [True, False]
    assert got["chain"] == [True, False, True]
    assert got["all_invalid"] == [False] * 8
    assert got["duplicates"] == [False, True, False, False, False, False]
    assert got["invalid_never_acts"] == [False, True]
    assert got["zero_area"] == [True, True, True, True, False]


def _np_iou(a, b):
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (aa[:, None] + ab[None, :] - inter)


@pytest.mark.parametrize("boxes,valid,thr,want", [
    # tests/test_postprocess.py: golden chain at 0.45.
    ([[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0], [1.0, 0.0, 2.0, 1.0]],
     [True, True, True], 0.45, [True, False, True]),
    # suppressed box does not suppress, at 0.3.
    ([[0.0, 0.0, 1.0, 1.0], [0.4, 0.0, 1.4, 1.0], [0.9, 0.0, 1.9, 1.0]],
     [True, True, True], 0.3, [True, False, True]),
    # invalid top box never acts or survives.
    ([[0.0, 0.0, 1.0, 1.0], [0.05, 0.0, 1.05, 1.0]],
     [False, True], 0.45, [False, True]),
])
def test_reference_cases_on_given_iou(boxes, valid, thr, want):
    """The recurrence alone, on one numpy IoU matrix fed to both."""
    iou = _np_iou(np.asarray(boxes, np.float32), np.asarray(boxes, np.float32))
    got = greedy_nms_mask(torch.from_numpy(iou), torch.tensor(valid), thr)
    jgot = jpost.greedy_nms_mask(jnp.asarray(iou), jnp.asarray(valid), thr)
    assert got.tolist() == want == np.asarray(jgot).tolist()


def test_reference_random_oracle_case():
    """tests/test_postprocess.py:test_greedy_nms_random_matches_oracle's
    input, on both packages."""
    rng = np.random.default_rng(0)
    n = 64
    lo = rng.uniform(0, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    boxes = np.concatenate([lo, lo + wh], 1).astype(np.float32)
    iou = _np_iou(boxes, boxes)
    got = greedy_nms_mask(torch.from_numpy(iou), torch.ones(n, dtype=bool),
                          0.45)
    want = jpost.greedy_nms_mask(jnp.asarray(iou), jnp.ones(n, bool), 0.45)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        _port_keep(boxes, np.ones(n, bool)), _jax_keep(boxes, np.ones(n, bool)))


def test_plain_path_does_not_count_launches():
    boxes, valid = _random_sets(seed=5, b=1, k=16)
    before = nms_cuda.launches
    _port_keep(boxes, valid)
    assert nms_cuda.launches == before


def test_greedy_nms_keep_matches_plain_on_iou():
    boxes, valid = _random_sets(seed=9, b=3, k=32)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    np.testing.assert_array_equal(
        nms_cuda.greedy_nms_keep(b, v, THR).numpy(),
        greedy_nms_mask(pairwise_iou(b, b), v, THR).numpy())


@pytest.mark.parametrize("boxes,valid,err", [
    (torch.zeros(2, 8, 3), torch.ones(2, 8, dtype=bool), ValueError),
    (torch.zeros(2, 8, 4), torch.ones(2, 7, dtype=bool), ValueError),
    (torch.zeros(2, 8, 4, dtype=torch.float64), torch.ones(2, 8, dtype=bool),
     TypeError),
    (torch.zeros(2, 8, 4, dtype=torch.bfloat16), torch.ones(2, 8, dtype=bool),
     TypeError),
    (torch.zeros(2, 8, 4), torch.ones(2, 8, dtype=torch.uint8), TypeError),
    (torch.zeros(1, 257, 4), torch.ones(1, 257, dtype=bool), ValueError),
    (torch.zeros(1, 0, 4), torch.ones(1, 0, dtype=bool), ValueError),
    (torch.zeros(2, 4, 8).transpose(1, 2), torch.ones(2, 8, dtype=bool),
     ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(boxes, valid, err):
    with pytest.raises(err):
        nms_cuda.greedy_nms_keep(boxes, valid, THR)


MASK64 = (1 << 64) - 1
K_ROWS = 4                # csrc/nms.cu kRows


def _popc(x):
    return bin(x).count("1")


def _kernel_schedule(over, valid):
    """A transcription of `csrc/nms.cu`'s index arithmetic for one set, on
    Python ints: the valid compaction (ballots and prefix counts), the
    triangle by blocks of 32 columns and K_ROWS rows per step (each row's
    ballot stored once as its 32-bit word), the scan over kept boxes and
    the mapping back.  ``over`` (K, K) bool
    is the relation IoU >= thr, ``valid`` (K,) bool.  Returns the keep
    mask, the (row, column) pairs each lane was given, in compacted
    positions, and the row words."""
    k = len(valid)
    words = (k + 63) // 64
    # 1. Compaction.
    orig, ballots = [], []
    for c0 in range(0, k, 32):
        m = sum(1 << lane for lane in range(32)
                if c0 + lane < k and valid[c0 + lane])
        orig += [c0 + lane for lane in range(32) if (m >> lane) & 1]
        ballots.append(m)
    n_v = len(orig)
    # 2. The triangle, one block of 32 columns at a time: lane t holds
    # column 32 cb + t, the warp walks the rows with a column above them in
    # the block, K_ROWS per step, and each row's ballot is its 32-bit word
    # cb, stored once.
    words32 = [[0] * (2 * words) for _ in range(n_v)]
    given = [[] for _ in range(32)]
    stored = set()
    for cb in range((n_v + 31) // 32):
        rows_cb = min(n_v - 1, 32 * cb + 31)
        for i0 in range(0, rows_cb, K_ROWS):
            for i in range(i0, min(i0 + K_ROWS, rows_cb)):
                hits = 0
                for lane in range(32):
                    col = 32 * cb + lane
                    if i < col < n_v:
                        given[lane].append((i, col))
                        if over[orig[i], orig[col]]:
                            hits |= 1 << lane
                assert (i, cb) not in stored          # one store per word
                stored.add((i, cb))
                words32[i][cb] = hits
    rows = [[w32[2 * w] | w32[2 * w + 1] << 32 for w in range(words)]
            for w32 in words32]
    # 3. The scan over kept boxes: avail holds the valid candidates not
    # removed and above the last kept one.
    avail = [MASK64 if n_v - 64 * w >= 64 else
             (1 << max(n_v - 64 * w, 0)) - 1 for w in range(words)]
    kept = [0] * max(n_v, 1)
    while any(avail):
        w = next(w for w in range(words) if avail[w])
        i = 64 * w + (avail[w] & -avail[w]).bit_length() - 1
        kept[i] = 1
        for v in range(words):
            below = i + 1 - 64 * v
            above = MASK64 if below <= 0 else 0 if below >= 64 else \
                (MASK64 << below) & MASK64
            avail[v] &= ~rows[i][v] & above
    # 4. Back to the original positions.
    keep, before = [False] * k, 0
    for q, m in enumerate(ballots):
        for lane in range(32):
            i = 32 * q + lane
            if i < k and (m >> lane) & 1:
                keep[i] = bool(kept[before + _popc(m & ((1 << lane) - 1))])
        before += _popc(m)
    return np.array(keep), given, rows, orig


def _schedule_case(k, mask, seed):
    boxes, valid = _random_sets(seed=seed, b=1, k=k, invalid_share=0.4)
    boxes, valid = boxes[0, :2], valid[0, :2]
    if mask == "all_invalid":
        valid[:] = False
    elif mask == "all_valid":
        valid[:] = True
    elif mask == "duplicates":
        boxes[:] = boxes[:, :1]
    return boxes, valid


@pytest.mark.parametrize("mask", ["random", "all_invalid", "all_valid",
                                  "duplicates"])
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 63, 64, 65, 200, 256])
def test_kernel_schedule_matches_plain(k, mask):
    """`csrc/nms.cu`'s schedule: every pair i < j of valid candidates goes
    to exactly one lane and each row word is stored once, the row words hold exactly the relation among valid candidates above the
    diagonal, and the keep mask equals the plain version's, on random
    (non-prefix) masks, all-invalid, all-valid and duplicate boxes."""
    boxes, valid = _schedule_case(k, mask, seed=100 + k)
    for b, v in zip(boxes, valid):
        over = (pairwise_iou(torch.from_numpy(b), torch.from_numpy(b))
                >= THR).numpy()
        keep, given, rows, orig = _kernel_schedule(over, v)
        n_v = len(orig)
        assert orig == list(np.flatnonzero(v))
        flat = sorted(pair for lane in given for pair in lane)
        assert flat == [(i, j) for i in range(n_v) for j in range(i + 1, n_v)]
        for i in range(n_v):
            want = sum(1 << j for j in range(i + 1, n_v)
                       if over[orig[i], orig[j]])
            assert sum(w << (64 * q) for q, w in enumerate(rows[i])) == want
        plain = nms_cuda.greedy_nms_keep(torch.from_numpy(b[None]),
                                         torch.from_numpy(v[None]), THR)
        np.testing.assert_array_equal(keep, plain[0].numpy())
        if mask == "duplicates" and v.any():
            assert keep.sum() == 1


def _rounded_sign(x):
    """The sign of ``x`` (an exact Fraction) after one rounding to f32:
    0 below half the smallest subnormal, 2**-150 (a tie goes to even, 0)."""
    return 0 if abs(x) <= Fraction(1, 2 ** 150) else (1 if x > 0 else -1)


def _screen(inter, uni, thr):
    """`csrc/nms.cu` `overlaps`'s decision without the division: True,
    False, or None where it takes the division.  Each fused multiply-add
    is its exact value rounded once."""
    if not (uni > 0 and np.isfinite(uni)):
        return None
    inter, uni = Fraction(float(inter)), Fraction(float(uni))
    thr_below = Fraction(float(np.nextafter(thr, np.float32(-np.inf))))
    if _rounded_sign(inter - Fraction(float(thr)) * uni) > 0:
        return True
    if _rounded_sign(inter - thr_below * uni) < 0:
        return False
    return None


@pytest.mark.parametrize("thr", [0.45, 0.5, 0.3, 0.7, 1e-30])
def test_division_screen_is_exact(thr):
    """Wherever the screen decides, it decides as fl(inter / uni) >= thr
    (IEEE f32 division), on unions across many octaves and intersections
    within a few ulps of thr * uni and of thr_below * uni, where the
    division is closest to thr."""
    thr = np.float32(thr)
    rng = np.random.default_rng(int(thr * 1e6) + 1)
    uni = (rng.uniform(1, 2, 400) * 2.0 ** rng.integers(-60, 60, 400)
           ).astype(np.float32)
    decided = {True: 0, False: 0, None: 0}
    for u in uni:
        for t in (thr, np.nextafter(thr, np.float32(-np.inf))):
            centre = np.float32(t * u)
            for step in range(-3, 4):
                inter = centre
                for _ in range(abs(step)):
                    inter = np.nextafter(inter, np.float32(np.sign(step)
                                                           * np.inf))
                got = _screen(inter, u, thr)
                decided[got] += 1
                if got is not None:
                    assert got == bool(np.float32(inter / u) >= thr), (
                        inter, u, thr)
    assert decided[True] and decided[False]
    assert decided[None] < decided[True] + decided[False]


def test_wrapper_takes_k_256():
    boxes, valid = _random_sets(seed=1, b=1, k=256)
    keep = nms_cuda.greedy_nms_keep(torch.from_numpy(boxes[:, :1]),
                                    torch.from_numpy(valid[:, :1]), THR)
    assert keep.shape == (1, 1, 256)
