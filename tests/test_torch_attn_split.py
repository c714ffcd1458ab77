"""The split plan of the decode attention kernels (ops/decode_stack.py
attn_split_plan), across the ring geometries of the three priors the
cascades sample: the 1b_lyrics top (order 12: f0 up to n_ctx 6528 rows,
f1 / f2 / f3 of block 102, f7 of 448 prime rows; 2 heads of 256), the
upsamplers (order 2, block 64, 128 blocks; one head of 480) and the
5b_lyrics top (order 10, block 128, 64 blocks, f6 over 512 encoder rows;
8 heads of 150). For every pattern and position: the splits cover the live
rows exactly (the last one ragged), each split holds SPLIT_MIN_ROWS..
SPLIT_MAX_ROWS rows (a multiple of the block's 8 warps) unless one split
takes them all, up to ONE_SPLIT_ROWS rows run in one split, there are no more than SPLIT_WAVES blocks per
SM unless a chunk bound forces more, the slot row falls in exactly one
split, and the workspace holds every split's (max, sum, partial output)
row. Pure arithmetic: runs anywhere."""

import numpy as np
import pytest

from jukebox_tpu_torch.hparams import setup_hparams
from jukebox_tpu_torch.models.transformer import ATTN_ORDERS
from jukebox_tpu_torch.ops import decode_stack as ds

SMS = ds.H100_SMS
PRIORS = {
    "1b_lyrics top": ("prior_1b_lyrics", 448, None),
    "upsampler": ("upsampler_level_0", None, None),
    "5b_lyrics top": ("prior_5b_lyrics", None, 512),
}


def ring_cases(name):
    """(attn_func, cache shape of one batch row, t) for every pattern of the
    prior and positions crossing block, prime and split boundaries."""
    preset, prime, enc = PRIORS[name]
    h = setup_hparams(preset, {})
    A = int(h.m_attn * h.prior_width)
    bc = h.n_ctx // h.blocks
    funcs = sorted({ATTN_ORDERS[h.attn_order](d)
                    for d in range(h.prior_depth)})
    shapes = {0: (1, h.n_ctx, A), 1: (1, bc, A), 2: (1, bc, h.blocks, A),
              3: (1, 2 * bc, A), 7: (1, prime or 1, A), 6: (1, enc or 1, A)}
    ts = sorted({0, 1, bc - 1, bc, 2 * bc + 1, 127, 128, 129, 700, 2431,
                 h.n_ctx - 1} | ({prime - 1, prime} if prime else set()))
    for f in funcs:
        for t in ts:
            if t < h.n_ctx:
                yield f, shapes[f], t, A, h.heads, bc, prime


@pytest.mark.parametrize("name", list(PRIORS))
@pytest.mark.parametrize("B", [1, 4, 16])
def test_split_plan_covers_every_geometry(name, B):
    seen = set()
    for f, shape, t, A, H, bc, prime in ring_cases(name):
        hd = A // H
        rows, w, r0, n = ds.ring_geometry(f, t, (B,) + shape[1:], bc, prime)
        splits, chunk, floats = ds.attn_split_plan(n, B, H, hd, SMS)
        assert (splits - 1) * chunk < n <= splits * chunk, (f, t)
        if n <= ds.ONE_SPLIT_ROWS:
            assert (splits, chunk, floats) == (1, n, 0), (f, t)
            continue
        seen.add(f)
        if splits == 1:
            assert chunk == n and floats == 0
            continue
        assert chunk % 8 == 0
        assert ds.SPLIT_MIN_ROWS <= chunk <= ds.SPLIT_MAX_ROWS, (f, t)
        # about SPLIT_WAVES blocks per SM: no more, unless a chunk bound
        # forces more (the floor for short rows, the ceiling for long)
        want = -(-ds.SPLIT_WAVES * SMS // (B * H))
        if ds.SPLIT_MIN_ROWS < chunk < ds.SPLIT_MAX_ROWS:
            assert splits <= want, (f, t)
        assert floats == B * H * splits * (2 + hd)
        if r0 <= w < r0 + n:  # the slot row: in exactly one split
            owner = (w - r0) // chunk
            assert 0 <= owner < splits
            assert owner * chunk <= w - r0 < min((owner + 1) * chunk, n)
            if f == 0:  # t is the last live row: the ragged last split
                assert owner == splits - 1
    # the long patterns do split: f0 everywhere it exists, f6 and f7, and
    # the short rings past ONE_SPLIT_ROWS
    if name == "1b_lyrics top":
        assert {0, 1, 3, 7} <= seen
    if name == "5b_lyrics top":
        assert {2, 6} <= seen


def test_split_plan_at_the_representative_shapes():
    """The shapes the smoke times: the 1b top's f0 layer at its last
    position of the cascade window (2432 rows) and at n_ctx, with 4
    samples; the 5b_lyrics top's f6 layer over its 512 encoder rows; its
    short rings of 64 and 128 rows; a ring that fits one split."""
    # 1b top f0, B 4, 2 heads of 256: 31 splits of 80 rows (the last 32)
    assert ds.attn_split_plan(2432, 4, 2, 256, SMS) == (
        31, 80, 4 * 2 * 31 * 258)
    assert ds.attn_split_plan(6528, 4, 2, 256, SMS) == (
        33, 200, 4 * 2 * 33 * 258)
    # 5b top f6, B 4, 8 heads of 150: 8 splits of 64 rows
    assert ds.attn_split_plan(512, 4, 8, 150, SMS) == (8, 64, 4 * 8 * 8 * 152)
    # the short rings: chunks of SPLIT_MIN_ROWS
    assert ds.attn_split_plan(64, 4, 8, 150, SMS) == (4, 16, 4 * 8 * 4 * 152)
    assert ds.attn_split_plan(128, 4, 8, 150, SMS) == (8, 16,
                                                      4 * 8 * 8 * 152)
    assert ds.attn_split_plan(ds.ONE_SPLIT_ROWS, 4, 2, 256, SMS) == (
        1, ds.ONE_SPLIT_ROWS, 0)
    # the chunk never falls below SPLIT_MIN_ROWS nor exceeds SPLIT_MAX_ROWS
    assert ds.attn_split_plan(8192, 1, 1, 480, SMS) == (256, 32, 256 * 482)
    assert ds.attn_split_plan(8192, 16, 8, 150, SMS) == (
        32, 256, 16 * 8 * 32 * 152)
    assert ds.attn_split_plan(129, 16, 8, 150, SMS) == (3, 48,
                                                        16 * 8 * 3 * 152)


@pytest.mark.parametrize("BH,L", [(2, 6528), (1, 6528), (1, 64), (1, 129),
                                  (3, 1000), (2, 517), (8, 8192)])
def test_flash_forward_schedule(BH, L):
    """The flash forward's work items (ops/flash_attention.py
    fwd_schedule): every (head row, q tile) reads its causal K/V tiles
    exactly once, split in two halves of one pair only when it is longer
    than the cut (half the longest tile, or the average work per SM when
    that is larger), no item longer than the cut, and the items run
    longest first."""
    from jukebox_tpu_torch.ops import flash_attention as fa
    items, pairs = fa.fwd_schedule(BH, L)
    nq = -(-L // fa.FWD_Q)
    counts = [min(t * fa.FWD_Q + fa.FWD_Q - 1, L - 1) // fa.FWD_KV + 1
              for t in range(nq)]
    cut = max(-(-counts[-1] // 2), -(-BH * sum(counts) // 132))
    seen = {}
    for bh, t, lo, hi, pair in items:
        seen.setdefault((bh, t), []).append((lo, hi, pair))
    assert set(seen) == {(bh, t) for bh in range(BH) for t in range(nq)}
    for (bh, t), parts in seen.items():
        parts.sort()
        assert parts[0][0] == 0 and parts[-1][1] == counts[t]
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        if counts[t] > cut:
            assert len(parts) == 2 and parts[0][2] == parts[1][2] >= 0
        else:
            assert parts == [(0, counts[t], -1)]
    lengths = [hi - lo for _, _, lo, hi, _ in items]
    assert lengths == sorted(lengths, reverse=True)
    assert max(lengths) <= cut
    assert pairs == len({p for *_, p in items if p >= 0})
    if (BH, L) == (2, 6528):  # the 1b top's f0 layer: 154 items of <= 51
        assert len(items) == 154 and pairs == 52 and max(lengths) == 51
    if (BH, L) == (8, 8192):  # work enough for every SM: no split
        assert pairs == 0


def causal_tiles(kind, L):
    """The tiles each tile of a flash kernel must read, from the causal
    mask itself: for each tile of the kernel's own side, the set of tiles
    of the other side that hold at least one (q_pos, kv_pos) pair with
    kv_pos <= q_pos, both < L."""
    from jukebox_tpu_torch.ops import flash_attention as fa
    own, other = ((fa.DKV_KV, fa.DKV_Q) if kind == "flash_dkv"
                  else (fa.DQ_Q, fa.DQ_KV))
    n_own, n_other = -(-L // own), -(-L // other)
    pos = np.arange(L)
    qp, kp = (pos[:, None], pos[None, :]) if kind == "flash_dq" else \
        (pos[None, :], pos[:, None])
    live = np.zeros((n_own * own, n_other * other), dtype=bool)
    live[:L, :L] = kp <= qp  # rows: the kernel's own side
    live = live.reshape(n_own, own, n_other, other).any(axis=(1, 3))
    return [set(np.flatnonzero(row).tolist()) for row in live]


@pytest.mark.parametrize("kind", ["flash_dq", "flash_dkv"])
@pytest.mark.parametrize("BH,L", [(2, 6528), (1, 6528), (2, 2500), (3, 517),
                                  (1, 64), (1, 129), (3, 1000), (8, 8192)])
def test_flash_backward_schedules(kind, BH, L):
    """The work items of flash_dq (q tiles of 64 rows, K/V tiles of 64)
    and flash_dkv (K/V tiles of 64 rows, q tiles of 64 on and below the
    diagonal): every (head row, tile) covers exactly its causal range,
    once; a split tile is two halves of one pair, each pair merged once
    (two items, one first half, one second); nothing longer than the cut;
    longest first; and no split at all when the work already fills every
    SM (the cut reaches the longest tile)."""
    from jukebox_tpu_torch.ops import flash_attention as fa
    items, pairs = fa.SCHEDULES[kind](BH, L, SMS)
    needed = causal_tiles(kind, L)
    lengths = [len(tiles) for tiles in needed]
    cut = max(-(-max(lengths) // 2), -(-BH * sum(lengths) // SMS))
    seen, by_pair = {}, {}
    for bh, t, lo, hi, pair in items:
        assert 0 <= bh < BH and lo < hi
        seen.setdefault((bh, t), []).append((lo, hi, pair))
        if pair >= 0:
            by_pair.setdefault(pair, []).append((bh, t, lo, hi))
    assert set(seen) == {(bh, t) for bh in range(BH)
                         for t in range(len(needed))}
    for (bh, t), parts in seen.items():
        covered = [j for lo, hi, _ in parts for j in range(lo, hi)]
        assert sorted(covered) == sorted(needed[t])  # each tile once
        if len(needed[t]) > cut:
            assert len(parts) == 2 and parts[0][2] == parts[1][2] >= 0
        else:
            assert [p[2] for p in parts] == [-1]
    assert sorted(by_pair) == list(range(pairs))
    for halves in by_pair.values():
        (bh0, t0, lo0, hi0), (bh1, t1, lo1, hi1) = sorted(halves,
                                                          key=lambda h: h[2])
        assert (bh0, t0) == (bh1, t1) and hi0 == lo1
        assert lo0 == min(needed[t0])  # the kernels tell the halves apart so
    item_lengths = [hi - lo for _, _, lo, hi, _ in items]
    assert item_lengths == sorted(item_lengths, reverse=True)
    assert max(item_lengths) <= cut
    if BH * sum(lengths) >= SMS * max(lengths):
        assert pairs == 0
    if (BH, L) == (2, 6528):  # the 1b top's f0 layer: 102 tiles a head
        assert (len(items), pairs, max(item_lengths)) == (248, 44, 80)
    if (BH, L) == (8, 8192):  # work enough for every SM: no split
        assert pairs == 0
