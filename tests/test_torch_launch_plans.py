"""The launch plans of the redesigned CUDA kernels, on the CPU.

``kernels/netes_mixing.plan`` decides which output tiles of the dense Eq. 3
GEMM run whole and how the tiles of the last, partial wave are split along
the source axis; ``kernels/flash_attention.plan`` cuts the (position, head)
rows of each KV head into query tiles. The kernels compute their work from
the block index as ``block_work`` and ``block_rows`` do; here those
mappings must cover every output tile and K stretch, or every (batch,
position, query head) row, exactly once. The dense GEMM's decomposition is
also replayed in float64 numpy (weighted operand, padded halves, split
pieces summed in piece order, epilogue) against the plain version.

The two sparse Eq. 3 kernels (``netes_sparse_mixing`` and
``fused_neighbor_sum``) share one plan (``kernels/_slab.py``): column slabs
held in shared memory, (slab, receiver) units cut into one run per block,
senders in chunks when N rows do not fit. Their ``block_work`` must cover
every (receiver, column) once and ``chunk_bounds`` every sender once per
column. The sparse kernel's factored, chunked decomposition (Y, then the
slot sum, then −wsum·θ_j, per chunk) is replayed in float64 numpy against
the plain version; the fused kernel's in-kernel weight fold is replayed in
float32 numpy against ``ref.folded_weights`` bit for bit, and its slab's
bf16 widening of int8 codes is checked exact for every code.

The WKV-6 recurrence (``kernels/rwkv6_wkv.plan``) splits each head's state
columns over blocks; its ``block_work`` must cover every (b, h, column)
of the padded head once and ``thread_entries`` every state entry of a
block once, at rwkv6-7b's shapes and at ragged head widths, with a grid
that covers the SMs at B = 1 × H = 64. Its float64 replay is in ``test_torch_rwkv6_wkv.py``.

Tolerance of the replays: |replay − plain| ≤ 1e-9·S, S the same sum over
absolute values: both run in float64 here (the plain version computes in
its inputs' type) and differ only in the order of the sums, ≈ 1e-15·S; a
missing or doubled K stretch, chunk or slot moves an output by ≈ S/N or
S/K_max ≥ 4e-3·S.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _slab
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import netes_fused_mixing as nfm
from repro_torch.kernels import netes_mixing as nm
from repro_torch.kernels import netes_sparse_mixing as nsm
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as rw

H100_SMS = 132

# (N, P): the main path, the paper's 3000 agents, below one tile, ragged
MIXING_SHAPES = [(1000, 4481), (3000, 4481), (32, 4481), (257, 700)]


@pytest.mark.parametrize("resident", [1, 2, 3])
@pytest.mark.parametrize("n,p", MIXING_SHAPES)
def test_mixing_plan_covers_every_tile_and_k_stretch_once(n, p, resident):
    pl = nm.plan(n, p, H100_SMS, resident)
    assert pl.kh % nm.BK == 0 and pl.kh >= n
    assert pl.npad % nm.BM == 0 and pl.npad >= n
    assert pl.k_tiles * nm.BK == 2 * pl.kh
    pieces = {}
    for row0, col0, kt0, kt1 in nm.block_work(pl):
        assert row0 < n and col0 < p and 0 <= kt0 < kt1 <= pl.k_tiles
        assert kt1 - kt0 >= min(nm.MIN_PIECE_K_TILES, pl.k_tiles)
        pieces.setdefault((row0, col0), []).append((kt0, kt1))
    tiles = {(r, c) for r in range(0, n, nm.BM) for c in range(0, p, nm.BN)}
    assert set(pieces) == tiles
    for stretches in pieces.values():
        # in block order, the pieces of a tile tile [0, k_tiles) end to end
        assert stretches[0][0] == 0 and stretches[-1][1] == pl.k_tiles
        assert all(a[1] == b[0] for a, b in zip(stretches, stretches[1:]))
    split_tiles = [t for t, s in pieces.items() if len(s) > 1]
    assert len(split_tiles) == pl.rem
    assert all(len(pieces[t]) == pl.split for t in split_tiles)
    assert pl.grid_blocks == pl.full + pl.rem * pl.split


def test_mixing_plan_fills_the_last_wave_at_the_main_shape():
    """N = 1000, P = 4481, 2 blocks per SM: 288 tiles on 264 slots. The 24
    tiles past the first wave run as 24 × 11 = 264 pieces."""
    pl = nm.plan(1000, 4481, H100_SMS, 2)
    assert (pl.full, pl.rem, pl.split, pl.grid_blocks) == (264, 24, 11, 528)
    assert pl.rem * pl.split <= pl.slots
    assert pl.rem * pl.split > 0.9 * pl.slots


def _replay_mixing(pl, adj, wt, we, th, ep, sigma):
    """The kernel's arithmetic, in float64 numpy, in the plan's pieces."""
    n, p = th.shape
    w_op = np.zeros((2 * pl.kh, pl.npad))
    w_op[:n, :n] = (adj * wt[None, :]).T
    w_op[pl.kh:pl.kh + n, :n] = sigma * (adj * we[None, :]).T
    src = np.zeros((2 * pl.kh, p))
    src[:n], src[pl.kh:pl.kh + n] = th, ep
    wsum = (adj * wt[None, :]).sum(1)
    out = np.full((n, p), np.nan)
    partial = {}
    for row0, col0, kt0, kt1 in nm.block_work(pl):
        ks = slice(kt0 * nm.BK, kt1 * nm.BK)
        acc = w_op[ks, row0:row0 + nm.BM].T @ src[ks, col0:col0 + nm.BN]
        partial.setdefault((row0, col0), []).append(acc)
    for (row0, col0), accs in partial.items():
        total = accs[0]
        for acc in accs[1:]:
            total = total + acc
        rows = slice(row0, min(row0 + nm.BM, n))
        cols = slice(col0, min(col0 + nm.BN, p))
        h, w = rows.stop - row0, cols.stop - col0
        out[rows, cols] = total[:h, :w] - wsum[rows, None] * th[rows, cols]
    return out


@pytest.mark.parametrize("n,p,sms,resident", [
    (257, 700, 7, 2),     # 18 tiles on 14 slots: 4 split in 3
    (257, 700, 132, 2),   # 18 tiles, all split in 8
    (40, 300, 2, 1),      # 3 tiles on 2 slots: one split in 2
    (130, 129, 1, 3),     # 4 tiles on 3 slots: one split in 3
])
def test_mixing_replay_in_the_plans_pieces_matches_plain_version(
        n, p, sms, resident):
    rng = np.random.default_rng(n + p + sms)
    adj = (rng.random((n, n)) < 0.4).astype(np.float64)
    wt, we = rng.normal(size=n), rng.normal(size=n)
    th, ep = rng.normal(size=(n, p)), rng.normal(size=(n, p))
    sigma = 0.1
    pl = nm.plan(n, p, sms, resident)
    got = _replay_mixing(pl, adj, wt, we, th, ep, sigma)
    want = ref.netes_mixing_ref(*(torch.as_tensor(x) for x in
                                  (adj, wt, we, th, ep)), sigma=sigma).numpy()
    a = np.abs(adj)
    scale = ((a * np.abs(wt)) @ np.abs(th) + sigma * ((a * np.abs(we))
             @ np.abs(ep)) + np.abs((adj * wt).sum(1))[:, None] * np.abs(th))
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 1e-9 * scale).all()


# (B, Sq, H, Hkv): G = 1, 2, 4, 5 at Sq·G that is and is not a multiple of
# the query tile, and the main path's shapes
ATTN_SHAPES = [
    (1, 333, 8, 8), (2, 333, 16, 8), (1, 333, 32, 8), (1, 333, 40, 8),
    (2, 256, 8, 8), (1, 64, 32, 8), (1, 8192, 32, 8), (1, 8192, 16, 16),
    (2, 1000, 32, 8), (1, 7, 40, 8), (3, 1, 40, 8),
]


# gemma3-4b's 8/4 heads of 256 (64-row query tiles): its serve runs (a) and
# (b), Sq·G off the tile, B = 2, and one position
ATTN_SHAPES_HD256 = [(1, 8192, 8, 4), (8, 512, 8, 4), (2, 333, 8, 4),
                     (1, 1, 8, 4), (1, 77, 8, 8)]


def _check_plan_covers_every_row_once(b, sq, h, hkv, hd):
    pl = fa.plan(b, sq, h, hkv, hd)
    assert pl.rows == fa.rows_per_block(hd)
    g = h // hkv
    seen = []
    for block in range(pl.grid_blocks):
        rows = list(fa.block_rows(pl, block))
        assert 0 < len(rows) <= pl.rows
        # one batch row and one KV head per block
        assert len({(rb, head // g) for rb, _, head in rows}) == 1
        positions = sorted({pos for _, pos, _ in rows})
        # a tile's positions are contiguous: its masks are a key range
        assert positions == list(range(positions[0], positions[-1] + 1))
        assert len(positions) <= -(-pl.rows // g) + 1
        seen.extend(rows)
    assert len(seen) == len(set(seen)) == b * sq * h
    assert pl.grid_blocks == pl.tiles * hkv * b


@pytest.mark.parametrize("b,sq,h,hkv", ATTN_SHAPES)
def test_attention_plan_covers_every_row_once(b, sq, h, hkv):
    _check_plan_covers_every_row_once(b, sq, h, hkv, 128)


@pytest.mark.parametrize("b,sq,h,hkv", ATTN_SHAPES_HD256)
def test_attention_plan_covers_every_row_once_hd256(b, sq, h, hkv):
    _check_plan_covers_every_row_once(b, sq, h, hkv, 256)


def test_attention_rows_per_block_follow_the_head_width():
    """The source's BR: 128 rows at hd 32, 64 and 128, 64 at hd 256 (whose
    128-row tiles would need 416 KB of shared memory)."""
    assert [fa.rows_per_block(hd) for hd in fa.HEAD_DIMS] == [128, 128, 128,
                                                              64]
    assert fa.plan(1, 8192, 8, 4, 256).grid_blocks == 1024
    assert fa.plan(1, 8192, 32, 8, 128).grid_blocks == 2048


@pytest.mark.parametrize("b,sq,h,hkv,hd", [
    pytest.param(1, 8192, 32, 8, 128, id="1-8192-32-8"),
    pytest.param(2, 1000, 40, 8, 128, id="2-1000-40-8"),
    pytest.param(1, 8192, 8, 4, 256, id="1-8192-8-4-hd256"),
    pytest.param(2, 333, 8, 4, 256, id="2-333-8-4-hd256")])
def test_attention_plan_issues_the_latest_positions_first(b, sq, h, hkv, hd):
    """Every (batch, KV head) starts its last query tile, the longest under
    a causal mask, before any block starts a shorter one."""
    pl = fa.plan(b, sq, h, hkv, hd)
    last_pos = [max(pos for _, pos, _ in fa.block_rows(pl, block))
                for block in range(pl.grid_blocks)]
    assert last_pos == sorted(last_pos, reverse=True)
    heads = hkv * b
    assert set(last_pos[:heads]) == {sq - 1}
    firsts = {(rb, head // (h // hkv)) for block in range(heads)
              for rb, _, head in fa.block_rows(pl, block)}
    assert len(firsts) == heads


# ---------------------------------------------------------------------------
# the two sparse Eq. 3 kernels: column slabs in shared memory
# ---------------------------------------------------------------------------

# (N, P): the main path, the paper's 3000 agents, ragged, and an N whose
# slab does not fit in one block (4 sender chunks in both kernels)
SLAB_SHAPES = [(1000, 4481), (3000, 4481), (257, 700), (5000, 700)]
SLAB_KERNELS = {"netes_sparse_mixing": nsm, "fused_neighbor_sum": nfm}


@pytest.mark.parametrize("resident", [1, 2])
@pytest.mark.parametrize("n,p", SLAB_SHAPES)
@pytest.mark.parametrize("kname", sorted(SLAB_KERNELS))
def test_slab_plan_covers_every_receiver_column_and_sender_once(
        kname, n, p, resident):
    mod = SLAB_KERNELS[kname]
    pl = mod.plan(n, p, H100_SMS, resident)
    assert pl.slab == mod.SLAB and pl.smem_bytes <= _slab.SMEM_MAX
    assert 1 <= pl.grid <= min(H100_SMS * resident, pl.units)
    # the slabs tile the columns end to end
    spans = [(s * pl.slab, min(p, (s + 1) * pl.slab))
             for s in range(pl.slabs)]
    assert spans[0][0] == 0 and spans[-1][1] == p
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:]))
    # every (slab, receiver) unit in exactly one block's run
    runs = {}
    for segs in mod.block_work(pl):
        assert segs, "a block without work"
        assert len(segs) <= -(-pl.units // pl.grid // n) + 2
        for s, r0, r1 in segs:
            assert 0 <= s < pl.slabs and 0 <= r0 < r1 <= n
            runs.setdefault(s, []).append((r0, r1))
    assert sorted(runs) == list(range(pl.slabs))
    for s, rs in runs.items():
        rs.sort()
        assert rs[0][0] == 0 and rs[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
    # the chunks take every sender once
    bounds = mod.chunk_bounds(pl)
    assert len(bounds) == pl.chunks and bounds[0][0] == 0
    assert bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(0 < c1 - c0 <= pl.chunk_rows for c0, c1 in bounds)
    # the runs are equal to within one unit
    sizes = [sum(r1 - r0 for _, r0, r1 in segs)
             for segs in mod.block_work(pl)]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == pl.units


def test_slab_plans_at_the_main_path_and_the_papers_sizes():
    """N = 1000: one chunk (161,024 bytes of shared memory: one block per
    SM), 141 slabs of 32 columns and 71 of 64 on 132 blocks. N = 3000
    (Fig. 2B): two chunks of 1500 senders. N = 5000: four."""
    sp = nsm.plan(1000, 4481, H100_SMS, 1)
    fu = nfm.plan(1000, 4481, H100_SMS, 1)
    assert (sp.slabs, sp.chunks, sp.chunk_rows, sp.grid) == (141, 1, 1000, 132)
    assert (fu.slabs, fu.chunks, fu.chunk_rows, fu.grid) == (71, 1, 1000, 132)
    assert sp.smem_bytes == fu.smem_bytes == 161_024
    assert sp.list_entries(130) == 1000 * 136
    for mod in (nsm, nfm):
        assert (mod.plan(3000, 4481, H100_SMS, 1).chunks,
                mod.plan(3000, 4481, H100_SMS, 1).chunk_rows) == (2, 1500)
        assert mod.plan(5000, 700, H100_SMS, 1).chunks == 4
    # the largest N of one chunk, and the first of two
    rows = (_slab.SMEM_MAX - _slab.smem_bytes(0)) // _slab.ROW_BYTES
    assert _slab.chunking(rows) == (rows, 1)
    assert _slab.chunking(rows + 1)[1] == 2
    assert _slab.smem_bytes(rows) <= _slab.SMEM_MAX
    assert _slab.smem_bytes(rows + 1) > _slab.SMEM_MAX


def _neighbor_list(n, p, rng, shuffle=True, drop=0.0):
    """A padded neighbor list of G(n, p) without self loops, built row by
    row: edge weights in [0.5, 2), padding (index j, weight 0) at the end,
    then (``shuffle``) each row's slots permuted, so nothing may rely on
    ascending order; ``drop`` zeroes that fraction of the live weights, as
    a channel's dropout does."""
    nbrs = []
    for j in range(n):
        cand = np.flatnonzero(rng.random(n) < p)
        nbrs.append(cand[cand != j])
    k_max = max(1, max(len(c) for c in nbrs))
    idx = np.repeat(np.arange(n, dtype=np.int32)[:, None], k_max, axis=1)
    mask = np.zeros((n, k_max), np.float32)
    for j, c in enumerate(nbrs):
        idx[j, :len(c)] = c
        mask[j, :len(c)] = rng.uniform(0.5, 2.0, len(c))
    if drop:
        mask *= rng.random(mask.shape) >= drop
    if shuffle:
        perm = np.argsort(rng.random((n, k_max)), axis=1)
        idx = np.take_along_axis(idx, perm, 1)
        mask = np.take_along_axis(mask, perm, 1)
    return idx, mask


def _replay_blocks(pl, work, blocks):
    """The slabs the chosen blocks touch, and each one's position among
    them: the replays generate and compare only those columns (the map is
    separable by column)."""
    slabs = sorted({s for b in blocks for s, _, _ in work[b]})
    widths = [min(pl.cols, (s + 1) * pl.slab) - s * pl.slab for s in slabs]
    starts = np.concatenate([[0], np.cumsum(widths)])
    return {s: slice(int(starts[k]), int(starts[k + 1]))
            for k, s in enumerate(slabs)}, int(starts[-1])


def _chosen_blocks(work):
    """The first block, the first whose run spans two slabs, the last."""
    spans = [b for b, segs in enumerate(work) if len(segs) > 1]
    return sorted({0, len(work) - 1, *spans[:1]})


def _replay_sparse(pl, work, blocks, cols_of, idx, mask, wt, we, th, ep,
                   sigma):
    """The kernel's arithmetic, in float64 numpy, in the plan's pieces:
    per block, per slab of its run, per sender chunk, Y of the chunk, then
    each receiver's live slots (sender in the chunk, not padding), then
    −wsum_c·θ_j, the chunks' parts added in chunk order."""
    out = np.full(th.shape, np.nan)
    for b in blocks:
        for s, r0, r1 in work[b]:
            cols = cols_of[s]
            rows = np.arange(r0, r1)
            total = None
            for c0, c1 in _slab.chunk_bounds(pl):
                y = (wt[c0:c1, None] * th[c0:c1, cols]
                     + (sigma * we[c0:c1])[:, None] * ep[c0:c1, cols])
                i, m = idx[r0:r1], mask[r0:r1]
                live = ((i >= c0) & (i < c1)
                        & ~((m == 0) & (i == rows[:, None])))
                w = np.where(live, m, 0.0)
                ic = np.where(live, i - c0, 0)
                part = (np.einsum("jk,jkc->jc", w, y[ic])
                        - (w * wt[c0:c1][ic]).sum(1)[:, None]
                        * th[r0:r1, cols])
                total = part if total is None else total + part
            out[r0:r1, cols] = total
    return out


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("n,p,density", [(1000, 4481, 0.1),
                                         (3000, 4481, 0.1),
                                         (257, 700, 0.3),
                                         (5000, 700, 0.02)])
def test_sparse_mixing_replay_in_the_plans_pieces_matches_plain_version(
        n, p, density, drop):
    rng = np.random.default_rng(n + p)
    idx, mask = _neighbor_list(n, density, rng, drop=drop)
    pl = nsm.plan(n, p, H100_SMS, 1)
    work = list(nsm.block_work(pl))
    blocks = range(pl.grid) if n * p < 10**6 else _chosen_blocks(work)
    cols_of, width = _replay_blocks(pl, work, blocks)
    wt, we = rng.normal(size=n), rng.normal(size=n)
    th, ep = rng.normal(size=(n, width)), rng.normal(size=(n, width))
    sigma = 0.1
    got = _replay_sparse(pl, work, blocks, cols_of, idx,
                         mask.astype(np.float64), wt, we, th, ep, sigma)
    want = ref.sparse_mixing_ref(*(torch.as_tensor(x) for x in (
        idx, mask.astype(np.float64), wt, we, th, ep)), sigma=sigma).numpy()
    a = np.abs(mask.astype(np.float64))
    scale = (np.einsum("jk,jkc->jc", a * np.abs(wt[idx]), np.abs(th[idx]))
             + sigma * np.einsum("jk,jkc->jc", a * np.abs(we[idx]),
                                 np.abs(ep[idx]))
             + np.abs((mask * wt[idx]).sum(1))[:, None] * np.abs(th))
    done = ~np.isnan(got)
    assert done.any(0).all(), "a replayed column without any receiver"
    if len(blocks) == pl.grid:
        assert done.all()
    assert (np.abs(got - want)[done] <= 1e-9 * scale[done]).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1000, 3000, 257, 5000])
def test_fused_fold_replay_is_bitwise_the_plain_folded_weights(n, masked):
    """The kernel's fold, w = m·coeff[i]; w = w·em; w = w·scale[i], each
    product rounded to float32 alone, against ``ref.folded_weights``."""
    rng = np.random.default_rng(n)
    density = {1000: 0.1, 3000: 0.1, 257: 0.3, 5000: 0.02}[n]
    idx, mask = _neighbor_list(n, density, rng)
    coeff = rng.normal(size=n).astype(np.float32)
    scale = np.exp(rng.normal(scale=3.0, size=(n, 1))).astype(np.float32)
    em = None
    if masked:   # a dropout mask, and non-binary weights that test the order
        em = ((rng.random(mask.shape) >= 0.1)
              * rng.uniform(0.5, 1.5, mask.shape)).astype(np.float32)
    w = mask * coeff[idx]
    if em is not None:
        w = w * em
    w = w * scale[idx, 0]
    assert w.dtype == np.float32
    want = ref.folded_weights(
        torch.as_tensor(idx), torch.as_tensor(mask), torch.as_tensor(coeff),
        torch.as_tensor(scale),
        None if em is None else torch.as_tensor(em)).numpy()
    np.testing.assert_array_equal(w.view(np.uint32), want.view(np.uint32))


def test_fused_slab_widens_every_int8_code_exactly():
    """Staged: the float's upper 16 bits (bf16), two codes to a word;
    gathered: ``w << 16`` and ``w & 0xffff0000`` read as float32."""
    v = np.arange(-128, 128, dtype=np.int8)
    bf16 = v.astype(np.float32).view(np.uint32) >> 16
    word = (bf16[::-1] << 16) | bf16          # hi: the reversed codes
    lo = (word << 16).view(np.float32)
    hi = (word & np.uint32(0xFFFF0000)).view(np.float32)
    np.testing.assert_array_equal(lo, v.astype(np.float32))
    np.testing.assert_array_equal(hi, v[::-1].astype(np.float32))


@pytest.mark.parametrize("name", ["THREADS", "ROW_BYTES", "ROUND", "RING",
                                  "SMEM_MAX"])
def test_slab_plan_constants_are_the_kernels_header(name):
    """``kernels/_slab.py`` plans with the constants of ``csrc/_slab.cuh``,
    which both slab kernels include."""
    header = (pathlib.Path(_slab.__file__).resolve().parent.parent / "csrc"
              / "_slab.cuh").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", header)
    assert found == [str(getattr(_slab, name))]


def _replay_fused(pl, work, blocks, cols_of, idx, ws, codes):
    """The fused kernel's sum in float64 numpy, in the plan's pieces: per
    chunk, the slots whose sender lies in it and whose folded weight is not
    0, the chunks' parts added in chunk order."""
    out = np.full(codes.shape, np.nan)
    for b in blocks:
        for s, r0, r1 in work[b]:
            cols = cols_of[s]
            total = None
            for c0, c1 in _slab.chunk_bounds(pl):
                i, w = idx[r0:r1], ws[r0:r1]
                live = (i >= c0) & (i < c1) & (w != 0)
                part = np.einsum("jk,jkc->jc", np.where(live, w, 0.0),
                                 codes[np.where(live, i, 0)][:, :, cols])
                total = part if total is None else total + part
            out[r0:r1, cols] = total
    return out


@pytest.mark.parametrize("n,d,density", [(1000, 4481, 0.1), (257, 700, 0.3),
                                         (5000, 700, 0.02)])
def test_fused_replay_in_the_plans_pieces_matches_plain_version(n, d,
                                                                density):
    rng = np.random.default_rng(n + d + 1)
    idx, mask = _neighbor_list(n, density, rng)
    pl = nfm.plan(n, d, H100_SMS, 1)
    work = list(nfm.block_work(pl))
    blocks = range(pl.grid) if n * d < 10**6 else _chosen_blocks(work)
    cols_of, width = _replay_blocks(pl, work, blocks)
    coeff = rng.normal(size=n).astype(np.float32)
    scale = rng.uniform(1e-3, 1e-2, size=(n, 1)).astype(np.float32)
    em = (rng.random(mask.shape) >= 0.1).astype(np.float32)
    codes = rng.integers(-127, 128, size=(n, width), dtype=np.int8)
    args = [torch.as_tensor(x) for x in (idx, mask, coeff, codes, scale, em)]
    ws = ref.folded_weights(*args[:3], args[4], args[5]).numpy()
    got = _replay_fused(pl, work, blocks, cols_of, idx, ws.astype(np.float64),
                        codes.astype(np.float64))
    want = ref.fused_neighbor_sum_ref(*args).numpy()
    scale_s = np.einsum("jk,jkc->jc", np.abs(ws.astype(np.float64)),
                        np.abs(codes[idx].astype(np.float64)))
    done = ~np.isnan(got)
    assert done.any(0).all()
    # the plain version sums in float32: its own rounding, ≤ K_max·u·S
    assert (np.abs(got - want)[done] <= 3e-5 * scale_s[done] + 1e-30).all()


# (B, S, H, n): rwkv6-7b's prefills of serve runs (a) and (b), its decode
# steps, then the ragged head widths chip_smoke.py runs
WKV_SHAPES = [(1, 8192, 64, 64), (8, 512, 64, 64), (1, 1, 64, 64),
              (8, 1, 64, 64), (2, 100, 3, 8), (1, 77, 5, 16), (3, 33, 2, 32),
              (1, 50, 2, 40)]


@pytest.mark.parametrize("b,s,h,n", WKV_SHAPES,
                         ids=["x".join(map(str, x)) for x in WKV_SHAPES])
def test_wkv_plan_covers_every_column_and_state_entry_once(b, s, h, n):
    pl = rw.plan(b, h, n)
    assert (pl.n, pl.rs, pl.warps) in rw.INSTANCES
    assert pl.n == rw.padded(n) >= n
    assert pl.cols * (pl.groups - 1) < pl.n <= pl.cols * pl.groups
    seen = {}
    for block in range(pl.grid):
        bb, hh, cols = rw.block_work(pl, block)
        assert len(cols) > 0, "a block without columns"
        for c in cols:
            seen[bb, hh, c] = seen.get((bb, hh, c), 0) + 1
    assert seen == {(bb, hh, c): 1 for bb in range(b) for hh in range(h)
                    for c in range(pl.n)}
    entries = {}
    for tid in range(32 * pl.warps):
        for e in rw.thread_entries(pl, tid):
            entries[e] = entries.get(e, 0) + 1
    assert entries == {(i, c): 1 for i in range(pl.n)
                       for c in range(pl.cols)}
    # the sequence in whole chunks, then a tail the kernel steps apart
    full, tail = divmod(s, rw.CHUNK)
    assert full * rw.CHUNK + tail == s


def test_wkv_plan_at_rwkv6_7b_prefill_and_decode():
    """n = 64: 16 threads share four columns (4 × 4 entries a thread), 2
    column groups of 32 a head, blocks of 4 computing warps. B = 1 × H =
    64: 128 blocks, one on each of 128 of the H100's 132 SMs (narrower
    blocks ran slower); B = 8: 1024. n = 40 runs padded to 64."""
    one = rw.plan(1, 64, 64)
    assert (one.rs, one.warps, one.cols, one.groups, one.grid) == (
        16, 4, 32, 2, 128)
    assert H100_SMS - 4 <= one.grid <= H100_SMS
    assert rw.plan(8, 64, 64).grid == 1024
    ragged = rw.plan(1, 2, 40)
    assert (ragged.n, ragged.grid) == (64, 2 * 2)


def test_wkv_plan_constants_are_the_kernels():
    """``kernels/rwkv6_wkv.py`` plans with the chunk and the instances of
    ``csrc/rwkv6_wkv.cu``, and takes only instances that exist."""
    src = (pathlib.Path(rw.__file__).resolve().parent.parent / "csrc"
           / "rwkv6_wkv.cu").read_text()
    assert re.findall(r"constexpr int CHUNK = (\d+);", src) == [str(rw.CHUNK)]
    listed = re.findall(r"X\((\d+), (\d+), (\d+)\)", src)
    assert sorted(tuple(map(int, x)) for x in listed) == sorted(rw.INSTANCES)
    assert sorted(i[0] for i in rw.INSTANCES) == [8, 16, 32, 64]
    assert [rw.padded(n) for n in (1, 8, 9, 16, 17, 32, 33, 64)] == [
        8, 8, 16, 16, 32, 32, 64, 64]
