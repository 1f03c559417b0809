"""The launch plans of the two redesigned CUDA kernels, on the CPU.

``kernels/netes_mixing.plan`` decides which output tiles of the dense Eq. 3
GEMM run whole and how the tiles of the last, partial wave are split along
the source axis; ``kernels/flash_attention.plan`` cuts the (position, head)
rows of each KV head into query tiles. The kernels compute their work from
the block index as ``block_work`` and ``block_rows`` do; here those
mappings must cover every output tile and K stretch, or every (batch,
position, query head) row, exactly once. The dense GEMM's decomposition is
also replayed in float64 numpy (weighted operand, padded halves, split
pieces summed in piece order, epilogue) against the plain version.

Tolerance of the replay: |replay − plain| ≤ 1e-9·S, S the same sum over
absolute values: both run in float64 here (the plain version computes in
its inputs' type) and differ only in the order of the sums, ≈ 1e-15·S; a
missing or doubled K stretch moves an output by ≈ S/N ≥ 4e-3·S.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import netes_mixing as nm
from repro_torch.kernels import ref

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


@pytest.mark.parametrize("b,sq,h,hkv", ATTN_SHAPES)
def test_attention_plan_covers_every_row_once(b, sq, h, hkv):
    pl = fa.plan(b, sq, h, hkv)
    g = h // hkv
    seen = []
    for block in range(pl.grid_blocks):
        rows = list(fa.block_rows(pl, block))
        assert 0 < len(rows) <= fa.ROWS_PER_BLOCK
        # one batch row and one KV head per block
        assert len({(rb, head // g) for rb, _, head in rows}) == 1
        positions = sorted({pos for _, pos, _ in rows})
        # a tile's positions are contiguous: its masks are a key range
        assert positions == list(range(positions[0], positions[-1] + 1))
        assert len(positions) <= -(-fa.ROWS_PER_BLOCK // g) + 1
        seen.extend(rows)
    assert len(seen) == len(set(seen)) == b * sq * h
    assert pl.grid_blocks == pl.tiles * hkv * b


@pytest.mark.parametrize("b,sq,h,hkv", [(1, 8192, 32, 8), (2, 1000, 40, 8)])
def test_attention_plan_issues_the_latest_positions_first(b, sq, h, hkv):
    """Every (batch, KV head) starts its last query tile, the longest under
    a causal mask, before any block starts a shorter one."""
    pl = fa.plan(b, sq, h, hkv)
    last_pos = [max(pos for _, pos, _ in fa.block_rows(pl, block))
                for block in range(pl.grid_blocks)]
    assert last_pos == sorted(last_pos, reverse=True)
    heads = hkv * b
    assert set(last_pos[:heads]) == {sq - 1}
    firsts = {(rb, head // (h // hkv)) for block in range(heads)
              for rb, _, head in fa.block_rows(pl, block)}
    assert len(firsts) == heads
