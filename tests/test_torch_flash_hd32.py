"""The flash kernel's head_dim-32 instance (whisper-tiny-smoke's 4 heads of
32, the contract linter's nano LM's 2 heads of 32): its launch plan and
the wrapper's CPU route at head_dim 32 against the JAX reference's
oracle, ``repro.kernels.ref.flash_attention_ref``.

The CUDA instance runs only on the card: ``chip_smoke.py`` holds it
against this plain version there (1 × 1500 non-causal, 8 × 64 causal).

Tolerance: rtol = atol = 1e-5, float32, as in
``tests/test_torch_flash_attention.py``: both sides take a softmax over a
few hundred unit-scale scores and sum in other orders (≈ 3e-7).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, Sq, Sk, H, Hkv, causal, window, chunk)
CASES = {
    "whisper_smoke_causal": (2, 64, 64, 4, 4, True, 0, 0),
    "whisper_smoke_cross": (2, 10, 64, 4, 4, False, 0, 0),
    "nano_g1_ragged": (1, 77, 77, 2, 2, True, 0, 0),
    "g2_window": (2, 100, 100, 4, 2, True, 16, 0),
    "g2_chunk": (1, 90, 90, 4, 2, True, 0, 32),
    "rows_without_a_key": (1, 60, 30, 4, 2, True, 8, 0),
}
# whisper-tiny-smoke's prompts and frames, the chip's two shapes, the
# nano LM, Sq·G off the 128-row tile
PLAN_SHAPES = [(2, 64, 4, 4), (8, 64, 4, 4), (1, 1500, 4, 4), (1, 64, 2, 2),
               (2, 333, 4, 2), (1, 1, 4, 4)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_route_matches_reference_at_head_dim_32(name):
    b, sq, sk, h, hkv, causal, window, chunk = CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((b, sq, h, 32)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, 32)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jref.flash_attention_ref(
        q, k, v, causal=causal, window=window, chunk=chunk))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,sq,h,hkv", PLAN_SHAPES)
def test_plan_covers_every_row_once_at_head_dim_32(b, sq, h, hkv):
    pl = fa.plan(b, sq, h, hkv, 32)
    assert 32 in fa.HEAD_DIMS and pl.rows == fa.rows_per_block(32) == 128
    seen = sorted(row for block in range(pl.grid_blocks)
                  for row in fa.block_rows(pl, block))
    assert seen == sorted((bb, p, hh) for bb in range(b) for p in range(sq)
                          for hh in range(h))


def test_shape_only_path_at_head_dim_32():
    """On meta tensors (a dry run's stand-in for the card) the wrapper
    returns the output's shape and launches nothing."""
    q = torch.empty(2, 64, 4, 32, device="meta")
    k = torch.empty(2, 64, 4, 32, device="meta")
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, k)
    assert out.shape == q.shape and out.device.type == "meta"
    assert fa.KERNEL.launches == before
