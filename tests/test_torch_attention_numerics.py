"""The numerical design of the attention kernels, checked on the CPU.

``csrc/attention.cu`` and ``csrc/attention_bwd.cu`` multiply on the tensor
cores in tf32 with each f32 operand split as x = hi + lo (hi and lo rounded
by ``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away from
zero), a product taken as hi.hi + hi.lo + lo.hi, and they skip every
64-key tile whose mask entries are all -inf. Neither can run here, so these
tests emulate the split with numpy and show that it holds the kernels'
1e-4 gate against ``attention_plain``, and that dropping the fully masked
tiles from the inputs changes no output bit of the plain versions: the
exactness the skip relies on.
"""
import numpy as np
import pytest
import torch

from findtextcenternet_tpu_torch.models.transformer import make_key_mask
from findtextcenternet_tpu_torch.ops import attention

TILE = 64


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (finite inputs)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = (bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)
    return (sign | (mag & np.uint32(0xFFFFE000))).view(np.float32)


def split(x: np.ndarray):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def split_product(eq: str, a: np.ndarray, b: np.ndarray,
                  passes: int = 3) -> np.ndarray:
    """``einsum(eq, a, b)`` as the tensor cores take it: tf32 operands
    (their products exact in f32), an f32 sum; the cross terms first."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    out = np.zeros((), np.float32)
    for x, y in terms:
        out = out + np.einsum(eq, x, y).astype(np.float32)
    return out


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                 # tf32 spacing at 1.0
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                  one + ulp * 1.5, np.float32(3.14159265)], np.float32)
    got = rna_tf32(x)
    np.testing.assert_array_equal(
        got[:4], np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                          np.float32))
    assert (got.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    hi, lo = split(x)
    # hi + lo keeps 22 of the 24 significand bits
    assert (np.abs(hi.astype(np.float64) + lo - x) <= np.abs(x) * 2.0 ** -21
            ).all()


def _inputs(b, tq, tk, h, hd, gaps, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, t, h, hd)).astype(np.float32)
                  for t in (tq, tk, tk, tq))
    enc = np.ones((b, tk, 2), np.float32)
    for i, ranges in enumerate(gaps):
        for lo, hi in ranges:
            enc[i, lo:hi] = 0.0
    return q, k, v, g, make_key_mask(torch.from_numpy(enc))


def test_split_tf32_attention_holds_the_kernel_gate(capsys):
    """Attention at (2, 400, 4, 64) with the scores and P.V taken in the
    3-product split form matches ``attention_plain`` within 1e-4; one tf32
    pass does not come as close."""
    q, k, v, _, mask = _inputs(2, 400, 400, 4, 64,
                               [[], [(0, 64), (311, 400)]], seed=0)
    want = attention.attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                     mask).numpy()
    errs = {}
    for passes in (3, 1):
        s = split_product("bqhd,bkhd->bhqk", q, k, passes)
        s = s * np.float32(1 / 8) + mask.numpy()
        p = torch.softmax(torch.from_numpy(s), dim=-1).numpy()
        out = split_product("bhqk,bkhd->bqhd", p, v, passes)
        errs[passes] = float(np.abs(out - want).max())
    with capsys.disabled():
        print(f"\nsplit tf32 attention (2,400,4,64): max_abs_err "
              f"{errs[3]:.3g} (3 products), {errs[1]:.3g} (one pass); "
              f"gate 1e-4")
    assert errs[3] <= 1e-4
    assert errs[1] > 10 * errs[3]


# window 0: whole tiles masked at the head and in the middle, a partial
# tail tile; window 1: a gap in the middle only; window 2: one key left;
# window 3: fully masked
GAPS = [[(0, 64), (128, 192), (280, 300)], [(64, 192)], [(0, 130),
                                                         (131, 300)],
        [(0, 300)]]


def _drop_masked_tiles(x, mask_row):
    """Keys of ``x`` (T, H, hd) in the 64-key tiles of ``mask_row`` (T,)
    that hold an unmasked key; the mask row cut the same way."""
    keep = np.zeros(mask_row.shape[0], bool)
    for t0 in range(0, mask_row.shape[0], TILE):
        if (mask_row[t0:t0 + TILE] != -np.inf).any():
            keep[t0:t0 + TILE] = True
    return x[keep], mask_row[keep]


@pytest.mark.parametrize("seed", [0, 1])
def test_dropping_fully_masked_tiles_changes_no_bit(seed):
    """Dropping every fully masked 64-key tile leaves ``attention_plain``
    and ``attention_bwd_plain`` bit-identical in each window with an
    unmasked key (the masked keys' gradients are exact zeros), and the
    fully masked window NaN."""
    q, k, v, g, mask = _inputs(4, 100, 300, 2, 16, GAPS, seed)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out = attention.attention_plain(qt, kt, vt, mask)
    dq, dk, dv = attention.attention_bwd_plain(qt, kt, vt, mask, gt)
    assert all(bool(torch.isnan(x[3]).all()) for x in (out, dq, dk, dv))
    m = mask[:, 0, 0].numpy()
    for i in range(3):
        ks, mrow = _drop_masked_tiles(k[i], m[i])
        vs, _ = _drop_masked_tiles(v[i], m[i])
        assert ks.shape[0] < k.shape[1]
        mi = torch.from_numpy(mrow)[None, None, None]
        args = (qt[i:i + 1], torch.from_numpy(ks)[None],
                torch.from_numpy(vs)[None], mi)
        torch.testing.assert_close(attention.attention_plain(*args),
                                   out[i:i + 1], rtol=0, atol=0)
        dqi, dki, dvi = attention.attention_bwd_plain(*args, gt[i:i + 1])
        torch.testing.assert_close(dqi, dq[i:i + 1], rtol=0, atol=0)
        kept, _ = _drop_masked_tiles(np.arange(300), m[i])
        for full, cut in ((dk, dki), (dv, dvi)):
            torch.testing.assert_close(cut[0], full[i, kept], rtol=0, atol=0)
            dropped = np.setdiff1d(np.arange(300), kept)
            assert (full[i, dropped] == 0).all()
