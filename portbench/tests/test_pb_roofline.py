"""The yardstick's operation and byte counts against hand counts."""
import pytest

from portbench import roofline
from portbench.reference import detector as ref_det
from portbench.reference import transformer as ref_tf

B, T, H, HD = 32, 400, 12, 64


def test_attention_forward_counts():
    keys = 5290
    flops, nbytes = roofline.attention_fwd_work(B, T, T, H, HD, keys,
                                                masked=True, lse=True)
    # q.k and p.v: 2 flops each per query, unmasked key, head and column
    assert flops == 2 * 2 * T * keys * H * HD
    # q, k, v in and out out, f32; the (B,T) mask; the (B,H,T) lse
    assert nbytes == 4 * 4 * B * T * H * HD + 4 * B * T + 4 * B * H * T
    flops, nbytes = roofline.attention_fwd_work(B, T, T, H, HD, B * T,
                                                masked=False, lse=False)
    assert flops == 4 * B * T * T * H * HD
    assert nbytes == 4 * 4 * B * T * H * HD


def test_attention_backward_counts():
    keys = 5290
    flops, nbytes = roofline.attention_bwd_work(B, T, T, H, HD, keys,
                                                masked=True)
    assert flops == 5 * 2 * T * keys * H * HD
    # reads q, k, v, out, dout, lse, mask; writes dq, dk, dv
    assert nbytes == 8 * 4 * B * T * H * HD + 4 * B * H * T + 4 * B * T


def test_nms_counts():
    flops, nbytes = roofline.nms_work(8, 192, 192)
    assert nbytes == 3 * 4 * 8 * 192 * 192
    assert flops == 13 * 8 * 192 * 192
    # far below the ridge: the bytes bound it
    assert roofline.bound_s(flops, nbytes) == nbytes / 3.35e12


def test_bound_takes_the_larger_time():
    assert roofline.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_transformer_dense_flops_by_hand():
    dims = {"enc_input_dim": 106, "embed_dim": 768, "head_num": 12,
            "enc_block_num": 10, "dec_block_num": 10, "max_enc_seq_len": 400,
            "max_dec_seq_len": 400}
    d, s, t = 768, 400, 400
    enc, kv, rnd = roofline.transformer_dense_flops(ref_tf, dims)
    # embed; a block: q, k, v, out and SwiGLU's w1, wg (d->2d) and w2
    assert enc == 2 * s * 106 * d + 10 * (4 * 2 * s * d * d
                                          + 3 * 2 * s * d * 2 * d)
    assert kv == 10 * 2 * 2 * s * d * d
    # a round: self q, k, v, out; cross q, out; SwiGLU; the three heads
    assert rnd == 10 * (6 * 2 * t * d * d + 3 * 2 * t * d * 2 * d) \
        + 2 * t * d * (1091 + 1093 + 1097)


def test_attention_pairs():
    dims = {"enc_block_num": 2, "dec_block_num": 3, "max_enc_seq_len": 10,
            "max_dec_seq_len": 8}
    # encoder: 2 blocks x 10 queries x (4 + 6) keys; a round: 3 blocks of
    # 8 x 8 self pairs a window and 8 queries x 10 cross keys
    assert roofline.attention_pairs(dims, [4, 6], rounds=2) == \
        2 * 10 * 10 + 2 * 3 * (8 * 8 * 2 + 8 * 10)


def test_detector_flops_by_hand_for_the_stem():
    # the first conv of the tiny backbone: 3 -> 8 channels, 3x3, stride 2
    count = []
    conv = ref_det._conv_fn(False, count)
    import torch
    meta = torch.device("meta")
    conv(torch.empty((1, 3, 64, 64), device=meta),
         torch.empty((8, 3, 3, 3), device=meta), None, 2, 1)
    assert count == [2 * 8 * 3 * 9 * 32 * 32]
    assert ref_det.flops_per_tile("tiny", 128) > 0
