"""The traffic generators repeat exactly for a seed, differ across seeds,
and give every seed the same amount of work."""
import numpy as np
import pytest
import torch

from portbench import generate, harness, weights
from portbench.tests.tiny import tiny_cell

BIG = 2**31 + 17


def pages(seed, p):
    rng = np.random.default_rng(weights.sub_seed(seed, "page", 0))
    return generate.book_page(rng, p)


@pytest.mark.parametrize("seed", [0, BIG])
def test_book_page_repeats_and_differs(seed):
    p = harness.find_cell("xl.book_dense", False).traffic
    a, b, c = pages(seed, p), pages(seed, p), pages(seed + 1, p)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[1], c[1])
    # the same counts for every seed: the pages' work does not move
    assert a[1].shape == c[1].shape
    assert a[0].shape == (p["page_h"], p["page_w"], 3)
    assert 1800 <= len(a[1]) <= 2100      # ~1.5k glyphs, 30 % doubled


def test_page_features_repeat_and_differ():
    f = [generate.page_features(50, 100, s, 0, "cpu") for s in (3, 3, 4)]
    assert f[0].dtype == torch.float16
    assert torch.equal(f[0], f[1]) and not torch.equal(f[0], f[2])


def _batches(seed):
    cell = tiny_cell("xl.train3")
    dims = {k: cell.config["transformer"][k] for k in (
        "enc_input_dim", "max_enc_seq_len", "max_dec_seq_len")}
    return generate.train_batches(cell.traffic, dims, 4, seed, "cpu")


def test_train_batches_repeat_and_differ():
    a, b, c = _batches(BIG), _batches(BIG), _batches(BIG + 1)
    for x, y, z in zip(a, b, c):
        for k in ("encoder_input", "decoder_input", "decoder_true"):
            assert torch.equal(x[k], y[k])
            assert not torch.equal(x[k], z[k])
        # the same lengths in every batch of every seed, in another order
        assert sorted(x["enc_keys"]) == sorted(z["enc_keys"])
    # the rows of one step all differ
    enc = a[0]["encoder_input"]
    assert len({r.numpy().tobytes() for r in enc}) == len(enc)


def test_train_batch_layout():
    b = _batches(5)[0]
    enc, true = b["encoder_input"], b["decoder_true"]
    for i, keys in enumerate(b["enc_keys"]):
        nonzero = (enc[i] != 0).any(-1)
        assert int(nonzero.sum()) == keys and bool(nonzero[:keys].all())
        assert true[i, 0] == generate.SOT and true[i, keys - 1] == generate.EOT
        assert (true[i, keys:] == 0).all()
