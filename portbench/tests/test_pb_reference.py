"""The reference's frozen copies compute what the port computes, in f32 on
the CPU at a small size: a later divergence of either side shows here."""
import numpy as np
import torch

from portbench import weights
from portbench.reference import detector as ref_det
from portbench.reference import pages as ref_pages
from portbench.reference import transformer as ref_tf

DIMS = {"enc_input_dim": 106, "embed_dim": 64, "head_num": 4,
        "enc_block_num": 2, "dec_block_num": 2, "max_enc_seq_len": 32,
        "max_dec_seq_len": 32}
MP = {"max_rounds": 8, "topk": 3, "remask_threshold": 0.9,
      "early_stop_threshold": 0.99}


def test_detector_equals_the_port():
    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)
    sd = weights.draw(ref_det.param_specs("tiny"),
                      weights.generator(1, "cpu", "d"), "cpu")
    port = CenterNetDetection("tiny").eval()
    port.load_state_dict(sd)
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = port(x)
        got = ref_det.forward(sd, x, "tiny")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_page_geometry_equals_the_port():
    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    p = OCRPipeline.__new__(OCRPipeline)
    p.cfg = Config()
    p._min_bucket = 1
    for h, w in ((1448, 2048), (700, 500), (2000, 1000)):
        assert ref_pages.tile_grid(h, w, 768, 0.6) == p.tile_grid(h, w)
    for n in (1, 3, 12, 13, 17):
        assert [b for _, _, b in ref_pages.chunks(n, 8)] == p._chunk_sizes(n)


def test_peaks_equal_the_port():
    from findtextcenternet_tpu_torch.ops.peaks import extract_peaks
    g = torch.Generator().manual_seed(3)
    heat = torch.randn(3, 48, 48, 9, generator=g)
    feat = torch.randn(3, 48, 48, 8, generator=g)
    mask = torch.zeros(3, 48, 48)
    mask[:, 5:40, 3:44] = 1
    want = extract_peaks(heat, feat, max_peaks=100, threshold=0.4,
                         region_mask=mask > 0)
    got = ref_pages.peaks(heat, mask, 100, 0.4)
    for k in ("score", "w", "h", "codes", "valid"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["x"].int(), want["x"])
    assert torch.equal(got["y"].int(), want["y"])


def _transformer():
    from findtextcenternet_tpu_torch.models.transformer import (
        Transformer, TransformerDims)
    sd = weights.draw(ref_tf.param_specs(DIMS),
                      weights.generator(5, "cpu", "w"), "cpu",
                      ref_tf.sinusoid)
    m = Transformer(TransformerDims(**DIMS))
    m.load_state_dict(sd)
    g = torch.Generator().manual_seed(1)
    enc = torch.randn(3, 32, 106, generator=g)
    enc[1, 20:] = 0
    enc[2, 5:] = 0
    return sd, m, enc, g


def test_transformer_and_mask_predict_equal_the_port():
    from findtextcenternet_tpu_torch.models.transformer import mask_predict
    sd, m, enc, g = _transformer()
    dec = torch.randint(0, 1091, (3, 32), generator=g)
    m.eval()
    with torch.no_grad():
        want = m(enc, dec)
    got = ref_tf.forward(sd, DIMS, enc, dec, ref_tf.Math())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    codes, p = mask_predict(m, enc)
    rc, rp, _ = ref_tf.mask_predict(sd, DIMS, enc, MP, ref_tf.Math())
    assert torch.equal(codes.long(), rc)
    torch.testing.assert_close(p, rp)


def test_three_train_steps_equal_the_port():
    from findtextcenternet_tpu_torch.train.state import create_train_state
    from findtextcenternet_tpu_torch.train.steps import (
        transformer_train_step)
    sd, m, enc, g = _transformer()
    true = torch.randint(4, 5000, (3, 32), generator=g)
    true[:, 0] = 1
    din = torch.where(torch.rand(3, 32, generator=g) < 0.5, 3, true)
    batch = {"encoder_input": enc, "decoder_input": din,
             "decoder_true": true}
    state = create_train_state(m, 2.5e-3)
    params = {k: v.clone().requires_grad_(k not in ref_tf.frozen_keys(DIMS))
              for k, v in sd.items()}
    train = {k: v for k, v in params.items() if v.requires_grad}
    assert set(train) == set(state.optimizer.params)
    opt = ref_tf.ScheduleFreeRAdam(train, 2.5e-3)
    for _ in range(3):
        _, met = transformer_train_step(state, batch)
        loss = ref_tf.loss(params, DIMS, batch, ref_tf.Math())
        opt.step(train, dict(zip(train, torch.autograd.grad(
            loss, list(train.values())))))
        np.testing.assert_allclose(float(met["loss"]), float(loss.detach()),
                                   rtol=1e-6)
    for k, v in train.items():
        torch.testing.assert_close(state.optimizer.params[k].detach(),
                                   v.detach(), rtol=1e-5, atol=1e-7)
