"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where no CUDA
device is present. This file imports only torch, numpy and the port, so it
also runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: the NMS kernel computes the same compares and one expf per
peak as the plain version (atol 1e-6). The attention kernels sum scores in
another order (key tiles, online softmax; the backward rebuilds the
softmax from the forward's log-sum-exp) and multiply on the tensor cores in
split tf32: f32 within atol 1e-4, rtol 1e-4;
bf16 outputs round to 8 bits and the plain version also rounds the softmax
weights to bf16, so atol 3e-2. Detector training on the card against its
CPU run: f32 with TF32 off, convolution sums in another order, atol/rtol
1e-4.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from findtextcenternet_tpu_torch.config import Config
from findtextcenternet_tpu_torch.infer.pipeline import FeatureStream, OCRPipeline
from findtextcenternet_tpu_torch.models.batchnorm import (
    BatchNorm1d, BatchNorm2d)
from findtextcenternet_tpu_torch.models.detector import topk_fmask
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.models.transformer import (
    MultiheadAttn, Transformer, TransformerDims, make_key_mask)
from findtextcenternet_tpu_torch.ops import attention, nms, peaks
from findtextcenternet_tpu_torch.train.state import create_train_state
from findtextcenternet_tpu_torch.train.steps import (
    _detector_micro, batch_to_device, detector_batch_to_device,
    detector_train_step, loss_and_grads, transformer_train_step)
from findtextcenternet_tpu_torch.train.train1 import build_detector_state

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _nms_inputs(b, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w)).astype(np.float32)
    # plateaus: equal-valued 2x2 blocks, where >= keeps both ties, inside
    # and on all four borders
    x[:, 10:12, 10:12] = 4.0
    x[:, 0:2, 0:3] = 5.0
    x[:, -2:, -3:] = 4.5
    m = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(m)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data pointer is 4 bytes past a
    16-byte boundary (the kernel's element-by-element path)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape,aligned", [
    ((8, 192, 192), True), ((4, 192, 192), True), ((2, 64, 64), True),
    ((3, 37, 50), True), ((1, 5, 7), True), ((2, 64, 64), False),
    ((1, 2, 1024), True)])
def test_nms_kernel_matches_plain(cuda, shape, aligned):
    """Row bands of 4 (heights 37, 5 and 2 end in a short band), widths not
    a multiple of 4 (50, 7) and a misaligned pointer (element loads), the
    widest map the kernel takes; two launches agree bit for bit and each
    counts once."""
    x, m = _nms_inputs(*shape, seed=0)
    want = nms.nms_sigmoid_masked_plain(x, m)
    xc, mc = x.to(cuda), m.to(cuda)
    if not aligned:
        xc, mc = _misaligned(xc), _misaligned(mc)
        assert xc.data_ptr() % 16 and xc.is_contiguous()
    before = nms.launches.count
    got = nms.nms_sigmoid_masked(xc, mc)
    again = nms.nms_sigmoid_masked(xc, mc)
    torch.cuda.synchronize()
    assert nms.launches.count == before + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-6)
    assert (got.cpu().numpy()[:, 0:2, 0:3] > 0).any()


def test_nms_kernel_rejects_bad_inputs(cuda):
    x = torch.zeros((2, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        nms.nms_sigmoid_masked(x.half(), x.half())
    with pytest.raises(ValueError):
        nms.nms_sigmoid_masked(x.transpose(1, 2), x)
    with pytest.raises(ValueError):
        nms.nms_sigmoid_masked(x, x[:, :8])
    wide = torch.zeros((1, 2, nms.MAX_WIDTH + 4), device=cuda)
    with pytest.raises(ValueError):
        nms.nms_sigmoid_masked(wide, wide)


def _tiny_pipelines(cuda):
    """(default path, host path) port pipelines on the card sharing one
    tiny f32 detector and one small Transformer's weights."""
    import dataclasses

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)

    # the tiny detector in f32, as the CPU tests run it
    det = init_flax_defaults_(CenterNetDetection("tiny"),
                              torch.Generator().manual_seed(0))
    det = det.to(cuda).eval()
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, model_size="tiny"),
        transformer=dataclasses.replace(
            cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=24, max_dec_seq_len=24),
        inference=dataclasses.replace(cfg.inference, tile_size=256,
                                      detector_batch=2,
                                      max_peaks_per_tile=64),
        mask_predict=dataclasses.replace(cfg.mask_predict, max_rounds=2))
    dev = OCRPipeline(cfg, model_size="tiny", detector_apply=det,
                      device=cuda)
    host = OCRPipeline(
        dataclasses.replace(cfg, inference=dataclasses.replace(
            cfg.inference, fused_page_merge=False, device_features=False)),
        transformer_state=dev.transformer.state_dict(), model_size="tiny",
        detector_apply=det, device=cuda)
    return dev, host


def test_device_path_equals_host_path_on_card(cuda):
    dev, host = _tiny_pipelines(cuda)
    rng = np.random.default_rng(1)
    gray = np.full((420, 610, 3), 255, np.uint8)
    for i in range(7):
        x = 40 + 80 * i
        gray[60:95, x:x + 35] = int(rng.integers(0, 40))
        gray[200:240, x:x + 40] = int(rng.integers(0, 40))
    color = gray.copy()
    color[..., 2] = np.clip(color[..., 2].astype(int) + 7, 0,
                            255).astype(np.uint8)
    for img, twopass in ((gray, False), (color, False), (gray, True)):
        a = dev.run_detector(img, twopass=twopass)
        b = host.run_detector(img, twopass=twopass)
        assert len(a.locations), "an empty page proves nothing"
        np.testing.assert_array_equal(a.locations, b.locations)
        np.testing.assert_array_equal(np.asarray(a.features), b.features)
        np.testing.assert_array_equal(a.lines, b.lines)
        np.testing.assert_array_equal(a.seps, b.seps)
    dev.feature_gathers.reset()
    assert dev(gray) == host(gray)
    assert dev.feature_gathers.count > 0 and dev.mosaic_merges.count > 0


def _attn_inputs(b, tq, tk, h, hd, dtype, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((b, t, h, hd)).astype(np.float32)).to(dtype)
        for t in (tq, tk, tk))
    enc = torch.ones((b, tk, 2))
    for i, n in enumerate(lengths or []):
        enc[i, n:] = 0.0          # tail rows masked, as make_key_mask does
    return q, k, v, make_key_mask(enc)


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 3e-2, 0.0)])
def test_attention_kernel_matches_plain_at_decode_shape(cuda, dtype, atol,
                                                        rtol):
    q, k, v, mask = _attn_inputs(4, 400, 400, 12, 64, dtype, seed=1,
                                 lengths=[400, 250, 64, 0])
    want = attention.attention_plain(q.to(cuda), k.to(cuda), v.to(cuda),
                                     mask.to(cuda))
    before = attention.launches.count
    got = attention.fused_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                    mask.to(cuda))
    torch.cuda.synchronize()
    assert attention.launches.count == before + 1
    assert got.dtype == dtype
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    # window 3 is fully masked: NaN on both sides
    assert np.isnan(got[3]).all() and np.isnan(want[3]).all()
    np.testing.assert_allclose(got[:3], want[:3], atol=atol, rtol=rtol)


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 40, 48, 72, 128, 256, 13, 30])
def test_attention_kernel_small_heads_and_cross_shapes(cuda, hd):
    """Tq != Tk; hd 13 and 30 (hd % 4 != 0) take 4-byte copies."""
    q, k, v, mask = _attn_inputs(3, 24, 40, 4, hd, torch.float32, seed=2,
                                 lengths=[40, 17, 1])
    want = attention.attention_plain(q, k, v, mask)
    got = attention.fused_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                    mask.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_attention_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    wide = torch.zeros((1, 8, 2, attention.MAX_HEAD_DIM + 8), device=cuda)
    with pytest.raises(ValueError):
        attention.fused_attention(wide, wide, wide)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q[:, :0], q[:, :0])
    with pytest.raises(TypeError):
        attention.fused_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        attention.fused_attention(q.transpose(1, 2), q, q)


@pytest.mark.parametrize("hd", [24, 48])
def test_multihead_attn_on_card_launches_kernel_at_routed_widths(cuda, hd):
    heads = 2
    attn = MultiheadAttn(heads * hd, heads, 16, attn_impl="fused").eval()
    x = torch.randn((2, 16, heads * hd),
                    generator=torch.Generator().manual_seed(hd))
    enc = torch.ones((2, 16, 3))
    enc[1, 9:] = 0.0
    with torch.inference_mode():
        want = attn(x, key_mask=make_key_mask(enc))
        before = attention.launches.count
        got = attn.to(cuda)(x.to(cuda), key_mask=make_key_mask(enc.to(cuda)))
        torch.cuda.synchronize()
    assert attention.launches.count == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_extract_peaks_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    heat = torch.from_numpy(
        rng.standard_normal((2, 48, 48, 9)).astype(np.float32))
    feats = torch.from_numpy(
        rng.standard_normal((2, 48, 48, 5)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(2, 48, 48)) > 0.2)
    before = nms.launches.count
    got = peaks.extract_peaks(heat.to(cuda), feats.to(cuda), max_peaks=64,
                              region_mask=mask.to(cuda))
    want = peaks.extract_peaks(heat, feats, max_peaks=64, region_mask=mask)
    assert nms.launches.count == before + 1
    for key in ("x", "y", "valid"):
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      want[key].numpy())
    np.testing.assert_allclose(got["score"].cpu().numpy(),
                               want["score"].numpy(), atol=1e-6)


@pytest.mark.parametrize("hd", [8, 24, 64, 256])
def test_attention_bwd_kernel_matches_plain(cuda, hd):
    """Ragged lengths (Tq 72, Tk 100: partial tiles), tail key masks, and a
    fully masked window (NaN on both sides); masked keys get exact-zero
    gradients."""
    q, k, v, mask = _attn_inputs(4, 72, 100, 3, hd, torch.float32, seed=hd,
                                 lengths=[100, 37, 1, 0])
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(hd))
    want = attention.attention_bwd_plain(q, k, v, mask, g)
    qc, kc, vc, mc, gc = (t.to(cuda) for t in (q, k, v, mask, g))
    out, lse = attention.attention_fwd(qc, kc, vc, mc, with_lse=True)
    before = attention.bwd_launches.count
    got = attention.attention_bwd(qc, kc, vc, mc, out, lse, gc)
    torch.cuda.synchronize()
    assert attention.bwd_launches.count == before + 1
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.cpu().numpy(), w.numpy()
        assert np.isnan(a[3]).all() and np.isnan(w[3]).all(), name
        np.testing.assert_allclose(a[:3], w[:3], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    dk, dv = got[1].cpu(), got[2].cpu()
    assert (dk[1, 37:] == 0).all() and (dv[1, 37:] == 0).all()
    assert (dk[2, 1:] == 0).all() and (dv[2, 1:] == 0).all()


def _gap_mask(b, tk, gaps):
    """Additive (B,1,1,Tk) key mask with the key ranges ``gaps[i]`` of
    window i masked (whole 64-key tiles and parts of tiles)."""
    enc = torch.ones((b, tk, 2))
    for i, ranges in enumerate(gaps):
        for lo, hi in ranges:
            enc[i, lo:hi] = 0.0
    return make_key_mask(enc)


# window 0: whole tiles masked at the head, in the middle and at the tail;
# window 1: a partial head tile, a whole middle tile, keys past one tile
# boundary; window 2: one key left; window 3: fully masked
_GAPS = [[(0, 64), (128, 192), (256, 300)], [(0, 40), (64, 128), (250, 300)],
         [(0, 199), (200, 300)], [(0, 300)]]


@pytest.mark.parametrize("hd", [8, 24, 64, 72, 128, 256])
def test_attention_kernels_skip_masked_tiles_exactly(cuda, hd):
    """Forward (with its log-sum-exp) and backward against the plain
    versions where whole key tiles are masked at the head, in the middle
    and at the tail, Tk = 300 (not a multiple of 64) and Tq = 100 != Tk.
    Masked keys take exact-zero gradients; the fully masked window is NaN
    (lse -inf) on both sides."""
    rng = np.random.default_rng(hd)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (4, t, 3, hd)).astype(np.float32)) for t in (100, 300, 300, 100))
    mask = _gap_mask(4, 300, _GAPS)
    want = attention.attention_plain(q, k, v, mask)
    want_lse = torch.logsumexp(
        torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd) + mask, dim=-1)
    want_grads = attention.attention_bwd_plain(q, k, v, mask, g)
    qc, kc, vc, mc, gc = (x.to(cuda) for x in (q, k, v, mask, g))
    out, lse = attention.attention_fwd(qc, kc, vc, mc, with_lse=True)
    got_grads = attention.attention_bwd(qc, kc, vc, mc, out, lse, gc)
    torch.cuda.synchronize()
    out, lse = out.cpu().numpy(), lse.cpu().numpy()
    assert np.isnan(out[3]).all() and np.isnan(want[3].numpy()).all()
    assert (lse[3] == -np.inf).all()
    np.testing.assert_allclose(out[:3], want[:3].numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(lse[:3], want_lse[:3].numpy(), atol=1e-4,
                               rtol=1e-4)
    for name, a, w in zip(("dq", "dk", "dv"), got_grads, want_grads):
        a, w = a.cpu().numpy(), w.numpy()
        assert np.isnan(a[3]).all() and np.isnan(w[3]).all(), name
        np.testing.assert_allclose(a[:3], w[:3], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    masked = (mask[:3, 0, 0] == -np.inf).numpy()
    for a in got_grads[1:]:
        assert (a[:3].cpu().numpy()[masked] == 0).all()


@pytest.mark.parametrize("hd", [13, 30])
def test_attention_fwd_bf16_head_width_not_a_multiple_of_16_bytes(cuda, hd):
    """bf16 with hd % 8 != 0: the kernel loads one element at a time;
    Tq 150 > Tk 70."""
    q, k, v, mask = _attn_inputs(3, 150, 70, 2, hd, torch.bfloat16, seed=hd,
                                 lengths=[70, 65, 3])
    want = attention.attention_plain(q, k, v, mask)
    got = attention.fused_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                    mask.to(cuda))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), atol=3e-2)


def test_attention_fwd_bf16_with_masked_tiles_at_decode_shape(cuda):
    q, k, v, _ = _attn_inputs(4, 400, 400, 12, 64, torch.bfloat16, seed=7)
    mask = _gap_mask(4, 400, [[(0, 64), (128, 192)], [(300, 400)],
                              [(0, 399)], [(0, 400)]])
    want = attention.attention_plain(q, k, v, mask).float().numpy()
    got = attention.fused_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                    mask.to(cuda)).float().cpu().numpy()
    assert np.isnan(got[3]).all() and np.isnan(want[3]).all()
    np.testing.assert_allclose(got[:3], want[:3], atol=3e-2)


def test_attention_bwd_kernel_is_bit_identical_run_to_run(cuda):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v, mask = _attn_inputs(4, 400, 400, 12, 64, torch.float32, seed=8,
                                 lengths=[400, 311, 57, 200])
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(8))
    qc, kc, vc, mc, gc = (x.to(cuda) for x in (q, k, v, mask, g))
    out, lse = attention.attention_fwd(qc, kc, vc, mc, with_lse=True)
    first = attention.attention_bwd(qc, kc, vc, mc, out, lse, gc)
    second = attention.attention_bwd(qc, kc, vc, mc, out, lse, gc)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_attention_autograd_on_card_launches_both_kernels(cuda):
    q, k, v, mask = _attn_inputs(2, 40, 24, 2, 16, torch.float32, seed=5,
                                 lengths=[24, 9])
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(6))

    def grads(fn, dev):
        ts = [t.detach().clone().to(dev).requires_grad_()
              for t in (q, k, v)]
        out = fn(*ts, mask.to(dev))
        assert out.grad_fn is not None
        torch.sum(out * w.to(dev)).backward()
        return [t.grad.cpu().numpy() for t in ts]

    want = grads(attention.attention_plain, "cpu")
    f0, b0 = attention.launches.count, attention.bwd_launches.count
    got = grads(attention.fused_attention, cuda)
    assert attention.launches.count == f0 + 1
    assert attention.bwd_launches.count == b0 + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_attention_bwd_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(TypeError):
        attention.fused_attention(q, q, q)
    x = torch.zeros((1, 8, 2, 64), device=cuda)
    out, lse = attention.attention_fwd(x, x, x, with_lse=True)
    with pytest.raises(TypeError):
        attention.attention_bwd(x.half(), x.half(), x.half(), None, out, lse,
                                x)
    with pytest.raises(ValueError):
        attention.attention_bwd(x, x, x, None, out, None, x)


@pytest.mark.parametrize("hd", [24, 64])
def test_multihead_attn_fused_training_grads_equal_xla(cuda, hd):
    """Train mode through the kernels gives the einsum route's gradients
    for every projection and the input."""
    heads = 2
    attn = MultiheadAttn(heads * hd, heads, 16, attn_impl="fused").to(cuda)
    attn.train()
    gen = torch.Generator().manual_seed(hd)
    x = torch.randn((2, 16, heads * hd), generator=gen).to(cuda)
    w = torch.randn((2, 16, heads * hd), generator=gen).to(cuda)
    enc = torch.ones((2, 16, 3))
    enc[1, 9:] = 0.0
    mask = make_key_mask(enc.to(cuda))
    grads = {}
    for impl in ("fused", "xla"):
        attn.attn_impl = impl
        attn.zero_grad()
        xi = x.clone().requires_grad_()
        before = attention.bwd_launches.count
        torch.sum(attn(xi, key_mask=mask) * w).backward()
        assert attention.bwd_launches.count == before + (impl == "fused")
        grads[impl] = {n: p.grad.cpu().numpy()
                       for n, p in attn.named_parameters()
                       if p.grad is not None}
        grads[impl]["input"] = xi.grad.cpu().numpy()
    assert set(grads["fused"]) == set(grads["xla"])
    assert {"q_proj.weight", "k_proj.weight", "v_proj.weight",
            "input"} <= set(grads["fused"])
    for n, g in grads["xla"].items():
        np.testing.assert_allclose(grads["fused"][n], g, atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_train_step_on_card_fused_equals_xla(cuda):
    """Two train steps of a small Transformer on the card: the fused route
    (attention kernels forward and backward at every site) against the
    einsum route, from the same weights. The first batch's gradients agree
    tensor by tensor within 1e-5 of the gradient's norm."""
    dims = TransformerDims(enc_input_dim=20, embed_dim=64, head_num=4,
                           enc_block_num=2, dec_block_num=2,
                           max_enc_seq_len=24, max_dec_seq_len=24)
    base = init_flax_defaults_(Transformer(dims),
                               torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        enc = rng.standard_normal((3, 24, 20)).astype(np.float32)
        enc[1, 13:] = 0.0
        true = rng.integers(4, 70000, (3, 24)).astype(np.int32)
        inp = np.where(rng.uniform(size=true.shape) < 0.5, 3, true)
        batches.append({"encoder_input": enc, "decoder_input": inp,
                        "decoder_true": true})
    results = {}
    for impl in ("fused", "xla"):
        model = Transformer(dims, attn_impl=impl)
        model.load_state_dict(base.state_dict())
        state = create_train_state(model.to(cuda), 2.5e-3)
        grads, _ = loss_and_grads(state, batch_to_device(batches[0], cuda))
        attention.launches.reset()
        attention.bwd_launches.reset()
        losses = []
        for b in batches:
            state, m = transformer_train_step(state, b)
            losses.append(float(m["loss"]))
        sites = dims.enc_block_num + 2 * dims.dec_block_num
        want = 2 * sites if impl == "fused" else 0
        assert attention.launches.count == want
        assert attention.bwd_launches.count == want
        results[impl] = (losses, {k: v.cpu().numpy()
                                  for k, v in model.state_dict().items()},
                         grads)
    for k, g in results["xla"][2].items():
        diff = float(torch.linalg.vector_norm(results["fused"][2][k] - g))
        norm = float(torch.linalg.vector_norm(g))
        assert norm > 0 and diff <= 1e-5 * norm, (k, diff, norm)
    np.testing.assert_allclose(results["fused"][0], results["xla"][0],
                               atol=1e-4, rtol=1e-4)
    for k, v in results["xla"][1].items():
        np.testing.assert_allclose(results["fused"][1][k], v, atol=1e-4,
                                   rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------
# detector training and bucketed decode
# ---------------------------------------------------------------------

def _tiny_detector_config():
    cfg = Config()
    return dataclasses.replace(
        cfg, detector=dataclasses.replace(
            cfg.detector, model_size="tiny", feature_dim=8,
            decoder_mid_dim=32, image_size=(64, 64),
            fmask_topk_per_sample=8),
        train=dataclasses.replace(cfg.train, learning_rate=1e-3,
                                  warmup_steps=2))


def _detector_batch(seed, n=4):
    from findtextcenternet_tpu_torch.data.targets import make_target_maps
    rng = np.random.default_rng(seed)
    labels, ids = [], []
    for _ in range(n):
        k = int(rng.integers(2, 6))
        pos = np.stack([rng.uniform(8, 56, k), rng.uniform(8, 56, k),
                        rng.uniform(6, 20, k), rng.uniform(6, 20, k)], 1)
        codes = np.stack([rng.integers(0x20, 0x3000, k),
                          rng.integers(0, 16, k)], 1)
        keysize, idmap, _ = make_target_maps(
            pos.astype(np.float32), codes.astype(np.int32), (16, 16))
        lines = (rng.uniform(size=(16, 16, 2)) > 0.7).astype(np.float32)
        labels.append(np.concatenate([keysize, lines], -1))
        ids.append(idmap)
    return {"image": rng.uniform(0, 1, (n, 64, 64, 3)).astype(np.float32),
            "labelmap": np.stack(labels).astype(np.float32),
            "idmap": np.stack(ids).astype(np.int32)}


def test_detector_train_step_on_card_equals_cpu(cuda):
    """The tiny detector's first micro-step (drop path on, its masks drawn
    from the same seeded CPU generator): gradients, the BN buffers after
    it and the CoV statistics; then three optimizer steps (accum 1, 1, 2):
    every loss term, on the card as on the CPU, f32."""
    cfg = _tiny_detector_config()
    states = {}
    for dev in ("cpu", cuda):
        _, st = build_detector_state(cfg, seed=0, device=dev)
        st.compute_dtype = torch.float32
        states[str(dev)] = st
    cpu, gpu = states["cpu"], states["cuda"]
    batch = _detector_batch(0)
    g = {}
    for name, st in states.items():
        st.model.train()
        mb = detector_batch_to_device(batch, next(st.model.parameters()
                                                  ).device)
        g[name], _ = _detector_micro(st, mb, 8, 1.0, seed=7)
    for k, want in g["cpu"].items():
        np.testing.assert_allclose(g["cuda"][k].cpu().numpy(),
                                   want.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    for k, want in cpu.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                gpu.model.state_dict()[k].cpu().numpy(), want.numpy(),
                atol=1e-4, rtol=1e-4, err_msg=k)
    for f in ("mean_L", "mean_l", "S_l"):
        np.testing.assert_allclose(getattr(gpu.cov, f).cpu().numpy(),
                                   getattr(cpu.cov, f).numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f)
    for i, accum in enumerate((1, 1, 2)):
        b = _detector_batch(1 + i)
        _, mc = detector_train_step(cpu, b, fmask_k=8, accum_steps=accum)
        _, mg = detector_train_step(gpu, b, fmask_k=8, accum_steps=accum)
        for k, want in mc.items():
            np.testing.assert_allclose(float(mg[k]), float(want), atol=1e-4,
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert gpu.step == cpu.step == 3


def _stage2_data(root):
    """Tiny stage-2 inputs painted with numpy (no fonts): two shards of
    ``.npy`` samples and a fixdata directory of PNG pages with their line
    maps and box JSONs."""
    from PIL import Image

    from findtextcenternet_tpu_torch.data.shards import ShardWriter

    rng = np.random.default_rng(9)

    def page(h=256, w=192, n=12):
        img = np.full((h, w), 230, np.uint8)
        pos = np.stack([rng.uniform(20, w - 20, n), rng.uniform(20, h - 20, n),
                        rng.uniform(8, 24, n), rng.uniform(8, 24, n)], 1)
        for x, y, bw, bh in pos.astype(int):
            img[y - bh // 2:y + bh // 2, x - bw // 2:x + bw // 2] = 40
        line = np.zeros((h // 2, w // 2), np.uint8)
        line[20:30, 10:80] = 255
        codes = np.stack([rng.integers(0x3041, 0x3097, n),
                          rng.integers(0, 16, n)], 1)
        return img, line, pos.astype(np.float32), codes.astype(np.int32)

    with ShardWriter(str(root / "t%03d.tar"), samples_per_shard=3) as wr:
        for i in range(6):
            img, line, pos, codes = page()
            wr.write({"__key__": f"s{i}", "image.npy": img,
                      "textline.npy": line,
                      "sepline.npy": np.zeros_like(line),
                      "position.npy": pos, "code_list.npy": codes})
        shards = list(wr.paths)
    fix = root / "fix"
    fix.mkdir()
    for i in range(2):
        img, line, pos, codes = page()
        Image.fromarray(img).save(fix / f"p{i}.png")
        Image.fromarray(line).save(fix / f"p{i}.png.lines.png")
        boxes = [{"cx": float(x), "cy": float(y), "w": float(w),
                  "h": float(h), "text": chr(int(c)),
                  "p_code1": float(f & 1), "p_code8": float(f >> 3 & 1)}
                 for (x, y, w, h), (c, f) in zip(pos, codes)]
        (fix / f"p{i}.json").write_text(json.dumps({"textbox": boxes}))
    return shards, str(fix)


def test_stage2_iteration_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """One stage-2 iteration of ``train2.train`` (a streamed step at weight
    0.5, a fixdata step at 2.0) from one stage-1 checkpoint on the same
    loaders' batches: the tiny detector's final state on the card equals
    the CPU's, f32."""
    from findtextcenternet_tpu_torch.train import train2
    from findtextcenternet_tpu_torch.train.checkpoint import save_checkpoint

    cfg = _tiny_detector_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, epochs=1, log_every=1))
    shards, fix = _stage2_data(tmp_path)
    _, st = build_detector_state(cfg, seed=0, device="cpu")
    stage1 = str(tmp_path / "result1")
    save_checkpoint(stage1, st, cfg)
    real = train2.build_detector_state

    def f32_state(*a, **kw):
        model, state = real(*a, **kw)
        state.compute_dtype = torch.float32
        return model, state

    monkeypatch.setattr(train2, "build_detector_state", f32_state)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark",
                        torch.backends.cudnn.benchmark)
    finals = []
    for i, dev in enumerate(("cpu", cuda)):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(tmp_path / f"run{i}")))
        state = train2.train(fix, shards=shards, config=c, init_from=stage1,
                             steps_per_epoch=1, weight_fix=2.0,
                             weight_stream=0.5, num_workers=1, device=dev)
        assert state.step == 2 and state.optimizer.count == 2
        finals.append({k: v.detach().cpu() for k, v in
                       state.model.state_dict().items()})
    for k, want in finals[0].items():
        np.testing.assert_allclose(finals[1][k].numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_topk_fmask_tie_order_on_card(cuda):
    """A batch-32 GT keymap at the training size, mostly exact zeros and
    plateaus: the card selects the indices the CPU does, lower index first
    among ties (numpy's stable argsort as the reference)."""
    rng = np.random.default_rng(0)
    keymap = np.zeros((32, 192, 192), np.float32)
    idx = rng.integers(0, keymap.size, 5000)
    keymap.reshape(-1)[idx] = rng.integers(1, 5, len(idx)) / 4.0
    want = np.argsort(-keymap.reshape(-1), kind="stable")[:32 * 1024]
    got_cpu = topk_fmask(torch.from_numpy(keymap), 1024).numpy()
    got_gpu = topk_fmask(torch.from_numpy(keymap).to(cuda), 1024).cpu()
    np.testing.assert_array_equal(got_cpu, want)
    np.testing.assert_array_equal(got_gpu.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_running_variance_fixup_on_card(cuda, dtype):
    """The card's BatchNorm with the fix-up: the running variance moves
    towards the biased batch variance, in 2-d and 1-d, on f32 input and on
    bf16 input under autocast (a convolution's output there)."""
    gen = torch.Generator().manual_seed(0)
    for bn, x in ((BatchNorm2d(16, eps=1e-3), torch.randn(
            (4, 16, 24, 24), generator=gen) * 2 + 1),
                  (BatchNorm1d(64, eps=1e-5), torch.randn(
            (256, 64), generator=gen) * 3 - 1)):
        bn = bn.to(cuda).train()
        bn.running_var.fill_(2.0)
        xc = x.to(cuda, dtype)
        with torch.autocast("cuda", dtype=dtype,
                            enabled=dtype != torch.float32):
            bn(xc)
        xs = xc.float()
        dims = [d for d in range(xs.dim()) if d != 1]
        var = xs.var(dim=dims, unbiased=False)
        mean = xs.mean(dim=dims)
        torch.testing.assert_close(bn.running_var, 0.9 * 2.0 + 0.1 * var,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(bn.running_mean, 0.1 * mean,
                                   rtol=1e-5, atol=1e-5)


def test_bucketed_decode_on_card_equals_cpu(cuda):
    """decode_len_buckets (8, 12, 24) with the fused route: windows at
    lengths 8 and 24 reach the attention kernel, those at 12 (not a
    multiple of 8) the einsum path; the texts equal the CPU run's, on the
    host stream and on the default path's FeatureStream (glyph features
    on the card in f16, gathered per (bucket, s_len) inside the decode)."""
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, transformer=dataclasses.replace(
            cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=24, max_dec_seq_len=24),
        inference=dataclasses.replace(
            cfg.inference, decode_attention="fused",
            decode_len_buckets=(8, 12, 24)),
        mask_predict=dataclasses.replace(cfg.mask_predict, max_rounds=3))
    rng = np.random.default_rng(7)
    # f16 values, so the device buffer holds what the host stream does
    feats = rng.standard_normal((60, 106)).astype(np.float16)
    feats = feats.astype(np.float32)
    feats[:, -6:] = 0.0
    stream = feats.copy().view(FeatureStream)
    stream[:, :100] = 0.0
    stream.glyph_idx = np.arange(len(feats), dtype=np.int64)
    stream.glyph_dev = torch.from_numpy(
        feats[:, :100].astype(np.float16)).to(cuda)
    groups = {8: [(0, 0, 3, 0), (0, 3, 7, 0)], 12: [(0, 7, 15, 0)],
              24: [(0, 15, 37, 0), (0, 37, 59, 0)]}
    cpu = OCRPipeline(cfg, model_size="tiny", device="cpu")
    gpu = OCRPipeline(cfg, transformer_state=cpu.transformer.state_dict(),
                      model_size="tiny", device=cuda)
    for s_len, windows in groups.items():
        want = cpu.decode_windows(feats, windows)
        for src in (feats, stream):
            before = attention.launches.count
            got = gpu.decode_windows(src, windows)
            launched = attention.launches.count - before
            assert (launched > 0) == (s_len % 8 == 0), (s_len, launched)
            assert got == want, s_len
    windows = [w for ws in groups.values() for w in ws]
    want = cpu.decode_windows(feats, windows)
    assert gpu.decode_windows(feats, windows) == want
    gpu.feature_gathers.reset()
    assert gpu.decode_windows(stream, windows) == want
    assert gpu.feature_gathers.count >= 1

def test_from_torch_checkpoints_on_card_equals_cpu(cuda, tmp_path):
    """A tiny ``model.pt`` / ``model3.pt`` served on the card and on the
    CPU: the same tensors load on both, and with the detector in f32 (its
    bf16 weights cast back, the same values on both sides) the page gives
    the same boxes (to the convolutions' summation order) and texts."""
    from findtextcenternet_tpu_torch.infer import run_ocr
    from findtextcenternet_tpu_torch.io.torch_export import \
        save_torch_checkpoint
    from findtextcenternet_tpu_torch.models.detector import TextDetectorModel

    cfg = run_ocr.build_pipeline("tiny", random_weights=True,
                                 device="cpu").cfg
    gen = torch.Generator().manual_seed(11)
    det = init_flax_defaults_(TextDetectorModel(
        "tiny", cfg.detector.feature_dim, cfg.detector.decoder_mid_dim), gen)
    t = cfg.transformer
    tf = init_flax_defaults_(Transformer(TransformerDims(
        t.enc_input_dim, t.embed_dim, t.head_num, t.enc_block_num,
        t.dec_block_num, t.max_enc_seq_len, t.max_dec_seq_len)), gen)
    model_pt, model3_pt = str(tmp_path / "model.pt"), str(tmp_path /
                                                          "model3.pt")
    save_torch_checkpoint(model_pt, det.state_dict())
    save_torch_checkpoint(model3_pt, tf.state_dict())
    pipes = {d: run_ocr.build_pipeline("tiny", model_pt, model3_pt, device=d)
             for d in ("cpu", cuda)}
    for name in ("detector", "transformer", "simple_decoder"):
        a = getattr(pipes["cpu"], name).state_dict()
        b = getattr(pipes[cuda], name).state_dict()
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k].cpu()) for k in a), name
    rng = np.random.default_rng(4)
    img = rng.integers(150, 256, (300, 500, 3)).astype(np.uint8)
    for i in range(6):
        img[100:140, 40 + 70 * i:80 + 70 * i] = rng.integers(0, 60,
                                                             (40, 40, 3))
    out = {}
    for d, p in pipes.items():
        p.detector.float()
        out[d] = (p.run_detector(img), p(img))
    (dcpu, want), (dgpu, got) = out["cpu"], out[cuda]
    assert len(dcpu.locations) > 0
    assert dgpu.locations.shape == dcpu.locations.shape
    np.testing.assert_allclose(dgpu.locations, dcpu.locations, atol=1e-3,
                               rtol=1e-4)
    assert got["text"] == want["text"]


def test_native_rasterizer_builds_on_the_card_machine(cuda):
    """The page factory's glyph engine builds from ``native/rasterizer/src``
    into the port's build directory and loads (fonts are not needed for
    that: a path that is no font opens as null)."""
    from findtextcenternet_tpu_torch.factory import rasterizer
    from findtextcenternet_tpu_torch.infer import native

    path = rasterizer.build_native_rasterizer()
    assert path.startswith(native.BUILD_DIR)
    lib = rasterizer._load_rast_lib()
    assert lib.rast_open(b"/nonexistent.ttf", 32.0, 0, 0, 0) is None


# ---------------------------------------------------------------------------
# deployment artifacts (ONNX evaluator, MIL mapping, torch.export)
# ---------------------------------------------------------------------------

def _seed11_models():
    """The tiny CLI config and the seed-11 weights of
    ``test_from_torch_checkpoints_on_card_equals_cpu`` (a page on which
    their peaks are clear of the card's summation noise)."""
    from findtextcenternet_tpu_torch.infer import run_ocr
    from findtextcenternet_tpu_torch.models.detector import TextDetectorModel

    cfg = run_ocr.build_pipeline("tiny", random_weights=True,
                                 device="cpu").cfg
    gen = torch.Generator().manual_seed(11)
    det = init_flax_defaults_(TextDetectorModel(
        "tiny", cfg.detector.feature_dim, cfg.detector.decoder_mid_dim),
        gen).detector.eval()
    t = cfg.transformer
    dims = TransformerDims(t.enc_input_dim, t.embed_dim, t.head_num,
                           t.enc_block_num, t.dec_block_num,
                           t.max_enc_seq_len, t.max_dec_seq_len)
    tf = init_flax_defaults_(Transformer(dims), gen).eval()
    return cfg, det, tf, dims


def _seed11_page():
    rng = np.random.default_rng(4)
    img = rng.integers(150, 256, (300, 500, 3)).astype(np.uint8)
    for i in range(6):
        img[100:140, 40 + 70 * i:80 + 70 * i] = rng.integers(0, 60,
                                                             (40, 40, 3))
    return img


def _graph_feeds(name, dims, rng):
    if name.startswith("detector"):
        return {"image": rng.random((2, 3, 64, 64)).astype(np.float32)}
    L = dims.max_enc_seq_len
    enc = rng.standard_normal((3, L, dims.enc_input_dim)).astype(np.float32)
    enc[0, 10:] = 0.0
    km = make_key_mask(torch.from_numpy(enc)).numpy()
    if name == "encoder":
        return {"encoder_input": enc, "key_mask": km}
    return {"encoder_output": rng.standard_normal(
                (3, L, dims.embed_dim)).astype(np.float32),
            "decoder_input": rng.integers(
                0, 5000, (3, dims.max_dec_seq_len)).astype(np.int64),
            "key_mask": km}


def _assert_maps_close(got, want, atol, rtol):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = ~torch.isneginf(want)
    torch.testing.assert_close(got[fin], want[fin], atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", ["detector", "detector_fp16", "encoder",
                                  "decoder"])
def test_onnx_evaluator_and_mil_on_card_match_cpu(cuda, name):
    """The evaluator and the MIL backend on the card against the evaluator
    on the CPU (cuDNN / cuBLAS f32 with TF32 off against the CPU's kernels:
    atol/rtol 1e-4); every output stays on the card."""
    from findtextcenternet_tpu_torch.export import onnx_models
    from findtextcenternet_tpu_torch.export.coreml_models import (
        MilSession, run_mapped)
    from findtextcenternet_tpu_torch.export.onnx_writer import OnnxEvaluator

    _, det, tf, dims = _seed11_models()
    blob = {"detector": lambda: onnx_models.emit_detector(
                det, "tiny", 64, 64, 8),
            "detector_fp16": lambda: onnx_models.emit_detector(
                det, "tiny", 64, 64, 8, half=True),
            "encoder": lambda: onnx_models.emit_transformer_encoder(tf,
                                                                    dims),
            "decoder": lambda: onnx_models.emit_transformer_decoder(
                tf, dims)}[name]()
    feeds = _graph_feeds(name, dims, np.random.default_rng(0))
    want = OnnxEvaluator(blob, "cpu")(**feeds)
    for got in (OnnxEvaluator(blob, cuda)(**feeds),
                run_mapped(blob, feeds, cuda),
                MilSession(blob, cuda)(**feeds)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cuda"
            _assert_maps_close(got[k], want[k], atol=1e-4, rtol=1e-4)


def test_qdq_graph_on_card_matches_cpu_node_by_node(cuda):
    """The static-int8 detector op by op: each node on the card, given the
    CPU evaluator's values of its inputs, against the CPU node; the
    QuantizeLinear integers equal (a whole-graph comparison would let a
    1e-7 difference cross a rounding boundary and move one step)."""
    from findtextcenternet_tpu_torch.export import onnx_models, quantize
    from findtextcenternet_tpu_torch.export.onnx_writer import (
        OnnxEvaluator, to_tensor)

    _, det, _, _ = _seed11_models()
    rng = np.random.default_rng(1)
    ranges = quantize.calibrate_detector_edges(
        det, [rng.random((1, 64, 64, 3)).astype(np.float32)])
    blob = onnx_models.emit_detector_qdq(det, ranges, "tiny", 64, 64, 8)
    cpu, gpu = OnnxEvaluator(blob, "cpu"), OnnxEvaluator(blob, cuda)
    env = {k: to_tensor(v, "cpu") for k, v in _graph_feeds(
        "detector", None, rng).items()}
    quantized = 0
    for node in cpu.m["nodes"]:
        args = [(env[n] if n in env else cpu.inits[n]) if n else None
                for n in node["inputs"]]
        gargs = [None if a is None else a.to(cuda) for a in args]
        want = cpu.run_node(node, args)[0]
        got = gpu.run_node(node, gargs)[0]
        env[node["outputs"][0]] = want
        assert got.dtype == want.dtype, node["op"]
        if node["op"] == "QuantizeLinear" or not want.is_floating_point():
            assert torch.equal(got.cpu(), want), node["op"]
            quantized += node["op"] == "QuantizeLinear"
        else:
            _assert_maps_close(got, want, atol=1e-4, rtol=1e-4)
    assert quantized >= 8


def test_from_onnx_page_on_card_equals_cpu(cuda):
    from findtextcenternet_tpu_torch.export import onnx_models
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    from findtextcenternet_tpu_torch.ops import nms

    cfg, det, tf, dims = _seed11_models()
    ts = cfg.inference.tile_size
    blobs = (onnx_models.emit_detector(det, "tiny", ts, ts,
                                       cfg.detector.feature_dim),
             onnx_models.emit_transformer_encoder(tf, dims),
             onnx_models.emit_transformer_decoder(tf, dims))
    img = _seed11_page()
    out = {}
    for d in ("cpu", cuda):
        pipe = OCRPipeline.from_onnx(*blobs, cfg, "tiny", device=d)
        nms.launches.reset()
        out[d] = (pipe.run_detector(img), pipe(img), nms.launches.count)
    (dcpu, want, n_cpu), (dgpu, got, n_gpu) = out["cpu"], out[cuda]
    assert len(dcpu.locations) > 0 and n_cpu == 0 and n_gpu > 0
    assert dgpu.locations.shape == dcpu.locations.shape
    np.testing.assert_allclose(dgpu.locations, dcpu.locations, atol=1e-3,
                               rtol=1e-4)
    assert got["text"] == want["text"]


def test_exported_program_loads_onto_the_card(cuda, tmp_path):
    """Programs exported on the CPU load onto the card and compute there,
    against the CPU programs at atol/rtol 1e-4."""
    from findtextcenternet_tpu_torch.export import export

    _, det, tf, dims = _seed11_models()
    d_det = export.export_detector(str(tmp_path / "det"), det, tile=64)
    d_enc = export.export_transformer_encoder(str(tmp_path / "enc"), tf)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((3, 64, 64, 3)).astype(np.float32))
    enc = torch.from_numpy(_graph_feeds("encoder", dims, rng)[
        "encoder_input"])
    for path, args in ((d_det, (x,)), (d_enc, (enc,))):
        prog_cpu, meta = export.load_exported(path, "cpu")
        prog_gpu, _ = export.load_exported(path, cuda)
        with torch.inference_mode():
            want = prog_cpu(*args)
            got = prog_gpu(*[a.to(cuda) for a in args])
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            _assert_maps_close(g, w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------
# the mesh under NCCL (a world of 1: NCCL refuses two ranks on one card;
# its groups of one rank are active, so every collective runs under NCCL)
# ---------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda):
    """A world-1 NCCL process group (``parallel.init_distributed``) and its
    ``make_mesh`` mesh; the group is destroyed after the test."""
    import socket

    import torch.distributed as dist

    from findtextcenternet_tpu_torch.parallel import make_mesh
    from findtextcenternet_tpu_torch.parallel.distributed import (
        init_distributed)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, always=True)
    assert dist.get_backend() == "nccl"
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.bool])
def test_mesh_collectives_on_card(nccl_mesh, dtype):
    """Every collective of the seam runs under NCCL on card tensors of the
    paths' dtypes and, on a world of 1, gives back its input."""
    from findtextcenternet_tpu_torch.parallel import collectives as coll

    g, m = nccl_mesh.data_group, nccl_mesh.model_group
    assert coll.active(g) and coll.active(m)
    x = (torch.randn((8, 6, 5), device="cuda") * 50).to(dtype)
    outs = [coll.all_reduce_(x.clone(), g), coll.all_gather(x, g, 1),
            coll.reduce_scatter(x, g, 2), coll.broadcast_(x.clone(), 0, m),
            coll.broadcast_batch({"x": x}, "cuda")["x"],
            # a strided tensor (NCCL refuses one where gloo takes it)
            coll.all_reduce_(x.transpose(0, 2).clone(), g).transpose(0, 2)]
    if dtype != torch.bfloat16:                 # numpy has no bf16
        outs.append(coll.broadcast_batch({"x": x.cpu().numpy()},
                                         "cuda")["x"])
    for y in outs:
        assert y.device.type == "cuda" and torch.equal(y, x)
    if dtype.is_floating_point:
        xg = x.detach().requires_grad_()
        y = coll.reduce_from_group(coll.copy_to_group(xg, m), m)
        y = coll.all_reduce_sum(coll.gather_from_group(y, m, -1), g)
        w = torch.randn(x.shape, device="cuda").to(dtype)
        (gx,) = torch.autograd.grad((y * w).sum(), xg)
        assert torch.equal(y, x) and torch.equal(gx, w)


def test_mesh_detector_step_on_card_equals_plain(nccl_mesh):
    """The tiny detector's mesh step (its BatchNorms on the sync path, the
    top-k selection and loss counts over the data group) equals the plain
    step on the card, f32 at atol/rtol 1e-4 (the sync BatchNorm sums in
    another order than cuDNN's kernel)."""
    cfg = _tiny_detector_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, learning_rate=1e-3, warmup_steps=1))
    out = {}
    for name, mesh in (("plain", None), ("mesh", nccl_mesh)):
        _, st = build_detector_state(cfg, mesh, seed=0, device="cuda")
        st.compute_dtype = torch.float32
        before = {n: p.detach().clone() for n, p in
                  st.optimizer.params.items()}
        metrics = []
        for i in range(2):
            _, m = detector_train_step(st, _detector_batch(i), fmask_k=8)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = (metrics, {n: p.detach() - before[n] for n, p in
                               st.optimizer.params.items()},
                     {k: v.clone() for k, v in st.model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))})
    for got, want in zip(out["mesh"][0], out["plain"][0]):
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    # the update of the two steps (the second at lr 1e-3), not the
    # weights: within 1 % of its norm (missing: 100 %, reversed: 200 %)
    upd = {k: torch.cat([u.reshape(-1) for u in v[1].values()])
           for k, v in out.items()}
    norm = float(upd["plain"].norm())
    assert norm > 0.0
    assert float((upd["mesh"] - upd["plain"]).norm()) <= 1e-2 * norm
    for k, w in out["plain"][2].items():
        np.testing.assert_allclose(out["mesh"][2][k].cpu().numpy(),
                                   w.cpu().numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_mesh_train3_step_on_card_equals_plain(nccl_mesh):
    """A small Transformer's ZeRO-1 mesh step through the attention kernels
    leaves the parameters bit-equal to the plain step's."""
    import dataclasses

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.train.train3 import (
        build_transformer_state)

    cfg = Config()
    cfg = dataclasses.replace(
        cfg, transformer=dataclasses.replace(
            cfg.transformer, enc_input_dim=20, embed_dim=64, head_num=4,
            enc_block_num=1, dec_block_num=1, max_enc_seq_len=24,
            max_dec_seq_len=24),
        train=dataclasses.replace(cfg.train, zero1=True))
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((4, 24, 20)).astype(np.float32)
    true = rng.integers(4, 70000, (4, 24)).astype(np.int32)
    batch = {"encoder_input": enc, "decoder_input":
             np.where(rng.uniform(size=true.shape) < 0.5, 3, true),
             "decoder_true": true}
    out = {}
    for name, mesh in (("plain", None), ("mesh", nccl_mesh)):
        _, state = build_transformer_state(cfg, mesh, seed=0, device="cuda")
        attention.launches.reset()
        attention.bwd_launches.reset()
        state, m = transformer_train_step(state, batch)
        assert attention.launches.count > 0
        assert attention.bwd_launches.count > 0
        out[name] = (float(m["loss"]), {n: p.detach().clone() for n, p in
                                        state.optimizer.params.items()})
    assert out["mesh"][0] == out["plain"][0]
    for n, p in out["plain"][1].items():
        assert torch.equal(out["mesh"][1][n], p), n


def test_mesh_page_on_card_equals_host_path(nccl_mesh):
    """The tiny page through ``OCRPipeline(mesh=...)`` equals the host
    path's, with the NMS kernel launched once a chunk."""
    import dataclasses

    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline

    _, host = _tiny_pipelines(torch.device("cuda"))
    mesh = OCRPipeline(dataclasses.replace(
        host.cfg, inference=dataclasses.replace(
            host.cfg.inference, fused_page_merge=True,
            device_features=True)),
        transformer_state=host.transformer.state_dict(), model_size="tiny",
        detector_apply=host._apply_fn, device="cuda", mesh=nccl_mesh)
    assert not mesh._lazy_features and not mesh._fused_merge
    rng = np.random.default_rng(1)
    img = np.full((420, 610, 3), 255, np.uint8)
    for i in range(7):
        img[60:95, 40 + 80 * i:75 + 80 * i] = int(rng.integers(0, 40))
    want = host(img)
    nms.launches.reset()
    got = mesh(img)
    n_chunks = len(mesh._chunk_sizes(len(mesh.tile_grid(*img.shape[:2])[2])))
    assert nms.launches.count == n_chunks
    assert want["box"], "an empty page proves nothing"
    assert got == want


# ---------------------------------------------------------------------
# tools/: each tool's route on the card at a small size
# ---------------------------------------------------------------------

def test_fused_attn_check_on_card(cuda):
    """The kernel check holds the attention kernel to the einsum within
    1e-4; the decode check's fused route launches it and decodes the
    einsum route's texts."""
    from findtextcenternet_tpu_torch.tools import fused_attn_check
    k = fused_attn_check.kernel_check(2, 64, 4, 64, device=cuda)
    assert k["within_1e-4"] and k["nan_pattern_match"]
    d = fused_attn_check.decode_check(batch=2, device=cuda, tiny=True)
    assert d["fused_kernel_launches"] > 0
    assert d["texts_agree"]


def test_decode_bench_on_card(cuda):
    from findtextcenternet_tpu_torch.tools import decode_bench
    res = decode_bench.run(decode_bench.TINY_DIMS, batch=2, rounds=2,
                           iters=1, device=cuda, moduli=(7, 11, 13))
    for name in ("f32", "bf16"):
        assert res[f"{name}_fused_attn_launches"] > 0
        assert res[f"{name}_paths_agree"]
        assert res[f"{name}_hoisted_ms"] > 0
    assert res["f32_fused_attn_codes_agree"]
    # the kernel's flops are added from its shapes: both routes count alike
    assert res["f32_fused_attn_tflop"] == res["f32_hoisted_tflop"]
    assert res["topk3_impls_agree"]


def test_train_bench_on_card(cuda, capsys):
    from findtextcenternet_tpu_torch.tools import train_bench
    assert train_bench.main(["--transformer", "--tiny", "--batch", "4",
                             "--iters", "2", "--attn-impl", "fused"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["attention_fwd_launches_per_step"] > 0
    assert out["attention_bwd_launches_per_step"] > 0
    assert np.isfinite(out["loss"]) and "nvidia_smi" in out
    assert train_bench.main(["--model-size", "tiny", "--image", "64",
                             "--batch", "4", "--accum", "2", "--iters", "1",
                             "--head-conv-dim", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["keymap_loss"]) and out["peak_share"] > 0


def test_trained_margin_check_on_card(cuda, tmp_path):
    """A few training steps through the attention kernels (forward and
    backward) and the decode of both routes on the trained weights."""
    from findtextcenternet_tpu_torch.tools import trained_margin_check
    out = trained_margin_check.run(trained_margin_check.parse_args([
        "--embed", "32", "--seq", "16", "--batch", "8", "--steps", "3",
        "--epochs", "1", "--windows", "4", "--hira-only", "--ckpt-dir",
        str(tmp_path / "ck"), "--device", "cuda"]))
    assert out["train_attention_bwd_launches"] > 0
    assert out["trained"]["fused_kernel_launches"] > 0
    assert out["random_init"]["fused_kernel_launches"] > 0


def test_annotate_on_card_equals_cpu(cuda, tmp_path):
    """process_image1 / process_image4 with the tiny model on the card (the
    NMS kernel) against the same weights on the CPU: the same boxes within
    1e-3 (the detector computes in bf16 on both, with other conv sums) and
    the same box list. On a page of one tile (the same crop in both
    tilings) the vectors at the detected centers equal the f16 features
    run_detector returns there."""
    from PIL import Image

    from findtextcenternet_tpu_torch.infer.run_ocr import build_pipeline
    from findtextcenternet_tpu_torch.tools import annotate
    cpu = build_pipeline("tiny", random_weights=True, device="cpu")
    gpu = build_pipeline("tiny", random_weights=True, device=cuda)
    rng = np.random.default_rng(0)
    img = rng.integers(150, 256, (256, 448, 3)).astype(np.uint8)
    for i in range(5):
        img[90:130, 30 + 80 * i:70 + 80 * i] = rng.integers(0, 60,
                                                            (40, 40, 3))
    out = {}
    for name, pipe in (("cpu", cpu), ("gpu", gpu)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "page.png")
        Image.fromarray(img).save(path)
        nms.launches.reset()
        first = annotate.process_image1(pipe, path)
        launched = nms.launches.count
        annotate.process_image4(pipe, path)
        with open(path + ".json", encoding="utf-8") as f:
            out[name] = (first, json.load(f), launched)
    assert out["gpu"][2] > 0 and out["cpu"][2] == 0
    want, got = out["cpu"][0]["textbox"], out["gpu"][0]["textbox"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("cx", "cy", "w", "h"):
            assert abs(g[k] - w[k]) <= 1e-3 * max(1.0, abs(w[k])), k
    assert out["gpu"][1]["boxlist"] == out["cpu"][1]["boxlist"]
    one_tile = np.ascontiguousarray(img[:, :256])
    page = gpu.run_detector(one_tile)
    # a center at x or y 0 is owned by no tile of the reference's tiling
    inside = (page.locations[:, 1] > 0) & (page.locations[:, 2] > 0)
    assert inside.any()
    feats = annotate._features_at_centers(
        gpu, one_tile, page.locations[inside, 1:3].astype(np.float32))
    np.testing.assert_allclose(
        feats.astype(np.float16).astype(np.float32),
        np.asarray(page.features, np.float32)[inside], atol=1e-3,
        rtol=1e-3)


def test_tf_import_round_trip_on_card(cuda):
    from findtextcenternet_tpu_torch.io import tf_import
    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)
    det = CenterNetDetection("tiny", feature_dim=8, head_conv_dim=8).to(cuda)
    rng = np.random.default_rng(0)
    npz = {k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in tf_import.export_backbone_npz(det, "tiny").items()}
    tf_import.load_backbone_npz(det, npz, "tiny")
    assert det.backbone.features[0][0].weight.is_cuda
    back = tf_import.export_backbone_npz(det, "tiny")
    for k, v in npz.items():
        np.testing.assert_array_equal(back[k], v)
