"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where no CUDA
device is present. This file imports only torch, numpy and the port, so it
also runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: the NMS kernel computes the same compares and one expf per
pixel as the plain version (atol 1e-6). The attention kernels sum scores in
another order (64-key tiles, online softmax; the backward rebuilds the
softmax from the forward's log-sum-exp): f32 within atol 1e-4, rtol 1e-4;
bf16 outputs round to 8 bits and the plain version also rounds the softmax
weights to bf16, so atol 3e-2.
"""
import numpy as np
import pytest
import torch

from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.models.transformer import (
    MultiheadAttn, Transformer, TransformerDims, make_key_mask)
from findtextcenternet_tpu_torch.ops import attention, nms, peaks
from findtextcenternet_tpu_torch.train.state import create_train_state
from findtextcenternet_tpu_torch.train.steps import (
    batch_to_device, loss_and_grads, transformer_train_step)

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
    # plateaus: equal-valued 2x2 blocks, where >= keeps both ties
    x[:, 10:12, 10:12] = 4.0
    x[:, 0:2, 0:3] = 5.0
    m = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(m)


@pytest.mark.parametrize("shape", [(8, 192, 192), (3, 37, 50)])
def test_nms_kernel_matches_plain(cuda, shape):
    x, m = _nms_inputs(*shape, seed=0)
    want = nms.nms_sigmoid_masked_plain(x, m)
    before = nms.launches.count
    got = nms.nms_sigmoid_masked(x.to(cuda), m.to(cuda))
    torch.cuda.synchronize()
    assert nms.launches.count == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-6)


def test_nms_kernel_rejects_bad_inputs(cuda):
    x = torch.zeros((2, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        nms.nms_sigmoid_masked(x.half(), x.half())
    with pytest.raises(ValueError):
        nms.nms_sigmoid_masked(x.transpose(1, 2), x)


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


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 40, 48, 72, 128, 256])
def test_attention_kernel_small_heads_and_cross_shapes(cuda, hd):
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
