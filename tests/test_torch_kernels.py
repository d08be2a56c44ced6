"""The port's kernel modules (plain versions) against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

Tolerances: NMS atol 1e-6 (the same compares; sigmoid to an ulp or two).
Attention rtol/atol 1e-5 (f32 sums in another order; the scale is a
power of two, so dividing and multiplying agree exactly).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findtextcenternet_tpu.models.transformer import make_key_mask as jmask
from findtextcenternet_tpu.ops.attention import fused_attention as jattn
from findtextcenternet_tpu.ops.attention import supported as jsupported
from findtextcenternet_tpu.ops.pallas_kernels import nms_sigmoid_masked as jnms
from findtextcenternet_tpu_torch.models.transformer import (
    MultiheadAttn, make_key_mask)
from findtextcenternet_tpu_torch.ops import attention, kernels, nms


def _nms_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 40, 36)).astype(np.float32)
    x[0, 5:7, 5:8] = 3.0          # plateau: ties survive together
    x[1, 0:2, 0:2] = 4.0          # plateau at the border
    x[2] = np.round(x[2] * 2) / 2  # many exact ties
    m = (rng.uniform(size=x.shape) > 0.3).astype(np.float32)
    m[0, 5:7, 5:8] = 1.0
    return x, m


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_plain_matches_pallas(seed):
    x, m = _nms_inputs(seed)
    want = np.asarray(jnms(jnp.asarray(x), jnp.asarray(m), interpret=True))
    got = nms.nms_sigmoid_masked(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # both plateau cells of tile 0 survive (>= keeps ties)
    assert (got.numpy()[0, 5:7, 5:8] > 0).all()


def _attn_inputs(b, tq, tk, h, hd, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, hd)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, hd)).astype(np.float32)
    enc = np.ones((b, tk, 3), np.float32)
    for i, n in enumerate(lengths):
        enc[i, n:] = 0.0
    return q, k, v, enc


@pytest.mark.parametrize("tq,tk", [(16, 16), (24, 40)])
def test_attention_plain_matches_pallas(tq, tk):
    q, k, v, enc = _attn_inputs(3, tq, tk, 4, 16, [tk, tk - 5, 3], seed=tq)
    want = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jmask(jnp.asarray(enc)), interpret=True))
    got = attention.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        make_key_mask(torch.from_numpy(enc)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attention_all_masked_rows_are_nan_on_both_sides():
    q, k, v, enc = _attn_inputs(2, 16, 16, 2, 8, [16, 0], seed=3)
    want = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jmask(jnp.asarray(enc)), interpret=True))
    got = attention.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        make_key_mask(torch.from_numpy(enc))).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    nms.launches.reset()
    attention.launches.reset()
    x, m = _nms_inputs(2)
    nms.nms_sigmoid_masked(torch.from_numpy(x), torch.from_numpy(m))
    q = torch.zeros((1, 8, 2, 64))
    out = attention.fused_attention(q, q, q)
    assert out.shape == q.shape
    assert nms.launches.count == 0
    assert attention.launches.count == 0


@pytest.mark.parametrize("tq,tk,hd", [
    (400, 400, 64), (400, 400, 48), (400, 400, 24), (400, 400, 8),
    (400, 400, 72), (400, 400, 256), (400, 400, 44), (404, 400, 64),
    (400, 12, 64), (1024, 1024, 64), (1032, 1032, 64), (8, 8, 8)])
def test_fused_routing_rule_is_the_jax_rule(tq, tk, hd):
    assert attention.supported(tq, tk, hd) == jsupported(tq, tk, hd)


@pytest.mark.parametrize("hd,routed", [(24, True), (48, True), (64, True),
                                       (20, False)])
def test_multihead_attn_routes_every_jax_kernel_site(monkeypatch, hd,
                                                     routed):
    calls = []
    real = attention.fused_attention

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(attention, "fused_attention", spy)
    heads = 2
    attn = MultiheadAttn(heads * hd, heads, 16, attn_impl="fused").eval()
    x = torch.randn((2, 16, heads * hd), generator=torch.Generator()
                    .manual_seed(hd))
    enc = torch.ones((2, 16, 3))
    enc[1, 9:] = 0.0
    with torch.inference_mode():
        got = attn(x, key_mask=make_key_mask(enc))
        attn.attn_impl = "xla"
        want = attn(x, key_mask=make_key_mask(enc))
    assert bool(calls) == routed
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"


def test_kernel_library_is_named_by_its_headers_too(monkeypatch, tmp_path):
    """The build compiles only the ``.cu`` sources, but the library's hash
    covers the ``.cuh`` headers they include: an edited header rebuilds."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(kernels, "nvcc_version", lambda: "nvcc V12.8")
    assert {os.path.basename(p) for p in kernels.csrc_files(".cu")} == {
        "nms.cu", "attention.cu", "attention_bwd.cu", "gemm_tf32x3.cu"}
    before = kernels.library_path()
    assert kernels.library_path() == before
    header = csrc / "attention_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernels.library_path() != before
