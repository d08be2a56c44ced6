"""The port's CRT codec, Transformer and mask-predict against the JAX
package, on the same weights through ``io.from_jax``.

Tolerance for encoder outputs and decoder logits: atol/rtol 1e-5 (f32 on
both sides; matmul and LayerNorm sums run in another order). Decoded
codes must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findtextcenternet_tpu import crt as jcrt
from findtextcenternet_tpu.models import transformer as jt
from findtextcenternet_tpu_torch import crt
from findtextcenternet_tpu_torch.const import MAX_CODEPOINT, MODULO_LIST
from findtextcenternet_tpu_torch.io.from_jax import transformer_state_from_flax
from findtextcenternet_tpu_torch.models import transformer as tt

# dims as in tests/test_fused_attention.py
JDIMS = jt.TransformerDims(enc_input_dim=20, embed_dim=32, head_num=4,
                           enc_block_num=2, dec_block_num=2,
                           max_enc_seq_len=16, max_dec_seq_len=16)
TDIMS = tt.TransformerDims(**{f: getattr(JDIMS, f) for f in
                              JDIMS.__dataclass_fields__})


def test_crt_decode_bit_exact_over_codepoint_range():
    x = np.arange(MAX_CODEPOINT + 1, dtype=np.int64)
    res = crt.encode(x)
    np.testing.assert_array_equal(crt.decode(*res), x)
    tres = tuple(torch.from_numpy(r) for r in res)
    np.testing.assert_array_equal(crt.decode(*tres).numpy(), x)
    # arbitrary residue triples (most decode past the codepoint range)
    rng = np.random.default_rng(0)
    b = [rng.integers(0, m, 200000) for m in MODULO_LIST]
    want = np.asarray(jcrt.decode(*[jnp.asarray(a, jnp.int32) for a in b]))
    np.testing.assert_array_equal(crt.decode(*b), want)
    np.testing.assert_array_equal(
        crt.decode(*[torch.from_numpy(a) for a in b]).numpy(), want)
    np.testing.assert_array_equal(
        crt.decode_checked(*b, fill=-1),
        np.asarray(jcrt.decode_checked(*[jnp.asarray(a) for a in b],
                                       fill=-1)))


@pytest.fixture(scope="module")
def tiny_transformer():
    jm = jt.Transformer(JDIMS)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 20)),
                         jnp.zeros((1, 16), jnp.int32))
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = transformer_state_from_flax(v, TDIMS)
    return v, sd


def _port(sd, attn_impl="xla"):
    m = tt.Transformer(TDIMS, attn_impl=attn_impl).eval()
    m.load_state_dict(sd)
    return m


def _enc_input(seed):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((3, 16, 20)).astype(np.float32)
    enc[1, 9:] = 0.0         # padded tail rows
    enc[2, 4:] = 0.0
    return enc


def test_encoder_and_decoder_logits_match(tiny_transformer):
    v, sd = tiny_transformer
    enc = _enc_input(1)
    dec = np.random.default_rng(2).integers(0, 70000, (3, 16)).astype(
        np.int32)
    jm = jt.Transformer(JDIMS)
    jenc = jm.apply(v, jnp.asarray(enc), method=jt.Transformer.encode)
    jlog = jm.apply(v, jnp.asarray(enc), jnp.asarray(dec))
    m = _port(sd)
    with torch.no_grad():
        tenc = m.encode(torch.from_numpy(enc))
        tlog = m(torch.from_numpy(enc), torch.from_numpy(dec).long())
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=1e-5,
                               atol=1e-5)
    for t, j in zip(tlog, jlog):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_mask_predict_codes_equal(tiny_transformer, attn_impl):
    v, sd = tiny_transformer
    enc = _enc_input(3)
    jm = jt.Transformer(JDIMS, attn_impl=attn_impl)
    jc, jp = jt.mask_predict(jm, v, jnp.asarray(enc), max_rounds=3)
    tc, tp = tt.mask_predict(_port(sd, attn_impl), torch.from_numpy(enc),
                             max_rounds=3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)


def test_topk_descending_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(5)
    p = np.round(rng.random((3, 9, 257)).astype(np.float32) * 4) / 4
    wv, wi = jax.lax.top_k(jnp.asarray(p), 3)
    tv, ti = tt.topk_descending(torch.from_numpy(p), 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))


@pytest.mark.parametrize("topk", [1, 3])
def test_crt_combine_topk_matches_jax(topk):
    """Logits -> softmax -> the CRT product search: codes equal, the
    geometric-mean probabilities within f32 rounding; some positions favour
    residues that decode past MAX_CODEPOINT (scored 0)."""
    rng = np.random.default_rng(6 + topk)
    logits = [(rng.standard_normal((2, 7, m)) * 3).astype(np.float32)
              for m in MODULO_LIST]
    logits[0][0, 0, -1] = logits[1][0, 0, -1] = logits[2][0, 0, -1] = 30.0
    jc, jp = jt.crt_combine_topk([jnp.asarray(x) for x in logits], topk)
    tc, tp = tt.crt_combine_topk([torch.from_numpy(x) for x in logits],
                                 topk)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-7)


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError):
        tt.Transformer(TDIMS, attn_impl="flash")
    from findtextcenternet_tpu_torch.config import InferenceConfig
    with pytest.raises(ValueError):
        InferenceConfig(decode_attention="auto")


def test_set_attn_impl_reroutes_every_site():
    m = tt.Transformer(TDIMS)
    sites = [s for s in m.modules() if isinstance(s, tt.MultiheadAttn)]
    assert len(sites) == TDIMS.enc_block_num + 2 * TDIMS.dec_block_num
    m.set_attn_impl("fused")
    assert {s.attn_impl for s in sites} == {"fused"}
    with pytest.raises(ValueError):
        m.set_attn_impl("flash")
    assert {s.attn_impl for s in sites} == {"fused"}
