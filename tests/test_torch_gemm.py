"""The f32 dense products of ``ops.gemm`` (``csrc/gemm_tf32x3.cu``) and
``Dense``'s route to them.

On the CPU: the wrapper is ``F.linear`` to the bit, forward and backward;
its input checks raise on a wrong dtype, rank, inner size, contiguity or
device; the K-slice plan and the padded copies; ``Dense`` takes the
wrapper in f32 only.

On the card (marked ``gpu``, skipped without one): the kernel's forward,
input-gradient and weight-gradient products against an f64 product, at
the train step's and the decode's shapes. The error is the largest
``|C - C64|`` over the product of the two operand vectors' norms (the
bound of any f32 sum's rounding scales with it); the kernel's is at most
4x cuBLAS f32's at the same shape and at least 100x under one TF32 pass.
A live decode captured as CUDA graphs replays the kernel. This file
imports only torch and the port:

    python -m pytest --noconftest -m gpu tests/test_torch_gemm.py
"""
import pytest
import torch
import torch.nn.functional as F

from findtextcenternet_tpu_torch.models import transformer as tt
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.models.transformer import (
    DecodeGraphs, Dense, Transformer, TransformerDims, mask_predict)
from findtextcenternet_tpu_torch.ops import gemm
from findtextcenternet_tpu_torch.ops.kernels import LaunchCounter

# (M, N, K) of y = x . w^T: the train step's products at 32 x 400 rows (q/k/
# v/out, SwiGLU's w1/wg and w2, an output layer, the encoder's input), the
# served decode's largest output layer at 4 x 400 rows, and a ragged one
SHAPES = [(12800, 768, 768), (12800, 1536, 768), (12800, 768, 1536),
          (12800, 1091, 768), (12800, 768, 106), (1600, 1097, 768),
          (37, 768, 768)]
CPU_ROWS = 1600     # the CPU cases' rows: the route does not depend on them


def _operands(m, n, k, seed, device="cpu", bias=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(device)
    w = torch.randn(n, k, generator=g).to(device)
    b = torch.randn(n, generator=g).to(device) if bias else None
    return x, w, b


# -- the plain route ----------------------------------------------------------

@pytest.mark.parametrize("m,n,k", SHAPES)
def test_cpu_route_is_f_linear_to_the_bit(m, n, k):
    x, w, b = _operands(min(m, CPU_ROWS), n, k, seed=k)
    gy = torch.randn(x.shape[0], n, generator=torch.Generator().manual_seed(1))
    got, want = [], []
    for fn, out in ((gemm.linear, got), (F.linear, want)):
        xx, ww, bb = (t.clone().requires_grad_() for t in (x, w, b))
        y = fn(xx, ww, bb)
        y.backward(gy)
        out += [y.detach(), xx.grad, ww.grad, bb.grad]
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_cpu_tensors_count_no_launch():
    counters = (gemm.launches, gemm.dgrad_launches, gemm.wgrad_launches)
    before = [c.count for c in counters]
    x, w, b = _operands(5, 6, 7, seed=0)
    x.requires_grad_()
    gemm.linear(x[None], w, b).sum().backward()
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("change,err", [
    ("x_dtype", TypeError), ("w_dtype", TypeError), ("b_dtype", TypeError),
    ("w_rank", ValueError), ("inner", ValueError), ("bias_len", ValueError),
    ("x_strided", ValueError), ("device", ValueError)])
def test_checks_raise_on_what_the_kernel_does_not_take(change, err):
    x, w, b = _operands(8, 12, 16, seed=0)
    if change == "x_dtype":
        x = x.double()
    elif change == "w_dtype":
        w = w.half()
    elif change == "b_dtype":
        b = b.bfloat16()
    elif change == "w_rank":
        w = w[None]
    elif change == "inner":
        w = w[:, :15].contiguous()
    elif change == "bias_len":
        b = b[:11]
    elif change == "x_strided":
        x = x.t().contiguous().t()
    with pytest.raises(err):
        gemm._check(x, w, b)


def test_checks_pass_a_card_shaped_call_but_for_its_device():
    x, w, b = _operands(3, 12, 16, seed=0)
    with pytest.raises(ValueError, match="unsupported device"):
        gemm._check(x[None], w, b)


# -- the launch plan ---------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(12800, 768, 768), (12800, 1536, 768),
                                   (12800, 1091, 768), (1600, 1097, 768)])
def test_products_with_enough_tiles_take_one_slice(m, n, k):
    assert gemm.plan_splits(m, n, k, 132) == 1


@pytest.mark.parametrize("m,n,k", [(768, 768, 12800), (1536, 768, 12800),
                                   (768, 1536, 12800), (1091, 768, 12800),
                                   (768, 106, 12800), (768, 768, 37)])
def test_weight_gradients_cut_k_into_whole_slices(m, n, k):
    s = gemm.plan_splits(m, n, k, 132)
    nk = -(-k // gemm.KBLOCK)
    kps = -(-nk // s)
    assert 1 <= s <= gemm.MAX_SPLITS and -(-nk // kps) == s
    tiles = -(-m // gemm.TILE) * -(-n // gemm.TILE)
    if tiles * 2 <= 132 and nk >= 16:
        assert s > 1            # too few tiles to fill the card alone


def test_a_short_k_takes_one_slice():
    assert gemm.plan_splits(12800, 768, 106, 132) == 1
    assert gemm.plan_splits(5, 5, 1, 132) == 1


@pytest.mark.parametrize("width", [106, 1091, 1093, 1097, 768])
def test_padded_copies_keep_the_values(width):
    t = torch.randn(9, width)
    p = gemm._aligned(t)
    if width % 4 == 0:
        assert p is t
    else:
        assert p.shape == (9, width + (-width) % 4)
        assert p.stride(0) % 4 == 0 and p.data_ptr() % 16 == 0
        assert torch.equal(p[:, :width], t)


# -- Dense's route ------------------------------------------------------------

@pytest.mark.parametrize("dtype,routed", [(torch.float32, True),
                                          (torch.bfloat16, False)])
def test_dense_takes_the_wrapper_in_f32_only(monkeypatch, dtype, routed):
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return F.linear(*a, **k)
    monkeypatch.setattr(gemm, "linear", spy)
    d = Dense(16, 24, dtype=dtype)
    d(torch.randn(2, 3, 16))
    assert bool(calls) == routed


def test_dense_f32_is_f_linear_to_the_bit_on_the_cpu():
    d = Dense(16, 24)
    x = torch.randn(2, 3, 16)
    assert torch.equal(d(x), F.linear(x, d.weight, d.bias))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(c, ref, sa, sb) -> float:
    return ((c.double() - ref).abs() / (sa[:, None] * sb[None, :])).max().item()


def _product(kind, m, n, k, dev):
    """(kernel call, cuBLAS call, f64 result, row norms of the two sides)
    of the forward, input-gradient or weight-gradient product of a
    ``Dense`` (m rows, n outputs, k inputs)."""
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = torch.randn(m, k, device=dev, generator=g)
    w = torch.randn(n, k, device=dev, generator=g)
    gy = torch.randn(m, n, device=dev, generator=g)
    b = torch.randn(n, device=dev, generator=g)
    xd, wd, gd = x.double(), w.double(), gy.double()
    if kind == "forward":
        return (lambda: gemm.linear_fwd(x, w, b), lambda: F.linear(x, w, b),
                xd @ wd.t() + b.double(), xd.norm(dim=1), wd.norm(dim=1))
    if kind == "input_grad":
        return (lambda: gemm.linear_dgrad(gy, w), lambda: gy @ w, gd @ wd,
                gd.norm(dim=1), wd.norm(dim=0))
    return (lambda: gemm.linear_wgrad(gy, x), lambda: gy.t() @ x,
            gd.t() @ xd, gd.norm(dim=0), xd.norm(dim=0))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["forward", "input_grad", "weight_grad"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_kernel_error_against_f64(cuda, kind, m, n, k):
    ker, lib, ref, sa, sb = _product(kind, m, n, k, cuda)
    counter = {"forward": gemm.launches, "input_grad": gemm.dgrad_launches,
               "weight_grad": gemm.wgrad_launches}[kind]
    before = counter.count
    got = ker()
    torch.cuda.synchronize()
    assert counter.count == before + 1
    err = _err(got, ref, sa, sb)
    err_f32 = _err(lib(), ref, sa, sb)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err_tf32 = _err(lib(), ref, sa, sb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert err <= 4 * err_f32, (err, err_f32)
    assert err * 100 <= err_tf32, (err, err_tf32)


@pytest.mark.gpu
def test_autograd_launches_the_kernel_for_both_gradients(cuda):
    x, w, b = _operands(300, 130, 70, seed=3, device=cuda)
    counters = (gemm.launches, gemm.dgrad_launches, gemm.wgrad_launches)
    before = [c.count for c in counters]
    xx, ww, bb = (t.clone().requires_grad_() for t in (x, w, b))
    y = gemm.linear(xx[None], ww, bb)
    gy = torch.randn_like(y)
    y.backward(gy)
    assert [c.count - n for c, n in zip(counters, before)] == [1, 1, 1]
    xr, wr, br = (t.double().requires_grad_() for t in (x, w, b))
    F.linear(xr[None], wr, br).backward(gy.double())
    for got, want in ((y[0], x.double() @ w.double().t() + b.double()),
                      (xx.grad, xr.grad), (ww.grad, wr.grad),
                      (bb.grad, br.grad)):
        torch.testing.assert_close(got.double(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_decode_graphs_replay_the_kernel(cuda):
    dims = TransformerDims(embed_dim=64, head_num=4, enc_block_num=1,
                           dec_block_num=1, max_enc_seq_len=24,
                           max_dec_seq_len=24)
    model = init_flax_defaults_(Transformer(dims),
                                torch.Generator().manual_seed(0)).to(cuda)
    model.eval()
    enc = torch.randn(2, 24, dims.enc_input_dim,
                      generator=torch.Generator().manual_seed(1)).to(cuda)
    graphs = DecodeGraphs(LaunchCounter("captures"), LaunchCounter("replays"),
                          LaunchCounter("eager_rounds"))
    with torch.inference_mode():
        eager = mask_predict(model, enc, max_rounds=2)
        for _ in range(2):
            before = gemm.launches.count
            got = mask_predict(model, enc, max_rounds=2, graphs=graphs)
            torch.cuda.synchronize()
            assert gemm.launches.count > before
    assert graphs.captures.count == 1 and graphs.eager_rounds.count == 0
    assert graphs.replays.count >= 2
    for a, c in zip(got, eager):
        assert torch.equal(a, c)
    # a replay adds what its graph launched: the encode graph's Dense
    # calls, and each round's decoder
    slot = graphs._free[next(iter(graphs._free))][0]
    assert all(n > 0 for n in
               (launches[tt.DecodeSlot.COUNTERS.index(gemm.launches)]
                for launches in slot._launches[:2]))
