"""The port's ``OCRPipeline(mesh=...)`` over 2 spawned gloo ranks on the
CPU against the JAX package's sharded pipeline
(``tests/test_sharded_inference.py``) on a 2-device data mesh.

The tiny config of ``test_sharded_inference`` (tile 256, detector batch 8,
64 peaks a tile, a 32-wide 4-head 1+1-block Transformer at 24 tokens, 2
mask-predict rounds) with f32 maps; both sides run the same f32 tiny
detector through their ``detector_apply`` hooks and the same Transformer
weights (the JAX package's init, carried by ``io.from_jax``), on noisy
pages that yield boxes, on the xla and the fused decode routes. The
ranks' texts (``text``, ``aozora``) must equal JAX's and the boxes'
centres agree within atol 1e-3, as ``test_sharded_inference`` holds
JAX's sharded pipeline against its single-device one; both ranks return
the same page. ``detector_batch=3`` does not divide over 2 data ranks and
raises ``ValueError``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.infer import native
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline, ocr_pages
from findtextcenternet_tpu_torch.models.detector import CenterNetDetection
from findtextcenternet_tpu_torch.parallel import Mesh

ROUTES = ("xla", "fused")
SEEDS = (0, 1)


def _fields(decode_attention="xla", detector_batch=8):
    return dict(
        detector={"model_size": "tiny"},
        transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                     "dec_block_num": 1, "max_enc_seq_len": 24,
                     "max_dec_seq_len": 24},
        inference=dict(tile_size=256, detector_batch=detector_batch,
                       max_peaks_per_tile=64, quantize_maps=False,
                       decode_attention=decode_attention),
        mask_predict={"max_rounds": 2})


def _config(mod, **kw):
    cfg = mod.Config()
    return dataclasses.replace(cfg, **{
        s: dataclasses.replace(getattr(cfg, s), **f)
        for s, f in _fields(**kw).items()})


def _page(seed):
    """A noisy page with dark glyph blocks (``test_torch_pipeline``'s)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(150, 256, (300, 500, 3)).astype(np.uint8)
    for i in range(6):
        x = 40 + 70 * i
        img[100:140, x:x + 40] = rng.integers(0, 60, (40, 40, 3))
    return img


def _rank_main(rank, world, path):
    torch.set_num_threads(1)
    from findtextcenternet_tpu_torch.parallel import make_mesh
    from findtextcenternet_tpu_torch.parallel.distributed import (
        init_distributed)
    init_distributed(f"file://{path}/init", world, rank, device="cpu")
    try:
        weights = torch.load(os.path.join(path, "weights.pt"))
        det = CenterNetDetection("tiny").eval()
        det.load_state_dict(weights["detector"])
        mesh = make_mesh()
        for route in ROUTES:
            pipe = OCRPipeline(_config(tconfig, decode_attention=route),
                               transformer_state=weights["transformer"],
                               model_size="tiny", detector_apply=det,
                               device="cpu", mesh=mesh)
            assert pipe._min_bucket == world and not pipe._lazy_features
            with torch.inference_mode():
                outs = ocr_pages(pipe, [_page(s) for s in SEEDS])
            torch.save(outs, os.path.join(path, f"{route}{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jax_pages(tmp_path_factory):
    """JAX's sharded pipeline's pages per route, and the weights file the
    ranks load."""
    import jax
    import jax.numpy as jnp

    from findtextcenternet_tpu import config as jconfig
    from findtextcenternet_tpu.infer import hostops as jhostops
    from findtextcenternet_tpu.infer import lineengine as jlineengine
    from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipe
    from findtextcenternet_tpu.models.detector import (
        CenterNetDetection as JDet)
    from findtextcenternet_tpu.models.transformer import Transformer as JTf
    from findtextcenternet_tpu.models.transformer import TransformerDims
    from findtextcenternet_tpu.parallel import make_mesh
    from findtextcenternet_tpu_torch.io.from_jax import (
        detector_state_from_flax, transformer_state_from_flax)

    # the JAX bindings load the port's builds of the same native sources
    saved = [(m, m.LIB_PATH, m._lib) for m in (jlineengine, jhostops)]
    jlineengine.LIB_PATH = native.build("lineengine")
    jhostops.LIB_PATH = native.build("hostops")
    jlineengine._lib = jhostops._lib = None
    try:
        key = jax.random.PRNGKey(0)
        jdet = JDet("tiny")
        dvars = jax.jit(jdet.init)(key, jnp.zeros((1, 256, 256, 3)))
        t = _config(jconfig).transformer
        dims = TransformerDims(
            enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
            head_num=t.head_num, enc_block_num=t.enc_block_num,
            dec_block_num=t.dec_block_num,
            max_enc_seq_len=t.max_enc_seq_len,
            max_dec_seq_len=t.max_dec_seq_len)
        tvars = jax.jit(JTf(dims).init)(
            key, jnp.zeros((1, 24, t.enc_input_dim)),
            jnp.zeros((1, 24), jnp.int32))
        mesh = make_mesh(n_data=2, n_model=1)
        pages = {}
        for route in ROUTES:
            jpipe = JPipe(_config(jconfig, decode_attention=route),
                          detector_variables=dvars,
                          transformer_variables=tvars, model_size="tiny",
                          detector_apply=jdet.apply, mesh=mesh)
            assert jpipe._min_bucket == 2
            pages[route] = [jpipe(_page(s)) for s in SEEDS]
    finally:
        for m, p, lib in saved:
            m.LIB_PATH, m._lib = p, lib
    npv = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    path = str(tmp_path_factory.mktemp("mesh_pipeline"))
    torch.save({"detector": detector_state_from_flax(npv(dvars), "tiny"),
                "transformer": transformer_state_from_flax(npv(tvars),
                                                           dims)},
               os.path.join(path, "weights.pt"))
    return pages, path


@pytest.fixture(scope="module")
def rank_pages(jax_pages):
    _, path = jax_pages
    native.build("lineengine")          # built once, before the ranks
    native.build("hostops")
    mp.spawn(_rank_main, args=(2, path), nprocs=2, join=True)
    return {route: [torch.load(os.path.join(path, f"{route}{r}.pt"))
                    for r in range(2)] for route in ROUTES}


@pytest.mark.parametrize("route", ROUTES)
def test_mesh_pipeline_matches_jax_sharded(jax_pages, rank_pages, route):
    want_pages = jax_pages[0][route]
    rank0, rank1 = rank_pages[route]
    assert rank0 == rank1
    for got, want in zip(rank0, want_pages):
        assert want["box"], "the page must yield boxes"
        assert got["text"] == want["text"]
        assert got["aozora"] == want["aozora"]
        assert len(got["box"]) == len(want["box"])
        for a, b in zip(got["box"], want["box"]):
            np.testing.assert_allclose(a["cx"], b["cx"], atol=1e-3)
            np.testing.assert_allclose(a["cy"], b["cy"], atol=1e-3)


def test_mesh_batch_divisibility_check():
    bad = _config(tconfig, detector_batch=3)
    with pytest.raises(ValueError, match="divisible"):
        OCRPipeline(bad, model_size="tiny", device="cpu", mesh=Mesh(2, 1))
    ok = OCRPipeline(_config(tconfig, detector_batch=4), model_size="tiny",
                     device="cpu", mesh=Mesh(2, 1))
    assert ok._min_bucket == 2 and ok._chunk_sizes(5) == [4, 2]
    assert not ok._fused_merge and not ok._lazy_features
