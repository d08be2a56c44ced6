"""The port's ``ZmqLoader`` (``findtextcenternet_tpu_torch/data/zmq_loader``)
against the JAX package's, on the CPU.

The round trip and the four-reader backpressure bound of
``tests/test_zmq_handwriting.py``, and the same samples, as a multiset,
as the JAX package's ``ZmqLoader`` on the same shards (readers take the
same shards and seeds, so even their random draws agree). The port's
readers start with ``spawn``, so their ``process_fn`` s are module-level
functions of this file (which imports no JAX at the top).
"""
import pickle
import time

import numpy as np
import pytest

from findtextcenternet_tpu_torch.data.shards import ShardWriter
from findtextcenternet_tpu_torch.data.zmq_loader import _EOF, ZmqLoader

zmq = pytest.importorskip("zmq")


def _write_shards(tmp_path, n_samples, per_shard, hw):
    with ShardWriter(str(tmp_path / "s%03d.tar"), per_shard) as w:
        for i in range(n_samples):
            w.write({
                "__key__": f"k{i}",
                "image.png": np.zeros((hw, hw), np.uint8),
                "textline.png": np.zeros((hw // 2, hw // 2), np.uint8),
                "sepline.png": np.zeros((hw // 2, hw // 2), np.uint8),
                "position.npy": np.array([[hw / 2, hw / 2, hw / 8, hw / 8]],
                                         np.float32),
                "code_list.npy": np.array([[65 + i, 0]], np.int32),
            })
        return list(w.paths)


def position_shape(sample, rng):
    return {"key": sample["position"].shape}


def one(sample, rng):
    return {"n": 1}


def keyed_draw(sample, rng):
    """The sample's key and code, and one draw of the reader's rng."""
    return {"key": sample["__key__"],
            "code": int(sample["code_list"][0, 0]),
            "u": float(rng.uniform())}


def test_zmq_loader_roundtrip(tmp_path):
    paths = _write_shards(tmp_path, 6, 3, 128)
    got = list(ZmqLoader(paths, num_workers=2, process_fn=position_shape))
    assert len(got) == 6
    assert all(g["key"] == (1, 4) for g in got)


def test_zmq_backpressure_four_readers(tmp_path):
    """Readers pause under a slow consumer: after a stall, the backlog
    drained without publishing is bounded by the window (each reader at
    most consumed/N + 2 ahead plus one in flight), not the whole stream;
    every sample still arrives after."""
    n_samples, n_workers = 120, 4
    paths = _write_shards(tmp_path, n_samples, 10, 32)
    loader = ZmqLoader(paths, num_workers=n_workers, process_fn=one)
    it = iter(loader)
    consumed = 0
    for _ in range(8):
        next(it)
        consumed += 1
    time.sleep(1.0)
    backlog = 0
    while True:
        try:
            msg = loader._pull.recv(zmq.NOBLOCK)
        except zmq.Again:
            break
        if msg == _EOF:
            loader._eofs += 1
            continue
        pickle.loads(msg)
        backlog += 1
    assert backlog <= 3 * n_workers + n_workers, backlog
    assert backlog + consumed < n_samples
    loader._consumed += backlog
    total = consumed + backlog + sum(1 for _ in it)
    assert total == n_samples


def test_zmq_loader_same_samples_as_jax(tmp_path):
    from findtextcenternet_tpu.data.zmq_loader import ZmqLoader as JLoader

    paths = _write_shards(tmp_path, 24, 4, 32)

    def multiset(loader):
        return sorted((d["key"], d["code"], d["u"]) for d in loader)

    got = multiset(ZmqLoader(paths, num_workers=3, seed=5,
                             process_fn=keyed_draw))
    want = multiset(JLoader(paths, num_workers=3, seed=5,
                            process_fn=keyed_draw))
    assert len(got) == 24
    assert got == want
