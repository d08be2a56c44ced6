"""The port's http(s) shard streaming and corpus collectors against the
JAX package's, on the CPU, against servers on 127.0.0.1 only.

``open_shard_stream`` of a URL runs the native downloader (built from
``native/downloader/main.cpp`` at first use; it hands each transfer to
``curl``) where ``curl`` is on the PATH. The downloader retries a failed
transfer for ever, a 404 or a refused connection included, so no test
points it at a URL that fails: every served URL answers, and a dropped
connection is one the server honours with ``Range`` on the retry. Every
test runs under its own time limit (``SIGALRM``) and closes each
downloader it started in teardown, which ends the process.
"""
import http.server
import json
import os
import signal
import socket
import threading

import numpy as np
import pytest

from findtextcenternet_tpu_torch.data import shards
from findtextcenternet_tpu_torch.data.loader import DetectorLoader
from findtextcenternet_tpu_torch.data.shards import (
    ShardWriter, iter_tar_samples, open_shard_stream, shard_route)
from findtextcenternet_tpu_torch.factory import corpus

TEST_SECONDS = 60
HW = 64


class _Handler(http.server.BaseHTTPRequestHandler):
    """Serves ``server.routes`` (path -> bytes), honours ``Range:
    bytes=N-``, and for a path in ``server.drop_once`` sends half of the
    body on the first request, then closes the connection."""

    def do_GET(self):
        srv = self.server
        srv.log.append((self.path, self.headers.get("Range"),
                        self.headers.get("Accept")))
        body = srv.routes.get(self.path)
        if body is None:
            self.send_error(404)
            return
        rng = self.headers.get("Range")
        start = int(rng.split("=")[1].split("-")[0]) if rng else 0
        part = body[start:]
        self.send_response(206 if rng else 200)
        if rng:
            self.send_header("Content-Range",
                             f"bytes {start}-{len(body) - 1}/{len(body)}")
        self.send_header("Content-Length", str(len(part)))
        self.end_headers()
        if self.path in srv.drop_once:
            srv.drop_once.discard(self.path)
            self.wfile.write(part[:len(part) // 2])
            self.wfile.flush()
            self.connection.shutdown(socket.SHUT_WR)
            return
        self.wfile.write(part)

    def log_message(self, *args):
        pass


@pytest.fixture
def server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    srv.routes, srv.drop_once, srv.log = {}, set(), []
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    srv.url = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv
    srv.shutdown()
    srv.server_close()
    th.join(10)


@pytest.fixture(autouse=True)
def bounded(monkeypatch):
    """A time limit for the test, and every downloader it started closed
    (its process ended) in teardown."""
    started = []

    class Tracked(shards.DownloadStream):
        def __init__(self, url):
            super().__init__(url)
            started.append(self)

    def expire(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_SECONDS} s")

    monkeypatch.setattr(shards, "DownloadStream", Tracked)
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_SECONDS)
    try:
        yield started
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        for s in started:
            s.close()
        assert all(s.proc.poll() is not None for s in started)


def _write_shard(path, n=4, seed=0):
    rng = np.random.default_rng(seed)
    with ShardWriter(path, n) as w:
        for i in range(n):
            w.write({
                "__key__": f"k{i}",
                "image.png": rng.integers(0, 255, (HW, HW), dtype=np.uint8),
                "textline.png": np.zeros((HW // 2, HW // 2), np.uint8),
                "sepline.png": np.zeros((HW // 2, HW // 2), np.uint8),
                "position.npy": np.array([[32, 32, 8, 8], [16, 40, 6, 6]],
                                         np.float32),
                "code_list.npy": np.array([[65 + i, 0], [66, 1]], np.int32),
                "txt": f"sample {i}",
            })
        return w.paths[0]


def _read(stream):
    with stream:
        return stream.read()


def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture
def shard(tmp_path, server):
    path = _write_shard(str(tmp_path / "s%03d.tar"))
    with open(path, "rb") as f:
        server.routes["/s.tar"] = f.read()
    return path, server.url + "/s.tar"


def test_open_shard_stream_http_matches_the_file_and_jax(shard, server,
                                                         bounded):
    from findtextcenternet_tpu.data import shards as jshards

    path, url = shard
    assert shard_route(url) == "downloader"
    assert shard_route(path) == "file"
    assert _read(open_shard_stream(url)) == server.routes["/s.tar"]
    assert len(bounded) == 1 and bounded[0].proc.returncode == 0
    with open_shard_stream(url) as stream:
        got = list(iter_tar_samples(stream))
    with open_shard_stream(path) as stream:
        local = list(iter_tar_samples(stream))
    want = list(jshards.iter_tar_samples(jshards.open_shard_stream(url)))
    _same_samples(got, want)
    _same_samples(local, list(iter_tar_samples(path)))
    _same_samples(got, local)


def test_downloader_resumes_a_dropped_connection(shard, server, bounded):
    path, url = shard
    server.drop_once.add("/s.tar")
    body = server.routes["/s.tar"]
    assert _read(open_shard_stream(url)) == body
    ranges = [r for p, r, _ in server.log]
    assert ranges == [None, f"bytes={len(body) // 2}-"]


def test_urllib_route_without_curl(shard, server, bounded, monkeypatch):
    path, url = shard
    monkeypatch.setattr(shards.shutil, "which", lambda name: None)
    assert shard_route(url) == "urllib"
    assert _read(open_shard_stream(url)) == server.routes["/s.tar"]
    assert not bounded


def test_detector_loader_takes_url_shards(tmp_path, shard, server):
    """A URL shard gives the batches its file gives (same seed); a served
    file that is not a tar becomes an error item, and the batches go on."""
    path, url = shard
    server.routes["/bad.tar"] = b"not a tar" * 100

    def batches(shard_list):
        loader = DetectorLoader(shard_list, 2, num_workers=1, seed=3,
                                shuffle_buf=2, repeat=False, out_hw=(HW, HW))
        out = list(loader)
        assert not loader._procs
        return out

    want = batches([path])
    for got in (batches([url]), batches([server.url + "/bad.tar", url])):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def keyed(sample, rng):
    """A ZmqLoader process_fn: the sample's key, first code and one draw
    of the reader's rng."""
    return {"key": sample["__key__"], "code": int(sample["code_list"][0, 0]),
            "u": float(rng.uniform())}


def test_zmq_loader_takes_url_shards(shard):
    pytest.importorskip("zmq")
    from findtextcenternet_tpu_torch.data.zmq_loader import ZmqLoader

    path, url = shard
    runs = [sorted(ZmqLoader([s], num_workers=1, seed=2, process_fn=keyed),
                   key=lambda d: d["key"]) for s in (path, url)]
    assert len(runs[0]) == 4 and runs[0] == runs[1]


AOZORA = ('<html><body><div class="main_text">吾輩は<ruby><rb>猫</rb>'
          '<rp>（</rp><rt>ねこ</rt><rp>）</rp></ruby>である。<br />'
          '名前はまだ無い。&amp;</div></body></html>')


@pytest.mark.parametrize("enc", ["shift_jis", "utf-8", "euc-jp"])
def test_fetch_aozora_matches_jax(server, enc):
    from findtextcenternet_tpu.factory import corpus as jcorpus

    server.routes["/card.html"] = AOZORA.encode(enc)
    url = server.url + "/card.html"
    got = corpus.fetch_aozora(url, timeout=10)
    assert got == jcorpus.fetch_aozora(url, timeout=10)
    if enc == "shift_jis":
        assert got == "吾輩は￹猫￺ねこ￻である。\n名前はまだ無い。&"


def _wiki(server, module, monkeypatch):
    monkeypatch.setattr(module, "WIKI_RANDOM_API",
                        server.url + "/{lang}/random")


def test_collect_corpus_matches_jax(server, tmp_path, monkeypatch, capsys):
    from findtextcenternet_tpu.factory import corpus as jcorpus

    server.routes["/ja/random"] = json.dumps(
        {"title": "猫", "extract": "猫は動物である。"}).encode("utf-8")
    server.routes["/en/random"] = json.dumps(
        {"title": "Cat", "extract": ""}).encode("utf-8")
    for mod in (corpus, jcorpus):
        _wiki(server, mod, monkeypatch)
    got = corpus.collect_corpus(str(tmp_path / "t"), ("ja", "en", "ko"), 2)
    printed = capsys.readouterr().out
    want = jcorpus.collect_corpus(str(tmp_path / "j"), ("ja", "en", "ko"), 2)
    assert printed == capsys.readouterr().out
    assert got == want == 4
    assert "wikipedia ko fetch failed" in printed
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "wiki_en_0000.txt", "wiki_en_0001.txt", "wiki_ja_0000.txt",
        "wiki_ja_0001.txt"]
    for n in names:
        with open(tmp_path / "t" / n, encoding="utf-8") as f, \
                open(tmp_path / "j" / n, encoding="utf-8") as g:
            assert f.read() == g.read()
    with open(tmp_path / "t" / "wiki_ja_0000.txt", encoding="utf-8") as f:
        assert f.read() == "猫\n猫は動物である。"
    assert {a for p, _, a in server.log} == {"application/json"}


def test_collect_corpus_offline_fails_fast(tmp_path, monkeypatch, capsys,
                                           bounded):
    """A refused connection: each language prints its failure and ends;
    nothing is written, as in JAX's collector."""
    from findtextcenternet_tpu.factory import corpus as jcorpus

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for mod in (corpus, jcorpus):
        monkeypatch.setattr(mod, "WIKI_RANDOM_API",
                            f"http://127.0.0.1:{port}/{{lang}}")
    got = corpus.collect_corpus(str(tmp_path / "t"), ("ja", "en"), 3)
    printed = capsys.readouterr().out
    want = jcorpus.collect_corpus(str(tmp_path / "j"), ("ja", "en"), 3)
    assert got == want == 0
    assert printed == capsys.readouterr().out
    assert printed.count("fetch failed") == 2
    assert not os.listdir(tmp_path / "t") and not bounded
