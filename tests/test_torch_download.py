"""The port's dataset downloader (``data/download.py``, on ``urllib``)
against the JAX package's (on ``requests``): both run against one local
Range-aware HTTP server on 127.0.0.1 from the same partial files, and must
leave the same bytes and send the same requests (method, path and Range;
after a cut body each resumes from the bytes it kept) in each case: a fresh
download, a resume, a server that ignores Range, a 302, a 503 on the HEAD
and on every GET, and a body cut mid-way. Then the two
offline cases of the JAX tests, side by side, with the sample URLs pointed
at a closed local port; and the loaders calling the downloader where the JAX
loaders do."""

import logging
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from styletransfer_tpu import constants as jconstants
from styletransfer_tpu.data import download as jdownload
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.data import coco as tcoco
from styletransfer_tpu_torch.data import download as tdownload
from styletransfer_tpu_torch.data import video as tvideo

FILES = {"clip.mp4": np.random.default_rng(0).integers(0, 256, 300_000, np.uint8).tobytes(),
         "small.bin": b"0123456789" * 7}


class _Handler(BaseHTTPRequestHandler):
    """``/files/<name>`` honours ``Range: bytes=N-``; ``/norange/`` sends
    the whole file with 200; ``/moved/`` redirects (302) to ``/files/``;
    ``/busy/`` answers every GET with 503, ``/down/`` every request; ``/cut/``
    sends half of the first GET's body, then closes."""

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self._serve(head=True)

    def do_GET(self):
        self._serve(head=False)

    def _serve(self, head):
        state = self.server.state
        state["log"].append((self.command, self.path, self.headers.get("Range")))
        route, name = self.path.split("?")[0].strip("/").split("/", 1)
        if route == "moved":
            self.send_response(302)
            self.send_header("Location", f"/files/{name}")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if route == "down" or (route == "busy" and not head):
            self.send_response(503)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = FILES[name]
        start = 0
        rng = self.headers.get("Range")
        if not head and rng and route != "norange":
            start = int(rng[len("bytes="):].rstrip("-"))
        self.send_response(206 if start else 200)
        if start:
            self.send_header("Content-Range", f"bytes {start}-{len(body) - 1}/{len(body)}")
        self.send_header("Content-Length", str(len(body) - start))
        self.end_headers()
        if head:
            return
        part = body[start:]
        if route == "cut" and not state["cut_done"]:
            state["cut_done"] = True
            part = part[:len(part) // 2]
        self.wfile.write(part)
        self.wfile.flush()


@pytest.fixture(scope="module")
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    srv.state = {"log": [], "cut_done": False}
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.fixture(autouse=True)
def no_proxies(monkeypatch):
    for var in ("HTTP_PROXY", "http_proxy", "HTTPS_PROXY", "https_proxy", "ALL_PROXY",
                "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")


def _run(fn, server, url, dst, partial):
    """``fn(url, dst)`` from ``partial`` bytes on disk: (result or the
    exception's class, the file's bytes or None, the requests it sent)."""
    if partial is not None:
        with open(dst, "wb") as f:
            f.write(partial)
    server.state.update(log=[], cut_done=False)
    try:
        result = fn(url, dst)
    except Exception as exc:  # noqa: BLE001 - compared below
        result = exc
    data = open(dst, "rb").read() if os.path.exists(dst) else None
    return result, data, list(server.state["log"])


CASES = {
    "fresh": ("files", "clip.mp4", None),
    "resume": ("files", "clip.mp4", FILES["clip.mp4"][:123_457]),
    "complete": ("files", "small.bin", FILES["small.bin"]),
    "ignores_range": ("norange", "clip.mp4", FILES["clip.mp4"][:50_000]),
    "redirect": ("moved", "clip.mp4", FILES["clip.mp4"][:1000]),
    "busy_get": ("busy", "small.bin", None),
    "down_head": ("down", "small.bin", None),
    "cut_mid_body": ("cut", "clip.mp4", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_same_bytes_and_requests_as_jax(server, tmp_path, case):
    route, name, partial = CASES[case]
    url = f"http://127.0.0.1:{server.server_port}/{route}/{name}"
    got = _run(tdownload.download_from_url, server, url, str(tmp_path / "port"), partial)
    want = _run(jdownload.download_from_url, server, url, str(tmp_path / "jax"), partial)
    assert got[1] == want[1]
    if case == "cut_mid_body":
        # The retry resumes from the bytes each kept of the cut body: the
        # port writes every byte it received (half the file); requests
        # drops the short chunk it was reading, keeping whole 64 KiB ones.
        half = len(FILES[name]) // 2
        assert [r[:2] for r in got[2]] == [r[:2] for r in want[2]]
        assert got[2][2][2] == f"bytes={half}-"
        kept = int(want[2][2][2][len("bytes="):-1])
        assert kept % (64 * 1024) == 0 and 0 < kept <= half
    else:
        assert got[2] == want[2]  # method, path and Range of every request, in order
    if isinstance(want[0], Exception):
        assert isinstance(got[0], Exception), got[0]
        assert not isinstance(got[0], AssertionError)
    else:
        assert got[0] == want[0] == len(FILES[name])
        assert got[1] == FILES[name]
    if case == "resume":
        assert got[2][-1] == ("GET", f"/files/{name}", "bytes=123457-")
    if case == "busy_get":
        assert [m for m, _, _ in got[2]] == ["HEAD", "GET", "GET", "GET"]


def test_download_list_of_urls_names_files_as_jax(server, tmp_path, monkeypatch):
    base = f"http://127.0.0.1:{server.server_port}/files"
    urls = [f"{base}/small.bin", f"{base}/small.bin?" + "x" * 70]
    for module, sub in ((tdownload, "port"), (jdownload, "jax")):
        module.download_list_of_urls(urls, str(tmp_path / sub))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["0.mp4", "small.bin"]


def _closed_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_download_coco_missing_manifest_is_noop(tmp_path, monkeypatch):
    for constants, module, sub in ((tconstants, tdownload, "port"),
                                   (jconstants, jdownload, "jax")):
        monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path / sub))
        module.download_coco_images()
        assert os.path.isdir(tmp_path / sub / "data" / "coco_dataset" / "images")
    assert os.listdir(tmp_path / "port" / "data" / "coco_dataset" / "images") == []


def test_download_videos_offline_graceful(tmp_path, monkeypatch, caplog):
    urls = [f"http://127.0.0.1:{_closed_port()}/sample/{n}.mp4" for n in ("a", "b")]
    for constants, module, sub in ((tconstants, tdownload, "port"),
                                   (jconstants, jdownload, "jax")):
        monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path / sub))
        monkeypatch.setattr(module, "SAMPLE_VIDEO_URLS", urls)
        with caplog.at_level(logging.WARNING, logger="StyleTransfer"):
            module.download_videos_dataset()  # warns and returns, no raise
        assert os.listdir(tmp_path / sub / "data" / "video") == []
    warnings = [r.message for r in caplog.records if "Could not download sample videos" in
                r.getMessage()]
    assert len(warnings) == 2


def test_the_loaders_call_the_downloader_as_jax_does(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tdownload, "download_coco_images", lambda: calls.append("coco"))
    monkeypatch.setattr(tdownload, "download_videos_dataset", lambda: calls.append("video"))
    tcoco.get_coco_loader(batch_size=2, test_limit=2, train_limit=4,
                          image_dir=str(tmp_path / "none"))
    assert calls == ["coco"]
    tvideo.VideoDataset(videos=[0, 1], batch_size=2)
    assert calls == ["coco"]
    tvideo.VideoDataset(video_dir=str(tmp_path / "none"), batch_size=2)
    assert calls == ["coco", "video"]
