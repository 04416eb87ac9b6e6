"""Dataset downloaders with byte-range resume.

The port of ``styletransfer_tpu/data/download.py``, on the standard library's
``urllib.request`` (the GPU machine has no ``requests``): a resumable HTTP
downloader with a tqdm progress bar where tqdm imports, a URL-list helper,
the 4-video sample dataset, and the COCO per-image downloader driven by
``image_info_test2017.json``. ``coco.get_coco_loader`` and
``video.VideoDataset`` call it where the JAX package's loaders do.

Failure semantics are the JAX package's: a HEAD that follows redirects gives
the size; each of up to three attempts resumes from the bytes on disk with
an open-ended ``Range`` header, appends on 206, restarts from byte 0 on 200
and fails on an error status; complete files are skipped. Without a network
the video download fails on its first HEAD, warns and returns, and the COCO
download returns at once when its manifest is missing; the loaders then use
whatever is on disk, or their synthetic corpora.
"""

from __future__ import annotations

import http.client
import json
import os
import urllib.request
from typing import List

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.utils.logging import get_logger

BASE_COCO_PATH = "data/coco_dataset/"
IMAGE_FOLDER_PATH = os.path.join(BASE_COCO_PATH, "images")
VIDEO_DATA_PATH = "data/video/"

SAMPLE_VIDEO_URLS = [
    "http://commondatastorage.googleapis.com/gtv-videos-bucket/sample/BigBuckBunny.mp4",
    "http://commondatastorage.googleapis.com/gtv-videos-bucket/sample/ElephantsDream.mp4",
    "http://commondatastorage.googleapis.com/gtv-videos-bucket/sample/Sintel.mp4",
    "http://commondatastorage.googleapis.com/gtv-videos-bucket/sample/TearsOfSteel.mp4",
]

# (connect, read) timeouts, so that a dead network fails fast instead of
# holding up the start of training.
_TIMEOUT = (10, 30)
_MAX_ATTEMPTS = 3
_CHUNK = 64 * 1024


def _abspath(path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(constants.PROJECT_ROOT_PATH, path)


class _Timeouts:
    """Connects within the connect timeout, then reads with the read one."""

    def connect(self):
        self.timeout = _TIMEOUT[0]
        super().connect()
        self.sock.settimeout(_TIMEOUT[1])


class _HTTPConnection(_Timeouts, http.client.HTTPConnection):
    pass


class _HTTPSConnection(_Timeouts, http.client.HTTPSConnection):
    pass


class _HTTPHandler(urllib.request.HTTPHandler):
    def http_open(self, req):
        return self.do_open(_HTTPConnection, req)


class _HTTPSHandler(urllib.request.HTTPSHandler):
    def https_open(self, req):
        return self.do_open(_HTTPSConnection, req, context=self._context)


class _RedirectHandler(urllib.request.HTTPRedirectHandler):
    """Follows redirects keeping the method: urllib turns a redirected HEAD
    into a GET, which would fetch the whole file to read its size."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        new = super().redirect_request(req, fp, code, msg, headers, newurl)
        if new is not None and req.get_method() == "HEAD":
            new.method = "HEAD"
        return new


def _open(url: str, method: str, headers=None):
    """``urlopen`` through the timeout and redirect handlers; an error
    status raises ``urllib.error.HTTPError``."""
    opener = urllib.request.build_opener(_HTTPHandler, _HTTPSHandler, _RedirectHandler)
    return opener.open(urllib.request.Request(url, headers=headers or {}, method=method))


def _progress(total: int, initial: int, desc: str):
    """A tqdm bar, or None where tqdm does not import."""
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total, initial=initial, unit="B", unit_scale=True, desc=desc)


def download_from_url(url: str, dst: str) -> int:
    """Resumable single-file download; returns the file's size.

    HEADs for Content-Length (following redirects), resumes from the local
    size with an open-ended Range header, streams in 64 KiB chunks with a
    progress bar, and retries an interrupted transfer up to
    :data:`_MAX_ATTEMPTS` times, each retry resuming from the bytes already
    on disk. An error status on the HEAD raises at once."""
    with _open(url, "HEAD") as head:
        length = head.headers.get("Content-Length")
    if length is None:
        raise KeyError("Content-Length")
    file_size = int(length)
    last_exc: Exception = OSError(f"download of {url} incomplete after retries")
    for attempt in range(_MAX_ATTEMPTS):
        first_byte = os.path.getsize(dst) if os.path.exists(dst) else 0
        if first_byte >= file_size:
            return file_size
        pbar = None
        try:
            pbar = _progress(file_size, first_byte, url.split("/")[-1])
            with _open(url, "GET", {"Range": f"bytes={first_byte}-"}) as resp:
                # An error status raised above; a 200 means the server
                # ignored the Range, and its whole body must overwrite the
                # partial bytes, not follow them.
                resumed = first_byte > 0 and resp.status == 206
                if first_byte > 0 and not resumed:
                    get_logger().warning(
                        "Server ignored Range for %s (status %d); restarting from byte 0.",
                        url, resp.status)
                    if pbar is not None:
                        pbar.reset(total=file_size)
                declared = resp.headers.get("Content-Length")
                got = 0
                with open(dst, "ab" if resumed or first_byte == 0 else "wb") as f:
                    while True:
                        chunk = resp.read(_CHUNK)
                        if not chunk:
                            break
                        f.write(chunk)
                        got += len(chunk)
                        if pbar is not None:
                            pbar.update(len(chunk))
                if declared is not None and got < int(declared):
                    raise http.client.IncompleteRead(b"", int(declared) - got)
        except (OSError, http.client.HTTPException) as exc:
            last_exc = exc
            get_logger().warning("Download of %s interrupted (attempt %d/%d): %s",
                                 url, attempt + 1, _MAX_ATTEMPTS, exc)
            continue
        finally:
            if pbar is not None:
                pbar.close()
        if os.path.getsize(dst) >= file_size:
            return file_size
    raise last_exc


def download_list_of_urls(urls: List[str], destination_folder: str = VIDEO_DATA_PATH) -> None:
    """Download each URL into ``destination_folder``, named by the URL's
    last component (``<n>.mp4`` where that is empty or over 64 chars)."""
    destination_folder = _abspath(destination_folder)
    os.makedirs(destination_folder, exist_ok=True)
    name_counter = 0
    for url in urls:
        filename = url.split("/")[-1]
        if not filename or len(filename) > 64:
            filename = f"{name_counter}.mp4"
            name_counter += 1
        download_from_url(url, os.path.join(destination_folder, filename))


def download_videos_dataset() -> None:
    """Ensure the 4 sample videos are present. Every file is checked (a
    HEAD each), so a file cut short by an earlier run is resumed; without a
    network the first HEAD fails and this warns and returns."""
    path = _abspath(VIDEO_DATA_PATH)
    os.makedirs(path, exist_ok=True)
    try:
        download_list_of_urls(SAMPLE_VIDEO_URLS, VIDEO_DATA_PATH)
    except Exception as exc:  # noqa: BLE001 - offline environments
        get_logger().warning(
            "Could not download sample videos (%s); the video dataset falls back to "
            "synthetic clips if none are present.", exc)


def download_coco_images() -> None:
    """Ensure the COCO images named in ``image_info_test2017.json`` are
    present. Without the manifest (it is not shipped) this logs and returns;
    the download runs when the image count differs from the manifest's, and
    a failure warns (the loader then uses what is on disk)."""
    json_file_path = _abspath(os.path.join(BASE_COCO_PATH, "image_info_test2017.json"))
    image_dir = _abspath(IMAGE_FOLDER_PATH)
    os.makedirs(image_dir, exist_ok=True)
    if not os.path.isfile(json_file_path):
        get_logger().info("COCO manifest %s not found; skipping download.", json_file_path)
        return
    with open(json_file_path) as f:
        images_urls = [x["coco_url"] for x in json.load(f)["images"]]
    if len(images_urls) != len(os.listdir(image_dir)):
        try:
            download_list_of_urls(images_urls, IMAGE_FOLDER_PATH)
        except Exception as exc:  # noqa: BLE001
            get_logger().warning("COCO download interrupted/unavailable: %s", exc)
