"""fleet.utils — filesystem clients and the KV rendezvous server (port of
``paddle_tpu.distributed.fleet.utils``, copied: it is host-only and
imports no JAX).

Parity: python/paddle/distributed/fleet/utils/{fs.py, http_server.py}.
LocalFS and the KV server are real (stdlib); HDFSClient shells out to a
hadoop binary the image doesn't carry, so it constructs but raises with
the object-store guidance on use.
"""
from __future__ import annotations

import http.server
import os
import shutil
import threading

from ...framework.errors import UnimplementedError

__all__ = ["LocalFS", "HDFSClient", "FS", "KVServer", "KVHandler",
           "KVHTTPServer"]


class FS:
    """Abstract FS interface (ref: fleet/utils/fs.py:25)."""

    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem client (ref: fs.py:116) — the checkpoint/auto-
    checkpoint machinery's default store."""

    def ls_dir(self, fs_path):
        """→ ([dirs], [files]) — the reference's pair convention."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for entry in os.listdir(fs_path):
            (dirs if os.path.isdir(os.path.join(fs_path, entry))
             else files).append(entry)
        return dirs, files

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if self.is_file(fs_path):
            os.remove(fs_path)
        elif self.is_dir(fs_path):
            shutil.rmtree(fs_path)

    def need_upload_download(self):
        return False

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not overwrite and self.is_exist(dst_path):
            raise FileExistsError(dst_path)
        os.replace(src_path, dst_path)

    def list_dirs(self, fs_path):
        if not self.is_exist(fs_path):
            return []
        return [d for d in os.listdir(fs_path)
                if os.path.isdir(os.path.join(fs_path, d))]

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FileExistsError(fs_path)
        open(fs_path, "a").close()


class HDFSClient(FS):
    """Ref: fs.py HDFSClient — drives the ``hadoop fs`` CLI.  No hadoop
    binary is on the images this package runs on; every operation raises
    with the
    replacement (object-store paths via LocalFS-mounted fuse, or orbax's
    cloud-storage checkpointing in incubate.sharded_checkpoint)."""

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        self._hadoop_home = hadoop_home

    def _no_hadoop(self, op):
        raise UnimplementedError(
            f"HDFSClient.{op}: no hadoop CLI in this environment — mount "
            f"the store (gcsfuse etc.) and use LocalFS, or use "
            f"incubate.sharded_checkpoint (orbax) for cloud checkpoints")

    def ls_dir(self, fs_path):
        self._no_hadoop("ls_dir")

    def is_file(self, fs_path):
        self._no_hadoop("is_file")

    def is_dir(self, fs_path):
        self._no_hadoop("is_dir")

    def is_exist(self, fs_path):
        self._no_hadoop("is_exist")

    def mkdirs(self, fs_path):
        self._no_hadoop("mkdirs")

    def delete(self, fs_path):
        self._no_hadoop("delete")

    def need_upload_download(self):
        return True

    def touch(self, fs_path, exist_ok=True):
        self._no_hadoop("touch")


class KVHandler(http.server.BaseHTTPRequestHandler):
    """GET/PUT/DELETE over an in-memory KV map (ref: http_server.py:47) —
    the file-free rendezvous store RoleMaker variants used."""

    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):
        with self.server.kv_lock:
            value = self.server.kv.get(self.path.strip("/"))
        if value is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        with self.server.kv_lock:
            self.server.kv[self.path.strip("/")] = data
        self.send_response(200)
        self.end_headers()

    do_POST = do_PUT

    def do_DELETE(self):
        with self.server.kv_lock:
            self.server.kv.pop(self.path.strip("/"), None)
            self.server.delete_count += 1
        self.send_response(200)
        self.end_headers()


class KVHTTPServer(http.server.ThreadingHTTPServer):
    """Ref: http_server.py:135."""

    def __init__(self, port, handler):
        super().__init__(("", port), handler)
        self.kv_lock = threading.Lock()
        self.kv = {}
        self.delete_count = 0

    def get_deleted_size(self, key=None):
        with self.kv_lock:
            return self.delete_count


class KVServer:
    """Threaded KV rendezvous server (ref: http_server.py:158):
    ``start()``/``stop()`` around a KVHTTPServer."""

    def __init__(self, port, size=None):
        self.http_server = KVHTTPServer(port, KVHandler)
        self.listen_thread = None
        self.size = size or {}

    def start(self):
        self.listen_thread = threading.Thread(
            target=self.http_server.serve_forever, daemon=True)
        self.listen_thread.start()

    def stop(self):
        self.http_server.shutdown()
        self.listen_thread.join()
        self.http_server.server_close()

    def should_stop(self):
        return self.http_server.get_deleted_size() >= sum(
            self.size.values()) if self.size else False
