"""Shared threaded HTTP wrapper for the framework's pure
request->response frontends (rgw's S3/Swift handlers, the mgr
prometheus/restful surface).

``handle(method, path, headers, body, query) -> (status, headers,
body)`` frontends plug in unchanged; the in-process fabric is not
thread-safe, so concurrent connections serialize on one lock (the
reference runs real thread pools over thread-safe cores).
"""
from __future__ import annotations

import threading

from .lockdep import DebugLock
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Tuple
from urllib.parse import parse_qsl, urlparse

HandleFn = Callable[[str, str, Dict[str, str], bytes, Dict[str, str]],
                    Tuple[int, Dict[str, str], bytes]]


def serve_frontend(handle: HandleFn, port: int = 0):
    """Returns (server, port); ``server.shutdown()`` +
    ``server.server_close()`` when done (shutdown alone leaves the
    listening fd open)."""
    lock = DebugLock("http_frontend::serial")

    class Handler(BaseHTTPRequestHandler):
        def _run(self, method: str) -> None:
            u = urlparse(self.path)
            ln = int(self.headers.get("Content-Length", "0") or 0)
            body = self.rfile.read(ln) if ln else b""
            with lock:
                # keep_blank_values: bare subresource markers
                # (?versioning, ?uploads, ?acl ...) must survive
                status, hdrs, out = handle(
                    method, u.path, dict(self.headers), body,
                    dict(parse_qsl(u.query, keep_blank_values=True)))
            self.send_response(status)
            sent_len = False
            for k, v in hdrs.items():
                self.send_header(k, v)
                if k.lower() == "content-length":
                    sent_len = True
            if not sent_len:
                self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            if method != "HEAD":
                self.wfile.write(out)

        def do_GET(self):
            self._run("GET")

        def do_PUT(self):
            self._run("PUT")

        def do_POST(self):
            self._run("POST")

        def do_DELETE(self):
            self._run("DELETE")

        def do_HEAD(self):
            self._run("HEAD")

        def log_message(self, *a):  # pragma: no cover - quiet server
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]
