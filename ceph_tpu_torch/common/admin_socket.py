"""AdminSocket — runtime introspection commands.

Port of ``ceph_tpu/common/admin_socket.py``, the same behaviour under the same names.

Mirrors the reference's unix-socket JSON command surface
(src/common/admin_socket.{h,cc}; tests drive it as `ceph --admin-daemon
<sock> perf dump`): hooks register under a command prefix and return JSON.
In-process calls are the primary surface; `serve_unix()` optionally
exposes the same commands over a real unix socket (newline-delimited
command in, JSON out) for external tooling.
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
from typing import Callable, Dict, Optional

Hook = Callable[[str, Dict[str, str]], object]


class AdminSocket:
    def __init__(self):
        self._hooks: Dict[str, Hook] = {}
        self._help: Dict[str, str] = {}
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self.register("help", lambda cmd, args: dict(self._help),
                      "list available commands")

    def register(self, command: str, hook: Hook, help: str = "") -> None:
        if command in self._hooks:
            raise KeyError(f"command {command!r} already registered")
        self._hooks[command] = hook
        self._help[command] = help

    def unregister(self, command: str) -> None:
        self._hooks.pop(command, None)
        self._help.pop(command, None)

    def execute(self, command: str, args: Optional[Dict[str, str]] = None):
        """Longest-prefix dispatch, like the reference's hook matching."""
        args = args or {}
        cand = command
        while cand:
            if cand in self._hooks:
                return self._hooks[cand](command, args)
            cand = cand.rsplit(" ", 1)[0] if " " in cand else ""
        raise KeyError(f"unknown command {command!r}")

    def execute_json(self, command: str,
                     args: Optional[Dict[str, str]] = None) -> str:
        try:
            return json.dumps(self.execute(command, args), default=str)
        except (KeyError, ValueError) as e:
            # hooks signal bad arguments with ValueError (e.g. config
            # set on an unknown option); socket clients must still get
            # a JSON reply, not a dropped connection
            return json.dumps({"error": str(e)})

    # ---- optional real unix socket ----------------------------------------
    def serve_unix(self, path: str) -> None:
        if os.path.exists(path):
            os.unlink(path)
        admin = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline().decode().strip()
                self.wfile.write(admin.execute_json(line).encode() + b"\n")

        self._server = socketserver.ThreadingUnixStreamServer(path, Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
