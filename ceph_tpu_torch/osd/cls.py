"""Object classes — server-side op plugins (src/cls, 30k LoC in the
reference; dispatched by PrimaryLogPG do_osd_ops CEPH_OSD_OP_CALL).

The reference loads ``libcls_<name>.so`` plugins that register named
methods; clients invoke them with ``rados_exec``/``ObjectOperation::
exec`` and the method runs ON the OSD inside the op transaction, with
read/write access to the target object.  Same shape here: a registry of
``(class, method) -> fn(ctx, input) -> (ret, output)`` where ctx wraps
the vector interpreter's in-memory object state, so a method's
mutations commit atomically with the rest of the op vector.

Built-ins mirror reference fixtures: ``hello`` (cls_hello.cc) and
``numops`` (cls_numops.cc: string-encoded arithmetic on the object
body).

The port's own copy of ``ceph_tpu/osd/cls.py``, with the classes
the port has (``load_builtin_classes``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_METHODS: Dict[Tuple[str, str], Callable] = {}

# method flags (cls_method_handle_t CLS_METHOD_RD/WR)
CLS_METHOD_RD = 1
CLS_METHOD_WR = 2


class ClsError(Exception):
    """Typed method failure: carries the errno the call returns
    (cls_cxx_* negative returns)."""

    def __init__(self, ret: int):
        super().__init__(f"cls error {ret}")
        self.ret = ret


class ClsContext:
    """The method's view of the object (cls_method_context_t role):
    reads and writes go through the SAME staged state the rest of the
    op vector sees, so everything commits (or aborts) together."""

    def __init__(self, st: Dict):
        self._st = st

    @property
    def exists(self) -> bool:
        return self._st["exists"]

    @property
    def now(self) -> float:
        """OSD wall time (for cls_lock expirations)."""
        return self._st.get("now", 0.0)

    @property
    def entity(self) -> str:
        """The calling client's entity name (cls_cxx_get_origin)."""
        return self._st.get("entity", "")

    def read(self) -> bytes:
        return bytes(self._st["body"])

    def write_full(self, data: bytes) -> None:
        self._st["body"] = bytearray(data)
        self._st["exists"] = True
        self._st["_mutated"] = True

    def getxattr(self, name: str) -> bytes:
        try:
            return self._st["attrs"][name]
        except KeyError:
            raise ClsError(-61)       # ENODATA (cls_cxx_getxattr)

    def setxattr(self, name: str, value: bytes) -> None:
        self._st["attrs"][name] = bytes(value)
        self._st["exists"] = True
        self._st["_meta"] = True

    def rmxattr(self, name: str) -> None:
        self._st["attrs"].pop(name, None)
        self._st["_meta"] = True

    def attr_names(self):
        return sorted(self._st["attrs"])

    def _check_omap(self) -> None:
        if not self._st.get("omap_ok", True):
            raise ClsError(-95)      # EOPNOTSUPP: no omap on EC pools

    def omap_get(self) -> Dict[str, bytes]:
        self._check_omap()
        return dict(self._st["omap"])

    def omap_set(self, kv: Dict[str, bytes]) -> None:
        self._check_omap()
        self._st["omap"].update(
            {k: v if isinstance(v, bytes) else str(v).encode()
             for k, v in kv.items()})
        self._st["exists"] = True
        self._st["_meta"] = True

    def omap_rm_keys(self, keys) -> None:
        self._check_omap()
        for k in keys:
            self._st["omap"].pop(k, None)
        self._st["_meta"] = True


def register_cls_method(cls: str, method: str, flags: int = CLS_METHOD_RD
                        ) -> Callable:
    """Decorator: register fn(ctx, input: bytes) -> (ret, out: bytes)
    (cls_register_cxx_method)."""

    def wrap(fn: Callable) -> Callable:
        _METHODS[(cls, method)] = (fn, flags)
        return fn
    return wrap


def lookup(cls: str, method: str):
    return _METHODS.get((cls, method))


# ---- built-in classes ------------------------------------------------------

@register_cls_method("hello", "say_hello")
def _say_hello(ctx: ClsContext, inp: bytes):
    who = inp.decode() if inp else "world"
    return 0, f"Hello, {who}!".encode()


@register_cls_method("hello", "record_hello", CLS_METHOD_WR)
def _record_hello(ctx: ClsContext, inp: bytes):
    who = inp.decode() if inp else "world"
    ctx.write_full(f"Hello, {who}!".encode())
    ctx.setxattr("hello", b"1")
    return 0, b""


@register_cls_method("numops", "add", CLS_METHOD_WR)
def _numops_add(ctx: ClsContext, inp: bytes):
    """cls_numops: the object body holds a string-encoded number; add
    the input to it (cls_numops.cc add)."""
    try:
        delta = float(inp.decode())
        cur = float(ctx.read().decode()) if ctx.exists and ctx.read() \
            else 0.0
    except ValueError:
        return -22, b""                      # EINVAL, like the reference
    out = cur + delta
    enc = ("%d" % out if out == int(out) else repr(out)).encode()
    ctx.write_full(enc)
    return 0, b""


@register_cls_method("numops", "mul", CLS_METHOD_WR)
def _numops_mul(ctx: ClsContext, inp: bytes):
    try:
        factor = float(inp.decode())
        cur = float(ctx.read().decode()) if ctx.exists and ctx.read() \
            else 0.0
    except ValueError:
        return -22, b""
    out = cur * factor
    enc = ("%d" % out if out == int(out) else repr(out)).encode()
    ctx.write_full(enc)
    return 0, b""


# generic lock class registers with the same registry (src/cls/lock)
from . import cls_lock  # noqa: E402,F401


def load_builtin_classes() -> None:
    """Import every in-tree object class (osd_class_load_list='*'):
    the reference OSD dlopens all cls plugins at start, so a client's
    call works whether or not ITS process imported the owning package
    — essential for cross-process clusters, where the OSD daemon never
    imports the rbd, cephfs, rgw or journal package on its own.

    The port loads ``rbd`` (``rbd/cls_rbd``), ``fs`` (``cephfs/cls_fs``),
    ``rgw`` (``rgw/cls_rgw``) and ``journal`` (``journal/cls_journal``)
    beside the classes of this module and ``cls_lock``, as the JAX
    package does."""
    import importlib
    for mod in ("ceph_tpu_torch.rbd.cls_rbd",
                "ceph_tpu_torch.cephfs.cls_fs",
                "ceph_tpu_torch.rgw.cls_rgw",
                "ceph_tpu_torch.journal.cls_journal"):
        importlib.import_module(mod)
