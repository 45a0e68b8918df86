"""rgw-lite: S3-shaped object gateway over rados (src/rgw, 122k LoC in
the reference, at lite scale).

Storage layout mirrors the reference's: user and bucket-entrypoint
records in a metadata pool (``user.<uid>``, ``bucket.<name>``), one
index object per bucket (``.dir.<bucket_id>``) mutated through the
two-phase cls_rgw protocol, and object payloads chunked into the data
pool under ``<bucket_id>_<name>[.chunk.N]`` with a manifest in the
index entry (RGWObjManifest role).  Multipart uploads stage parts
under a ``_multipart_`` namespace and stitch a manifest at complete,
like RGWMultipart*.

S3 object versioning (version stacks with delete markers, suspended
mode, GET/DELETE ?versionId), bucket lifecycle (expiration +
noncurrent-version expiration, the `lc process` pass) and S3 ACLs
(canned ACLs + grant lists with owner/grantee/permission checks) are
implemented below at the same lite scale (rgw_rados versioned ops,
rgw_lc.cc, rgw_acl_s3.cc roles).  Scope-outs vs the reference: the
ACL XML wire grammar (grants are structured dicts) and the civetweb
frontend (the ``http`` module provides a threaded stdlib server
speaking the S3 path-style subset with AWS v2-style HMAC auth).
"""
from __future__ import annotations

import hashlib
import json
import secrets
import time
from typing import Dict, List, Optional

from ..client.rados import RadosClient
from . import cls_rgw  # noqa: F401

CHUNK = 4 << 20                   # rgw_max_chunk_size default (4 MiB)


class RGWError(IOError):
    def __init__(self, api: str, result: int, reason: str = ""):
        super().__init__(f"rgw {api}: {result} {reason}".rstrip())
        self.result = result


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _absent(e: IOError) -> bool:
    return getattr(e, "errno", None) == 2


class RGWLite:
    """The gateway core (RGWRados role): all state in rados."""

    def __init__(self, client: RadosClient, meta_pool: str,
                 data_pool: str):
        self.client = client
        self.mpool = meta_pool
        self.dpool = data_pool

    # ---- cls / meta helpers ------------------------------------------------
    def _exec(self, pool: str, oid: str, method: str, payload=None
              ) -> bytes:
        ret, out = self.client.exec(pool, oid, "rgw", method,
                                    _j(payload or {}))
        if ret < 0:
            raise RGWError(method, ret)
        return out

    def _meta_get(self, oid: str) -> Optional[Dict]:
        try:
            return json.loads(self.client.read(self.mpool, oid))
        except IOError as e:
            if _absent(e):
                return None
            raise

    # ---- users (RGWUser / radosgw-admin user create) -----------------------
    def create_user(self, uid: str, display_name: str = "") -> Dict:
        if self._meta_get(f"user.{uid}") is not None:
            raise RGWError("create_user", -17)
        user = {"uid": uid, "display_name": display_name or uid,
                "access_key": secrets.token_hex(10),
                "secret_key": secrets.token_hex(20),
                "buckets": []}
        self._save_user(user)
        self._meta_index(f"user.{uid}", True)
        return user

    def get_user(self, uid: str) -> Dict:
        u = self._meta_get(f"user.{uid}")
        if u is None:
            raise RGWError("get_user", -2)
        return u

    def delete_user(self, uid: str) -> None:
        """Remove a user (radosgw-admin user rm): refused while the
        user still owns buckets."""
        u = self.get_user(uid)
        if u["buckets"]:
            raise RGWError("delete_user", -39, "user owns buckets")
        self.client.remove(self.mpool, f"user.{uid}")
        self._meta_index(f"user.{uid}", False)

    def list_users(self) -> List[str]:
        return [oid[len("user."):] for oid in self._meta_list("user.")]

    def _save_user(self, user: Dict) -> None:
        self.client.write_full(self.mpool, f"user.{user['uid']}",
                               _j(user))

    def _save_bucket(self, bucket: Dict) -> None:
        self.client.write_full(self.mpool,
                               f"bucket.{bucket['name']}", _j(bucket))

    def modify_user(self, uid: str, display_name: Optional[str] = None,
                    suspended: Optional[bool] = None,
                    max_buckets: Optional[int] = None) -> Dict:
        """radosgw-admin user modify / suspend / enable: a suspended
        user's requests are refused at the frontends (the reference's
        RGW_USER_SUSPENDED check)."""
        u = self.get_user(uid)
        if display_name is not None:
            u["display_name"] = display_name
        if suspended is not None:
            u["suspended"] = bool(suspended)
        if max_buckets is not None:
            u["max_buckets"] = int(max_buckets)
        self._save_user(u)
        return u

    def user_add_key(self, uid: str) -> Dict:
        """radosgw-admin key create: an ADDITIONAL key pair; every
        key authenticates the user (RGWUserInfo access_keys map)."""
        u = self.get_user(uid)
        key = {"access_key": secrets.token_hex(10),
               "secret_key": secrets.token_hex(20)}
        u.setdefault("keys", []).append(key)
        self._save_user(u)
        return key

    def user_rm_key(self, uid: str, access_key: str) -> None:
        """radosgw-admin key rm (the primary key is not removable
        here — the reference also refuses removing the last key)."""
        u = self.get_user(uid)
        keys = u.get("keys", [])
        kept = [k for k in keys if k["access_key"] != access_key]
        if len(kept) == len(keys):
            raise RGWError("user_rm_key", -2, "no such key")
        u["keys"] = kept
        self._save_user(u)

    def user_caps(self, uid: str, add: Optional[str] = None,
                  rm: Optional[str] = None) -> Dict[str, str]:
        """radosgw-admin caps add/rm: admin capability strings like
        'users=read,write' (RGWUserCaps grammar)."""
        u = self.get_user(uid)
        caps = dict(u.get("caps", {}))
        for spec, is_add in ((add, True), (rm, False)):
            if not spec:
                continue
            for part in spec.split(";"):
                kind, _, perms = part.strip().partition("=")
                if not kind:
                    continue
                if is_add:
                    caps[kind] = perms or "read"
                elif not perms:
                    caps.pop(kind, None)       # rm the whole kind
                else:
                    # subtract only the listed perms
                    # (RGWUserCaps::remove)
                    have = [p for p in caps.get(kind, "").split(",")
                            if p]
                    left = [p for p in have
                            if p not in perms.split(",")]
                    if left:
                        caps[kind] = ",".join(left)
                    else:
                        caps.pop(kind, None)
        u["caps"] = caps
        self._save_user(u)
        return caps

    def set_user_quota(self, uid: str,
                       max_size: Optional[int] = None,
                       max_objects: Optional[int] = None,
                       enabled: Optional[bool] = None) -> Dict:
        """radosgw-admin quota set/enable/disable --quota-scope=user:
        checked on every put against the user's aggregate usage."""
        u = self.get_user(uid)
        q = dict(u.get("quota", {}))
        if max_size is not None:
            q["max_size"] = int(max_size)
        if max_objects is not None:
            q["max_objects"] = int(max_objects)
        if enabled is not None:
            q["enabled"] = bool(enabled)
        u["quota"] = q
        self._save_user(u)
        return q

    def user_stats(self, uid: str) -> Dict:
        """radosgw-admin user stats: aggregate usage across every
        owned bucket (the quota subsystem's accounting)."""
        u = self.get_user(uid)
        size = objects = 0
        for b in u.get("buckets", []):
            try:
                st = self.bucket_stats(b)
            except RGWError:
                continue
            size += int(st.get("size_bytes", 0))
            objects += int(st.get("num_objects", 0))
        return {"uid": uid, "size": size, "num_objects": objects}

    def _check_user_quota(self, uid: Optional[str],
                          incoming: int) -> None:
        if not uid:
            return
        try:
            u = self.get_user(uid)
        except RGWError:
            return
        q = u.get("quota", {})
        if not q.get("enabled"):
            return
        # aggregate walk with early exit (the reference amortizes this
        # with RGWQuotaCache; at lite scale the walk stops as soon as
        # either limit is provably exceeded)
        max_size = q.get("max_size", 0)
        max_objects = q.get("max_objects", 0)
        size, objects = incoming, 1
        for b in u.get("buckets", []):
            try:
                st = self.bucket_stats(b)
            except RGWError:
                continue
            size += int(st.get("size_bytes", 0))
            objects += int(st.get("num_objects", 0))
            if (max_size > 0 and size > max_size) or \
                    (max_objects > 0 and objects > max_objects):
                raise RGWError("put_object", -122, "QuotaExceeded")
        if (max_size > 0 and size > max_size) or \
                (max_objects > 0 and objects > max_objects):
            raise RGWError("put_object", -122, "QuotaExceeded")

    def link_bucket(self, bucket: str, uid: str) -> None:
        """radosgw-admin bucket link: move ownership to *uid*."""
        b = self.get_bucket(bucket)
        new_owner = self.get_user(uid)
        old = b.get("owner")
        if old == uid:
            return
        mb = int(new_owner.get("max_buckets", 0) or 0)
        if mb > 0 and len(new_owner.get("buckets", [])) >= mb:
            raise RGWError("link_bucket", -24, "TooManyBuckets")
        if old:
            try:
                ou = self.get_user(old)
                ou["buckets"] = [x for x in ou["buckets"]
                                 if x != bucket]
                self._save_user(ou)
            except RGWError:
                pass
        b["owner"] = uid
        self._save_bucket(b)
        if bucket not in new_owner["buckets"]:
            new_owner["buckets"].append(bucket)
            self._save_user(new_owner)

    def unlink_bucket(self, bucket: str, uid: str) -> None:
        """radosgw-admin bucket unlink: detach from the user (the
        bucket keeps existing, ownerless)."""
        b = self.get_bucket(bucket)
        if b.get("owner") != uid:
            raise RGWError("unlink_bucket", -22,
                           "bucket not linked to that user")
        u = self.get_user(uid)
        u["buckets"] = [x for x in u["buckets"] if x != bucket]
        self._save_user(u)
        b["owner"] = ""
        self._save_bucket(b)

    def bucket_stats(self, bucket: str) -> Dict:
        """Bucket entry + index stats (radosgw-admin bucket stats)."""
        b = self.get_bucket(bucket)
        stats = json.loads(self._exec(
            self.mpool, self._index_oid(b["id"]), "bucket_stats"))
        return {**b, **stats}

    def user_by_access_key(self, access_key: str) -> Optional[Dict]:
        # lite linear scan (the reference keeps a key->uid index object)
        for oid in self._meta_list("user."):
            u = self._meta_get(oid)
            if u is None:
                continue
            if u["access_key"] == access_key or any(
                    k["access_key"] == access_key
                    for k in u.get("keys", [])):
                return u
        return None

    def secret_for_key(self, user: Dict, access_key: str) -> str:
        """The secret matching *access_key* (primary or additional)."""
        if user["access_key"] == access_key:
            return user["secret_key"]
        for k in user.get("keys", []):
            if k["access_key"] == access_key:
                return k["secret_key"]
        raise RGWError("secret_for_key", -2, "no such key")

    def _meta_list(self, prefix: str) -> List[str]:
        try:
            om = self.client.omap_get(self.mpool, "rgw_meta_index")
        except IOError as e:
            if not _absent(e):
                raise
            om = {}
        return sorted(k for k in om if k.startswith(prefix))

    def _meta_index(self, key: str, add: bool) -> None:
        if add:
            self.client.omap_set(self.mpool, "rgw_meta_index",
                                 {key: b"1"})
        else:
            self.client.omap_rm_keys(self.mpool, "rgw_meta_index",
                                     [key])

    # ---- buckets -----------------------------------------------------------
    def _index_oid(self, bucket_id: str) -> str:
        return f".dir.{bucket_id}"

    def create_bucket(self, uid: str, name: str) -> Dict:
        user = self.get_user(uid)
        mb = int(user.get("max_buckets", 0) or 0)
        if mb > 0 and len(user.get("buckets", [])) >= mb:
            raise RGWError("create_bucket", -24, "TooManyBuckets")
        if self._meta_get(f"bucket.{name}") is not None:
            raise RGWError("create_bucket", -17, "BucketAlreadyExists")
        bid = secrets.token_hex(8)
        bucket = {"name": name, "id": bid, "owner": uid,
                  "created": time.time()}
        self._save_bucket(bucket)
        self.client.create(self.mpool, self._index_oid(bid),
                           exclusive=False)
        user["buckets"] = sorted(set(user["buckets"]) | {name})
        self._save_user(user)
        return bucket

    def get_bucket(self, name: str) -> Dict:
        b = self._meta_get(f"bucket.{name}")
        if b is None:
            raise RGWError("get_bucket", -2, "NoSuchBucket")
        return b

    def delete_bucket(self, name: str,
                      actor: Optional[str] = None) -> None:
        """RGWDeleteBucket::verify_permission checks bucket policy
        (rgw_op.cc:2828-2832), not raw ownership — a FULL_CONTROL/
        WRITE grantee may delete; actor None = admin bypass."""
        b = self.get_bucket(name)
        self._check_bucket_access(b, actor, "WRITE")
        stats = json.loads(self._exec(self.mpool,
                                      self._index_oid(b["id"]),
                                      "bucket_stats"))
        if stats["num_objects"]:
            raise RGWError("delete_bucket", -39, "BucketNotEmpty")
        self.client.remove(self.mpool, self._index_oid(b["id"]))
        self.client.remove(self.mpool, f"bucket.{name}")
        owner = self._meta_get(f"user.{b['owner']}")
        if owner:
            owner["buckets"] = [x for x in owner["buckets"] if x != name]
            self._save_user(owner)

    def list_buckets(self, uid: str) -> List[str]:
        return list(self.get_user(uid)["buckets"])

    # ---- objects -----------------------------------------------------------
    def _data_oid(self, bucket_id: str, name: str) -> str:
        # distinct o_/c_/mp_ namespaces: a key can never collide with
        # another key's chunk or multipart staging objects (the
        # reference's __shadow_ namespace escaping, rgw_obj::set_ns)
        return f"{bucket_id}_o_{name}"

    def _write_chunked(self, base_oid: str, data: bytes) -> List[str]:
        """Payload -> head object + .chunk.N tail objects (manifest)."""
        oids = []
        for i in range(0, max(len(data), 1), CHUNK):
            oid = base_oid if i == 0 else \
                base_oid.replace("_o_", "_c_", 1) + f".{i // CHUNK}"
            r = self.client.write_full(self.dpool, oid,
                                       data[i:i + CHUNK])
            if r < 0:
                raise RGWError("put_object", r)
            oids.append(oid)
        return oids

    def put_object(self, bucket: str, name: str, data: bytes,
                   content_type: str = "binary/octet-stream",
                   actor: Optional[str] = None) -> Dict:
        """Two-phase put: index prepare -> data chunks -> index
        complete.  A crash mid-way leaves a pending marker and garbage
        chunks, but never a listing entry for unreadable data.

        On a VERSIONED bucket every put pushes a new version onto the
        key's stack (suspended mode overwrites the 'null' slot), like
        RGWRados versioned object ops."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE")
        # storage quota charges the bucket OWNER (RGWQuotaHandler)
        self._check_user_quota(b.get("owner"), len(data))
        vstate = b.get("versioning")
        idx = self._index_oid(b["id"])
        cur = None
        try:
            cur = self._raw_entry(b, name)
        except RGWError:
            pass
        tag = secrets.token_hex(8)
        self._exec(self.mpool, idx, "bucket_prepare_op",
                   {"tag": tag, "name": name, "op": "put"})
        vid = None
        if vstate == "enabled":
            vid = secrets.token_hex(8)
        elif vstate == "suspended" or (cur is not None
                                       and "versions" in cur):
            vid = "null"
        try:
            chunks = self._write_chunked(
                self._vdata_oid(b["id"], name, vid), data)
        except Exception:
            self._exec(self.mpool, idx, "bucket_cancel_op", {"tag": tag})
            raise
        vrec = {"size": len(data),
                "etag": hashlib.md5(data).hexdigest(),
                "mtime": time.time(), "content_type": content_type,
                "chunks": len(chunks)}
        if actor is not None:
            vrec["owner"] = actor
        replaced: List[Dict] = []
        if vid is None:
            meta = vrec
        else:
            vrec["vid"] = vid
            stack = self._version_stack(b, name, cur)
            # replacing the null slot drops its old data — EXCEPT the
            # oids the new write just reused (a same-slot overwrite
            # shares the base oids; only a legacy-null's unsuffixed
            # objects and shrink-stranded tails actually go)
            replaced = [v for v in stack if v["vid"] == vid]
            stack = [vrec] + [v for v in stack if v["vid"] != vid]
            meta = {"versions": stack}
            meta.update(self._current_summary(stack))
        self._exec(self.mpool, idx, "bucket_complete_op",
                   {"tag": tag, "name": name, "op": "put", "meta": meta})
        if vid is not None:
            # replaced-null data goes only AFTER the index committed
            # (index-first: a crash never leaves a listed version
            # pointing at deleted chunks), minus oids the new write
            # reused
            new_oids = set(chunks)
            for old in replaced:
                for oid in self._vrec_chunk_oids(b, name, old):
                    if oid not in new_oids:
                        self.client.remove(self.dpool, oid)
        if vid is None and cur is not None:
            # a shrinking unversioned overwrite strands the old tail
            # chunks; collect them now (the reference defers to GC)
            for oid in self._chunk_oids(b["id"], name,
                                        cur.get("chunks", 0)
                                        )[len(chunks):]:
                self.client.remove(self.dpool, oid)
        return dict(vrec)

    # ---- versioning plumbing (RGWRados versioned objects) ------------
    def _vdata_oid(self, bid: str, name: str,
                   vid: Optional[str]) -> str:
        base = self._data_oid(bid, name)
        # '#v#' cannot appear in the o_/c_/mp_ escaping, so version
        # payloads never collide with another key's objects
        return base if vid is None else f"{base}#v#{vid}"

    def _vrec_chunk_oids(self, b: Dict, name: str, vrec: Dict):
        base = self._vdata_oid(b["id"], name,
                               None if vrec.get("legacy")
                               else vrec["vid"])
        return [base if i == 0 else
                base.replace("_o_", "_c_", 1) + f".{i}"
                for i in range(vrec.get("chunks", 0))]

    def _raw_entry(self, b: Dict, name: str) -> Dict:
        try:
            return json.loads(self._exec(
                self.mpool, self._index_oid(b["id"]),
                "bucket_get_entry", {"name": name}))
        except RGWError as e:
            if e.result == -2:
                raise RGWError("head_object", -2, "NoSuchKey")
            raise

    def _version_stack(self, b: Dict, name: str,
                       cur: Optional[Dict]) -> List[Dict]:
        """The key's existing versions, newest first; a pre-versioning
        entry is wrapped as the implicit 'null' version whose data
        lives at the unsuffixed oids (the reference's plain->versioned
        transition)."""
        if cur is None:
            return []
        if "versions" in cur:
            return list(cur["versions"])
        legacy = dict(cur)
        legacy.update({"vid": "null", "legacy": True})
        return [legacy]

    @staticmethod
    def _current_summary(stack: List[Dict]) -> Dict:
        """Denormalized current-version fields kept on the entry so
        unversioned readers (stats, listings) stay meaningful."""
        if not stack:
            return {}
        cur = stack[0]
        out = {"size": 0 if cur.get("delete_marker")
               else cur.get("size", 0),
               "etag": cur.get("etag", ""),
               "mtime": cur.get("mtime", 0.0),
               "content_type": cur.get("content_type",
                                       "binary/octet-stream"),
               "chunks": 0 if cur.get("delete_marker")
               else cur.get("chunks", 0),
               "delete_marker": bool(cur.get("delete_marker"))}
        # the uploader owns the object (RGWRados sets the attr owner
        # to the writing user): surface the current version's owner
        # at entry level so _check_object_access sees it
        if "owner" in cur:
            out["owner"] = cur["owner"]
        return out

    def put_bucket_versioning(self, bucket: str, status: str,
                              actor: Optional[str] = None) -> None:
        """status: 'enabled' | 'suspended' (S3 PutBucketVersioning;
        versioning can never return to the never-versioned state)."""
        if status not in ("enabled", "suspended"):
            raise RGWError("put_bucket_versioning", -22, "InvalidArg")
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE_ACP")
        b["versioning"] = status
        self._save_bucket(b)

    def get_bucket_versioning(self, bucket: str,
                              actor: Optional[str] = None
                              ) -> Optional[str]:
        # s3GetBucketVersioning maps to READ_ACP in the reference's
        # op_to_perm (rgw_iam_policy.h:102), not plain READ
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "READ_ACP")
        return b.get("versioning")

    def list_object_versions(self, bucket: str, prefix: str = "",
                             actor: Optional[str] = None
                             ) -> List[Dict]:
        """S3 ListObjectVersions: every version of every key, newest
        first per key, delete markers included."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "READ")
        out: List[Dict] = []
        marker = ""
        while True:
            raw = json.loads(self._exec(
                self.mpool, self._index_oid(b["id"]), "bucket_list",
                {"prefix": prefix, "marker": marker,
                 "max_keys": 1000}))
            for e in raw["entries"]:
                stack = self._version_stack(b, e["name"], e)
                if not stack:
                    stack = [dict(e, vid="null", legacy=True)]
                for i, v in enumerate(stack):
                    out.append({
                        "key": e["name"], "version_id": v["vid"]
                        if "vid" in v else "null",
                        "is_latest": i == 0,
                        "delete_marker": bool(v.get("delete_marker")),
                        "size": v.get("size", 0),
                        "etag": v.get("etag", ""),
                        "mtime": v.get("mtime", 0.0)})
            if not raw["truncated"] or not raw["entries"]:
                break
            marker = raw["entries"][-1]["name"]
        return out

    def get_object(self, bucket: str, name: str,
                   version_id: Optional[str] = None,
                   actor: Optional[str] = None) -> bytes:
        b = self.get_bucket(bucket)
        cur = self._raw_entry(b, name)
        self._check_object_access(b, cur, actor, "READ")
        if "versions" in cur or version_id is not None:
            stack = self._version_stack(b, name, cur)
            if version_id is None:
                if not stack or stack[0].get("delete_marker"):
                    raise RGWError("get_object", -2, "NoSuchKey")
                vrec = stack[0]
            else:
                vrec = next((v for v in stack
                             if v["vid"] == version_id), None)
                if vrec is None:
                    raise RGWError("get_object", -2, "NoSuchVersion")
                if vrec.get("delete_marker"):
                    raise RGWError("get_object", -2, "DeleteMarker")
            oids = self._vrec_chunk_oids(b, name, vrec)
        else:
            oids = self._chunk_oids(b["id"], name, cur["chunks"])
        return b"".join(self.client.read(self.dpool, oid)
                        for oid in oids)

    def _chunk_oids(self, bid: str, name: str, count: int):
        base = self._data_oid(bid, name)
        return [base if i == 0 else
                base.replace("_o_", "_c_", 1) + f".{i}"
                for i in range(count)]

    def head_object(self, bucket: str, name: str,
                    version_id: Optional[str] = None,
                    actor: Optional[str] = None) -> Dict:
        b = self.get_bucket(bucket)
        cur = self._raw_entry(b, name)
        self._check_object_access(b, cur, actor, "READ")
        if version_id is not None:
            vrec = next((v for v in
                         self._version_stack(b, name, cur)
                         if v["vid"] == version_id), None)
            if vrec is None:
                raise RGWError("head_object", -2, "NoSuchVersion")
            return dict(vrec)
        if cur.get("delete_marker"):
            raise RGWError("head_object", -2, "NoSuchKey")
        if "versions" in cur:
            # present the CURRENT version's fields (callers expect the
            # flat size/etag/content_type shape)
            return dict(cur["versions"][0])
        return cur

    def delete_object(self, bucket: str, name: str,
                      version_id: Optional[str] = None,
                      actor: Optional[str] = None) -> Dict:
        """Index first, data second: a crash mid-delete leaves orphan
        chunks (GC debt) but never a listing entry pointing at deleted
        data — the same invariant direction as put.

        Versioned semantics (S3 DeleteObject): without a version id a
        versioned bucket gets a DELETE MARKER pushed (no data removed);
        with one, that exact version is permanently removed — deleting
        the newest exposes its predecessor (restore)."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE")
        cur = self._raw_entry(b, name)
        idx = self._index_oid(b["id"])
        vstate = b.get("versioning")
        versioned = vstate is not None or "versions" in cur

        def _index_put(meta: Dict) -> None:
            tag = secrets.token_hex(8)
            self._exec(self.mpool, idx, "bucket_prepare_op",
                       {"tag": tag, "name": name, "op": "put"})
            self._exec(self.mpool, idx, "bucket_complete_op",
                       {"tag": tag, "name": name, "op": "put",
                        "meta": meta})

        def _index_del() -> None:
            tag = secrets.token_hex(8)
            self._exec(self.mpool, idx, "bucket_prepare_op",
                       {"tag": tag, "name": name, "op": "del"})
            self._exec(self.mpool, idx, "bucket_complete_op",
                       {"tag": tag, "name": name, "op": "del"})

        if not versioned:
            _index_del()
            for oid in self._chunk_oids(b["id"], name,
                                        cur.get("chunks", 0)):
                self.client.remove(self.dpool, oid)
            return {"delete_marker": False}

        stack = self._version_stack(b, name, cur)
        if version_id is None:
            vid = ("null" if vstate == "suspended"
                   else secrets.token_hex(8))
            marker = {"vid": vid, "delete_marker": True,
                      "mtime": time.time()}
            replaced = [v for v in stack if v["vid"] == vid]
            stack = [marker] + [v for v in stack if v["vid"] != vid]
            meta = {"versions": stack}
            meta.update(self._current_summary(stack))
            _index_put(meta)
            # replaced-slot data only after the index committed
            for old_v in replaced:
                for oid in self._vrec_chunk_oids(b, name, old_v):
                    self.client.remove(self.dpool, oid)
            return {"delete_marker": True, "version_id": vid}
        vrec = next((v for v in stack if v["vid"] == version_id), None)
        if vrec is None:
            raise RGWError("delete_object", -2, "NoSuchVersion")
        stack = [v for v in stack if v["vid"] != version_id]
        if stack:
            meta = {"versions": stack}
            meta.update(self._current_summary(stack))
            _index_put(meta)
        else:
            _index_del()
        for oid in self._vrec_chunk_oids(b, name, vrec):
            self.client.remove(self.dpool, oid)
        return {"delete_marker": bool(vrec.get("delete_marker")),
                "version_id": version_id}

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "", marker: str = "",
                     max_keys: int = 1000,
                     actor: Optional[str] = None) -> Dict:
        """S3 ListObjects semantics incl. delimiter rollup into
        CommonPrefixes (RGWRados::cls_bucket_list + RGWListBucket).
        Keys whose CURRENT version is a delete marker are invisible
        here (they only show in list_object_versions)."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "READ")
        raw = json.loads(self._exec(
            self.mpool, self._index_oid(b["id"]), "bucket_list",
            {"prefix": prefix, "marker": marker,
             "max_keys": max_keys if not delimiter else 100000}))
        raw_last = raw["entries"][-1]["name"] if raw["entries"] else ""
        raw["entries"] = [e for e in raw["entries"]
                          if not e.get("delete_marker")]
        if not delimiter:
            # resume from the last RAW key scanned: a page of
            # marker-current keys must still advance the cursor (an
            # empty next_marker would restart callers from the top)
            return {"contents": raw["entries"], "common_prefixes": [],
                    "truncated": raw["truncated"],
                    "next_marker": raw_last}
        # delimiter rollup with GROUP-atomic pagination: a common
        # prefix is never split across pages (the whole contiguous key
        # group is consumed before the cap applies), so resuming from
        # next_marker never re-emits a prefix
        contents, prefixes = [], []
        entries = raw["entries"]
        next_marker = ""
        i = 0
        truncated = False
        while i < len(entries):
            if len(contents) + len(prefixes) >= max_keys:
                truncated = True
                break
            e = entries[i]
            rest = e["name"][len(prefix):]
            if delimiter in rest:
                cp = prefix + rest.split(delimiter, 1)[0] + delimiter
                marker_before_group = next_marker
                prefixes.append(cp)
                while i < len(entries) and \
                        entries[i]["name"].startswith(cp):
                    next_marker = entries[i]["name"]
                    i += 1
                if i == len(entries) and raw["truncated"]:
                    # the group may continue past the raw fetch cap:
                    # withdraw it from this page and resume BEFORE it,
                    # so no prefix is ever emitted twice — unless the
                    # page would then be EMPTY (one group larger than
                    # the raw cap): emit it and advance past what we
                    # consumed, accepting one possible duplicate over a
                    # livelocked pagination
                    if contents or len(prefixes) > 1:
                        prefixes.pop()
                        next_marker = marker_before_group or marker
                    truncated = True
                    break
            else:
                contents.append(e)
                next_marker = e["name"]
                i += 1
        truncated = truncated or raw["truncated"]
        if not contents and not prefixes and raw_last:
            next_marker = raw_last      # all-markers page: still advance
        return {"contents": contents, "common_prefixes": prefixes,
                "truncated": truncated, "next_marker": next_marker}

    # ---- multipart (RGWMultipart*) -----------------------------------------
    def initiate_multipart(self, bucket: str, name: str,
                           actor: Optional[str] = None) -> str:
        """RGWInitMultipart needs s3PutObject on the bucket
        (rgw_op.cc:5155-5160) — WRITE here."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE")
        upload_id = secrets.token_hex(8)
        meta = {"parts": {}, "key": name}
        if actor is not None:
            meta["owner"] = actor
        self.client.write_full(
            self.mpool, f"multipart.{b['id']}.{name}.{upload_id}",
            _j(meta))
        return upload_id

    def list_multipart_uploads(self, bucket: str,
                               actor: Optional[str] = None
                               ) -> List[Dict]:
        """In-progress uploads for a bucket (RGWListBucketMultiparts
        role), sorted by (key, upload_id)."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "READ")
        prefix = f"multipart.{b['id']}."
        out = []
        moids = [o for o in self.client.list_objects(self.mpool)
                 if o.startswith(prefix)]
        for moid in moids:
            rest = moid[len(prefix):]
            if "." not in rest:
                continue
            name, upload_id = rest.rsplit(".", 1)
            mp = self._meta_get(moid) or {}
            out.append({"key": name, "upload_id": upload_id,
                        "owner": mp.get("owner")})
        return sorted(out, key=lambda u: (u["key"], u["upload_id"]))

    def list_parts(self, bucket: str, name: str, upload_id: str,
                   actor: Optional[str] = None) -> List[Dict]:
        """Parts uploaded so far (RGWListMultipart role,
        rgw_op.cc:5641-5644), ascending part number."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "READ")
        mp = self._meta_get(self._mp_meta_oid(b["id"], name,
                                              upload_id))
        if mp is None:
            raise RGWError("list_parts", -2, "NoSuchUpload")
        return [{"part_number": int(pn), "size": p["size"],
                 "etag": p["etag"]}
                for pn, p in sorted(mp["parts"].items(),
                                    key=lambda kv: int(kv[0]))]

    def _mp_meta_oid(self, bid: str, name: str, upload_id: str) -> str:
        return f"multipart.{bid}.{name}.{upload_id}"

    def upload_part(self, bucket: str, name: str, upload_id: str,
                    part_num: int, data: bytes,
                    actor: Optional[str] = None) -> str:
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE")
        # staged parts count against the owner's quota too — without
        # this a quota-limited user could park unbounded data in
        # _multipart_ staging
        self._check_user_quota(b.get("owner"), len(data))
        moid = self._mp_meta_oid(b["id"], name, upload_id)
        mp = self._meta_get(moid)
        if mp is None:
            raise RGWError("upload_part", -2, "NoSuchUpload")
        poid = f"{b['id']}_mp_{name}.{upload_id}.{part_num}"
        r = self.client.write_full(self.dpool, poid, data)
        if r < 0:
            raise RGWError("upload_part", r)
        etag = hashlib.md5(data).hexdigest()
        mp["parts"][str(part_num)] = {"size": len(data), "etag": etag}
        self.client.write_full(self.mpool, moid, _j(mp))
        return etag

    def complete_multipart(self, bucket: str, name: str,
                           upload_id: str,
                           parts: Optional[List[Dict]] = None,
                           actor: Optional[str] = None) -> Dict:
        """Stitch the parts into the final object (copy-concatenate —
        the reference links manifests instead; lite keeps one chunk
        layout for get_object).

        ``parts`` (the client's CompleteMultipartUpload manifest,
        [{'part_number', 'etag'}]) is validated against what was
        uploaded the way RGWCompleteMultipart::execute checks each
        listed part's etag (rgw_op.cc InvalidPart path); None keeps
        the legacy use-everything behavior."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE")
        moid = self._mp_meta_oid(b["id"], name, upload_id)
        mp = self._meta_get(moid)
        if mp is None:
            raise RGWError("complete_multipart", -2, "NoSuchUpload")
        if parts is not None:
            if not parts:
                raise RGWError("complete_multipart", -22,
                               "MalformedXML")
            nums = [p["part_number"] for p in parts]
            # strictly ascending: duplicates are invalid too
            if any(x >= y for x, y in zip(nums, nums[1:])):
                raise RGWError("complete_multipart", -22,
                               "InvalidPartOrder")
            for p in parts:
                have = mp["parts"].get(str(p["part_number"]))
                if have is None or (p.get("etag") and
                                    p["etag"].strip('"') !=
                                    have["etag"]):
                    raise RGWError("complete_multipart", -22,
                                   "InvalidPart")
            use = [str(p["part_number"]) for p in parts]
        else:
            use = sorted(mp["parts"], key=int)
        data = b""
        for pn in use:
            poid = f"{b['id']}_mp_{name}.{upload_id}.{pn}"
            data += self.client.read(self.dpool, poid)
        meta = self.put_object(bucket, name, data, actor=actor)
        self.abort_multipart(bucket, name, upload_id)
        return meta

    def abort_multipart(self, bucket: str, name: str,
                        upload_id: str,
                        actor: Optional[str] = None) -> None:
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE")
        moid = self._mp_meta_oid(b["id"], name, upload_id)
        mp = self._meta_get(moid)
        if mp is None:
            return
        for pn in mp["parts"]:
            self.client.remove(
                self.dpool,
                f"{b['id']}_mp_{name}.{upload_id}.{pn}")
        self.client.remove(self.mpool, moid)


    # ---- ACLs (rgw_acl_s3.cc role; grants as structured dicts) -------------
    CANNED_ACLS = {
        "private": [],
        "public-read": [{"grantee": "*", "permission": "READ"}],
        "public-read-write": [{"grantee": "*", "permission": "READ"},
                              {"grantee": "*", "permission": "WRITE"}],
        "authenticated-read": [{"grantee": "auth",
                                "permission": "READ"}],
    }

    @staticmethod
    def _grants_allow(owner: Optional[str], grants: List[Dict],
                      actor: Optional[str], perm: str) -> bool:
        """The RGWAccessControlPolicy::verify_permission decision:
        owner holds FULL_CONTROL; grants match by grantee (uid,
        'auth' = any authenticated user, '*' = everyone) and
        permission (FULL_CONTROL implies all)."""
        if owner is not None and actor == owner:
            return True
        for g in grants or []:
            who = g.get("grantee")
            if who == "*" or (who == "auth" and actor is not None)                     or (who == actor and actor is not None):
                if g.get("permission") in (perm, "FULL_CONTROL"):
                    return True
        return False

    def _check_bucket_access(self, b: Dict, actor: Optional[str],
                             perm: str) -> None:
        """actor None = the system/admin path (radosgw-admin), which
        bypasses policy like the reference's system uid."""
        if actor is None:
            return
        acl = b.get("acl") or {}
        if not self._grants_allow(b.get("owner"),
                                  acl.get("grants", []), actor, perm):
            raise RGWError("access", -13, "AccessDenied")

    def _check_object_access(self, b: Dict, entry: Dict,
                             actor: Optional[str], perm: str) -> None:
        if actor is None:
            return
        acl = entry.get("acl")
        owner = entry.get("owner", b.get("owner"))
        grants = (acl or {}).get("grants", [])
        if self._grants_allow(owner, grants, actor, perm):
            return
        # fall back to the bucket policy (the reference checks both)
        self._check_bucket_access(b, actor, perm)

    def _resolve_grants(self, canned: Optional[str],
                        grants: Optional[List[Dict]]) -> List[Dict]:
        if canned is not None:
            if canned not in self.CANNED_ACLS:
                raise RGWError("acl", -22, "InvalidCannedACL")
            return list(self.CANNED_ACLS[canned])
        return list(grants or [])

    def put_bucket_acl(self, bucket: str, canned: Optional[str] = None,
                       grants: Optional[List[Dict]] = None,
                       actor: Optional[str] = None) -> None:
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE_ACP")
        b["acl"] = {"grants": self._resolve_grants(canned, grants)}
        self._save_bucket(b)

    def get_bucket_acl(self, bucket: str,
                       actor: Optional[str] = None) -> Dict:
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "READ_ACP")
        return {"owner": b.get("owner"),
                "grants": (b.get("acl") or {}).get("grants", [])}

    def put_object_acl(self, bucket: str, name: str,
                       canned: Optional[str] = None,
                       grants: Optional[List[Dict]] = None,
                       actor: Optional[str] = None) -> None:
        b = self.get_bucket(bucket)
        cur = self._raw_entry(b, name)
        self._check_object_access(b, cur, actor, "WRITE_ACP")
        cur["acl"] = {"grants": self._resolve_grants(canned, grants)}
        tag = secrets.token_hex(8)
        idx = self._index_oid(b["id"])
        self._exec(self.mpool, idx, "bucket_prepare_op",
                   {"tag": tag, "name": name, "op": "put"})
        self._exec(self.mpool, idx, "bucket_complete_op",
                   {"tag": tag, "name": name, "op": "put", "meta": cur})

    def get_object_acl(self, bucket: str, name: str,
                       actor: Optional[str] = None) -> Dict:
        b = self.get_bucket(bucket)
        cur = self._raw_entry(b, name)
        self._check_object_access(b, cur, actor, "READ_ACP")
        return {"owner": cur.get("owner", b.get("owner")),
                "grants": (cur.get("acl") or {}).get("grants", [])}

    # ---- lifecycle (rgw_lc.cc role) ----------------------------------------
    def put_bucket_lifecycle(self, bucket: str, rules: List[Dict],
                             actor: Optional[str] = None) -> None:
        """rules: [{'id', 'prefix', 'status', 'expiration_days',
        'noncurrent_days'}] (the S3 LifecycleConfiguration subset the
        reference's RGWLC processes most)."""
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE_ACP")
        for r in rules:
            if not (r.get("expiration_days")
                    or r.get("noncurrent_days")):
                raise RGWError("lifecycle", -22, "MissingAction")
        b["lifecycle"] = list(rules)
        self._save_bucket(b)

    def get_bucket_lifecycle(self, bucket: str,
                             actor: Optional[str] = None
                             ) -> List[Dict]:
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "READ_ACP")
        return list(b.get("lifecycle") or [])

    def delete_bucket_lifecycle(self, bucket: str,
                                actor: Optional[str] = None) -> None:
        b = self.get_bucket(bucket)
        self._check_bucket_access(b, actor, "WRITE_ACP")
        b.pop("lifecycle", None)
        self._save_bucket(b)

    def lc_process(self, now: Optional[float] = None) -> Dict:
        """One lifecycle pass over every bucket (radosgw-admin lc
        process / RGWLC::process): expire current objects past
        expiration_days (versioned buckets get delete markers),
        permanently drop noncurrent versions past noncurrent_days,
        and clean up expired-object delete markers left alone on a
        stack."""
        now = time.time() if now is None else now
        report: Dict[str, Dict] = {}
        meta_oids = list(self.client.list_objects(self.mpool))
        for moid in sorted(o for o in meta_oids
                           if o.startswith("bucket.")):
            bname = moid[len("bucket."):]
            try:
                b = self.get_bucket(bname)
            except RGWError:
                continue
            rules = [r for r in (b.get("lifecycle") or [])
                     if r.get("status", "Enabled") == "Enabled"]
            if not rules:
                continue
            stats = {"expired": 0, "noncurrent_removed": 0,
                     "markers_cleaned": 0}
            all_versions = self.list_object_versions(bname)
            per_key_count: Dict[str, int] = {}
            for v in all_versions:
                per_key_count[v["key"]] = \
                    per_key_count.get(v["key"], 0) + 1
            for v in all_versions:
                key = v["key"]
                rule = next((r for r in rules
                             if key.startswith(r.get("prefix", ""))),
                            None)
                if rule is None:
                    continue
                exp = rule.get("expiration_days")
                non = rule.get("noncurrent_days")
                age_days = (now - v["mtime"]) / 86400.0
                if v["is_latest"]:
                    if exp and not v["delete_marker"]                             and age_days >= exp:
                        self.delete_object(bname, key)
                        stats["expired"] += 1
                    elif v["delete_marker"] and exp:
                        # expired-object delete marker: the marker is
                        # the ONLY version left -> remove the entry
                        if per_key_count.get(key, 0) == 1:
                            self.delete_object(
                                bname, key, version_id=v["version_id"])
                            stats["markers_cleaned"] += 1
                elif non and age_days >= non:
                    self.delete_object(bname, key,
                                       version_id=v["version_id"])
                    stats["noncurrent_removed"] += 1
            report[bname] = stats
        return report

    # ---- garbage collection (RGWGC role, src/rgw/rgw_gc.cc) ----------------
    def gc(self, repair: bool = False) -> Dict:
        """Scan for debt the two-phase protocol can leave behind: data
        objects not referenced by any committed index entry or active
        multipart upload (crashed puts, interrupted deletes), and
        uncommitted pending index markers.  With ``repair``, orphans
        are deleted and pending markers cancelled — the rgw gc +
        radosgw-admin gc process role.  Run it quiesced: a put in
        flight legitimately holds a pending marker and unreferenced
        chunks."""
        report = {"orphan_objects": [], "stale_pending": []}
        meta_oids = list(self.client.list_objects(self.mpool))
        bucket_names = [o[len("bucket."):] for o in meta_oids
                        if o.startswith("bucket.")]
        referenced = set()
        known_bids = set()
        pending: list = []
        protected_bids = set()
        for name in bucket_names:
            try:
                b = self.get_bucket(name)
            except RGWError:
                continue
            known_bids.add(b["id"])
            try:
                marker = ""
                while True:          # paginate over the RAW index:
                    # keys whose current is a delete marker are hidden
                    # from ListObjects, but their noncurrent versions'
                    # data is very much alive — gc must see them
                    listing = json.loads(self._exec(
                        self.mpool, self._index_oid(b["id"]),
                        "bucket_list",
                        {"prefix": "", "marker": marker,
                         "max_keys": 10000}))
                    listing["contents"] = listing.pop("entries")
                    for e in listing["contents"]:
                        if "versions" in e:
                            for v in e["versions"]:
                                referenced.update(self._vrec_chunk_oids(
                                    b, e["name"], v))
                        else:
                            referenced.update(self._chunk_oids(
                                b["id"], e["name"],
                                e.get("chunks", 1)))
                    if not listing["truncated"] or \
                            not listing["contents"]:
                        break
                    marker = listing["contents"][-1]["name"]
            except RGWError:
                # index unreadable/lost (ESTALE): this bucket's
                # references are unknowable — its data must never be
                # classified as orphaned
                protected_bids.add(b["id"])
            idx = self._index_oid(b["id"])
            try:
                om = self.client.omap_get(self.mpool, idx)
            except IOError:
                om = {}
            for k in om:
                if k.startswith("pending_"):
                    pending.append((name, idx, k[len("pending_"):]))
        for moid in meta_oids:
            if not moid.startswith("multipart."):
                continue
            mp = self._meta_get(moid)
            if not mp:
                continue
            _, bid, rest = moid.split(".", 2)
            name, upload_id = rest.rsplit(".", 1)
            for pn in mp.get("parts", {}):
                referenced.add(f"{bid}_mp_{name}.{upload_id}.{pn}")
        import re
        rgw_oid = re.compile(r"^[0-9a-f]{16}_(o|c|mp)_")
        # a bucket whose INDEX object exists but whose bucket.<name>
        # meta was unreadable this pass is unknowable — its data must
        # never be purged (the index may reference it); only a bucket
        # with NO index object left (delete_bucket removed it) has
        # truly deleted debris
        index_bids = {o[len(".dir."):] for o in meta_oids
                      if o.startswith(".dir.")}
        for oid in self.client.list_objects(self.dpool):
            if not rgw_oid.match(oid):
                continue             # not an rgw data object
            bid = oid.split("_", 1)[0]
            if bid in protected_bids:
                continue             # meta alive, index unreadable
            if bid in index_bids and bid not in known_bids:
                continue             # index alive, meta unreadable
            if bid in known_bids and oid in referenced:
                continue
            report["orphan_objects"].append(oid)
            if repair:
                self.client.remove(self.dpool, oid)
        for name, idx, tag in pending:
            report["stale_pending"].append([name, tag])
            if repair:
                self._exec(self.mpool, idx, "bucket_cancel_op",
                           {"tag": tag})
        return report
