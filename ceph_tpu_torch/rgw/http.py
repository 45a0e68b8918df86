"""S3 path-style HTTP frontend for rgw-lite (the civetweb/beast
frontend role, src/rgw/rgw_main.cc + rgw_rest_s3.cc at lite scale).

Speaks the S3 subset the gateway implements over path-style URLs
(``/bucket``, ``/bucket/key``): bucket PUT/GET/DELETE, object
PUT/GET/HEAD/DELETE/POST, ListObjectsV1/V2, and the subresources the
reference routes in rgw_rest_s3.cc: ``?versioning`` (GET/PUT,
rgw_rest_s3.cc:868-960), ``?versions`` (ListObjectVersions),
``versionId=`` on object GET/HEAD/DELETE, ``?acl`` (GET/PUT bucket +
object policy XML, rgw_rest_s3.cc:2176-2209 / rgw_acl_s3.cc
grammar), ``?lifecycle`` (GET/PUT/DELETE), and multipart
(``?uploads`` POST/GET, ``uploadId=`` PUT/POST/GET/DELETE,
rgw_rest_s3.cc:2628).  Auth speaks both reference header flavors
(rgw_auth_s3.cc): AWS signature v2 with full canonicalization
(content-md5/content-type/date-or-x-amz-date, sorted x-amz-*
headers, and the signed-subresource canonical resource) and AWS
signature v4 (``AWS4-HMAC-SHA256``: canonical request over the
SignedHeaders list, credential-scope HMAC key chain, and
x-amz-content-sha256 payload verification incl. UNSIGNED-PAYLOAD).

``handle()`` is a pure request->response function (testable without
sockets); ``serve()`` wraps it in a threaded stdlib HTTPServer.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import re
import time as _time
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple
from xml.sax.saxutils import escape

from . import acl_xml
from .gateway import RGWError, RGWLite


def _sign_v2(secret: str, method: str, date: str, path: str) -> str:
    """Legacy helper: the v2 string-to-sign with every optional
    section empty (kept for callers that sign bare requests)."""
    sts = f"{method}\n\n\n{date}\n{path}"
    mac = hmac.new(secret.encode(), sts.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


# the subresources that participate in the v2 canonical resource, in
# the reference's sorted order (rgw_auth_s3.cc:23-48
# signed_subresources)
SIGNED_SUBRESOURCES = (
    "acl", "cors", "delete", "lifecycle", "location", "logging",
    "notification", "partNumber", "policy", "requestPayment",
    "response-cache-control", "response-content-disposition",
    "response-content-encoding", "response-content-language",
    "response-content-type", "response-expires", "tagging", "torrent",
    "uploadId", "uploads", "versionId", "versioning", "versions",
    "website")


def _canon_amz_headers(headers: Dict[str, str]) -> str:
    """x-amz-* headers, lowercased keys, sorted, "k:v\\n" each
    (rgw_auth_s3.cc get_canon_amz_hdr over the meta map)."""
    metas = sorted((k.lower(), v.strip()) for k, v in headers.items()
                   if k.lower().startswith("x-amz-"))
    return "".join(f"{k}:{v}\n" for k, v in metas)


def _canon_resource(path: str, query: Dict[str, str]) -> str:
    """path + the signed subresources present in the query, '?'/'&'
    joined, '=value' only when non-empty (get_canon_resource)."""
    out = path
    initial = True
    for sub in SIGNED_SUBRESOURCES:
        if sub not in query:
            continue
        out += "?" if initial else "&"
        initial = False
        out += sub
        if query[sub]:
            out += "=" + query[sub]
    return out


def string_to_sign_v2(method: str, path: str, headers: Dict[str, str],
                      query: Dict[str, str]) -> str:
    """The full v2 canonical header string
    (rgw_create_s3_canonical_header): Date drops to empty when
    x-amz-date is supplied."""
    h = {k.lower(): v for k, v in headers.items()}
    date = "" if "x-amz-date" in h else h.get("date", "")
    return (f"{method}\n{h.get('content-md5', '')}\n"
            f"{h.get('content-type', '')}\n{date}\n"
            f"{_canon_amz_headers(headers)}"
            f"{_canon_resource(path, query)}")


def sign_v2(secret: str, method: str, path: str,
            headers: Optional[Dict[str, str]] = None,
            query: Optional[Dict[str, str]] = None) -> str:
    sts = string_to_sign_v2(method, path, headers or {}, query or {})
    mac = hmac.new(secret.encode(), sts.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


# ---- AWS signature v4 (rgw_auth_s3.cc:400-760) --------------------------

def _uri_quote(s: str, safe: str = "-_.~") -> str:
    out = []
    for ch in s.encode():
        c = chr(ch)
        # ASCII-only: non-ASCII bytes must always %-escape (AWS v4
        # canonical URI encoding; unicode alnum chars don't count)
        if ch < 0x80 and (c.isalnum() or c in safe):
            out.append(c)
        else:
            out.append("%%%02X" % ch)
    return "".join(out)


def v4_canonical_request(method: str, path: str,
                         query: Dict[str, str],
                         headers: Dict[str, str],
                         signed_headers: List[str],
                         payload_hash: str) -> str:
    h = {k.lower(): v for k, v in headers.items()}
    cq = "&".join(
        f"{_uri_quote(k)}={_uri_quote(v)}"
        for k, v in sorted(query.items()))
    ch = "".join(f"{name}:{' '.join(h.get(name, '').split())}\n"
                 for name in signed_headers)
    return "\n".join([method, _uri_quote(path, safe="/-_.~"), cq, ch,
                      ";".join(signed_headers), payload_hash])


def v4_signature(secret: str, amz_date: str, scope: str,
                 canonical_request: str) -> str:
    """AWS4-HMAC-SHA256: chained signing key over the credential
    scope, then HMAC of the string-to-sign (get_v4_signing_key /
    get_v4_signature)."""
    sts = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])
    key = ("AWS4" + secret).encode()
    for part in scope.split("/"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def sign_v4(access_key: str, secret: str, method: str, path: str,
            headers: Dict[str, str],
            query: Optional[Dict[str, str]] = None,
            body: bytes = b"", region: str = "default",
            unsigned_payload: bool = False) -> str:
    """Client-side convenience: returns the Authorization header value
    for a v4-signed request (x-amz-date and x-amz-content-sha256 must
    already be in *headers*; this fills them if absent)."""
    amz_date = headers.get("x-amz-date")
    if amz_date is None:
        amz_date = _time.strftime("%Y%m%dT%H%M%SZ", _time.gmtime())
        headers["x-amz-date"] = amz_date
    if "x-amz-content-sha256" not in headers:
        headers["x-amz-content-sha256"] = (
            "UNSIGNED-PAYLOAD" if unsigned_payload
            else hashlib.sha256(body).hexdigest())
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    signed = sorted(k.lower() for k in headers
                    if k.lower() in ("host", "content-type",
                                     "content-md5")
                    or k.lower().startswith("x-amz-"))
    creq = v4_canonical_request(method, path, query or {}, headers,
                                signed, headers["x-amz-content-sha256"])
    sig = v4_signature(secret, amz_date, scope, creq)
    return (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")


def _err(status: int, code: str, message: str = "") -> Tuple[int, Dict,
                                                             bytes]:
    body = (f'<?xml version="1.0"?><Error><Code>{escape(code)}</Code>'
            f"<Message>{escape(message or code)}</Message></Error>")
    return status, {"Content-Type": "application/xml"}, body.encode()


_ERRNO_TO_S3 = {
    -2: (404, "NoSuchKey"),
    -13: (403, "AccessDenied"),
    -17: (409, "BucketAlreadyExists"),
    -22: (400, "InvalidArgument"),
    -39: (409, "BucketNotEmpty"),
}

# gateway reasons that ARE S3 error codes ride through verbatim (the
# reference maps op_ret -> rgw_http_errors the same way)
_CODE_RE = re.compile(r"^[A-Z][A-Za-z]+$")


def _rgw_err(e: RGWError) -> Tuple[int, Dict, bytes]:
    status, code = _ERRNO_TO_S3.get(e.result, (500, "InternalError"))
    # RGWError's str is "rgw <api>: <result> <reason>"; when the
    # reason IS an S3 code (NoSuchUpload, InvalidPart, ...) it rides
    # through verbatim like the reference's rgw_http_errors mapping
    reason = str(e).rsplit(" ", 1)[-1]
    if _CODE_RE.match(reason):
        code = reason
    return _err(status, code, str(e))


def _iso8601(ts: float) -> str:
    return _time.strftime("%Y-%m-%dT%H:%M:%S.000Z", _time.gmtime(ts))


# namespace-insensitive XML helpers shared with the ACL grammar
_xml_local = acl_xml._local
_xml_find = acl_xml._find


def _xml_text(el, name, default: str = "") -> str:
    child = _xml_find(el, name)
    return (child.text or "").strip() if child is not None else default


class S3Frontend:
    def __init__(self, rgw: RGWLite):
        self.rgw = rgw

    # ---- auth --------------------------------------------------------------
    def _authenticate(self, method: str, path: str,
                      headers: Dict[str, str], query: Dict[str, str],
                      body: bytes) -> Optional[Dict]:
        """Header auth, v2 (``AWS AK:sig``, full canonicalization incl.
        content headers, x-amz-*, and signed subresources) or v4
        (``AWS4-HMAC-SHA256 Credential=.., SignedHeaders=..,
        Signature=..``) — rgw_auth_s3.cc's two header flavors."""
        auth = headers.get("Authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            return self._authenticate_v4(method, path, headers, query,
                                         body, auth)
        if not auth.startswith("AWS ") or ":" not in auth[4:]:
            return None
        access_key, sig = auth[4:].split(":", 1)
        user = self.rgw.user_by_access_key(access_key)
        if user is None:
            return None
        secret = self.rgw.secret_for_key(user, access_key)
        want = sign_v2(secret, method, path, headers, query)
        return user if hmac.compare_digest(want, sig) else None

    def _authenticate_v4(self, method: str, path: str,
                         headers: Dict[str, str],
                         query: Dict[str, str], body: bytes,
                         auth: str) -> Optional[Dict]:
        fields: Dict[str, str] = {}
        for part in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        cred = fields.get("Credential", "")
        signed = [s for s in fields.get("SignedHeaders", "").split(";")
                  if s]
        sig = fields.get("Signature", "")
        # access_key/YYYYMMDD/region/service/aws4_request
        # (rgw_auth_s3.cc:419-427)
        bits = cred.split("/")
        if len(bits) != 5 or bits[4] != "aws4_request" or not signed \
                or not sig:
            return None
        access_key, scope = bits[0], "/".join(bits[1:])
        user = self.rgw.user_by_access_key(access_key)
        if user is None:
            return None
        secret = self.rgw.secret_for_key(user, access_key)
        h = {k.lower(): v for k, v in headers.items()}
        amz_date = h.get("x-amz-date", "")
        if not amz_date.startswith(bits[1]):
            return None                # credential date != request date
        payload_hash = h.get("x-amz-content-sha256",
                             "UNSIGNED-PAYLOAD")
        if payload_hash == "STREAMING-AWS4-HMAC-SHA256-PAYLOAD":
            # chunked uploads need per-chunk signature verification
            # (the reference's AWSv4ComplMulti); accepting the body
            # unverified would be an integrity hole, so refuse
            return None
        if payload_hash != "UNSIGNED-PAYLOAD":
            if payload_hash != hashlib.sha256(body).hexdigest():
                return None            # body does not match its hash
        creq = v4_canonical_request(method, path, query, headers,
                                    signed, payload_hash)
        want = v4_signature(secret, amz_date, scope, creq)
        return user if hmac.compare_digest(want, sig) else None

    # ---- request router ----------------------------------------------------
    def handle(self, method: str, path: str,
               headers: Optional[Dict[str, str]] = None,
               body: bytes = b"",
               query: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Dict[str, str], bytes]:
        headers = headers or {}
        query = query or {}
        user = self._authenticate(method, path.split("?")[0], headers,
                                  query, body)
        if user is None:
            return _err(403, "AccessDenied", "bad or missing signature")
        if user.get("suspended"):
            # the reference's RGW_USER_SUSPENDED refusal
            return _err(403, "UserSuspended", "account suspended")
        parts = path.split("?")[0].strip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        try:
            if not bucket:
                return self._list_buckets(user)
            if not key:
                return self._bucket_op(method, user, bucket, query,
                                       body, headers)
            return self._object_op(method, user, bucket, key, body,
                                   query, headers)
        except RGWError as e:
            return _rgw_err(e)
        except ValueError as e:
            msg = str(e)
            code = msg.split(":", 1)[0] if _CODE_RE.match(
                msg.split(":", 1)[0]) else "InvalidArgument"
            return _err(400, code, msg)
        except Exception as e:      # a handler thread must always reply
            return _err(500, "InternalError", repr(e))

    # ---- display names for ACL XML -----------------------------------------
    def _display_names(self, *uids: Optional[str]) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for uid in uids:
            if not uid or uid in ("*", "auth") or uid in out:
                continue
            try:
                dn = self.rgw.get_user(uid).get("display_name")
            except RGWError:
                continue
            if dn:
                out[uid] = dn
        return out

    def _acl_response(self, policy: Dict) -> Tuple[int, Dict, bytes]:
        uids = [policy.get("owner")] + \
            [g["grantee"] for g in policy.get("grants", [])]
        xml = acl_xml.policy_to_xml(policy.get("owner"),
                                    policy.get("grants", []),
                                    self._display_names(*uids))
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    @staticmethod
    def _acl_request(headers: Dict[str, str], body: bytes
                     ) -> Tuple[Optional[str], Optional[List[Dict]]]:
        """PUT ?acl input: an XML policy body, else the x-amz-acl
        canned header (the reference accepts both; body wins)."""
        if body.strip():
            _owner, grants = acl_xml.policy_from_xml(body)
            return None, grants
        canned = headers.get("x-amz-acl") or \
            headers.get("X-Amz-Acl") or "private"
        return canned, None

    def _list_buckets(self, user):
        names = "".join(f"<Bucket><Name>{escape(n)}</Name></Bucket>"
                        for n in self.rgw.list_buckets(user["uid"]))
        xml = (f'<?xml version="1.0"?><ListAllMyBucketsResult>'
               f"<Buckets>{names}</Buckets></ListAllMyBucketsResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    def _bucket_op(self, method, user, bucket, query, body, headers):
        actor = user["uid"]
        if "versioning" in query:
            return self._versioning_op(method, actor, bucket, body)
        if "versions" in query:
            return self._list_versions(method, actor, bucket, query)
        if "acl" in query:
            return self._bucket_acl_op(method, actor, bucket, body,
                                       headers)
        if "lifecycle" in query:
            return self._lifecycle_op(method, actor, bucket, body)
        if "uploads" in query and method == "GET":
            return self._list_uploads(actor, bucket)
        if method == "PUT":
            self.rgw.create_bucket(user["uid"], bucket)
            return 200, {}, b""
        if method == "DELETE":
            # policy-gated like every other op (RGWDeleteBucket goes
            # through verify_bucket_permission, not a raw owner check)
            self.rgw.delete_bucket(bucket, actor=actor)
            return 204, {}, b""
        if method == "GET":
            # ACL-gated (bucket READ), not owner-gated: public-read
            # buckets list for any authenticated caller
            v2 = query.get("list-type") == "2"
            marker = (query.get("continuation-token")
                      or query.get("start-after", "")) if v2 \
                else query.get("marker", "")
            res = self.rgw.list_objects(
                bucket, prefix=query.get("prefix", ""),
                delimiter=query.get("delimiter", ""),
                marker=marker,
                max_keys=int(query.get("max-keys", "1000")),
                actor=user["uid"])
            items = "".join(
                f"<Contents><Key>{escape(e['name'])}</Key>"
                f"<Size>{e['size']}</Size>"
                f'<ETag>"{e["etag"]}"</ETag></Contents>'
                for e in res["contents"])
            cps = "".join(
                f"<CommonPrefixes><Prefix>{escape(p)}</Prefix>"
                f"</CommonPrefixes>"
                for p in res["common_prefixes"])
            extra = ""
            if v2:
                count = len(res["contents"]) + len(res["common_prefixes"])
                extra = f"<KeyCount>{count}</KeyCount>"
                if res["truncated"] and res.get("next_marker"):
                    tok = escape(res["next_marker"])
                    extra += (f"<NextContinuationToken>{tok}"
                              f"</NextContinuationToken>")
            xml = (f'<?xml version="1.0"?><ListBucketResult>'
                   f"<Name>{escape(bucket)}</Name>"
                   f"<IsTruncated>{str(res['truncated']).lower()}"
                   f"</IsTruncated>{extra}{items}{cps}"
                   f"</ListBucketResult>")
            return 200, {"Content-Type": "application/xml"}, xml.encode()
        return _err(405, "MethodNotAllowed")

    # ---- ?versioning (rgw_rest_s3.cc:868-960) ------------------------------
    def _versioning_op(self, method, actor, bucket, body):
        if method == "GET":
            status = self.rgw.get_bucket_versioning(bucket,
                                                    actor=actor)
            inner = "" if status is None else \
                f"<Status>{status.capitalize()}</Status>"
            xml = (f'<?xml version="1.0"?>'
                   f'<VersioningConfiguration xmlns="{acl_xml.XMLNS}">'
                   f"{inner}</VersioningConfiguration>")
            return 200, {"Content-Type": "application/xml"}, \
                xml.encode()
        if method == "PUT":
            try:
                root = ET.fromstring(body)
            except ET.ParseError:
                return _err(400, "MalformedXML")
            if _xml_local(root.tag) != "VersioningConfiguration":
                return _err(400, "MalformedXML")
            status = _xml_text(root, "Status")
            if not status:      # VersioningNotChanged
                return 200, {}, b""
            if status.lower() not in ("enabled", "suspended"):
                return _err(400, "MalformedXML",
                            f"bad Status {status!r}")
            self.rgw.put_bucket_versioning(bucket, status.lower(),
                                           actor=actor)
            return 200, {}, b""
        return _err(405, "MethodNotAllowed")

    # ---- ?versions (ListObjectVersions) ------------------------------------
    def _list_versions(self, method, actor, bucket, query):
        if method != "GET":
            return _err(405, "MethodNotAllowed")
        vers = self.rgw.list_object_versions(
            bucket, prefix=query.get("prefix", ""), actor=actor)
        items = []
        for v in vers:
            tag = "DeleteMarker" if v["delete_marker"] else "Version"
            fields = (f"<Key>{escape(v['key'])}</Key>"
                      f"<VersionId>{escape(v['version_id'])}"
                      f"</VersionId>"
                      f"<IsLatest>{str(v['is_latest']).lower()}"
                      f"</IsLatest>"
                      f"<LastModified>{_iso8601(v['mtime'])}"
                      f"</LastModified>")
            if not v["delete_marker"]:
                fields += (f'<ETag>"{v["etag"]}"</ETag>'
                           f"<Size>{v['size']}</Size>")
            items.append(f"<{tag}>{fields}</{tag}>")
        xml = (f'<?xml version="1.0"?>'
               f'<ListVersionsResult xmlns="{acl_xml.XMLNS}">'
               f"<Name>{escape(bucket)}</Name>"
               f"<Prefix>{escape(query.get('prefix', ''))}</Prefix>"
               f"{''.join(items)}</ListVersionsResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    # ---- ?acl (bucket) -----------------------------------------------------
    def _bucket_acl_op(self, method, actor, bucket, body, headers):
        if method == "GET":
            return self._acl_response(
                self.rgw.get_bucket_acl(bucket, actor=actor))
        if method == "PUT":
            canned, grants = self._acl_request(headers, body)
            self.rgw.put_bucket_acl(bucket, canned=canned,
                                    grants=grants, actor=actor)
            return 200, {}, b""
        return _err(405, "MethodNotAllowed")

    # ---- ?lifecycle --------------------------------------------------------
    def _lifecycle_op(self, method, actor, bucket, body):
        if method == "GET":
            rules = self.rgw.get_bucket_lifecycle(bucket, actor=actor)
            if not rules:
                return _err(404, "NoSuchLifecycleConfiguration")
            items = []
            for r in rules:
                inner = ""
                if r.get("id"):
                    inner += f"<ID>{escape(r['id'])}</ID>"
                inner += (f"<Prefix>{escape(r.get('prefix', ''))}"
                          f"</Prefix>"
                          f"<Status>{r.get('status', 'Enabled')}"
                          f"</Status>")
                if r.get("expiration_days"):
                    inner += (f"<Expiration><Days>"
                              f"{r['expiration_days']}</Days>"
                              f"</Expiration>")
                if r.get("noncurrent_days"):
                    inner += (f"<NoncurrentVersionExpiration>"
                              f"<NoncurrentDays>"
                              f"{r['noncurrent_days']}"
                              f"</NoncurrentDays>"
                              f"</NoncurrentVersionExpiration>")
                items.append(f"<Rule>{inner}</Rule>")
            xml = (f'<?xml version="1.0"?>'
                   f'<LifecycleConfiguration xmlns="{acl_xml.XMLNS}">'
                   f"{''.join(items)}</LifecycleConfiguration>")
            return 200, {"Content-Type": "application/xml"}, \
                xml.encode()
        if method == "PUT":
            try:
                root = ET.fromstring(body)
            except ET.ParseError:
                return _err(400, "MalformedXML")
            rules = []
            for rule in root:
                if _xml_local(rule.tag) != "Rule":
                    continue
                r: Dict = {"id": _xml_text(rule, "ID"),
                           "prefix": _xml_text(rule, "Prefix"),
                           "status": _xml_text(rule, "Status",
                                               "Enabled")}
                exp = _xml_find(rule, "Expiration")
                if exp is not None:
                    r["expiration_days"] = int(_xml_text(exp, "Days",
                                                         "0"))
                non = _xml_find(rule, "NoncurrentVersionExpiration")
                if non is not None:
                    r["noncurrent_days"] = int(
                        _xml_text(non, "NoncurrentDays", "0"))
                rules.append(r)
            if not rules:
                return _err(400, "MalformedXML", "no Rule")
            self.rgw.put_bucket_lifecycle(bucket, rules, actor=actor)
            return 200, {}, b""
        if method == "DELETE":
            self.rgw.delete_bucket_lifecycle(bucket, actor=actor)
            return 204, {}, b""
        return _err(405, "MethodNotAllowed")

    # ---- ?uploads listing --------------------------------------------------
    def _list_uploads(self, actor, bucket):
        ups = self.rgw.list_multipart_uploads(bucket, actor=actor)
        items = "".join(
            f"<Upload><Key>{escape(u['key'])}</Key>"
            f"<UploadId>{escape(u['upload_id'])}</UploadId></Upload>"
            for u in ups)
        xml = (f'<?xml version="1.0"?>'
               f'<ListMultipartUploadsResult xmlns="{acl_xml.XMLNS}">'
               f"<Bucket>{escape(bucket)}</Bucket>{items}"
               f"</ListMultipartUploadsResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    # ---- objects -----------------------------------------------------------
    def _object_op(self, method, user, bucket, key, body, query,
                   headers):
        # policy decisions live in the gateway's ACL engine (canned
        # ACLs + grants, rgw_acl_s3.cc role): the frontend just
        # supplies the authenticated actor
        actor = user["uid"]
        if "acl" in query:
            return self._object_acl_op(method, actor, bucket, key,
                                       body, headers)
        if "uploads" in query and method == "POST":
            upload_id = self.rgw.initiate_multipart(bucket, key,
                                                    actor=actor)
            xml = (f'<?xml version="1.0"?>'
                   f'<InitiateMultipartUploadResult '
                   f'xmlns="{acl_xml.XMLNS}">'
                   f"<Bucket>{escape(bucket)}</Bucket>"
                   f"<Key>{escape(key)}</Key>"
                   f"<UploadId>{upload_id}</UploadId>"
                   f"</InitiateMultipartUploadResult>")
            return 200, {"Content-Type": "application/xml"}, \
                xml.encode()
        if "uploadId" in query:
            return self._multipart_op(method, actor, bucket, key,
                                      body, query)
        vid = query.get("versionId")
        if method == "PUT":
            meta = self.rgw.put_object(bucket, key, body, actor=actor)
            hdrs = {"ETag": f'"{meta["etag"]}"'}
            if meta.get("vid"):
                hdrs["x-amz-version-id"] = meta["vid"]
            canned = headers.get("x-amz-acl") or \
                headers.get("X-Amz-Acl")
            if canned:
                # object-level canned ACL on upload; the actor just
                # became the owner, so this cannot be denied
                self.rgw.put_object_acl(bucket, key, canned=canned,
                                        actor=actor)
            return 200, hdrs, b""
        if method == "GET":
            data = self.rgw.get_object(bucket, key, version_id=vid,
                                       actor=actor)
            meta = self.rgw.head_object(bucket, key, version_id=vid)
            hdrs = {"Content-Type": meta["content_type"],
                    "ETag": f'"{meta["etag"]}"'}
            if meta.get("vid"):
                hdrs["x-amz-version-id"] = meta["vid"]
            return 200, hdrs, data
        if method == "HEAD":
            meta = self.rgw.head_object(bucket, key, version_id=vid,
                                        actor=actor)
            if meta.get("delete_marker"):
                return _err(405, "MethodNotAllowed",
                            "delete marker")   # S3's 405 on marker HEAD
            hdrs = {"Content-Length": str(meta["size"]),
                    "ETag": f'"{meta["etag"]}"'}
            if meta.get("vid"):
                hdrs["x-amz-version-id"] = meta["vid"]
            return 200, hdrs, b""
        if method == "DELETE":
            res = self.rgw.delete_object(bucket, key, version_id=vid,
                                         actor=actor)
            hdrs = {}
            if res.get("version_id"):
                hdrs["x-amz-version-id"] = res["version_id"]
            if res.get("delete_marker"):
                hdrs["x-amz-delete-marker"] = "true"
            return 204, hdrs, b""
        return _err(405, "MethodNotAllowed")

    def _object_acl_op(self, method, actor, bucket, key, body,
                       headers):
        if method == "GET":
            return self._acl_response(
                self.rgw.get_object_acl(bucket, key, actor=actor))
        if method == "PUT":
            canned, grants = self._acl_request(headers, body)
            self.rgw.put_object_acl(bucket, key, canned=canned,
                                    grants=grants, actor=actor)
            return 200, {}, b""
        return _err(405, "MethodNotAllowed")

    def _multipart_op(self, method, actor, bucket, key, body, query):
        upload_id = query["uploadId"]
        if method == "PUT" and "partNumber" in query:
            etag = self.rgw.upload_part(bucket, key, upload_id,
                                        int(query["partNumber"]),
                                        body, actor=actor)
            return 200, {"ETag": f'"{etag}"'}, b""
        if method == "POST":
            try:
                root = ET.fromstring(body)
            except ET.ParseError:
                return _err(400, "MalformedXML")
            parts = []
            for p in root:
                if _xml_local(p.tag) != "Part":
                    continue
                parts.append({
                    "part_number": int(_xml_text(p, "PartNumber",
                                                 "0")),
                    "etag": _xml_text(p, "ETag").strip('"')})
            meta = self.rgw.complete_multipart(bucket, key, upload_id,
                                               parts=parts,
                                               actor=actor)
            xml = (f'<?xml version="1.0"?>'
                   f'<CompleteMultipartUploadResult '
                   f'xmlns="{acl_xml.XMLNS}">'
                   f"<Location>/{escape(bucket)}/{escape(key)}"
                   f"</Location>"
                   f"<Bucket>{escape(bucket)}</Bucket>"
                   f"<Key>{escape(key)}</Key>"
                   f'<ETag>"{meta["etag"]}"</ETag>'
                   f"</CompleteMultipartUploadResult>")
            return 200, {"Content-Type": "application/xml"}, \
                xml.encode()
        if method == "GET":
            parts = self.rgw.list_parts(bucket, key, upload_id,
                                        actor=actor)
            items = "".join(
                f"<Part><PartNumber>{p['part_number']}</PartNumber>"
                f'<ETag>"{p["etag"]}"</ETag>'
                f"<Size>{p['size']}</Size></Part>"
                for p in parts)
            xml = (f'<?xml version="1.0"?>'
                   f'<ListPartsResult xmlns="{acl_xml.XMLNS}">'
                   f"<Bucket>{escape(bucket)}</Bucket>"
                   f"<Key>{escape(key)}</Key>"
                   f"<UploadId>{upload_id}</UploadId>{items}"
                   f"</ListPartsResult>")
            return 200, {"Content-Type": "application/xml"}, \
                xml.encode()
        if method == "DELETE":
            self.rgw.abort_multipart(bucket, key, upload_id,
                                     actor=actor)
            return 204, {}, b""
        return _err(405, "MethodNotAllowed")


def serve(frontend: S3Frontend, port: int = 0):
    """Threaded stdlib HTTP server; returns (server, port).  Call
    ``server.shutdown()`` + ``server.server_close()`` when done."""
    from ..common.http_serve import serve_frontend
    return serve_frontend(frontend.handle, port)


class SwiftFrontend:
    """Swift-dialect REST frontend (rgw_rest_swift.cc role): the same
    RGWLite core behind OpenStack-Swift paths.

    - ``GET /auth/v1.0`` with ``X-Auth-User: <uid>:swift`` and
      ``X-Auth-Key: <secret_key>`` answers ``X-Auth-Token`` (a
      stateless HMAC over the uid, so any frontend instance validates
      it) and ``X-Storage-Url`` (``/v1/AUTH_<uid>``).
    - ``/v1/AUTH_<uid>/<container>[/<object>]``: container PUT/GET
      (plain-text or ``format=json`` listings)/DELETE, object
      PUT/GET/HEAD/DELETE.  Swift names buckets "containers" and
      accounts map to rgw users (RGWSwift).
    """

    def __init__(self, rgw: RGWLite):
        self.rgw = rgw

    def _token_for(self, user: Dict) -> str:
        mac = hmac.new(user["secret_key"].encode(),
                       f"swift:{user['uid']}".encode(), hashlib.sha1)
        return f"AUTH_tk{mac.hexdigest()}"

    def _user_for_token(self, uid: str, token: str) -> Optional[Dict]:
        try:
            user = self.rgw.get_user(uid)
        except RGWError:
            return None
        if hmac.compare_digest(self._token_for(user), token or ""):
            return user
        return None

    def handle(self, method: str, path: str,
               headers: Optional[Dict[str, str]] = None,
               body: bytes = b"",
               query: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Dict[str, str], bytes]:
        headers = headers or {}
        query = query or {}
        if path.startswith("/auth/v1.0"):
            xuser = headers.get("X-Auth-User", "")
            uid = xuser.split(":", 1)[0]
            try:
                user = self.rgw.get_user(uid)
            except RGWError:
                return 401, {}, b"invalid user"
            if not hmac.compare_digest(
                    headers.get("X-Auth-Key", ""),
                    user["secret_key"]):
                return 401, {}, b"invalid key"
            return 204, {"X-Auth-Token": self._token_for(user),
                         "X-Storage-Url": f"/v1/AUTH_{uid}"}, b""
        if not path.startswith("/v1/AUTH_"):
            return 404, {}, b"not found"
        parts = path[len("/v1/AUTH_"):].split("/", 2)
        uid = parts[0]
        user = self._user_for_token(uid, headers.get("X-Auth-Token"))
        if user is None:
            return 401, {}, b"bad token"
        if user.get("suspended"):
            # same refusal as the S3 frontend (RGW_USER_SUSPENDED):
            # suspension covers EVERY frontend
            return 403, {}, b"account suspended"
        container = parts[1] if len(parts) > 1 and parts[1] else ""
        obj = parts[2] if len(parts) > 2 else ""
        try:
            if not container:
                if method == "GET":      # account listing
                    names = self.rgw.list_buckets(uid)
                    if not names:
                        return 204, {}, b""
                    return (200, {"Content-Type": "text/plain"},
                            ("\n".join(names) + "\n").encode())
                return 405, {}, b""
            if not obj:
                return self._container_op(method, user, container,
                                          query)
            return self._object_op(method, user, container, obj, body)
        except RGWError as e:
            status = {-2: 404, -17: 202, -39: 409,
                      -13: 403}.get(e.result, 500)
            return status, {}, str(e).encode()
        except ValueError as e:
            return 412, {}, str(e).encode()   # Swift's bad-param code
        except Exception as e:    # a handler thread must always reply
            return 500, {}, repr(e).encode()

    def _check_owner(self, user: Dict, container: str) -> None:
        if self.rgw.get_bucket(container)["owner"] != user["uid"]:
            raise RGWError("acl", -13, "forbidden")

    def _container_op(self, method, user, container, query):
        import json as _json
        if method == "PUT":
            try:
                self.rgw.create_bucket(user["uid"], container)
            except RGWError as e:
                if e.result != -17:
                    raise
                return 202, {}, b""      # existed: Swift says Accepted
            return 201, {}, b""
        if method == "DELETE":
            self._check_owner(user, container)
            self.rgw.delete_bucket(container)
            return 204, {}, b""
        if method == "HEAD":
            self._check_owner(user, container)
            stats = self.rgw.bucket_stats(container)
            return 204, {"X-Container-Object-Count":
                         str(stats["num_objects"])}, b""
        if method == "GET":
            self._check_owner(user, container)
            res = self.rgw.list_objects(
                container, prefix=query.get("prefix", ""),
                delimiter=query.get("delimiter", ""),
                marker=query.get("marker", ""),
                max_keys=int(query.get("limit", "10000")))
            if query.get("format") == "json":
                out = _json.dumps(
                    [{"name": e["name"], "bytes": e["size"],
                      "hash": e["etag"]} for e in res["contents"]] +
                    [{"subdir": p} for p in res["common_prefixes"]])
                return 200, {"Content-Type": "application/json"}, \
                    out.encode()
            names = [e["name"] for e in res["contents"]] + \
                res["common_prefixes"]
            return 200, {"Content-Type": "text/plain"}, \
                ("\n".join(names) + ("\n" if names else "")).encode()
        return 405, {}, b""

    def _object_op(self, method, user, container, obj, body):
        if method == "PUT":
            self._check_owner(user, container)
            meta = self.rgw.put_object(container, obj, body)
            return 201, {"Etag": meta["etag"]}, b""
        if method == "GET":
            self._check_owner(user, container)
            data = self.rgw.get_object(container, obj)
            meta = self.rgw.head_object(container, obj)
            return 200, {"Content-Type": meta["content_type"],
                         "Etag": meta["etag"]}, data
        if method == "HEAD":
            self._check_owner(user, container)
            meta = self.rgw.head_object(container, obj)
            return 200, {"Content-Length": str(meta["size"]),
                         "Etag": meta["etag"]}, b""
        if method == "DELETE":
            self._check_owner(user, container)
            self.rgw.delete_object(container, obj)
            return 204, {}, b""
        return 405, {}, b""
