"""S3 AccessControlPolicy XML grammar (rgw_acl_s3.cc role).

Emits and parses the reference's ACL XML shape
(the reference's ``src/rgw/rgw_acl_s3.cc``):

- ``RGWAccessControlPolicy_S3::to_xml`` (rgw_acl_s3.cc:436-443):
  ``<AccessControlPolicy xmlns=NS><Owner>..</Owner>
  <AccessControlList>..</AccessControlList></AccessControlPolicy>``
- ``ACLGrant_S3::to_xml`` (rgw_acl_s3.cc:210-244): ``<Grant><Grantee
  xmlns:xsi=.. xsi:type="CanonicalUser|Group">..</Grantee>
  <Permission>..</Permission></Grant>`` with CanonicalUser carrying
  ``<ID>``/``<DisplayName>`` and Group a ``<URI>``.
- group URIs (rgw_acl_s3.cc:18-19): AllUsers / AuthenticatedUsers.

The gateway's internal grant form is ``{"grantee": uid|"*"|"auth",
"permission": PERM}`` (gateway.py ``_grants_allow``); this module is
the bidirectional bridge between that and the wire XML.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple
from xml.sax.saxutils import escape

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
XSI = "http://www.w3.org/2001/XMLSchema-instance"
URI_ALL_USERS = "http://acs.amazonaws.com/groups/global/AllUsers"
URI_AUTH_USERS = \
    "http://acs.amazonaws.com/groups/global/AuthenticatedUsers"

PERMISSIONS = ("READ", "WRITE", "READ_ACP", "WRITE_ACP",
               "FULL_CONTROL")


def _grant_xml(grantee: str, display: Optional[str],
               permission: str) -> str:
    if grantee == "*":
        gt, inner = "Group", f"<URI>{URI_ALL_USERS}</URI>"
    elif grantee == "auth":
        gt, inner = "Group", f"<URI>{URI_AUTH_USERS}</URI>"
    else:
        gt = "CanonicalUser"
        inner = f"<ID>{escape(grantee)}</ID>"
        if display:
            inner += f"<DisplayName>{escape(display)}</DisplayName>"
    return (f'<Grant><Grantee xmlns:xsi="{XSI}" xsi:type="{gt}">'
            f"{inner}</Grantee>"
            f"<Permission>{permission}</Permission></Grant>")


def policy_to_xml(owner: Optional[str], grants: List[Dict],
                  display_names: Optional[Dict[str, str]] = None
                  ) -> str:
    """Serialize an owner + gateway-form grant list.  Like the
    reference's create_canned, the owner's implicit FULL_CONTROL is
    materialized as the first grant (S3 clients expect to see it)."""
    display_names = display_names or {}
    out = [f'<AccessControlPolicy xmlns="{XMLNS}">']
    if owner:
        out.append(f"<Owner><ID>{escape(owner)}</ID>")
        dn = display_names.get(owner)
        if dn:
            out.append(f"<DisplayName>{escape(dn)}</DisplayName>")
        out.append("</Owner>")
    out.append("<AccessControlList>")
    if owner:
        out.append(_grant_xml(owner, display_names.get(owner),
                              "FULL_CONTROL"))
    for g in grants:
        out.append(_grant_xml(g["grantee"],
                              display_names.get(g["grantee"]),
                              g["permission"]))
    out.append("</AccessControlList></AccessControlPolicy>")
    return "".join(out)


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _find(el, name):
    for child in el:
        if _local(child.tag) == name:
            return child
    return None


def policy_from_xml(data: bytes) -> Tuple[Optional[str], List[Dict]]:
    """Parse policy XML back to (owner_id, gateway-form grants).

    The owner's own FULL_CONTROL grant (which policy_to_xml
    materializes) is folded back into the implicit-owner form so a
    GET->PUT round trip is stable.  Unknown grantee types (e.g.
    AmazonCustomerByEmail) and permissions raise ValueError, the
    reference's -EINVAL path."""
    try:
        root = ET.fromstring(data)
    except ET.ParseError as e:
        raise ValueError(f"MalformedACLError: {e}")
    if _local(root.tag) != "AccessControlPolicy":
        raise ValueError("MalformedACLError: not an "
                         "AccessControlPolicy")
    owner = None
    owner_el = _find(root, "Owner")
    if owner_el is not None:
        id_el = _find(owner_el, "ID")
        if id_el is not None and id_el.text:
            owner = id_el.text
    grants: List[Dict] = []
    acl_el = _find(root, "AccessControlList")
    for grant in (acl_el if acl_el is not None else ()):
        if _local(grant.tag) != "Grant":
            continue
        grantee_el = _find(grant, "Grantee")
        perm_el = _find(grant, "Permission")
        if grantee_el is None or perm_el is None:
            raise ValueError("MalformedACLError: incomplete Grant")
        perm = (perm_el.text or "").strip().upper()
        if perm not in PERMISSIONS:
            raise ValueError(f"MalformedACLError: bad permission "
                             f"{perm!r}")
        gtype = (grantee_el.get(f"{{{XSI}}}type")
                 or grantee_el.get("type") or "")
        if gtype == "Group":
            uri_el = _find(grantee_el, "URI")
            uri = (uri_el.text or "") if uri_el is not None else ""
            if uri == URI_ALL_USERS:
                who = "*"
            elif uri == URI_AUTH_USERS:
                who = "auth"
            else:
                raise ValueError(f"MalformedACLError: unknown group "
                                 f"URI {uri!r}")
        elif gtype == "CanonicalUser":
            id_el = _find(grantee_el, "ID")
            if id_el is None or not id_el.text:
                raise ValueError("MalformedACLError: CanonicalUser "
                                 "without ID")
            who = id_el.text
        else:
            raise ValueError(f"MalformedACLError: unsupported grantee "
                             f"type {gtype!r}")
        if owner is not None and who == owner \
                and perm == "FULL_CONTROL":
            continue            # implicit-owner fold-back
        grants.append({"grantee": who, "permission": perm})
    return owner, grants
