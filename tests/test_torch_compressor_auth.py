"""The port's compressors and cephx tier against the JAX package's, on
the CPU.

Both packages get the same payloads, and the same entropy: ``os.urandom``
is pinned to one seeded stream (restarted for each side) and
``time.time`` to one instant, so every secret, nonce, challenge and
ticket expiry is drawn alike.  Compressed bytes, ciphertexts, tags,
keyring files and KDC replies are then compared byte for byte, and each
side's client authenticates to the other side's KDC and services.
"""
import os
import time

import numpy as np
import pytest

import ceph_tpu.auth as jauth
from ceph_tpu.compressor import create_compressor as jax_create
from ceph_tpu.compressor import g_compressor_registry as jax_registry

import ceph_tpu_torch.auth as pauth
from ceph_tpu_torch.compressor import create_compressor, g_compressor_registry

NOW = 1_700_000_000.25
SIDES = {"jax": jauth, "port": pauth}


class Entropy:
    """A seeded stand-in for ``os.urandom``; ``restart`` rewinds it."""

    def __init__(self, seed):
        self.seed = seed
        self.restart()

    def restart(self):
        self.rng = np.random.default_rng(self.seed)

    def __call__(self, n):
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture
def pinned(monkeypatch):
    ent = Entropy(1709)
    monkeypatch.setattr(os, "urandom", ent)
    monkeypatch.setattr(time, "time", lambda: NOW)
    return ent


def payload(n, seed=17):
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox " * (n // 40)
    return text + rng.integers(0, 256, n - len(text),
                               dtype=np.uint8).tobytes()


# ---- compressors -------------------------------------------------------

def test_same_compressors_present():
    names = g_compressor_registry.supported()
    assert names == jax_registry.supported()
    assert {"none", "zlib"} <= set(names)


@pytest.mark.parametrize("name", jax_registry.supported())
@pytest.mark.parametrize("n", [0, 1, 4096, 65536 + 17])
def test_compressed_bytes_equal(name, n):
    data = payload(n)
    p, j = create_compressor(name), jax_create(name)
    blob = p.compress(data)
    assert blob == j.compress(data)
    assert p.decompress(blob) == data
    assert j.decompress(blob) == data
    assert p.name == j.name == name


def test_unknown_compressor_same_error():
    errs = []
    for create in (create_compressor, jax_create):
        with pytest.raises(KeyError) as e:
            create("nope")
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert "unsupported compressor 'nope'" in errs[0]


# ---- crypto ------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000])
def test_cipher_and_tag_equal(pinned, n):
    key = payload(16, seed=n)
    body = payload(n, seed=n + 1)
    blobs = {}
    for side, mod in SIDES.items():
        pinned.restart()
        blobs[side] = (mod.encrypt(key, body), mod.hmac_tag(key, body),
                       mod.hmac_tag(key, body, 8), mod.make_secret())
    assert blobs["port"] == blobs["jax"]
    ct = blobs["port"][0]
    assert pauth.decrypt(key, ct) == jauth.decrypt(key, ct) == body


@pytest.mark.parametrize("blob", [b"", b"\x00" * 31, "tamper"])
def test_decrypt_refusals_equal(pinned, blob):
    key = payload(16, seed=3)
    if blob == "tamper":
        ct = bytearray(pauth.encrypt(key, b"secret body"))
        ct[20] ^= 1
        blob = bytes(ct)
    msgs = []
    for mod in (pauth, jauth):
        with pytest.raises(mod.AuthError) as e:
            mod.decrypt(key, blob)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---- keyring -----------------------------------------------------------

def _keyring(mod):
    kr = mod.Keyring()
    for e in ("mon", "osd.0", "osd.1", "client.admin"):
        kr.create(e)
    kr.set_caps("client.admin", {"mon": "allow *", "osd": "allow rw"})
    kr.set_caps("osd.0", {"osd": "allow *"})
    return kr


def test_keyring_files_equal_and_cross_load(pinned, tmp_path):
    paths = {}
    for side, mod in SIDES.items():
        pinned.restart()
        paths[side] = tmp_path / f"{side}.keyring"
        _keyring(mod).save(str(paths[side]))
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert paths["port"].read_text().startswith("[client.admin]\n\tkey = ")
    for src, mod in (("jax", pauth), ("port", jauth)):
        kr = mod.Keyring.load(str(paths[src]))
        other = SIDES["jax" if src == "port" else "port"].Keyring.load(
            str(paths[src]))
        assert kr.keys == other.keys and kr.caps == other.caps
        assert kr.lines() == other.lines()
    empty = tmp_path / "empty"
    pauth.Keyring().save(str(empty))
    assert empty.read_bytes() == b""


# ---- the KDC exchange and the authorizer -------------------------------

def _exchange(mod, entity="osd.0"):
    """One whole cephx run in ``mod``: KDC challenge, proof, reply,
    an authorizer for the ``osd`` service and its verification."""
    kr = _keyring(mod)
    kdc = mod.CephxServer(kr)
    cli = mod.CephxClient(entity, kr.get(entity))
    ch = kdc.get_challenge(entity)
    cch, proof = cli.make_proof(ch)
    reply = kdc.authenticate(entity, ch, cch, proof)
    cli.handle_reply(reply)
    svc = mod.CephxServiceVerifier("osd", kdc.rotating_bundle("osd"))
    conn_ch = os.urandom(16)
    auth, sk, nonce = cli.build_authorizer("osd", conn_ch)
    who, sk2, rproof = svc.verify_authorizer(auth, conn_ch)
    return {"challenge": ch, "client_challenge": cch, "proof": proof,
            "reply": reply, "tickets": cli.tickets,
            "rotating": cli.rotating, "authorizer": auth,
            "session_key": sk, "nonce": nonce, "verified": who,
            "verified_key": sk2, "reply_proof": rproof,
            "reply_ok": cli.check_authorizer_reply(sk, nonce, rproof),
            "renew": (cli.needs_renewal(), cli.needs_renewal(NOW + 4000))}


def test_kdc_exchange_and_authorizer_equal(pinned):
    runs = {}
    for side, mod in SIDES.items():
        pinned.restart()
        runs[side] = _exchange(mod)
    assert runs["port"] == runs["jax"]
    assert runs["port"]["verified"] == "osd.0"
    assert runs["port"]["reply_ok"]
    assert runs["port"]["renew"] == (False, True)
    for e in ("client.x", "osd.3", "mon"):
        assert pauth.entity_service(e) == jauth.entity_service(e)


def test_refusals_equal(pinned):
    """Unknown entity, a bad proof, a replayed challenge, a foreign
    service, an expired ticket: the same errors from both packages."""
    out = {}
    for side, mod in SIDES.items():
        pinned.restart()
        kr = _keyring(mod)
        kdc = mod.CephxServer(kr)
        cli = mod.CephxClient("osd.0", kr.get("osd.0"))
        msgs = []

        def refused(fn, *a, **kw):
            with pytest.raises(mod.AuthError) as e:
                fn(*a, **kw)
            msgs.append(str(e.value))

        refused(kdc.get_challenge, "osd.9")
        ch = kdc.get_challenge("osd.0")
        cch, proof = cli.make_proof(ch)
        refused(kdc.authenticate, "osd.0", ch, cch, proof[::-1])
        refused(kdc.authenticate, "osd.0", ch, cch, proof)   # consumed
        ch = kdc.get_challenge("osd.0")
        cch, proof = cli.make_proof(ch)
        cli.handle_reply(kdc.authenticate("osd.0", ch, cch, proof))
        refused(cli.build_authorizer, "nosuch")
        auth, _sk, _n = cli.build_authorizer("mon", b"c")
        svc = mod.CephxServiceVerifier("osd", kdc.rotating_bundle("osd"))
        refused(svc.verify_authorizer, auth, b"c")
        auth, _sk, _n = cli.build_authorizer("osd", b"c")
        refused(svc.verify_authorizer, auth, b"other challenge")
        refused(svc.verify_authorizer, auth, b"c", now=NOW + 7200)
        kdc.rotate(now=NOW + 10000)
        refused(mod.CephxServiceVerifier(
            "osd", {9: (b"k" * 16, NOW)}).verify_authorizer, auth, b"c")
        out[side] = msgs
    assert out["port"] == out["jax"]
    assert len(out["port"]) == 8


@pytest.mark.parametrize("kdc_side,client_side",
                         [("jax", "port"), ("port", "jax")])
def test_cross_package_authentication(pinned, kdc_side, client_side):
    """A client of one package authenticates to the other's KDC, and its
    authorizer passes the other package's service verifier; the mutual
    proof checks out on the client."""
    kmod, cmod = SIDES[kdc_side], SIDES[client_side]
    kr = _keyring(kmod)
    kdc = kmod.CephxServer(kr)
    cli = cmod.CephxClient("osd.1", kr.get("osd.1"))
    ch = kdc.get_challenge("osd.1")
    cch, proof = cli.make_proof(ch)
    cli.handle_reply(kdc.authenticate("osd.1", ch, cch, proof))
    assert cli.authenticated() and set(cli.rotating) == {"osd"}
    for vmod in (kmod, cmod):
        svc = vmod.CephxServiceVerifier("osd", cli.rotating["osd"])
        auth, sk, nonce = cli.build_authorizer("osd", b"conn")
        who, sk2, rproof = svc.verify_authorizer(auth, b"conn")
        assert (who, sk2) == ("osd.1", sk)
        assert cli.check_authorizer_reply(sk, nonce, rproof)
