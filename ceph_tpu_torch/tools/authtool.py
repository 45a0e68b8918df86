"""ceph-authtool — keyring create/list/mutate CLI
(src/tools/ceph_authtool.cc role over auth/keyring.py).

Output strings and exit codes are pinned byte-exact against the
reference's recorded cram suite (src/test/cli/ceph-authtool/*.t):
create/gen/list round-trips, --add-key with auid and its decode
failure, the all-replacing --cap semantics, and the doubled
can't-open message on a missing keyring.

The port's own copy of ``ceph_tpu/tools/authtool.py``: the same argv
gives the same output, exit code and files.
"""
from __future__ import annotations

import base64
import binascii
import sys

USAGE = """usage: ceph-authtool keyringfile [OPTIONS]...
where the options are:
  -l, --list                    will list all keys and capabilities present in
                                the keyring
  -p, --print-key               will print an encoded key for the specified
                                entityname. This is suitable for the
                                'mount -o secret=..' argument
  -C, --create-keyring          will create a new keyring, overwriting any
                                existing keyringfile
  -g, --gen-key                 will generate a new secret key for the
                                specified entityname
  --gen-print-key               will generate a new secret key without set it
                                to the keyringfile, prints the secret to stdout
  --import-keyring FILE         will import the content of a given keyring
                                into the keyringfile
  -n NAME, --name NAME          specify entityname to operate on
  -u AUID, --set-uid AUID       sets the auid (authenticated user id) for the
                                specified entityname
  -a BASE64, --add-key BASE64   will add an encoded key to the keyring
  --cap SUBSYSTEM CAPABILITY    will set the capability for given subsystem
  --caps CAPSFILE               will set all of capabilities associated with a
                                given key, for all subsystems"""

DEFAULT_AUID = 18446744073709551615          # CEPH_AUTH_UID_DEFAULT


def _gen_secret() -> bytes:
    # the CryptoKey encoding shape (type + stamp + len + 16 random
    # bytes = 28 bytes) so generated keys look like the reference's
    import os as _os
    import struct
    import time as _time
    t = _time.time()
    return struct.pack("<HII H", 1, int(t), int((t % 1) * 1e9),
                       16) + _os.urandom(16)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return _parse_and_run(argv)
    except IndexError:
        # a flag missing its operand (--cap osd, -n, ...)
        print(USAGE)
        return 1


def _parse_and_run(argv) -> int:
    from ..auth.keyring import Keyring
    fname = None
    do_list = do_create = do_gen = do_print_key = False
    gen_print = False
    name = "client.admin"
    add_key = None
    auid = DEFAULT_AUID
    caps = []
    import_file = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print("no command specified")
            print(USAGE)
            return 1
        elif a in ("-l", "--list"):
            do_list = True
        elif a in ("-C", "--create-keyring"):
            do_create = True
        elif a in ("-g", "--gen-key"):
            do_gen = True
        elif a == "--gen-print-key":
            gen_print = True
        elif a in ("-p", "--print-key"):
            do_print_key = True
        elif a in ("-n", "--name") or a.startswith("--name="):
            if "=" in a:
                name = a.split("=", 1)[1]
            else:
                i += 1
                name = argv[i]
        elif a in ("-u", "--set-uid"):
            i += 1
            auid = int(argv[i])
        elif a in ("-a", "--add-key") or a.startswith("--add-key="):
            if "=" in a and a.startswith("--add-key="):
                add_key = a.split("=", 1)[1]
            else:
                i += 1
                add_key = argv[i] if i < len(argv) else ""
            if not add_key:
                print("Option --add-key requires an argument")
                return 1
        elif a == "--cap":
            caps.append((argv[i + 1], argv[i + 2]))
            i += 2
        elif a == "--import-keyring":
            i += 1
            import_file = argv[i]
        else:
            fname = a
        i += 1
    if gen_print and not fname:
        print(base64.b64encode(_gen_secret()).decode())
        return 0
    if fname is None:
        print("ceph-authtool: must specify filename")
        print(USAGE)
        return 1

    kr = Keyring()
    if do_create:
        print(f"creating {fname}")
    else:
        try:
            kr = Keyring.load(fname)
        except FileNotFoundError:
            print(f"can't open {fname}: can't open {fname}: (2) No "
                  f"such file or directory")
            return 1
    modified = do_create
    if import_file is not None:
        other = Keyring.load(import_file)
        kr.keys.update(other.keys)
        for ent, c in other.caps.items():
            kr.caps[ent] = dict(c)
        modified = True
    if do_gen:
        kr.keys[name] = _gen_secret()
        modified = True
    if gen_print:
        print(base64.b64encode(_gen_secret()).decode())
    if add_key is not None:
        parts = add_key.split()
        try:
            secret = base64.b64decode(parts[0], validate=True)
            if not secret or len(parts[0]) % 4:
                raise binascii.Error("bad")
        except (binascii.Error, ValueError):
            print(f"can't decode key '{add_key}'")
            return 1
        if len(parts) > 1:
            auid = int(parts[1])
        kr.keys[name] = secret
        ncaps = len(kr.caps.get(name, {}))
        print(f"added entity {name} auth auth(auid = {auid} "
              f"key={parts[0]} with {ncaps} caps)")
        modified = True
    if caps:
        # --cap REPLACES the whole cap set (KeyRing semantics the
        # reference's cap-overwrite.t records)
        kr.set_caps(name, dict(caps))
        modified = True
    if do_print_key:
        sec = kr.get(name)
        if sec is None:
            print(f"entity {name} not found")
            return 1
        print(base64.b64encode(sec).decode())
    if do_list:
        for line in kr.lines():
            print(line)
    if modified:
        kr.save(fname)
    return 0


if __name__ == "__main__":
    # die silently on a closed pipe (`tool ... | head`), like the
    # C++ tools' default SIGPIPE disposition
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
