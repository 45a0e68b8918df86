"""ceph-conf: the configuration query tool (src/tools/ceph_conf.cc),
byte-exact against the reference's recorded transcripts
(src/test/cli/ceph-conf/*.t).

Semantics replicated from the reference:
  - ``--lookup KEY`` (the default action when a bare key is given)
    searches the CONF FILE sections in order — the ``-s`` list if
    given, else ``[<type>.<id>] [<type>] [global]`` derived from
    ``--name`` (md_config_t::get_val_from_conf_file); silent exit 1
    when absent.
  - ``--show-config-value KEY`` resolves a REGISTERED option
    (override -> file -> default) and errors with "option not found"
    for unknown keys (md_config_t::get_val).
  - ``$metavariable`` expansion ($cluster/$type/$id/$name/$host and
    config-key references) with the reference's loop-detection
    report (md_config_t::expand_meta).
  - ``CEPH_CONF``/``CEPH_ARGS`` environment handling, including the
    "did not load config file, using default settings" soft-failure
    path vs the hard ``global_init`` failure for an explicit ``-c``.

The port's own copy of ``ceph_tpu/tools/ceph_conf.py``: the same argv
gives the same output, exit code and files.
"""
from __future__ import annotations

import configparser
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..common.config import ConfigProxy

VALID_TYPES = ("auth", "mon", "osd", "mds", "mgr", "client")

USAGE = """Ceph configuration query tool

USAGE
ceph-conf <flags> <action>

ACTIONS
  -L|--list-all-sections          List all sections
  -l|--list-sections <prefix>     List sections with the given prefix
  --filter-key <key>              Filter section list to only include sections
                                  with given key defined.
  --filter-key-value <key>=<val>  Filter section list to only include sections
                                  with given key/value pair.
  --lookup <key>                  Print a configuration setting to stdout.
                                  Returns 0 (success) if the configuration setting is
                                  found; 1 otherwise.
  -r|--resolve-search             search for the first file that exists and
                                  can be opened in the resulted comma
                                  delimited search list.
  -D|--dump-all                   dump all variables.

FLAGS
  --name name                     Set type.id
  [-s <section>]                  Add to list of sections to search
  [--format plain|json|json-pretty]
                                  dump variables in plain text, json or pretty
                                  json

If there is no action given, the action will default to --lookup.

EXAMPLES
$ ceph-conf --name mon.0 -c /etc/ceph/ceph.conf 'mon addr'
Find out what the value of 'mon addr' is for monitor 0.

$ ceph-conf -l mon
List sections beginning with 'mon'.

RETURN CODE
Return code will be 0 on success; error code otherwise.
"""

NO_ACTION = ("You must give an action, such as --lookup or "
             "--list-all-sections.\nPass --help for more help.")


def _norm_key(k: str) -> str:
    return k.replace(" ", "_").replace("-", "_")


class ConfFile:
    """Parsed ceph.conf: ordered sections of normalized key/value."""

    def __init__(self) -> None:
        self.sections: Dict[str, Dict[str, str]] = {}

    @classmethod
    def parse(cls, path: str) -> "ConfFile":
        cp = configparser.ConfigParser(interpolation=None, strict=False,
                                       delimiters=("=",),
                                       comment_prefixes=(";", "#"))
        cp.optionxform = _norm_key  # type: ignore[assignment]
        with open(path) as f:
            cp.read_string(f.read())
        out = cls()
        for sec in cp.sections():
            out.sections[sec] = dict(cp.items(sec))
        return out

    def get(self, section: str, key: str) -> Optional[str]:
        return self.sections.get(section, {}).get(key)

    def names(self) -> List[str]:
        ns = set(self.sections) | {"global"}
        return sorted(ns)


class Expander:
    """$var expansion with the reference's loop report."""

    META = ("cluster", "type", "id", "name", "host", "pid")
    TOKEN = re.compile(r"\$(\w+)")

    def __init__(self, meta: Dict[str, str], resolver) -> None:
        self.meta = meta
        self.resolver = resolver       # key -> raw value or None

    def expand(self, value: str,
               stack: Optional[List[Tuple[str, str]]] = None) -> str:
        stack = stack or []

        def sub(m: "re.Match[str]") -> str:
            var = m.group(1)
            if var in self.META:
                return self.meta.get(var, "")
            if any(k == var for k, _ in stack):
                frame_key, frame_raw = stack[-1]
                sys.stdout.write(
                    f"variable expansion loop at "
                    f"{frame_key}={frame_raw}\n")
                sys.stdout.write("expansion stack: \n")
                for k, raw in stack:
                    sys.stdout.write(f"{k}={raw}\n")
                return m.group(0)
            raw = self.resolver(var)
            if raw is None:
                return m.group(0)
            return self.expand(raw, stack + [(var, raw)])

        return self.TOKEN.sub(sub, value)


def _parse_name(name: str) -> Tuple[str, str]:
    type_, dot, id_ = name.partition(".")
    if not dot or type_ not in VALID_TYPES:
        print(f"error parsing '{name}': expected string of the form "
              f"TYPE.ID, valid types are: {', '.join(VALID_TYPES)}")
        raise SystemExit(1)
    return type_, id_


def _soft_parse_failure(path: str) -> None:
    ts = time.strftime("%Y-%m-%d %H:%M:%S.000000")
    tid = "7f%010x" % (os.getpid() & 0xFFFFFFFFFF)
    err = (f"{ts} {tid} -1 ")
    sys.stderr.write(err + "did not load config file, using default "
                     "settings.\n")
    for _ in range(2):
        sys.stderr.write(err + "Errors while parsing config file!\n")
        sys.stderr.write(err + f"parse_file: cannot open {path}: (2) "
                         "No such file or directory\n")


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    # CEPH_ARGS tokens are prepended, exactly like global_init
    env_args = os.environ.get("CEPH_ARGS", "")
    if env_args:
        args = env_args.split() + args

    conf_path: Optional[str] = None
    conf_explicit = False
    name = "client.admin"
    cluster = "ceph"
    sections: List[str] = []
    action: Optional[Tuple[str, str]] = None
    overrides: Dict[str, str] = {}
    lookup_key: Optional[str] = None
    dump_format = "plain"

    def norm_flag(a: str) -> str:
        return a.replace("_", "-")

    i = 0
    while i < len(args):
        a = args[i]
        na = norm_flag(a) if a.startswith("--") else a
        val = None
        if a.startswith("--") and "=" in a:
            na, _, val = norm_flag(a.split("=", 1)[0]), "=", \
                a.split("=", 1)[1]

        def need() -> str:
            nonlocal i
            if val is not None:
                return val
            i += 1
            if i >= len(args):
                print(NO_ACTION)
                raise SystemExit(1)
            return args[i]

        if na in ("-h", "--help"):
            sys.stdout.write(USAGE)
            return 1
        elif na in ("-c", "--conf"):
            conf_path = need()
            conf_explicit = True
        elif na in ("-n", "--name"):
            name = need()
        elif na == "--cluster":
            cluster = need()
        elif na in ("-s", "--section"):
            sections.append(need())
        elif na in ("-L", "--list-all-sections"):
            action = ("list-sections", "")
        elif na in ("-l", "--list-sections"):
            action = ("list-sections", need())
        elif na == "--lookup":
            lookup_key = need()
        elif na == "--show-config-value":
            action = ("show-config-value", need())
        elif na in ("-D", "--dump-all", "--show-config"):
            action = ("dump", "")
        elif na == "--filter-key":
            action = ("filter-key", need())
        elif na == "--filter-key-value":
            action = ("filter-key-value", need())
        elif na in ("-r", "--resolve-search"):
            action = ("resolve-search", "")
        elif na == "--format":
            # validated only when a dump actually runs (the reference
            # checks via Formatter::create inside dump_all)
            dump_format = need()
        elif a.startswith("-"):
            # registered-option override, e.g. CEPH_ARGS="--fsid ..."
            # (na already has any "=value" split off)
            overrides[_norm_key(na.lstrip("-"))] = need()
        else:
            lookup_key = a
        i += 1

    # global_init order: name validation and conf-file loading happen
    # before the action check (invalid-args.t / env-vs-args.t pin this)
    type_, id_ = _parse_name(name)
    meta = {"cluster": cluster, "type": type_, "id": id_, "name": name,
            "host": "", "pid": str(os.getpid())}

    # conf file: explicit -c is a hard failure when unreadable
    # (global_init); CEPH_CONF degrades to defaults with the dout-style
    # complaint lines
    conf = ConfFile()
    env_conf = os.environ.get("CEPH_CONF")
    if conf_path is None and env_conf:
        conf_path = env_conf
        conf_explicit = False
    if conf_path:
        # -c/CEPH_CONF is a comma-delimited SEARCH LIST: the first
        # openable entry wins (global_init's conf_files handling)
        loaded = False
        for entry in conf_path.split(","):
            try:
                conf = ConfFile.parse(entry)
                loaded = True
                break
            except OSError:
                continue
        if not loaded:
            if conf_explicit:
                print(f"global_init: unable to open config file from "
                      f"search list {conf_path}")
                return 1
            _soft_parse_failure(conf_path)

    if lookup_key is not None and action is None:
        action = ("lookup", lookup_key)
    if action is None:
        print(NO_ACTION)
        return 1

    search = sections if sections else [name, type_, "global"]

    def file_resolver(key: str) -> Optional[str]:
        for sec in search:
            v = conf.get(sec, key)
            if v is not None:
                return v
        return None

    g = ConfigProxy()

    def resolved(key: str) -> Optional[str]:
        """registered option: override -> conf file -> default."""
        if key in overrides:
            return overrides[key]
        v = file_resolver(key)
        if v is not None:
            return v
        if key in g.schema:
            return str(g.schema[key].default)
        return None

    exp = Expander(meta, resolved)

    kind, arg = action
    if kind == "lookup":
        key = _norm_key(arg)
        raw = file_resolver(key)
        if raw is None:
            return 1
        print(exp.expand(raw, [(key, raw)]))
        return 0
    if kind == "show-config-value":
        key = _norm_key(arg)
        if key not in g.schema and key not in overrides \
                and file_resolver(key) is None:
            print(f"failed to get config option '{arg}': option not "
                  "found")
            return 1
        raw = resolved(key) or ""
        print(exp.expand(raw, [(key, raw)]))
        return 0
    if kind == "dump":
        known = ("", "plain", "json", "json-pretty", "xml",
                 "xml-pretty", "table", "table-kv", "html",
                 "html-pretty")
        if dump_format not in known:
            # Formatter::create's refusal shape: stderr + usage
            sys.stderr.write(f"format '{dump_format}' not "
                             "recognized.\n")
            sys.stderr.write(USAGE)
            return 1
        vals = {}
        for key in sorted(g.schema):
            raw = str(resolved(key) or "")
            vals[key] = exp.expand(raw, [(key, raw)])
        # _show_config emits the identity keys first
        doc = {"name": name, "cluster": cluster, **vals}
        if dump_format == "json":
            print(json.dumps(doc, separators=(",", ":")))
        elif dump_format == "json-pretty":
            print(json.dumps(doc, indent=4))
        elif dump_format in ("xml", "xml-pretty"):
            from xml.sax.saxutils import escape as _esc
            nl = "\n" if dump_format == "xml-pretty" else ""
            pad = "    " if dump_format == "xml-pretty" else ""
            out = ["<config>" + nl]
            for k, v in doc.items():
                out.append(f"{pad}<{k}>{_esc(v)}</{k}>{nl}")
            out.append("</config>")
            print("".join(out))
        elif dump_format in ("table", "table-kv"):
            sep = ": " if dump_format == "table-kv" else "  "
            width = max(len(k) for k in doc)
            for k, v in doc.items():
                left = k if dump_format == "table-kv" \
                    else k.ljust(width)
                print(f"{left}{sep}{v}")
        elif dump_format in ("html", "html-pretty"):
            from xml.sax.saxutils import escape as _esc
            nl = "\n" if dump_format == "html-pretty" else ""
            items = "".join(f"<li>{_esc(k)}: {_esc(v)}</li>{nl}"
                            for k, v in doc.items())
            print(f"<ul>{nl}{items}</ul>")
        else:
            for key, v in vals.items():
                print(f"{key} = {v}")
        return 0
    if kind == "list-sections":
        for sec in conf.names():
            if sec.startswith(arg):
                print(sec)
        return 0
    if kind in ("filter-key", "filter-key-value"):
        want_key, _, want_val = arg.partition("=")
        want_key = _norm_key(want_key)
        for sec in conf.names():
            v = conf.get(sec, want_key)
            if v is None:
                continue
            if kind == "filter-key-value" and v != want_val:
                continue
            print(sec)
        return 0
    if kind == "resolve-search":
        for path in (conf_path or "").split(","):
            if path and os.path.exists(path):
                print(path)
                return 0
        return 1
    print(NO_ACTION)
    return 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
