"""rbd CLI frontend: the reference shell's command matching, help
pages, and argv error contracts (src/tools/rbd/Shell.cc), byte-exact
against the recorded transcripts src/test/cli/rbd/{help,
not-enough-args, too-many-args, invalid-snap-usage}.t.

Structure mirrors the reference's split: the spec table
(rbd_specs.py, generated from the recorded help) plays the role of
the per-action get_arguments registrations; rbd_optfmt renders help;
this module does command-spec extraction, option/positional parsing
(boost::program_options semantics for the error paths), and the
execute-stage validation messages from src/tools/rbd/Utils.cc.
Implemented verbs are bridged onto the live RBD API via
rbd_cli.run's dialect.

Port of ``ceph_tpu/tools/rbd_shell.py``, a copy.  ``rbd bench`` prints
wall-clock rates.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .rbd_optfmt import Opt, Positional, print_action_help, \
    print_command_list
from .rbd_specs import SPECS

APP = "rbd"
BANNER = "Command-line interface for managing Ceph RBD images."
EINVAL = 22

GLOBAL_OPTS = [
    Opt("conf", "path to cluster configuration", short="c"),
    Opt("cluster", "cluster name"),
    Opt("id", "client id (without 'client.' prefix)"),
    Opt("user", "client id (without 'client.' prefix)"),
    Opt("name", "client name", short="n"),
    Opt("mon_host", "monitor host", short="m"),
    Opt("secret", "path to secret key (deprecated)"),
    Opt("keyfile", "path to secret key", short="K"),
    Opt("keyring", "path to keyring", short="k"),
]

FEATURE_NAMES = {"layering", "striping", "exclusive-lock", "object-map",
                 "fast-diff", "deep-flatten", "journaling", "data-pool"}

# bridged verbs that never mutate the cluster: a successful run of one
# of these must NOT rewrite the checkpoint
READONLY_SPECS = {"list", "info", "disk-usage", "status", "export",
                  "export-diff", "children", "diff", "snap list",
                  "lock list"}


class Action:
    def __init__(self, entry: dict):
        self.spec: Tuple[str, ...] = tuple(entry["spec"])
        self.alias: Optional[Tuple[str, ...]] = (
            tuple(entry["alias"]) if entry["alias"] else None)
        self.desc: str = entry["desc"]
        self.positionals = [Positional(n, d, v)
                            for n, d, v in entry["positionals"]]
        self.options = [Opt(long, d, short, has_arg, req)
                        for short, long, has_arg, req, d
                        in entry["options"]]
        self.help: str = entry["help"]


ACTIONS = [Action(e) for e in SPECS]

# every no-arg option long name across all commands: get_command_spec
# must know these are switches before the command is even identified
# (Shell.cc get_switch_arguments + at::SWITCH_ARGUMENTS role)
SWITCH_LONGS = {o.long for a in ACTIONS for o in a.options
                if not o.has_arg}
SWITCH_SHORTS = {o.short for a in ACTIONS for o in a.options
                 if not o.has_arg and o.short}


class ArgvError(Exception):
    """boost::program_options-stage failure: exit 1."""


class ValidationError(Exception):
    """execute-stage failure (utils.cc get_* helpers): exit EINVAL."""


def get_command_spec(arguments: Sequence[str]) -> List[str]:
    spec: List[str] = []
    i = 0
    while i < len(arguments):
        arg = arguments[i]
        if arg in ("-h", "--help"):
            return ["help"]
        if arg == "--":
            spec.extend(arguments[i + 1:])
            return spec
        if arg.startswith("-"):
            # a non-switch option consumes the next token as its value
            # unless the value is attached ("--x=v" or "-pv")
            long = arg[2:] if arg.startswith("--") else None
            short = arg[1:2] if not arg.startswith("--") else None
            is_switch = (long in SWITCH_LONGS
                         or (short is not None and short in SWITCH_SHORTS))
            attached = "=" in arg or (short is not None and len(arg) > 2)
            if not is_switch and not attached:
                i += 1
        else:
            spec.append(arg)
        i += 1
    return spec


def find_action(words: Sequence[str]
                ) -> Tuple[Optional[Action], Optional[Tuple[str, ...]],
                           bool]:
    for a in ACTIONS:
        if len(a.spec) <= len(words) and \
                tuple(words[:len(a.spec)]) == a.spec:
            return a, a.spec, False
        if a.alias and len(a.alias) <= len(words) and \
                tuple(words[:len(a.alias)]) == a.alias:
            return a, a.alias, True
    return None, None, False


def parse_arguments(action: Action, matched: Tuple[str, ...],
                    arguments: Sequence[str]
                    ) -> Tuple[Dict[str, str], List[str]]:
    """boost-style pass: returns (option values, positional args after
    the command words).  Raises ArgvError with the messages the
    reference's po catch blocks print."""
    by_long: Dict[str, Opt] = {}
    by_short: Dict[str, Opt] = {}
    for o in list(action.options) + GLOBAL_OPTS:
        by_long[o.long] = o
        if o.short:
            by_short[o.short] = o
    vm: Dict[str, str] = {}
    pos: List[str] = []
    rest_positional = False
    i = 0
    while i < len(arguments):
        arg = arguments[i]
        if rest_positional or not arg.startswith("-") or arg == "-":
            pos.append(arg)
        elif arg == "--":
            rest_positional = True
        else:
            if arg.startswith("--"):
                name, eq, val = arg[2:].partition("=")
                o = by_long.get(name)
            else:
                name, eq, val = arg[1:2], "", ""
                o = by_short.get(name)
                if o is not None and o.has_arg and len(arg) > 2:
                    # "-pvalue" attached-value form
                    val, eq = arg[2:], "="
            if o is None:
                raise ArgvError(f"unrecognised option '{arg}'")
            if o.has_arg and not eq:
                if i + 1 >= len(arguments):
                    raise ArgvError(
                        f"the required argument for option "
                        f"'--{o.long}' is missing")
                i += 1
                val = arguments[i]
            elif not o.has_arg and eq:
                raise ArgvError(
                    f"option '--{o.long}' does not take any arguments")
            vm[o.long] = val if o.has_arg else "1"
        i += 1
    # first len(matched) positionals are the command words themselves
    if pos[:len(matched)] != list(matched):
        raise ArgvError("failed to parse command")
    pos = pos[len(matched):]
    variadic = bool(action.positionals) and action.positionals[-1].variadic
    if not variadic and len(pos) > len(action.positionals):
        raise ArgvError("too many arguments")
    # NOTE: required options (e.g. bench --io-type) are NOT enforced
    # here — the reference's Shell calls po::store without notify(),
    # so requiredness surfaces from the action itself, after the
    # image/snap checks (invalid-snap-usage.t pins that order)
    return vm, pos


def _parse_spec(spec: str) -> Tuple[str, str, str]:
    """[pool/]image[@snap] -> (pool, image, snap)."""
    pool, slash, rest = spec.partition("/")
    if not slash:
        pool, rest = "", spec
    image, at, snap = rest.partition("@")
    return pool, image, snap if at else ""


def _image_check(spec: str, vm: Dict[str, str], presence: str,
                 dest: bool = False) -> Tuple[str, str, str]:
    """utils::get_pool_image_snapshot_names error contract.

    presence: 'none' | 'permitted' | 'required'."""
    prefix = "destination " if dest else ""
    pool, image, snap = _parse_spec(spec)
    if not image:
        image = vm.get("dest" if dest else "image", "")
    if not snap:
        snap = "" if dest else vm.get("snap", "")
    if spec and "@" in spec and presence == "none":
        raise ValidationError(
            f"{prefix}snapname specified for a command that doesn't "
            "use it")
    if not image:
        raise ValidationError(f"{prefix}image name was not specified")
    if presence == "required" and not snap:
        raise ValidationError(f"{prefix}snap name was not specified")
    return pool, image, snap


_PRESENCE = {
    "image-spec": "none",
    "source-image-spec": "none",
    "image-or-snap-spec": "permitted",
    "source-image-or-snap-spec": "permitted",
    "snap-spec": "required",
    "source-snap-spec": "required",
    "group-snap-spec": "required",
}


def validate(action: Action, vm: Dict[str, str],
             pos: List[str]) -> Dict[str, object]:
    """The execute-stage checks each reference action performs before
    touching the cluster; raises ValidationError(msg) -> exit 22."""
    spec_words = " ".join(action.spec)
    out: Dict[str, object] = {}

    def val(i: int) -> str:
        return pos[i] if i < len(pos) else ""

    for idx, p in enumerate(action.positionals):
        name = p.name
        if name in _PRESENCE:
            out["image"] = _image_check(val(idx), vm, _PRESENCE[name])
        elif name == "dest-image-spec":
            pool, image, snap = _image_check(val(idx), vm, "none",
                                             dest=True)
            out["dest"] = (pool or vm.get("dest-pool", ""), image, snap)
        elif name == "dest-snap-spec":
            spec = val(idx)
            _, image, snap = _parse_spec(spec)
            snap = snap or vm.get("dest-snap", "")
            if not snap:
                raise ValidationError(
                    "destination snap name was not specified")
            out["dest-snap"] = snap
        elif name in ("path-name", "diff1-path", "diff2-path"):
            v = val(idx) or vm.get("path", "")
            if not v:
                raise ValidationError(
                    {"diff1-path": "first diff was not specified",
                     "diff2-path": "second diff was not specified",
                     }.get(name, "path was not specified"))
            out[name] = v
        elif name == "features":
            feats = pos[idx:]
            if not feats:
                raise ValidationError(
                    "at least one feature name must be specified")
            out["features"] = feats
        elif name == "key":
            if spec_words.startswith("image-meta"):
                if not val(idx):
                    raise ValidationError(
                        "metadata key was not specified")
                out["key"] = val(idx)
        elif name == "value":
            if spec_words.startswith("image-meta"):
                if not val(idx):
                    raise ValidationError(
                        "metadata value was not specified")
                out["value"] = val(idx)
        elif name == "lock-id":
            if not val(idx):
                raise ValidationError("lock id was not specified")
            out["lock-id"] = val(idx)
        elif name == "locker":
            if not val(idx):
                raise ValidationError("locker was not specified")
            out["locker"] = val(idx)
        elif name == "image-or-snap-or-device-spec":
            if not val(idx) and not vm.get("image"):
                raise ValidationError(
                    "unmap requires either image name or device path")
            out["target"] = val(idx)
        elif name == "mode":
            if val(idx) not in ("image", "pool"):
                raise ValidationError(
                    "must specify 'image' or 'pool' mode.")
            out["mode"] = val(idx)
        elif name == "remote-cluster-spec":
            if not val(idx):
                raise ValidationError("remote cluster was not specified")
            out["remote"] = val(idx)
        elif name == "uuid":
            if not val(idx):
                raise ValidationError("must specify peer uuid")
            out["uuid"] = val(idx)
        elif name == "pool-name":
            out["pool"] = val(idx) or vm.get("pool", "")
        elif name in ("group-spec", "journal-spec", "source-journal-spec",
                      "dest-journal-spec"):
            kind = "group" if "group" in name else "journal"
            _, obj, _snap = _parse_spec(val(idx))
            if not obj and not vm.get(kind):
                raise ValidationError(f"{kind} name was not specified")
            out[name] = val(idx)
        elif name == "image-id":
            if not val(idx) and not vm.get("image-id"):
                raise ValidationError("image id was not specified")
            out["image-id"] = val(idx)
        elif name == "device-spec":
            if not val(idx):
                raise ValidationError("device was not specified")
            out["device"] = val(idx)
    # feature values are validated at po-store time (ImageFeatures
    # validator): any name outside the feature set is a po error
    if "features" in out:
        for f in out["features"]:  # type: ignore[union-attr]
            if f not in FEATURE_NAMES:
                raise ArgvError("the argument for option is invalid")
    return out


def execute_action(action: Action, vm: Dict[str, str],
                   parsed: Dict[str, object], checkpoint: Optional[str]
                   ) -> int:
    """Bridge the validated command onto the live RBD API (rbd_cli
    dialect).  Only reached when argv validation passed; commands
    outside the implemented storage surface report EOPNOTSUPP."""
    from . import rbd_cli

    def n(size: str) -> int:
        mult = {"B": 1, "K": 1 << 10, "M": 1 << 20,
                "G": 1 << 30, "T": 1 << 40}
        s = size.strip()
        try:
            if s and s[-1].upper() in mult:
                return int(float(s[:-1]) * mult[s[-1].upper()])
            return int(float(s) * (1 << 20))   # bare numbers: megabytes
        except ValueError:
            raise ValidationError("the argument for option is invalid")

    spec = " ".join(action.spec)
    img = parsed.get("image")
    pool = (img[0] if img else "") or vm.get("pool", "") or "rbd"
    name = img[1] if img else ""
    snap = img[2] if img else ""
    dest = parsed.get("dest")
    argv: Optional[List[str]] = None
    if spec == "create":
        argv = ["-p", pool, "create", name, "--size", str(n(
            vm.get("size", "0")))]
    elif spec == "list":
        argv = ["-p", parsed.get("pool") or "rbd", "ls"]  # type: ignore
    elif spec == "info":
        argv = ["-p", pool, "info", name]
    elif spec == "disk-usage":
        argv = ["-p", pool, "du", name + (f"@{snap}" if snap else "")]
    elif spec == "resize":
        argv = ["-p", pool, "resize", name, "--size", str(n(
            vm.get("size", "0")))]
    elif spec == "remove":
        argv = ["-p", pool, "rm", name]
    elif spec == "flatten":
        argv = ["-p", pool, "flatten", name]
    elif spec == "clone":
        argv = ["-p", pool, "clone", f"{name}@{snap}",
                dest[1]]  # type: ignore[index]
    elif spec == "copy":
        argv = ["-p", pool, "cp", name, dest[1]]  # type: ignore[index]
        if snap:
            argv += ["--snap", snap]
    elif spec in ("export", "export-diff", "import", "import-diff"):
        path = parsed.get("path-name", "")
        if spec == "export":
            argv = ["-p", pool, "export", name, path]  # type: ignore
        elif spec == "export-diff":
            argv = ["-p", pool, "export-diff", name,
                    path]  # type: ignore[list-item]
            if vm.get("from-snap"):
                argv += ["--from-snap", vm["from-snap"]]
            if snap:
                argv += ["--snap", snap]
        elif spec == "import":
            argv = ["-p", dest[0] or "rbd", "import",  # type: ignore
                    path, dest[1]]  # type: ignore[index]
        else:
            argv = ["-p", pool, "import-diff", path,
                    name]  # type: ignore[list-item]
    elif spec.startswith("snap "):
        verb = action.spec[1]
        verbmap = {"create": "create", "remove": "rm", "list": "ls",
                   "protect": "protect", "unprotect": "unprotect",
                   "rollback": "rollback"}
        if verb in verbmap:
            target = name + (f"@{snap}" if snap else "")
            argv = ["-p", pool, "snap", verbmap[verb], target]
    elif spec == "lock add":
        argv = ["-p", pool, "lock", "add", name,
                "--cookie", parsed.get("lock-id", "")]  # type: ignore
    elif spec == "lock list":
        argv = ["-p", pool, "lock", "ls", name]
    elif spec == "lock remove":
        argv = ["-p", pool, "lock", "rm", name,
                "--cookie", parsed.get("lock-id", ""),  # type: ignore
                "--locker", parsed.get("locker", "")]  # type: ignore
    elif spec == "bench":
        # rbd bench (tools/rbd/action/Bench.cc): drive IO at the image
        # through the librbd-lite API and report the reference's
        # SEC/OPS/OPS/SEC table + elapsed summary
        if checkpoint is None:
            print("rbd: error opening cluster (no --checkpoint)",
                  file=sys.stderr)
            return 1
        from ..cluster import MiniCluster
        c = MiniCluster.restore(checkpoint)
        from ..rbd import Image
        import time as _time
        io_type = vm.get("io-type", "")
        if io_type not in ("read", "write", "readwrite", "rw"):
            print("rbd: --io-type must be read, write, or "
                  "readwrite(rw)", file=sys.stderr)
            return EINVAL
        io_size = n(vm.get("io-size", "4K"))
        io_total = n(vm.get("io-total", "1G")) if "io-total" in vm \
            else (1 << 20)              # liliputian default for tests
        pattern = vm.get("io-pattern", "seq")
        if pattern not in ("seq", "rand"):
            print(f"rbd: --io-pattern must be rand or seq",
                  file=sys.stderr)
            return EINVAL
        img = Image(c.client("client.rbd-bench"), pool, name)
        size = img.size()
        if io_size <= 0 or io_size > size:
            print(f"rbd: --io-size must be > 0 and fit the image "
                  f"({size} bytes)", file=sys.stderr)
            return EINVAL
        ops_total = max(1, io_total // io_size)
        payload = b"\xbe" * io_size
        rng_seed = 0x5eed
        t0 = _time.perf_counter()
        last_tick, ops_done = t0, 0
        print("  SEC       OPS   OPS/SEC   BYTES/SEC")
        for i in range(ops_total):
            if pattern == "rand":
                rng_seed = (rng_seed * 1103515245 + 12345) & 0x7FFFFFFF
                off = (rng_seed * io_size) % max(size - io_size, 1)
                off -= off % io_size
            else:
                off = (i * io_size) % max(size - io_size + 1, 1)
            write_this = io_type in ("write",) or \
                (io_type in ("readwrite", "rw") and i % 2 == 0)
            if write_this:
                img.write(off, payload)
            else:
                img.read(off, io_size)
            ops_done += 1
            now = _time.perf_counter()
            if now - last_tick >= 1.0:
                dt = now - t0
                print(f"{int(dt):5d}  {ops_done:8d}  "
                      f"{ops_done / dt:8.2f}  "
                      f"{ops_done * io_size / dt:.2f}")
                last_tick = now
        dt = max(_time.perf_counter() - t0, 1e-9)
        print(f"elapsed: {int(dt):5d}  ops: {ops_total:8d}  "
              f"ops/sec: {ops_total / dt:8.2f}  "
              f"bytes/sec: {ops_total * io_size / dt:.2f}")
        if io_type != "read":
            c.checkpoint(checkpoint)    # bench writes persist
        return 0
    elif spec == "rename":
        from ..cluster import MiniCluster
        if checkpoint is None:
            print("rbd: error opening cluster (no --checkpoint)",
                  file=sys.stderr)
            return 1
        c = MiniCluster.restore(checkpoint)
        from ..rbd import RBD
        RBD(c.client("client.rbd-shell")).rename(
            pool, name, dest[1])  # type: ignore[index]
        c.checkpoint(checkpoint)
        return 0
    if argv is None:
        print(f"rbd: '{spec}' is not implemented in this build",
              file=sys.stderr)
        return 95                      # EOPNOTSUPP
    if checkpoint is None:
        print("rbd: error opening cluster (no --checkpoint)",
              file=sys.stderr)
        return 1
    from ..cluster import MiniCluster
    c = MiniCluster.restore(checkpoint)
    rc = rbd_cli.run(c, c.client("client.rbd-shell"), argv)
    if rc == 0 and spec not in READONLY_SPECS:
        # rados.py's CLI contract: mutations persist by checkpointing
        # the cluster back to the same directory; reads don't rewrite
        c.checkpoint(checkpoint)
    return rc


def execute(arguments: Sequence[str],
            checkpoint: Optional[str] = None) -> int:
    args = list(arguments)
    words = get_command_spec(args)
    if not words or words == ["help"]:
        sys.stdout.write(print_command_list(
            APP, BANNER,
            [(a.spec, a.alias, a.desc) for a in ACTIONS], GLOBAL_OPTS))
        return 0
    if words[0] == "help":
        action, _, is_alias = find_action(words[1:])
        if action is None:
            sys.stderr.write("error: unknown option '"
                             + " ".join(words[1:]) + "'\n\n")
            sys.stdout.write(print_command_list(
                APP, BANNER,
                [(a.spec, a.alias, a.desc) for a in ACTIONS],
                GLOBAL_OPTS))
            return 1
        shown = action.alias if is_alias and action.alias else action.spec
        sys.stdout.write(print_action_help(
            APP, shown, action.positionals, action.options, action.desc,
            action.help))
        return 0
    action, matched, _ = find_action(words)
    if action is None:
        sys.stderr.write("error: unknown option '"
                         + " ".join(words) + "'\n\n")
        sys.stdout.write(print_command_list(
            APP, BANNER,
            [(a.spec, a.alias, a.desc) for a in ACTIONS], GLOBAL_OPTS))
        return 1
    try:
        vm, pos = parse_arguments(action, matched, args)
        parsed = validate(action, vm, pos)
        return execute_action(action, vm, parsed, checkpoint)
    except ArgvError as e:
        print(f"rbd: {e}", file=sys.stderr)
        return 1
    except ValidationError as e:
        print(f"rbd: {e}", file=sys.stderr)
        return EINVAL


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    checkpoint = None
    if "--checkpoint" in args:
        i = args.index("--checkpoint")
        if i + 1 >= len(args):
            print("rbd: option '--checkpoint' requires an argument",
                  file=sys.stderr)
            return 1
        checkpoint = args[i + 1]
        del args[i:i + 2]
    return execute(args, checkpoint)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
