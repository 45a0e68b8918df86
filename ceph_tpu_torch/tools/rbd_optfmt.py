"""Help/usage formatting for the rbd CLI frontend.

Reproduces the reference rbd shell's help layout byte-exact
(src/tools/rbd/OptionPrinter.{h,cc} column algorithm and
src/tools/rbd/IndentStream.{h,cc} wrap semantics, plus the
boost::program_options two-column rendering used for the global
options) so the recorded CLI transcripts (src/test/cli/rbd/*.t)
replay verbatim.  The wrap algorithm is necessarily the same —
byte parity pins every break point — but the implementation is a
small string builder, not a streambuf.

Port of ``ceph_tpu/tools/rbd_optfmt.py``, a copy.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

LINE_WIDTH = 80
MIN_NAME_WIDTH = 20
MAX_DESCRIPTION_OFFSET = LINE_WIDTH // 2


class IndentWriter:
    """Word-wrapping writer: continuation lines are indented to
    ``indent``; the first flush pads from ``initial_offset`` (the text
    already on the line) up to ``indent``.  ``delim`` is the break
    character set (OptionPrinter uses "[" for usage option lists and
    " " everywhere else)."""

    def __init__(self, indent: int, initial_offset: int,
                 line_length: int = LINE_WIDTH):
        self.indent = indent
        self.initial_offset = initial_offset
        self.line_length = line_length
        self.delim = " "
        self._buf = ""
        self._out: List[str] = []

    def set_delimiter(self, delim: str) -> None:
        self.delim = delim

    def _flush_line(self) -> None:
        if self.initial_offset >= self.indent:
            self.initial_offset = 0
            self._out.append("\n")
        self._out.append(" " * (self.indent - self.initial_offset))
        self.initial_offset = 0

    def write(self, text: str) -> None:
        for c in text:
            if c == "\n":
                self._buf += c
                self._flush_line()
                self._out.append(self._buf)
                self._buf = ""
                continue
            if c == "\t":
                c = " "
            if self.indent + len(self._buf) >= self.line_length:
                space_delim = self.delim == " "
                off = self._buf.rfind(self.delim)
                if off < 0 and not space_delim:
                    off = self._buf.rfind(" ")
                if off >= 0:
                    self._flush_line()
                    self._out.append(self._buf[:off])
                    self._buf = self._buf[off + (1 if space_delim else 0):]
                else:
                    self._flush_line()
                    self._out.append(self._buf)
                    self._buf = ""
                self._out.append("\n")
            self._buf += c

    def endl(self) -> None:
        self.write("\n")

    def text(self) -> str:
        return "".join(self._out)


class Opt:
    """One command option: ``short`` like "p" or None, ``long`` like
    "pool", ``has_arg``, ``required`` (rendered unbracketed in the
    usage line), ``desc`` (may contain explicit newlines at the
    reference's own break points)."""

    def __init__(self, long: str, desc: str, short: Optional[str] = None,
                 has_arg: bool = True, required: bool = False):
        self.short = short
        self.long = long
        self.has_arg = has_arg
        self.required = required
        self.desc = desc

    def format_name(self) -> str:
        if self.short:
            return f"-{self.short} [ --{self.long} ]"
        return f"--{self.long}"

    def format_parameter(self) -> str:
        return "arg" if self.has_arg else ""


class Positional:
    """One positional argument: displayed ``<name>``; ``variadic``
    renders ``[<name> ...]`` in the usage line and lifts the
    positional-count cap."""

    def __init__(self, name: str, desc: str, variadic: bool = False):
        self.name = name
        self.desc = desc
        self.variadic = variadic

    # column math counts the same width the reference does for an
    # option-styled entry ("--name" == "<name>" in length, no arg)
    def format_name(self) -> str:
        return "--" + self.name

    def format_parameter(self) -> str:
        return ""


def compute_name_width(positionals: Sequence[Positional],
                       options: Sequence[Opt], indent: int = 2) -> int:
    width = MIN_NAME_WIDTH
    for ent in list(positionals) + list(options):
        width = max(width, len(ent.format_name())
                    + len(ent.format_parameter()) + 1)
    width += indent
    return min(width, MAX_DESCRIPTION_OFFSET) + 1


def print_short(usage_prefix: str, positionals: Sequence[Positional],
                options: Sequence[Opt]) -> str:
    """The wrapped ``usage:`` block, starting after ``usage_prefix``
    (which the caller has already emitted)."""
    initial = len(usage_prefix)
    name_width = min(initial, MAX_DESCRIPTION_OFFSET) + 1
    w = IndentWriter(name_width, initial)
    w.set_delimiter("[")
    for o in options:
        if not o.required:
            w.write("[")
        w.write("--" + o.long)
        if o.has_arg:
            w.write(f" <{o.long}>")
        if not o.required:
            w.write("]")
        w.write(" ")
    w.endl()
    if positionals:
        w.set_delimiter(" ")
        for p in positionals:
            w.write(f"<{p.name}> ")
            if p.variadic:
                w.write(f"[<{p.name}> ...]")
                break
        w.endl()
    return w.text()


def print_detailed(positionals: Sequence[Positional],
                   options: Sequence[Opt]) -> str:
    out: List[str] = []
    name_width = compute_name_width(positionals, options)
    if positionals:
        out.append("Positional arguments\n")
        for p in positionals:
            left = f"  <{p.name}>"
            out.append(left)
            w = IndentWriter(name_width, len(left))
            w.write(p.desc)
            w.endl()
            out.append(w.text())
        out.append("\n")
    if options:
        out.append("Optional arguments\n")
        for o in options:
            left = "  " + o.format_name() + " " + o.format_parameter()
            out.append(left)
            w = IndentWriter(name_width, len(left))
            w.write(o.desc)
            w.endl()
            out.append(w.text())
        out.append("\n")
    return "".join(out)


def print_action_help(app: str, spec: Sequence[str],
                      positionals: Sequence[Positional],
                      options: Sequence[Opt], description: str,
                      extra_help: str = "") -> str:
    prefix = f"usage: {app} " + " ".join(spec)
    out = prefix + print_short(prefix, positionals, options)
    if description:
        out += "\n" + description + "\n"
    out += "\n" + print_detailed(positionals, options)
    if extra_help:
        out += extra_help + "\n\n"
    return out


def format_command_name(spec: Sequence[str],
                        alias: Optional[Sequence[str]]) -> str:
    name = " ".join(spec)
    if alias:
        name += " (" + " ".join(alias) + ")"
    return name


def print_command_list(app: str, banner: str,
                       commands: Sequence[Tuple[Sequence[str],
                                                Optional[Sequence[str]],
                                                str]],
                       global_opts: Sequence[Opt],
                       ) -> str:
    """The full ``rbd --help`` page: sorted command list with wrapped
    one-line descriptions, then the boost-rendered global options."""
    out = [f"usage: {app} <command> ...\n\n{banner}\n\n"]
    out.append("Positional arguments:\n  <command>\n")
    cmds = sorted(commands, key=lambda c: list(c[0]))
    indent = 4
    name_width = MIN_NAME_WIDTH
    for spec, alias, _ in cmds:
        name_width = max(name_width, len(format_command_name(spec, alias)))
    name_width = min(name_width + indent, MAX_DESCRIPTION_OFFSET) + 1
    for spec, alias, desc in cmds:
        left = " " * indent + format_command_name(spec, alias)
        out.append(left)
        w = IndentWriter(name_width, len(left))
        w.write(desc)
        w.endl()
        out.append(w.text())
    out.append("\n")
    out.append(boost_options_block("Optional arguments", global_opts))
    out.append(f"\nSee '{app} help <command>' for help on a specific "
               "command.\n")
    return "".join(out)


def boost_options_block(caption: str, options: Sequence[Opt]) -> str:
    """boost::program_options options_description rendering (caption +
    ':' header, two columns, description column = longest entry + 1)."""
    out = [caption + ":\n"]
    width = 0
    for o in options:
        left = "  " + o.format_name()
        if o.has_arg:
            left += " " + o.format_parameter()
        width = max(width, len(left) + 1)
    for o in options:
        left = "  " + o.format_name()
        if o.has_arg:
            left += " " + o.format_parameter()
        out.append(left + " " * (width - len(left)) + o.desc + "\n")
    return "".join(out)
