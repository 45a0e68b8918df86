"""crushtool — compile/decompile/test crush maps.

CLI surface mirrors the reference tool (src/tools/crushtool.cc): -c compile
text → binary map, -d decompile, -i map --test with
--num-rep/--min-x/--max-x/--show-statistics/--show-mappings/
--show-bad-mappings/--weight/--set-*-tunables, and --build for quick
hierarchies.  The --test engine is CrushTester (crush/CrushTester.cc:472),
running the device mapper when eligible.

Maps are stored in the reference's binary crushmap format
(crush/binfmt.py ≙ CrushWrapper::encode/decode), so this tool reads maps
produced by the reference crushtool and vice versa.

The port's own copy of ``ceph_tpu/tools/crushtool.py``.  ``main`` runs
``--test`` on the card unless its caller passes ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import sys

from ..crush.binfmt import decode_crushmap, encode_crushmap
from ..crush.compiler import CrushCompiler
from ..crush.tester import CrushTester
from ..crush.wrapper import CrushWrapper


USAGE = """usage: crushtool ...

Display, modify and test a crush map

There are five stages, running one after the other:

 - input/build
 - tunables adjustments
 - modifications
 - display/test
 - output

Options that are not specific to a stage.

   [--infn|-i infile]
                         read the crush map from infile

Options for the input/build stage

   --decompile|-d map    decompile a crush map to source
   [--outfn|-o outfile]
                         specify output for for (de)compilation
   --compile|-c map.txt  compile a map from source
   --enable-unsafe-tunables
                         compile with unsafe tunables
   --build --num_osds N layer1 ...
                         build a new map, where each 'layer' is
                         'name (uniform|straw2|straw|list|tree) size'

Options for the tunables adjustments stage

   --set-choose-local-tries N
                         set choose local retries before re-descent
   --set-choose-local-fallback-tries N
                         set choose local retries using fallback
                         permutation before re-descent
   --set-choose-total-tries N
                         set choose total descent attempts
   --set-chooseleaf-descend-once <0|1>
                         set chooseleaf to (not) retry the recursive descent
   --set-chooseleaf-vary-r <0|1>
                         set chooseleaf to (not) vary r based on parent
   --set-chooseleaf-stable <0|1>
                         set chooseleaf firstn to (not) return stable results

Options for the modifications stage

   -i mapfn --add-item id weight name [--loc type name ...]
                         insert an item into the hierarchy at the
                         given location
   -i mapfn --update-item id weight name [--loc type name ...]
                         insert or move an item into the hierarchy at the
                         given location
   -i mapfn --remove-item name
                         remove the given item
   -i mapfn --reweight-item name weight
                         reweight a given item (and adjust ancestor
                         weights as needed)
   -i mapfn --reweight   recalculate all bucket weights
   -i mapfn --create-simple-rule name root type mode
                         create crush rule <name> to start from <root>,
                         replicate across buckets of type <type>, using
                         a choose mode of <firstn|indep>
   -i mapfn --create-replicated-rule name root type
                         create crush rule <name> to start from <root>,
                         replicate across buckets of type <type>
   --device-class <class>
                         use device class <class> for new rule
   -i mapfn --remove-rule name
                         remove the specified crush rule

Options for the display/test stage

   -f --format           the format of --dump, defaults to json-pretty
                         can be one of json, json-pretty, xml, xml-pretty,
                         table, table-kv, html, html-pretty
   --dump                dump the crush map
   --tree                print map summary as a tree
   --check [max_id]      check if any item is referencing an unknown name/type
   -i mapfn --show-location id
                         show location for given device id
   -i mapfn --test       test a range of inputs on the map
      [--min-x x] [--max-x x] [--x x]
      [--min-rule r] [--max-rule r] [--rule r] [--ruleset rs]
      [--num-rep n]
      [--pool-id n]      specifies pool id
      [--batches b]      split the CRUSH mapping into b > 1 rounds
      [--weight|-w devno weight]
                         where weight is 0 to 1.0
      [--simulate]       simulate placements using a random
                         number generator in place of the CRUSH
                         algorithm
   --show-utilization    show OSD usage
   --show-utilization-all
                         include zero weight items
   --show-statistics     show chi squared statistics
   --show-mappings       show mappings
   --show-bad-mappings   show bad mappings
   --show-choose-tries   show choose tries histogram
   --output-name name
                         prepend the data file(s) generated during the
                         testing routine with name
   --output-csv
                         export select data generated during testing routine
                         to CSV files for off-line post-processing
                         use --help-output for more information

Options for the output stage

   [--outfn|-o outfile]
                         specify output for modified crush map"""

HELP_OUTPUT = """data output from testing routine ...
           absolute_weights
                  the decimal weight of each OSD
                  data layout: ROW MAJOR
                               OSD id (int), weight (int)
           batch_device_expected_utilization_all
                  the expected number of objects each OSD should receive per placement batch
                  which may be a decimal value
                  data layout: COLUMN MAJOR
                               round (int), objects expected on OSD 0...OSD n (float)
           batch_device_utilization_all
                  the number of objects stored on each OSD during each placement round
                  data layout: COLUMN MAJOR
                               round (int), objects stored on OSD 0...OSD n (int)
           device_utilization_all
                  the number of objects stored on each OSD at the end of placements
                  data_layout: ROW MAJOR
                               OSD id (int), objects stored (int), objects expected (float)
           device_utilization
                  the number of objects stored on each OSD marked 'up' at the end of placements
                  data_layout: ROW MAJOR
                               OSD id (int), objects stored (int), objects expected (float)
           placement_information
                  the map of input -> OSD
                  data_layout: ROW MAJOR
                               input (int), OSD's mapped (int)
           proportional_weights_all
                  the proportional weight of each OSD specified in the CRUSH map
                  data_layout: ROW MAJOR
                               OSD id (int), proportional weight (float)
           proportional_weights
                  the proportional weight of each 'up' OSD specified in the CRUSH map
                  data_layout: ROW MAJOR
                               OSD id (int), proportional weight (float)"""


def load_map(path: str) -> CrushWrapper:
    with open(path, "rb") as f:
        return decode_crushmap(f.read())


def save_map(cw: CrushWrapper, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_crushmap(cw))


def _check_name_maps(cw, max_id: int) -> bool:
    """CrushTester::check_name_maps: walk the tree from the roots (the
    'ceph osd tree' walk) and verify every bucket has a name, every
    node's type has a name, and no device id reaches max_id; also
    probe the stray-device path with item 0."""
    def fail(msg, item):
        print(f"{msg}: item#{item}")
        return False

    def visit(item):
        if item < 0:
            b = cw.crush.bucket(item)
            if item not in cw.name_map:
                return fail("unknown item name", item)
            t = b.type
        else:
            if max_id > 0 and item >= max_id:
                return fail("item id too large", item)
            t = 0
        if t not in cw.type_map:
            return fail("unknown type name", item)
        if item < 0:
            for it in cw.crush.bucket(item).items:
                if not visit(it):
                    return False
        return True

    roots = [b.id for b in cw.crush.buckets if b is not None
             and cw._parent_of(b.id) is None]
    for r in sorted(roots):
        if not visit(r):
            return False
    # straying osd probe (id 0 need not be in the map)
    if 0 not in cw.type_map:
        return fail("unknown type name", 0)
    if max_id > 0 and 0 >= max_id:
        return fail("item id too large", 0)
    return True


def _check_overlapped_rules(cw) -> None:
    """CrushTester::check_overlapped_rules: rules sharing a (ruleset,
    type) whose [min_size, max_size] ranges overlap print per merged
    sub-interval, names sorted (the boost interval_map shape)."""
    groups: dict = {}
    for rno, r in enumerate(cw.crush.rules):
        if r is None:
            continue
        name = cw.rule_name_map.get(rno, f"rule{rno}")
        groups.setdefault((r.ruleset, r.type), []).append(
            (r.min_size, r.max_size, name))
    for (ruleset, _t), rules in sorted(groups.items()):
        points = sorted({p for lo, hi, _ in rules
                         for p in (lo, hi + 1)})
        prev = None
        for a, b in zip(points, points[1:]):
            names = sorted({n for lo, hi, n in rules
                            if lo <= a and a <= hi})
            if len(names) > 1 and names != prev:
                print(f"overlapped rules in ruleset {ruleset}: "
                      + ", ".join(names))
            prev = names if len(names) > 1 else None


def main(argv=None, device="cuda") -> int:
    """crushtool with ``argv`` (default ``sys.argv[1:]``); ``--test``
    sweeps on ``device`` (``CrushTester``'s), the card by default."""
    import os

    argv = list(sys.argv[1:] if argv is None else argv)
    # CEPH_ARGS is consumed by global_init; --debug-* flags there are
    # swallowed (our tools don't emit debug chatter).  A --debug-crush
    # ON the command line is NOT special — it falls through to the
    # remaining-args handling exactly like the reference (build.t
    # records the resulting 'remaining args: [...]' error)
    env_args = os.environ.get("CEPH_ARGS", "").split()
    filtered = []
    skip = False
    for a in env_args:
        if skip:
            skip = False
            continue
        if a == "--debug-crush":
            skip = True
            continue
        if a.startswith("--debug-crush="):
            continue
        filtered.append(a)
    argv = filtered + argv
    if "--help" in argv or "-h" in argv:
        print(USAGE)
        print("")
        return 0
    if "--help-output" in argv:
        print(HELP_OUTPUT)
        return 0

    p = argparse.ArgumentParser(prog="crushtool", add_help=False)
    p.add_argument("-i", "--infn", help="input map file")
    p.add_argument("-o", "--outfn", help="output file")
    p.add_argument("-c", "--compile", dest="srcfn",
                   help="compile text map to binary")
    p.add_argument("-d", "--decompile", dest="decompile",
                   help="decompile map to text", nargs="?", const="",
                   default=None)
    p.add_argument("-t", "--test", action="store_true",
                   help="test a range of inputs on the map")
    p.add_argument("--num-rep", "--num_rep", type=int, default=-1)
    p.add_argument("--min-x", "--min_x", type=int, default=-1)
    p.add_argument("--max-x", "--max_x", type=int, default=-1)
    p.add_argument("-x", "--x", dest="one_x", type=int, default=None)
    p.add_argument("--rule", type=int, default=-1)
    p.add_argument("--min-rule", type=int, default=-1)
    p.add_argument("--max-rule", type=int, default=-1)
    p.add_argument("--ruleset", type=int, default=-1)
    p.add_argument("--pool-id", type=int, default=-1)
    p.add_argument("--batches", type=int, default=1)
    p.add_argument("--simulate", action="store_true")
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-bad-mappings", action="store_true")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-utilization-all", action="store_true")
    p.add_argument("--show-choose-tries", action="store_true")
    p.add_argument("--output-name", default="")
    p.add_argument("--output-csv", action="store_true")
    p.add_argument("-w", "--weight", nargs=2, action="append",
                   default=[], metavar=("DEVNO", "WEIGHT"))
    # runtime tunable overrides (reference --set-* flags)
    p.add_argument("--set-choose-local-tries", type=int, default=None)
    p.add_argument("--set-choose-local-fallback-tries", type=int,
                   default=None)
    p.add_argument("--set-choose-total-tries", type=int, default=None)
    p.add_argument("--set-chooseleaf-descend-once", type=int, default=None)
    p.add_argument("--set-chooseleaf-vary-r", type=int, default=None)
    p.add_argument("--set-chooseleaf-stable", type=int, default=None)
    p.add_argument("--set-straw-calc-version", type=int, default=None)
    p.add_argument("--enable-unsafe-tunables", action="store_true")
    p.add_argument("--add-item", nargs=3, metavar=("ID", "W", "NAME"))
    p.add_argument("--loc", nargs=2, action="append", default=[],
                   metavar=("TYPE", "NAME"))
    p.add_argument("--update-item", nargs=3,
                   metavar=("ID", "W", "NAME"))
    p.add_argument("--reweight-item", nargs=2, metavar=("NAME", "W"))
    p.add_argument("--reweight", action="store_true")
    p.add_argument("--remove-item", metavar="NAME")
    p.add_argument("--remove-rule", metavar="NAME")
    p.add_argument("--create-simple-rule", nargs=4,
                   metavar=("NAME", "ROOT", "TYPE", "MODE"))
    p.add_argument("--create-replicated-rule", nargs=3,
                   metavar=("NAME", "ROOT", "TYPE"))
    p.add_argument("--device-class", default="")
    p.add_argument("--build", action="store_true",
                   help="build a layered map: --num_osds N "
                        "(name alg size)...")
    p.add_argument("--num_osds", type=int, default=0)
    p.add_argument("layers", nargs="*",
                   help="--build layer triples: name alg size")
    p.add_argument("--show-location", type=int, default=None,
                   metavar="ID")
    p.add_argument("--check", nargs="?", const=-1, type=int,
                   default=None, metavar="MAX_ID")
    p.add_argument("--dump", action="store_true",
                   help="dump the map as reference-format JSON")
    p.add_argument("-f", "--format", default="json-pretty")
    p.add_argument("--tree", action="store_true")
    p.add_argument("--host-mapper", action="store_true",
                   help="force the host interpreter (no device batch)")
    args, _unknown = p.parse_known_args(argv)
    # the reference's leftover-args pool: scan argv skipping every
    # known option (and its operands) — what's left, in ORIGINAL
    # order, is --build's layer list; anything else rejects it
    # (ceph_argparse leaves exactly these behind)
    nargs_of = {}
    optional_val = set()
    for act in p._actions:
        for s in act.option_strings:
            if isinstance(act, argparse._StoreTrueAction):
                nargs_of[s] = 0
            elif act.nargs in (None, 1):
                nargs_of[s] = 1
            elif act.nargs == "?":
                nargs_of[s] = 1
                optional_val.add(s)
            elif isinstance(act.nargs, int):
                nargs_of[s] = act.nargs
            else:
                nargs_of[s] = 0
    remaining = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        base = tok.split("=", 1)[0]
        if base in nargs_of:
            n = 0 if "=" in tok else nargs_of[base]
            if base in optional_val and n:
                nxt = argv[i + 1] if i + 1 < len(argv) else "-"
                if nxt.startswith("-") and not \
                        nxt.lstrip("-").isdigit():
                    n = 0
            i += 1 + n
        else:
            remaining.append(tok)
            i += 1
    args.layers = remaining
    if remaining and not args.build:
        print(f"unrecognized arguments: [{','.join(remaining)}]",
              file=sys.stderr)
        return 1

    def apply_tunable_flags(m) -> bool:
        changed = False
        for attr, val in [
                ("choose_local_tries", args.set_choose_local_tries),
                ("choose_local_fallback_tries",
                 args.set_choose_local_fallback_tries),
                ("choose_total_tries", args.set_choose_total_tries),
                ("chooseleaf_descend_once",
                 args.set_chooseleaf_descend_once),
                ("chooseleaf_vary_r", args.set_chooseleaf_vary_r),
                ("chooseleaf_stable", args.set_chooseleaf_stable),
                ("straw_calc_version", args.set_straw_calc_version)]:
            if val is not None:
                setattr(m, attr, val)
                changed = True
        return changed

    # ---- stage 1: input/build (crushtool.cc:744-846) -----------------------
    modified = False
    cw = None
    if args.build:
        cw = _do_build(args)
        if cw is None:
            return 1
        modified = True
    elif args.srcfn:
        with open(args.srcfn) as f:
            text = f.read()
        try:
            cw = CrushCompiler().compile(text)
        except ValueError as e:
            print(e)
            return 1
        modified = True
    else:
        infn = args.infn or (args.decompile or None)
        if infn:
            try:
                cw = load_map(infn)
            except FileNotFoundError:
                print(f"crushtool: error reading \'{infn}\': "
                      f"(2) No such file or directory", file=sys.stderr)
                return 1
            except Exception:
                print(f"crushtool: unable to decode {infn}")
                return 1
    adjust = any(v is not None for v in (
        args.set_choose_local_tries,
        args.set_choose_local_fallback_tries,
        args.set_choose_total_tries,
        args.set_chooseleaf_descend_once,
        args.set_chooseleaf_vary_r, args.set_chooseleaf_stable,
        args.set_straw_calc_version))
    no_action = not (args.build or args.srcfn or args.decompile
                     is not None or args.test or args.check is not None
                     or args.dump or args.tree or adjust
                     or args.show_location is not None
                     or args.add_item or args.update_item
                     or args.reweight_item or args.reweight
                     or args.remove_item or args.remove_rule
                     or args.create_simple_rule
                     or args.create_replicated_rule)
    if no_action:
        # --set-* flags count as an action (crushtool.cc:640 !adjust)
        print("no action specified; -h for help", file=sys.stderr)
        return 1
    if cw is None:
        print("crushtool: no input map specified", file=sys.stderr)
        return 1

    # ---- stage 2: tunables (crushtool.cc:848-880) --------------------------
    if apply_tunable_flags(cw.crush):
        modified = True

    # ---- stage 3: modifications (crushtool.cc:882-990) ---------------------
    if args.reweight_item:
        name, w = args.reweight_item
        print(f"crushtool reweighting item {name} to {float(w):g}")
        if not cw.name_exists(name):
            print(f" name {name} dne", file=sys.stderr)
            return 1
        r = cw.adjust_item_weight(cw.get_item_id(name),
                                  int(round(float(w) * 0x10000)))
        if r < 0:            # named but linked into no bucket
            print("crushtool (2) No such file or directory",
                  file=sys.stderr)
            return 1
        modified = True
    if args.remove_item:
        print(f"crushtool removing item {args.remove_item}")
        if not cw.name_exists(args.remove_item):
            print(f" name {args.remove_item} dne", file=sys.stderr)
            return 1
        cw.remove_item(cw.get_item_id(args.remove_item))
        modified = True
    if args.add_item or args.update_item:
        from ..osdmap.simple_build import insert_item
        if args.add_item:
            dev, w, name = args.add_item
            loc = {t: n for t, n in args.loc}
            try:
                insert_item(cw, int(dev),
                            int(round(float(w) * 0x10000)), name, loc)
            except ValueError as e:
                print(f"crushtool {e}", file=sys.stderr)
                return 1
        else:
            # CrushWrapper::update_item: adjust in place when the
            # item already sits at the given location; otherwise
            # UNLINK it from wherever it lives and re-insert at the
            # new location under the (possibly new) name
            dev, w, name = args.update_item
            dev = int(dev)
            w16 = int(round(float(w) * 0x10000))
            loc = {t: n for t, n in args.loc}
            placed = False
            for t in sorted(cw.type_map):
                bname = loc.get(cw.type_map[t])
                if t == 0 or bname is None:
                    continue
                if not cw.name_exists(bname):
                    break
                bid = cw.get_item_id(bname)
                if dev in cw.crush.bucket(bid).items:
                    delta = cw._set_item_weight_in(bid, dev, w16)
                    cw._propagate_above(bid, delta)
                    cw.set_item_name(dev, name)
                    if cw.item_class:
                        cw.rebuild_roots_with_classes()
                    placed = True
                break
            if not placed:
                if cw._parent_of(dev) is not None:
                    cw.remove_item(dev)
                insert_item(cw, dev, w16, name, loc)
        modified = True
    if args.create_simple_rule:
        rname, root, ftype, mode = args.create_simple_rule
        cw.add_simple_rule(rname, root_name=root,
                           failure_domain_name=ftype, mode=mode)
        modified = True
    if args.create_replicated_rule:
        rname, root, ftype = args.create_replicated_rule
        r = cw.add_simple_rule(rname, root_name=root,
                               failure_domain_name=ftype,
                               device_class=args.device_class,
                               mode="firstn")
        if r < 0:
            print(f"create-replicated-rule failed: {r}",
                  file=sys.stderr)
            return 1
        modified = True
    if args.remove_rule:
        if not cw.rule_exists(args.remove_rule):
            print(f"rule {args.remove_rule} does not exist",
                  file=sys.stderr)
            return 0
        cw.remove_rule(cw.get_rule_id(args.remove_rule))
        modified = True
    if args.reweight:
        cw.reweight()
        modified = True

    # ---- stage 4: display/test (crushtool.cc:992-1028) ---------------------
    if args.show_location is not None:
        loc = cw.get_full_location(args.show_location)
        for k in sorted(loc):        # std::map: alphabetical by type
            print(f"{k}\t{loc[k]}")
    if args.tree:
        from ..crush.treedump import crush_tree_lines
        for line in crush_tree_lines(cw):
            print(line)
    if args.dump:
        from ..crush.dumpfmt import dump_json
        sys.stdout.write(dump_json(cw))
    if args.decompile is not None:
        text = CrushCompiler(cw).decompile()
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        modified = False         # -o was consumed for the text
    if args.check is not None:
        _check_overlapped_rules(cw)
        if args.check >= 0 and not _check_name_maps(cw, args.check):
            return 1
    if args.test:
        t = CrushTester(cw, device=device)
        if args.num_rep >= 0:
            t.set_num_rep(args.num_rep)
        min_x, max_x = args.min_x, args.max_x
        if args.one_x is not None:
            min_x = max_x = args.one_x
        if min_x >= 0:
            t.set_min_x(min_x)
        if max_x >= 0:
            t.set_max_x(max_x)
        if args.rule >= 0:
            t.set_rule(args.rule)
        if args.min_rule >= 0:
            t.set_min_rule(args.min_rule)
        if args.max_rule >= 0:
            t.set_max_rule(args.max_rule)
        if args.ruleset >= 0:
            t.set_ruleset(args.ruleset)
        # --show-utilization[-all] implies statistics
        # (crushtool.cc:1017-1019)
        t.set_output_statistics(args.show_statistics
                                or args.show_utilization
                                or args.show_utilization_all)
        t.set_output_mappings(args.show_mappings)
        t.set_output_bad_mappings(args.show_bad_mappings)
        t.set_output_utilization(args.show_utilization)
        t.set_output_utilization_all(args.show_utilization_all)
        t.set_output_choose_tries(args.show_choose_tries)
        t.set_output_csv(args.output_csv, args.output_name)
        t.set_pool_id(args.pool_id)
        t.set_batches(args.batches)
        t.set_simulate(args.simulate)
        t.use_device = not args.host_mapper and \
            not args.show_choose_tries and args.pool_id < 0 and \
            not args.simulate
        for dev, w in args.weight:
            t.set_device_weight(int(dev), float(w))
        r = t.test()
        if r != 0:
            return r

    # ---- stage 5: output (crushtool.cc:1030-1047) --------------------------
    if modified:
        if not args.outfn:
            print("crushtool successfully built or modified map.  "
                  "Use \'-o <file>\' to write it out.")
        else:
            save_map(cw, args.outfn)
    return 0


def _do_build(args):
    """crushtool --build --num_osds N name alg size ...
    (src/tools/crushtool.cc:744): stack layers bottom-up, each layer
    packing the previous one\'s items into buckets of `size` (0 =
    everything into one bucket), named name<i> (bare name for size
    0); then build_simple_crush_rules over the top root, warning when
    several roots remain."""
    from ..crush.constants import (
        CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
        CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM)
    algs = {"uniform": CRUSH_BUCKET_UNIFORM,
            "list": CRUSH_BUCKET_LIST, "tree": CRUSH_BUCKET_TREE,
            "straw": CRUSH_BUCKET_STRAW,
            "straw2": CRUSH_BUCKET_STRAW2}
    if len(args.layers) % 3 or not args.layers:
        if args.layers:
            print(f"remaining args: [{','.join(args.layers)}]",
                  file=sys.stderr)
        print("layers must be specified with 3-tuples of "
              "(name, buckettype, size)", file=sys.stderr)
        return None
    for li in range(0, len(args.layers), 3):
        lname, lalg, lsize = args.layers[li:li + 3]
        if lalg not in algs:
            print(f"unknown bucket type \'{lalg}\'", file=sys.stderr)
            return None
        if not lsize.lstrip("-").isdigit() or int(lsize) < 0:
            print(f"invalid layer size \'{lsize}\'", file=sys.stderr)
            return None
    cw = CrushWrapper()
    cw.set_tunables_profile("jewel")
    cw.set_type_name(0, "osd")
    cw.set_max_devices(args.num_osds)
    lower = [(i, 0x10000) for i in range(args.num_osds)]
    for i in range(args.num_osds):
        cw.set_item_name(i, f"osd.{i}")
    t = 0
    lname = "osd"
    for li in range(0, len(args.layers), 3):
        lname, lalg, lsize = args.layers[li:li + 3]
        t += 1
        size = int(lsize)
        cw.set_type_name(t, lname)
        pos, idx = 0, 0
        cur = []
        while pos < len(lower):
            chunk = lower[pos:pos + size] if size else lower[pos:]
            pos += len(chunk)
            bid = cw.add_bucket(
                algs[lalg], t,
                f"{lname}{idx}" if size else lname,
                [c for c, _ in chunk], [w for _, w in chunk])
            cur.append((bid, sum(w for _, w in chunk)))
            idx += 1
        lower = cur
    root = lname if int(args.layers[-1]) == 0 else f"{lname}0"
    roots = [b.id for b in cw.crush.buckets
             if b is not None and cw._parent_of(b.id) is None]
    if len(roots) > 1:
        # crushtool.cc:832-838 (note the blank trailing line from the
        # final std::endl after the embedded newline)
        print(f"The crush rulesets will use the root {root}\n"
              "and ignore the others.\n"
              f"There are {len(roots)} roots, they can be\n"
              "grouped into a single root by appending something "
              "like:\n"
              "  root straw 0\n", file=sys.stderr)
    cw.add_simple_rule("replicated_rule", root_name=root,
                       failure_domain_name=cw.get_type_name(1),
                       mode="firstn", ruleno=0)
    return cw


if __name__ == "__main__":
    # die silently on a closed pipe (`tool ... | head`), like the
    # C++ tools\' default SIGPIPE disposition
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
