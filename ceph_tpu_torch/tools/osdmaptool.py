"""osdmaptool — inspect and exercise OSDMaps.

CLI surface mirrors the reference tool (src/tools/osdmaptool.cc):
--createsimple N builds a map, --test-map-pgs maps every PG of every pool
(the full-cluster remap benchmark harness, backed by OSDMapMapping's device
batch path), --test-map-object maps one object, --upmap runs the balancer
(calc_pg_upmaps), --mark-up-in resets osd states.  Maps are python pickles.

The port's own copy of ``ceph_tpu/tools/osdmaptool.py``.  ``main`` maps
``--test-map-pgs`` on the card unless its caller passes ``device="cpu"``
(``--host-mapper`` maps on the host ``crush_do_rule``).  A map is a
pickle of this package's ``OSDMap``: the tool reads only pickles whose
classes live in ``ceph_tpu_torch`` (a map written by the JAX package's
tool names ``ceph_tpu`` classes and is refused, not imported).
``--upmap-save`` writes the map with the computed upmap items, as the
reference tool does.
"""
from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np

from ..crush.constants import CRUSH_BUCKET_STRAW2, CRUSH_ITEM_NONE
from ..osdmap import (
    CEPH_OSD_IN, Incremental, OSDMap, OSDMapMapping, TYPE_REPLICATED,
    pg_pool_t, pg_t,
)


def createsimple_legacy(n_osds: int, pg_num: int = 128,
                 osds_per_host: int = 4) -> OSDMap:
    m = OSDMap()
    m.set_max_osd(n_osds)
    cw = m.crush
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    hosts = []
    n_hosts = (n_osds + osds_per_host - 1) // osds_per_host
    for h in range(n_hosts):
        osds = list(range(h * osds_per_host,
                          min((h + 1) * osds_per_host, n_osds)))
        hid = cw.add_bucket(CRUSH_BUCKET_STRAW2, 1, f"host{h}", osds,
                            [0x10000] * len(osds), id=-(h + 2))
        hosts.append((hid, len(osds)))
    cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default",
                  [h for h, _ in hosts],
                  [0x10000 * n for _, n in hosts], id=-1)
    for i in range(n_osds):
        m.set_osd(i, up=True, weight=CEPH_OSD_IN)
        cw.set_item_name(i, f"osd.{i}")
    rno = cw.add_simple_rule("replicated_rule", "default", "host",
                             mode="firstn")
    m.add_pool("rbd", pg_pool_t(type=TYPE_REPLICATED, size=3,
                                crush_rule=rno, pg_num=pg_num,
                                pgp_num=pg_num))
    m.epoch = 1
    return m


def _crush_item_weights(m: OSDMap) -> dict:
    """osd -> crush item weight, one pass over every bucket."""
    out: dict = {}
    for b in m.crush.crush.buckets:
        if b is None:
            continue
        for i, it in enumerate(b.items):
            if it >= 0:
                out[it] = b.item_weights[i]
    return out


def test_map_pgs(m: OSDMap, use_device: bool, out,
                 test_random: bool = False, only_pool: int = -1,
                 device="cuda") -> OSDMapMapping:
    """--test-map-pgs in the reference's output format
    (src/tools/osdmaptool.cc): per-pool pg_num lines, the per-IN-osd
    count table, ' in/avg/min/max' stats, and the size histogram —
    plus one trailing 'mapped ...' line naming the batch backend.
    ``use_device`` maps through ``OSDMapMapping`` on ``device``.  Returns
    the mapping (its ``last_backend`` and ``host_replayed`` say where
    the pools mapped)."""
    mapping = OSDMapMapping(use_device=use_device, device=device)
    t0 = time.perf_counter()
    if not test_random:
        mapping.update(m)
    dt = time.perf_counter() - t0
    count = np.zeros(m.max_osd, dtype=np.int64)
    first = np.zeros(m.max_osd, dtype=np.int64)
    primaries = np.zeros(m.max_osd, dtype=np.int64)
    sizes = np.zeros(30, dtype=np.int64)
    total_pgs = 0
    rng = np.random.default_rng()
    for pid in sorted(m.pools):
        if only_pool >= 0 and pid != only_pool:
            continue
        pool = m.pools[pid]
        print(f"pool {pid} pg_num {pool.pg_num}", file=out)
        for ps in range(pool.pg_num):
            total_pgs += 1
            if test_random:
                row = rng.integers(0, m.max_osd, size=pool.size)
                prim = int(row[0])
            else:
                pm = mapping.pools[pid]
                row = [o for o in pm.acting[ps] if o != CRUSH_ITEM_NONE]
                prim = int(pm.acting_primary[ps])
            sizes[len(row)] += 1
            for o in row:
                count[o] += 1
            if len(row):
                first[row[0]] += 1
            if prim >= 0:
                primaries[prim] += 1
    n_in = 0
    total = 0
    min_osd = max_osd = -1
    crush_w = _crush_item_weights(m)
    print("#osd\tcount\tfirst\tprimary\tc wt\twt", file=out)
    for o in range(m.max_osd):
        if m.osd_weight[o] == 0:
            continue
        cw = crush_w.get(o, 0)
        if cw <= 0:
            continue
        n_in += 1
        print(f"osd.{o}\t{count[o]}\t{first[o]}\t{primaries[o]}"
              f"\t{cw / 0x10000:g}\t{m.osd_weight[o] / 0x10000:g}",
              file=out)
        total += count[o]
        if count[o] and (min_osd < 0 or count[o] < count[min_osd]):
            min_osd = o
        if count[o] and (max_osd < 0 or count[o] > count[max_osd]):
            max_osd = o
    avg = total // n_in if n_in else 0
    dev = 0.0
    for o in range(m.max_osd):
        if m.osd_weight[o] == 0 or crush_w.get(o, 0) <= 0:
            continue
        dev += float(avg - count[o]) ** 2
    dev = (dev / n_in) ** 0.5 if n_in else 0.0
    edev = ((total / n_in) * (1.0 - 1.0 / n_in)) ** 0.5 if n_in else 0.0
    print(f" in {n_in}", file=out)
    print(f" avg {avg} stddev {dev:g} ({dev / avg if avg else 0:g}x) "
          f"(expected {edev:g} {edev / avg if avg else 0:g}x))",
          file=out)
    if min_osd >= 0:
        print(f" min osd.{min_osd} {count[min_osd]}", file=out)
    if max_osd >= 0:
        print(f" max osd.{max_osd} {count[max_osd]}", file=out)
    for i in range(4):
        print(f"size {i}\t{sizes[i]}", file=out)
    backends = ",".join(sorted(set(mapping.last_backend.values()))) \
        if not test_random else "random"
    print(f"mapped {total_pgs} pgs in {dt * 1000:.1f} ms "
          f"(backend: {backends})", file=out)
    return mapping


USAGE = """ usage: [--print] [--createsimple <numosd> [--clobber] [--pg_bits <bitsperosd>]] <mapfilename>
   --export-crush <file>   write osdmap's crush map to <file>
   --import-crush <file>   replace osdmap's crush map with <file>
   --test-map-pgs [--pool <poolid>] [--pg_num <pg_num>] map all pgs
   --test-map-pgs-dump [--pool <poolid>] map all pgs
   --test-map-pgs-dump-all [--pool <poolid>] map all pgs to osds
   --health                dump health checks
   --mark-up-in            mark osds up and in (but do not persist)
   --mark-out <osdid>      mark an osd as out (but do not persist)
   --with-default-pool     include default pool when creating map
   --clear-temp            clear pg_temp and primary_temp
   --test-random           do random placements
   --test-map-pg <pgid>    map a pgid to osds
   --test-map-object <objectname> [--pool <poolid>] map an object to osds
   --upmap-cleanup <file>  clean up pg_upmap[_items] entries, writing
                           commands to <file> [default: - for stdout]
   --upmap <file>          calculate pg upmap entries to balance pg layout
                           writing commands to <file> [default: - for stdout]
   --upmap-max <max-count> set max upmap entries to calculate [default: 100]
   --upmap-deviation <max-deviation>
                           max deviation from target [default: .01]
   --upmap-pool <poolname> restrict upmap balancing to 1 or more pools
   --upmap-save            write modified OSDMap with upmap changes"""


# the modules an osdmap pickle of this package may name
_PICKLE_MODULES = ("ceph_tpu_torch.", "numpy", "builtins", "collections",
                   "copyreg", "_codecs")


class _MapUnpickler(pickle.Unpickler):
    """Loads only this package's classes (and numpy's, the builtins')."""

    def find_class(self, module, name):
        if not (module + ".").startswith(_PICKLE_MODULES):
            raise pickle.UnpicklingError(
                f"{module}.{name} is not a class of this package")
        return super().find_class(module, name)


def load_map(raw: bytes) -> OSDMap:
    """An ``OSDMap`` from pickle bytes this tool wrote."""
    import io
    m = _MapUnpickler(io.BytesIO(raw)).load()
    if not isinstance(m, OSDMap):
        raise pickle.UnpicklingError(f"not an OSDMap: {type(m).__name__}")
    return m

def _pool_flags_string(flags: int) -> str:
    from ..osdmap.types import (
        FLAG_EC_OVERWRITES, FLAG_FULL, FLAG_FULL_QUOTA, FLAG_HASHPSPOOL,
        FLAG_NEARFULL,
    )
    names = [(FLAG_HASHPSPOOL, "hashpspool"), (FLAG_FULL, "full"),
             (FLAG_NEARFULL, "nearfull"),
             (FLAG_FULL_QUOTA, "full_quota"),
             (FLAG_EC_OVERWRITES, "ec_overwrites")]
    return ",".join(n for bit, n in sorted(names) if flags & bit)


def pool_print_line(pid: int, name: str, pool) -> str:
    """osd_types.cc operator<<(pg_pool_t) with the pool id/name prefix
    OSDMap::print_pools adds."""
    kind = "erasure" if pool.is_erasure() else "replicated"
    out = (f"pool {pid} '{name}' {kind} size {pool.size} "
           f"min_size {pool.min_size} crush_rule {pool.crush_rule} "
           f"object_hash rjenkins pg_num {pool.pg_num} "
           f"pgp_num {pool.pgp_num} last_change {pool.last_change}")
    if pool.flags:
        out += f" flags {_pool_flags_string(pool.flags)}"
    if pool.quota_max_bytes:
        out += f" max_bytes {pool.quota_max_bytes}"
    if pool.quota_max_objects:
        out += f" max_objects {pool.quota_max_objects}"
    out += f" stripe_width {pool.stripe_width}"
    if getattr(pool, "application", ""):
        out += f" application {pool.application}"
    return out


def _stamp(t: float) -> str:
    lt = time.localtime(t)
    frac = int((t % 1) * 1_000_000)
    return time.strftime("%Y-%m-%d %H:%M:%S", lt) + f".{frac:06d}"


def osdmap_print(m, out) -> None:
    """OSDMap::print (OSDMap.cc:3113), pinned by create-print.t /
    clobber.t.  The osd-status section covers the fields this map
    model tracks (state + weight)."""
    zero = "00000000-0000-0000-0000-000000000000"
    print(f"epoch {m.epoch}", file=out)
    # getattr defaults: maps pickled before these fields existed must
    # still print, not die with AttributeError
    print(f"fsid {getattr(m, 'fsid', zero)}", file=out)
    print(f"created {_stamp(getattr(m, 'created', 0.0))}", file=out)
    print(f"modified {_stamp(getattr(m, 'modified', 0.0))}",
          file=out)
    print("flags ", file=out)
    print(f"crush_version {getattr(m, 'crush_version', 1)}",
          file=out)
    print("full_ratio 0", file=out)
    print("backfillfull_ratio 0", file=out)
    print("nearfull_ratio 0", file=out)
    print("min_compat_client jewel", file=out)
    print("", file=out)
    for pid in sorted(m.pools):
        print(pool_print_line(pid, m.pool_name[pid], m.pools[pid]),
              file=out)
    if m.pools:
        print("", file=out)
    print(f"max_osd {m.max_osd}", file=out)
    for i in range(m.max_osd):
        if m.exists(i):
            updown = "up  " if m.is_up(i) else "down"
            inout = "in " if m.osd_weight[i] > 0 else "out"
            print(f"osd.{i} {updown} {inout} weight "
                  f"{m.osd_weight[i] / 0x10000:g}", file=out)
    print("", file=out)
    for pg in sorted(m.pg_upmap_items):
        pairs = ",".join(f"{a}->{b}" for a, b in m.pg_upmap_items[pg])
        print(f"pg_upmap_items {pg} [{pairs}]", file=out)


class _ArgError(Exception):
    def __init__(self, msg: str, blank: bool = False):
        super().__init__(msg)
        self.blank = blank


class _Args:
    """ceph_argparse-shaped scanner: --flag, --flag val, --flag=val;
    missing/invalid values reproduce the reference's messages."""

    def __init__(self, argv):
        self.argv = list(argv)
        self.i = 0

    def done(self):
        return self.i >= len(self.argv)

    def cur(self):
        return self.argv[self.i]

    def take(self):
        v = self.argv[self.i]
        self.i += 1
        return v

    def witharg(self, *names: str):
        a = self.cur()
        for n in names:
            if a == n:
                if self.i + 1 >= len(self.argv):
                    raise _ArgError(f"Option {n} requires an "
                                    f"argument.", blank=True)
                self.i += 1
                return self.take()
            if a.startswith(n + "="):
                self.i += 1
                return a[len(n) + 1:]
        return None

    def intarg(self, *names: str):
        v = self.witharg(*names)
        if v is None:
            return None
        try:
            return int(v)
        except ValueError:
            raise _ArgError(f"The option value '{v}' is invalid")

    def floatarg(self, *names: str):
        v = self.witharg(*names)
        if v is None:
            return None
        try:
            return float(v)
        except ValueError:
            raise _ArgError(f"The option value '{v}' is invalid")


def main(argv=None, device="cuda") -> int:
    """osdmaptool with ``argv`` (default ``sys.argv[1:]``);
    ``--test-map-pgs`` maps on ``device``, the card by default."""
    argv = list(sys.argv[1:] if argv is None else argv)
    fn = None
    createsimple = None
    create_from_conf = False
    conf = None
    clobber = with_default_pool = False
    pg_bits_arg = pgp_bits_arg = None
    mark_up_in = False
    mark_out = None
    clear_temp = False
    do_print = test_map_pgs_f = test_random = False
    import_crush = export_crush = None
    test_map_object = None
    test_map_pg = None
    pool = None
    upmap_file = None
    upmap_max = 100
    upmap_deviation = 0.01
    upmap_save = False
    tree_fmt = None
    host_mapper = False
    pg_num_arg = None

    sc = _Args(argv)
    try:
        while not sc.done():
            a = sc.cur()
            if a in ("-h", "--help"):
                print(USAGE)
                return 1
            v = sc.intarg("--createsimple")
            if v is not None:
                createsimple = v
                continue
            v = sc.witharg("-c", "--conf")
            if v is not None:
                conf = v
                continue
            v = sc.intarg("--pg_bits")
            if v is not None:
                pg_bits_arg = v
                continue
            v = sc.intarg("--pgp_bits")
            if v is not None:
                pgp_bits_arg = v
                continue
            v = sc.intarg("--pg-num", "--pg_num")
            if v is not None:
                pg_num_arg = v
                continue
            v = sc.intarg("--mark-out")
            if v is not None:
                mark_out = v
                continue
            v = sc.intarg("--pool")
            if v is not None:
                pool = v
                continue
            v = sc.witharg("--import-crush")
            if v is not None:
                import_crush = v
                continue
            v = sc.witharg("--export-crush")
            if v is not None:
                export_crush = v
                continue
            v = sc.witharg("--test-map-object")
            if v is not None:
                test_map_object = v
                continue
            v = sc.witharg("--test-map-pg")
            if v is not None:
                test_map_pg = v
                continue
            v = sc.witharg("--upmap")
            if v is not None:
                upmap_file = v
                continue
            v = sc.intarg("--upmap-max")
            if v is not None:
                upmap_max = v
                continue
            v = sc.floatarg("--upmap-deviation")
            if v is not None:
                upmap_deviation = v
                continue
            v = sc.witharg("--tree")
            if v is not None:
                tree_fmt = v
                continue
            if a == "--create-from-conf":
                create_from_conf = True
            elif a == "--with-default-pool":
                with_default_pool = True
            elif a == "--clobber":
                clobber = True
            elif a == "--mark-up-in":
                mark_up_in = True
            elif a == "--clear-temp":
                clear_temp = True
            elif a == "--print":
                do_print = True
            elif a == "--test-map-pgs":
                test_map_pgs_f = True
            elif a == "--test-random":
                test_random = True
            elif a == "--host-mapper":
                host_mapper = True
            elif a == "--upmap-save":
                upmap_save = True
            elif a.startswith("-"):
                print(f"unrecognized arg {a}", file=sys.stderr)
                print(USAGE)
                return 1
            else:
                if fn is not None:
                    print("osdmaptool: too many arguments",
                          file=sys.stderr)
                    print(USAGE)
                    return 1
                fn = a
            sc.take()
    except _ArgError as e:
        print(e)
        if e.blank:
            print("")
        return 1

    if fn is None:
        print("osdmaptool: must specify osdmap filename",
              file=sys.stderr)
        print(USAGE)
        return 1
    pg_bits = 6 if pg_bits_arg is None else pg_bits_arg
    pgp_bits = pg_bits if pgp_bits_arg is None else pgp_bits_arg

    print(f"osdmaptool: osdmap file '{fn}'", file=sys.stderr)
    modified = False
    creating = createsimple is not None or create_from_conf
    if creating and not clobber and os.path.exists(fn):
        print(f"osdmaptool: {fn} exists, --clobber to overwrite",
              file=sys.stderr)
        return 255
    if createsimple is not None:
        if createsimple < 1:
            print("osdmaptool: osd count must be > 0",
                  file=sys.stderr)
            return 1
        from ..osdmap.simple_build import build_simple
        if pg_bits_arg is None and not with_default_pool \
                and pg_num_arg is not None:
            m = createsimple_legacy(createsimple, pg_num_arg)
        else:
            m = build_simple(createsimple,
                             with_default_pool=with_default_pool,
                             pg_bits=pg_bits, pgp_bits=pgp_bits)
        m.epoch = 0              # inc_epoch below writes epoch 1
        modified = True
    elif create_from_conf:
        from ..osdmap.simple_build import build_from_conf
        if not conf:
            print("--create-from-conf requires -c <conffile>",
                  file=sys.stderr)
            return 1
        with open(conf) as f:
            conf_text = f.read()
        m = build_from_conf(conf_text,
                            with_default_pool=with_default_pool,
                            pg_bits=pg_bits, pgp_bits=pgp_bits)
        m.epoch = 0
        modified = True
    else:
        try:
            with open(fn, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            print(f"osdmaptool: couldn't open {fn}: can't open {fn}: "
                  f"(2) No such file or directory", file=sys.stderr)
            return 255
        try:
            m = load_map(raw)
        except (pickle.UnpicklingError, EOFError, AttributeError,
                ImportError, ValueError, TypeError):
            print(f"osdmaptool: error decoding osdmap '{fn}'",
                  file=sys.stderr)
            return 255

    if mark_up_in:
        print("marking all OSDs up and in")
        from ..osdmap.simple_build import mark_up_in as _mui
        _mui(m)

    if mark_out is not None and 0 <= mark_out < m.max_osd:
        print(f"marking OSD@{mark_out} as out")
        from ..osdmap.simple_build import mark_out as _mo
        _mo(m, mark_out)

    if clear_temp:
        print("clearing pg/primary temp")
        m.pg_temp.clear()
        m.primary_temp.clear()

    if upmap_file:
        from ..osdmap.upmap import PendingInc
        from ..osdmap.upmap import calc_pg_upmaps as exact_upmaps
        print(f"writing upmap command output to: {upmap_file}")
        print("checking for upmap cleanups")
        print(f"upmap, max-count {upmap_max}, "
              f"max deviation {upmap_deviation:g}")
        inc = PendingInc()
        pools = {pool} if pool is not None else None
        changed = exact_upmaps(m, upmap_deviation, upmap_max, pools, inc)
        # '-' means stdout (the USAGE's documented default)
        f = sys.stdout if upmap_file == "-" else open(upmap_file, "w")
        try:
            for pg in sorted(inc.old_pg_upmap_items):
                f.write(f"ceph osd rm-pg-upmap-items {pg}\n")
            for pg in sorted(inc.new_pg_upmap_items):
                pairs = " ".join(
                    f"{a} {b}" for a, b in inc.new_pg_upmap_items[pg])
                f.write(f"ceph osd pg-upmap-items {pg} {pairs}\n")
        finally:
            if f is not sys.stdout:
                f.close()
        if upmap_save and changed:
            # osdmaptool.cc applies the pending incremental: the map
            # already holds the items, the incremental is one epoch
            m.epoch += 1
            modified = True

    if import_crush:
        from ..crush.binfmt import decode_crushmap
        try:
            with open(import_crush, "rb") as f:
                cbl = f.read()
            cw = decode_crushmap(cbl)
        except FileNotFoundError as e:
            print(f"osdmaptool: error reading crush map from "
                  f"{import_crush}: {e}", file=sys.stderr)
            return 1
        if cw.crush.max_devices > m.max_osd:
            print(f"osdmaptool: crushmap max_devices "
                  f"{cw.crush.max_devices} > osdmap max_osd "
                  f"{m.max_osd}", file=sys.stderr)
            return 1
        m.crush = cw
        m.epoch += 1             # the applied incremental's epoch
        m.crush_version = getattr(m, "crush_version", 1) + 1
        print(f"osdmaptool: imported {len(cbl)} byte crush map from "
              f"{import_crush}")
        modified = True

    if export_crush:
        from ..crush.binfmt import encode_crushmap
        with open(export_crush, "wb") as f:
            f.write(encode_crushmap(m.crush))
        print(f"osdmaptool: exported crush map to {export_crush}")

    if test_map_object:
        if pool is None:
            print("osdmaptool: assuming pool 1 (use --pool to "
                  "override)")
            pool = 1
        if pool not in m.pools:
            print(f"There is no pool {pool}", file=sys.stderr)
            return 1
        pg = m.map_to_pg(pool, test_map_object)
        p_ = m.pools[pool]
        from ..osdmap import ceph_stable_mod
        ps = ceph_stable_mod(pg.ps, p_.pg_num, p_.pg_num_mask)
        up, upp, acting, actp = m.pg_to_up_acting_osds(pg_t(pool, ps))
        print(f" object '{test_map_object}' -> {pool}.{ps:x} -> "
              f"{acting}")

    if test_map_pg:
        try:
            pstr, sstr = test_map_pg.split(".", 1)
            pgid = pg_t(int(pstr), int(sstr, 16))
        except ValueError:
            print(f"osdmaptool: failed to parse pg '{test_map_pg}",
                  file=sys.stderr)
            print(USAGE)
            return 1
        print(f" parsed '{test_map_pg}' -> {pgid}")

        def _vec(v):
            return "[" + ",".join(str(o) for o in v) + "]"
        if pgid.pool in m.pools:
            raw, rawp = m.pg_to_raw_osds(pgid)
            up, upp, acting, actp = m.pg_to_up_acting_osds(pgid)
        else:
            raw, rawp, up, upp, acting, actp = \
                [], -1, [], -1, [], -1
        print(f"{pgid} raw ({_vec(raw)}, p{rawp}) "
              f"up ({_vec(up)}, p{upp}) "
              f"acting ({_vec(acting)}, p{actp})")

    if test_map_pgs_f:
        if pool is not None and pool not in m.pools:
            print(f"There is no pool {pool}", file=sys.stderr)
            return 1
        test_map_pgs(m, not host_mapper, sys.stdout,
                     test_random=test_random,
                     only_pool=-1 if pool is None else pool,
                     device=device)

    nothing = not (do_print or tree_fmt or modified or export_crush
                   or import_crush or test_map_object or test_map_pg
                   or test_map_pgs_f or upmap_file)
    if nothing:
        print("osdmaptool: no action specified?", file=sys.stderr)
        print(USAGE)
        return 1

    if modified:
        m.epoch += 1             # osdmaptool.cc:638 inc_epoch

    if do_print:
        osdmap_print(m, sys.stdout)

    if tree_fmt:
        from ..crush.treedump import osd_tree_json, osd_tree_lines
        if tree_fmt in ("json", "json-pretty"):
            sys.stdout.write(osd_tree_json(m))
        else:
            for line in osd_tree_lines(m):
                print(line)

    if modified:
        print(f"osdmaptool: writing epoch {m.epoch} to {fn}")
        with open(fn, "wb") as f:
            pickle.dump(m, f)
    return 0


if __name__ == "__main__":
    # die silently on a closed pipe (`tool ... | head`), like the
    # C++ tools' default SIGPIPE disposition
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
