"""ceph — cluster status CLI against a checkpointed mini cluster.

The python `ceph` tool analog (src/ceph.in + mon command surface,
mon/MonCommands.h): status/health/df plus the osd and pg inspection
verbs, driven from a checkpoint directory like tools/rados.py.

  status | health | df
  osd tree           (CrushTreeDumper-style hierarchy with weights)
  osd df             (per-osd object/byte usage from the stores)
  osd pool ls [detail]  (pool names / pg_pool_t summary with flags,
                         quotas, snaps mode, tiering)
  pg stat            (per-state PG counts)
  pg dump            (one line per PG: state, up/acting sets)
  pg <pgid> query    (one pg's peering/log state as json)
  pg scrub|deep-scrub [pool.ps]  (offline consistency pass report)
  log last [n]       (recent cluster-log entries)
  config-key get|ls  (replicated config-key store)
  osd pool create|set|rm         (pool admin; persists to the
                                  checkpoint, rm needs the
                                  double-name + flag confirmation)
  tell <who> injectargs|...      (runtime config, admin socket)

Inspection verbs never write the checkpoint back; the pool-admin
verbs (and tell-driven writes inside bench-style flows) do.  Port of
``ceph_tpu/tools/ceph_cli.py``.
"""
from __future__ import annotations

import argparse
import json
import sys


def _osd_tree(c) -> None:
    cw = c.mon.osdmap.crush
    m = cw.crush

    def walk(item: int, depth: int) -> None:
        indent = "  " * depth
        if item >= 0:
            w = c.mon.osdmap.osd_weight[item] / 0x10000 \
                if item < len(c.mon.osdmap.osd_weight) else 0
            up = "up" if c.mon.osdmap.is_up(item) else "down"
            print(f"{indent}osd.{item}\tweight {w:.3f}\t{up}")
            return
        b = m.bucket(item)
        if b is None:
            return
        name = cw.get_item_name(item) or str(item)
        tname = cw.get_type_name(b.type) or str(b.type)
        print(f"{indent}{tname} {name}")
        for child in b.items:
            walk(child, depth + 1)

    roots = set(b.id for b in m.buckets if b is not None)
    children = set()
    for b in m.buckets:
        if b is None:
            continue
        children.update(i for i in b.items if i < 0)
    for r in sorted(roots - children, reverse=True):
        walk(r, 0)


def _osd_df(c) -> None:
    print("ID\tOBJECTS\tBYTES\tSTATUS")
    for i, osd in sorted(c.osds.items()):
        n_obj = 0
        n_bytes = 0
        for cid in osd.store.list_collections():
            if cid == "meta":
                continue      # map history, not client data
            for ho in osd.store.list_objects(cid):
                n_obj += 1
                n_bytes += osd.store.stat(cid, ho)
        status = "up" if c.mon.osdmap.is_up(i) else "down"
        if i < len(c.mon.osdmap.osd_weight) and \
                c.mon.osdmap.osd_weight[i] == 0:
            status += "+out"
        print(f"{i}\t{n_obj}\t{n_bytes}\t{status}")


def _pg_lines(c):
    return c.primary_pgs()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph")
    p.add_argument("--cluster", required=True,
                   help="checkpoint directory (MiniCluster.checkpoint)")
    p.add_argument("verb", choices=["status", "health", "df", "osd",
                                    "pg", "log", "config-key", "fs",
                                    "mds", "mon", "tell", "daemon"])
    p.add_argument("args", nargs="*")
    # parse_known_args: `tell X injectargs --debug_osd 9` carries
    # dashed tokens that are arguments to injectargs, not to ceph
    a, extra = p.parse_known_args(argv)
    a.args = list(a.args) + list(extra)

    from ..cluster import MiniCluster
    c = MiniCluster.restore(a.cluster)
    v, rest = a.verb, a.args
    if v == "status":
        print(json.dumps({
            "health": c.health(),
            "epoch": c.mon.osdmap.epoch,
            "num_osds": len(c.osds),
            "num_up": sum(1 for i in c.osds
                          if c.mon.osdmap.is_up(i)),
            "pools": len(c.mon.osdmap.pools),
            "pg_states": c.pg_states(),
        }, indent=2))
    elif v == "health":
        print(c.health())
    elif v in ("fs", "mds"):
        # ceph fs status / ceph mds stat (MDSMonitor fsmap surface)
        st = c.mon.fs_status()
        if v == "mds" or rest[:1] == ["stat"]:
            act = ",".join(st["active"]) or "-"
            sby = len(st["standby"])
            print(f"{act} up:active, {sby} up:standby")
        else:
            print(json.dumps(st, indent=2, sort_keys=True))
    elif v == "mon":
        # ceph mon dump: the epoched MonMap (MonMap::print)
        if rest[:1] in ([], ["dump"]):
            for line in c.mon.monmap.print_lines():
                print(line)
        else:
            print(f"unknown: mon {' '.join(rest)}", file=sys.stderr)
            return 1
    elif v == "df":
        for pid, name in sorted(c.mon.osdmap.pool_name.items()):
            pool = c.mon.osdmap.pools[pid]
            kind = "erasure" if pool.is_erasure() else "replicated"
            print(f"{name}\t{kind}\tpg_num={pool.pg_num}")
    elif v == "osd":
        sub = rest[0] if rest else "tree"
        if sub == "tree":
            _osd_tree(c)
        elif sub == "df":
            _osd_df(c)
        elif sub in ("out", "in", "reweight"):
            # ceph osd out/in/reweight <id> [w] (MonCommands.h): mark
            # an osd out/in or set its override weight; commits an
            # epoch and persists like the pool-admin verbs
            ident = rest[1] if len(rest) > 1 else ""
            if ident.startswith("osd."):
                ident = ident[len("osd."):]
            if not ident.isdigit():
                print(f"usage: ceph osd {sub} <id>"
                      + (" <weight 0..1>" if sub == "reweight"
                         else ""), file=sys.stderr)
                return 1
            oid_ = int(ident)
            if not c.mon.osdmap.exists(oid_):
                print(f"osd.{oid_} does not exist", file=sys.stderr)
                return 1
            already = (sub == "out" and not c.mon.osdmap.is_in(oid_)) \
                or (sub == "in" and c.mon.osdmap.is_in(oid_))
            if already:
                # no epoch churn for a no-op, like the reference mon
                print(f"osd.{oid_} is already {sub}")
                return 0
            if sub == "out":
                c.mark_osd_out(oid_)     # the cluster helper bundles
                                         # publish + pump + recovery
            elif sub == "in":
                c.mon.mark_osd_in(oid_)
            else:
                try:
                    w = float(rest[2])
                except (IndexError, ValueError):
                    print("usage: ceph osd reweight <id> "
                          "<weight 0..1>", file=sys.stderr)
                    return 1
                if not 0.0 <= w <= 1.0:
                    print("weight must be in [0, 1]",
                          file=sys.stderr)
                    return 1
                from ..osdmap import Incremental
                inc = Incremental()
                inc.new_weight[oid_] = int(w * 0x10000)
                c.mon.publish(inc)
            if sub != "out":             # out's helper already settled
                c.network.pump()
                c.run_recovery()
            c.checkpoint(a.cluster)
            print(f"osd.{oid_} {sub} done "
                  f"(epoch {c.mon.osdmap.epoch})")
        elif sub == "pool" and rest[1:2] == ["create"]:
            # ceph osd pool create <name> <pg_num>
            #   [replicated | erasure [profile]]   (MonCommands.h)
            if len(rest) < 4 or not rest[3].isdigit() \
                    or int(rest[3]) < 1:
                print("usage: ceph osd pool create <name> <pg_num> "
                      "[replicated|erasure [profile]]  (pg_num >= 1)",
                      file=sys.stderr)
                return 1
            name, pg_num = rest[2], int(rest[3])
            if name in c.mon.osdmap.pool_name.values():
                # the reference treats re-creation as success
                print(f"pool '{name}' already exists")
                return 0
            kind = rest[4] if len(rest) > 4 else "replicated"
            try:
                if kind == "replicated":
                    c.create_replicated_pool(name, pg_num=pg_num)
                elif kind == "erasure":
                    profile = rest[5] if len(rest) > 5 else None
                    if profile:
                        if profile not in \
                                c.mon.osdmap.erasure_code_profiles:
                            print(f"unknown ec profile '{profile}'",
                                  file=sys.stderr)
                            return 1
                        # the mon's own path honors EVERY profile key
                        # (failure domain, stripe_unit, technique...)
                        c.mon.create_ec_pool(name, profile,
                                             pg_num=pg_num)
                        c.mon.publish()
                        c.network.pump()
                        c.run_recovery()
                    else:
                        c.create_ec_pool(name, pg_num=pg_num)
                else:
                    print(f"unknown pool type '{kind}'",
                          file=sys.stderr)
                    return 1
            except (ValueError, KeyError, RuntimeError) as e:
                print(f"pool create failed: {e}", file=sys.stderr)
                return 1
            c.checkpoint(a.cluster)
            print(f"pool '{name}' created")
        elif sub == "pool" and rest[1:2] == ["rm"]:
            # the reference's double-name + flag confirmation
            if len(rest) < 4 or rest[2] != rest[3] or \
                    "--yes-i-really-really-mean-it" not in rest:
                print("Error EPERM: WARNING: this will *PERMANENTLY "
                      "DESTROY* all data stored in pool. If you are "
                      "ABSOLUTELY CERTAIN that is what you want, pass "
                      "the pool name *twice*, followed by "
                      "--yes-i-really-really-mean-it.",
                      file=sys.stderr)
                return 1
            try:
                c.delete_pool(rest[2])
            except (KeyError, ValueError) as e:
                print(f"pool rm failed: {e}", file=sys.stderr)
                return 1
            c.checkpoint(a.cluster)
            print(f"pool '{rest[2]}' removed")
        elif sub == "pool" and rest[1:2] == ["set"]:
            # ceph osd pool set <name> <var> <val>
            if len(rest) < 5:
                print("usage: ceph osd pool set <name> <var> <val>",
                      file=sys.stderr)
                return 1
            name, var, val = rest[2], rest[3], rest[4]
            try:
                if var in ("pg_num", "pgp_num", "quota_max_objects",
                           "quota_max_bytes"):
                    if var == "pg_num":
                        c.mon.set_pool_pg_num(name, int(val))
                    elif var == "pgp_num":
                        c.mon.set_pool_pgp_num(name, int(val))
                    elif var == "quota_max_objects":
                        c.mon.set_pool_quota(name,
                                             max_objects=int(val))
                    else:
                        c.mon.set_pool_quota(name, max_bytes=int(val))
                    # the setters stage into the working map; COMMIT
                    # an epoch so OSDs (and restores, which rebuild
                    # from incrementals) actually see it
                    c.mon.publish()
                elif var in ("size", "min_size"):
                    pid = c.mon.osdmap.lookup_pg_pool_name(name)
                    if pid < 0:
                        raise KeyError(name)
                    from ..osdmap import Incremental
                    inc = Incremental()
                    import copy
                    pool = copy.deepcopy(c.mon.osdmap.pools[pid])
                    v = int(val)
                    new_size = v if var == "size" else pool.size
                    new_min = v if var == "min_size" else pool.min_size
                    if new_size < 1 or new_min < 1 or \
                            new_min > new_size:
                        raise ValueError(
                            f"size {new_size} / min_size {new_min} "
                            "out of range")
                    setattr(pool, var, v)
                    inc.new_pools[pid] = pool
                    inc.new_pool_names[pid] = name
                    c.mon.publish(inc)
                else:
                    print(f"unknown variable '{var}'",
                          file=sys.stderr)
                    return 1
            except (KeyError, ValueError) as e:
                print(f"pool set failed: {e!r}", file=sys.stderr)
                return 1
            c.network.pump()
            c.run_recovery()
            c.checkpoint(a.cluster)
            print(f"set pool '{name}' {var} to {val}")
        elif sub == "pool" and rest[1:2] == ["ls"]:
            # ceph osd pool ls [detail] (MonCommands.h)
            if rest[2:] not in ([], ["detail"]):
                print(f"unknown: osd pool ls {' '.join(rest[2:])}",
                      file=sys.stderr)
                return 1
            detail = rest[2:3] == ["detail"]
            from ..osdmap.types import (
                FLAG_EC_OVERWRITES, FLAG_FULL, FLAG_FULL_QUOTA,
                FLAG_NEARFULL,
            )
            for pid, name in sorted(c.mon.osdmap.pool_name.items()):
                if not detail:
                    print(name)
                    continue
                pool = c.mon.osdmap.pools[pid]
                kind = "erasure" if pool.is_erasure() else "replicated"
                flags = [fname for bit, fname in [
                    (FLAG_FULL, "full"),
                    (FLAG_FULL_QUOTA, "full_quota"),
                    (FLAG_NEARFULL, "nearfull"),
                    (FLAG_EC_OVERWRITES, "ec_overwrites"),
                ] if pool.has_flag(bit)]
                parts = [f"pool {pid} '{name}' {kind}",
                         f"size {pool.size}",
                         f"min_size {pool.min_size}",
                         f"crush_rule {pool.crush_rule}",
                         f"pg_num {pool.pg_num}",
                         f"pgp_num {pool.pgp_num}"]
                if pool.erasure_code_profile:
                    parts.append(
                        f"profile {pool.erasure_code_profile}")
                if flags:
                    parts.append("flags " + "+".join(flags))
                if pool.quota_max_objects:
                    parts.append(
                        f"max_objects {pool.quota_max_objects}")
                if pool.quota_max_bytes:
                    parts.append(f"max_bytes {pool.quota_max_bytes}")
                if pool.selfmanaged:
                    parts.append("selfmanaged_snaps")
                elif pool.snaps:
                    parts.append(f"snaps {len(pool.snaps)}")
                if pool.read_tier >= 0:
                    parts.append(f"read_tier {pool.read_tier}")
                if pool.tier_of >= 0:
                    parts.append(f"tier_of {pool.tier_of}")
                print(" ".join(parts))
        else:
            print(f"unknown: osd {sub}", file=sys.stderr)
            return 1
    elif v == "pg":
        sub = rest[0] if rest else "stat"
        if sub == "stat":
            counts = {}
            for _pgid, pg in _pg_lines(c):
                counts[pg.state] = counts.get(pg.state, 0) + 1
            print(json.dumps(counts))
        elif sub == "dump":
            for pgid, pg in sorted(_pg_lines(c)):
                print(f"{pgid[0]}.{pgid[1]:x}\t{pg.state}"
                      f"\tup={pg.up}\tacting={pg.acting}"
                      f"\tlast_scrub={pg.last_scrub_stamp:.0f}"
                      f"\tlast_deep_scrub={pg.last_deep_scrub_stamp:.0f}")
        elif sub == "query" or (len(rest) > 1 and rest[1] == "query"):
            # ceph pg <pgid> query (PG::Query role): one pg's peering
            # and log state as json.  pgids are the canonical pg_t
            # rendering (HEX ps) only — accepting decimal too would
            # make ids like 0.10 ambiguous
            if len(rest) < 2:
                print("usage: ceph pg <pgid> query", file=sys.stderr)
                return 1
            want = rest[1] if sub == "query" else rest[0]
            from ..os_store import parse_pg_from_cid
            for pgid, pg in _pg_lines(c):
                if f"{pgid[0]}.{pgid[1]:x}" == want:
                    n_obj = 0
                    for cid in pg.osd.store.list_collections():
                        if parse_pg_from_cid(cid) == pgid \
                                and not cid.endswith("_meta"):
                            n_obj += len(
                                pg.osd.store.list_objects(cid))
                    print(json.dumps({
                        "pgid": f"{pgid[0]}.{pgid[1]:x}",
                        "state": pg.state,
                        "up": list(pg.up),
                        "acting": list(pg.acting),
                        "acting_primary": pg.acting_primary,
                        "last_update": pg.pg_log.head,
                        "log_tail": pg.pg_log.tail,
                        "log_entries": len(pg.pg_log.entries),
                        "objects_on_primary": n_obj,
                        "last_scrub_stamp": pg.last_scrub_stamp,
                        "last_deep_scrub_stamp":
                            pg.last_deep_scrub_stamp,
                    }, indent=2, sort_keys=True))
                    break
            else:
                print(f"pg {want} does not exist", file=sys.stderr)
                return 1
        elif sub in ("scrub", "deep-scrub"):
            # ceph pg scrub/deep-scrub <pool.ps> (MonCommands.h role);
            # the restored cluster is ephemeral, so this reports what
            # the pass found rather than mutating daemon state
            want = rest[1] if len(rest) > 1 else None
            ran, matched = 0, 0
            for pgid, pg in _pg_lines(c):
                # canonical pg_t rendering only (hex ps)
                if want and want != f"{pgid[0]}.{pgid[1]:x}":
                    continue
                matched += 1
                if pg.start_scrub(deep=(sub == "deep-scrub")):
                    ran += 1
            if want and not matched:
                print(f"pg {want} does not exist", file=sys.stderr)
                return 1
            c.network.pump()
            print(json.dumps({"scrubbed": ran,
                              "declined": matched - ran, "deep":
                              sub == "deep-scrub",
                              "pg_states": c.pg_states()}))
        else:
            print(f"unknown: pg {sub}", file=sys.stderr)
            return 1
    elif v == "log":
        # ceph log last [n] (LogMonitor history)
        sub = rest[0] if rest else "last"
        if sub != "last":
            print(f"unknown: log {sub}", file=sys.stderr)
            return 1
        try:
            n = int(rest[1]) if len(rest) > 1 else 20
        except ValueError:
            print(f"log last: not a count: {rest[1]!r}", file=sys.stderr)
            return 1
        for stamp, who, level, text in c.mon.log_last(n):
            print(f"{stamp:.1f} {who} {level}: {text}")
    elif v in ("tell", "daemon"):
        # `ceph tell <who> injectargs --opt val ...` and
        # `ceph daemon <who> <asok command> [k=v ...]` — runtime
        # reconfiguration/introspection over the admin socket.  Like
        # the reference, injectargs is NOT durable: it mutates the
        # running process only (checkpoints don't carry it).
        if len(rest) < 2:
            print(f"usage: ceph {v} <who> <command> [args...]",
                  file=sys.stderr)
            return 1
        who, cmd, cargs = rest[0], rest[1], rest[2:]
        if cmd == "injectargs":
            if len(cargs) == 1 and " " in cargs[0]:
                # the reference's quoted form:
                # ceph tell osd.0 injectargs '--debug-osd 20'
                cargs = cargs[0].split()
            changed = {}
            i = 0
            while i < len(cargs):
                tok = cargs[i]
                if not tok.startswith("--"):
                    print(f"injectargs: expected --option, got "
                          f"'{tok}'", file=sys.stderr)
                    return 1
                name, eq, val = tok[2:].partition("=")
                name = name.replace("-", "_")
                if not eq:
                    if i + 1 >= len(cargs):
                        print(f"injectargs: missing value for "
                              f"--{name}", file=sys.stderr)
                        return 1
                    i += 1
                    val = cargs[i]
                # ONE set path: the asok 'config set' hook owns
                # validation + observer notification
                try:
                    out = c.admin_socket.execute(
                        "config set", {"name": name, "value": val})
                except ValueError as e:
                    print(f"injectargs: {e}", file=sys.stderr)
                    return 1
                changed[name] = out[name]
                i += 1
            print(json.dumps(changed, sort_keys=True))
        else:
            # multi-word asok commands may arrive as separate shell
            # words (`daemon mon.a config show`): everything up to the
            # first k=v token is the command
            words = [cmd]
            kv = {}
            for t in cargs:
                if "=" in t:
                    k, _, vv = t.partition("=")
                    kv[k] = vv
                else:
                    words.append(t)
            try:
                out = c.admin_socket.execute(" ".join(words), kv)
            except (KeyError, ValueError) as e:
                print(f"admin socket: {e}", file=sys.stderr)
                return 1
            print(json.dumps(out, indent=2, sort_keys=True,
                             default=repr))
    elif v == "config-key":
        sub = rest[0] if rest else "dump"
        if sub == "dump":
            print(json.dumps(c.mon.config_key_dump(), indent=2,
                             sort_keys=True))
        elif sub == "get" and len(rest) > 1:
            val = c.mon.config_key_get(rest[1])
            if val is None:
                print(f"no such key {rest[1]!r}", file=sys.stderr)
                return 1
            print(val)
        elif sub == "exists" and len(rest) > 1:
            ok = c.mon.config_key_get(rest[1]) is not None
            print(json.dumps({"exists": ok}))
            return 0 if ok else 1
        else:
            print(f"unknown: config-key {sub}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
