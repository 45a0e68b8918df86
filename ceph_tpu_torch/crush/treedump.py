"""Tree dumpers: the `crushtool --tree` / `osd tree` renderings
(crush/CrushTreeDumper.h traversal + common/TextTable.cc layout +
CrushWrapper.cc CrushTreePlainDumper / OSDMap.cc OSDTreePlainDumper),
pinned byte-exact by the crushtool/osdmaptool cram goldens.

The port's own copy of ``ceph_tpu/crush/treedump.py``; ``osd_tree_lines``
and ``osd_tree_json`` take the port's ``OSDMap``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

LEFT, RIGHT = 0, 1


class TextTable:
    """common/TextTable: every cell rendered pad(cell, width, align)
    + one space — including the last column (trailing spaces are part
    of the recorded output)."""

    def __init__(self):
        self.cols: List[Tuple[str, int, int]] = []  # heading, ha, ca
        self.rows: List[List[str]] = []

    def define_column(self, heading: str, hd_align: int,
                      col_align: int) -> None:
        self.cols.append((heading, hd_align, col_align))

    def add_row(self, cells: List[str]) -> None:
        self.rows.append([str(c) for c in cells])

    @staticmethod
    def _pad(s: str, width: int, align: int) -> str:
        if align == RIGHT:
            return s.rjust(width)
        return s.ljust(width)

    def render(self) -> List[str]:
        widths = [max(len(h), *(len(r[i]) for r in self.rows))
                  if self.rows else len(h)
                  for i, (h, _, _) in enumerate(self.cols)]
        out = ["".join(self._pad(h, widths[i], ha) + " "
                       for i, (h, ha, _) in enumerate(self.cols))]
        for r in self.rows:
            out.append("".join(
                self._pad(r[i], widths[i], ca) + " "
                for i, (_h, _ha, ca) in enumerate(self.cols)))
        return out


def weightf(v: float) -> str:
    """include/types.h weightf_t printing."""
    if v < -0.01:
        return "-"
    if v < 0.000001:
        return "0"
    return f"{v:.5f}"


class Item:
    def __init__(self, id: int, parent: int, depth: int,
                 weight: float):
        self.id = id
        self.parent = parent
        self.depth = depth
        self.weight = weight
        self.children: List[int] = []

    def is_bucket(self) -> bool:
        return self.id < 0


def _item_class_name(cw, item: int) -> str:
    cid = cw.item_class.get(item)
    if cid is None:
        return ""
    return cw.class_map.get(cid, "")


def _sort_key(cw, item: int) -> str:
    """CrushTreeDumper's (class, name) child ordering key."""
    if item >= 0:
        return f"{_item_class_name(cw, item)}_osd.{item:08d}"
    return "_" + cw.name_map.get(item, "")


def iter_tree(cw, show_shadow: bool = False):
    """Yield Items in CrushTreeDumper order: roots ascending, then
    depth-first with children sorted by (class, name)."""
    roots = sorted(b.id for b in cw.crush.buckets
                   if b is not None and cw._parent_of(b.id) is None
                   and (show_shadow
                        or "~" not in cw.name_map.get(b.id, "")))

    def walk(item: Item):
        kids: List[int] = []
        if item.is_bucket():
            b = cw.crush.bucket(item.id)
            kids = sorted(range(b.size),
                          key=lambda k: _sort_key(cw, b.items[k]))
            # the reference queues children in reverse-sorted order,
            # which is what its "children" arrays record
            item.children = [b.items[k] for k in reversed(kids)]
        yield item
        if not item.is_bucket():
            return
        b = cw.crush.bucket(item.id)
        for k in kids:
            yield from walk(Item(b.items[k], item.id, item.depth + 1,
                                 b.item_weights[k] / 0x10000))

    for r in roots:
        yield from walk(Item(r, 0, 0,
                             cw.crush.bucket(r).weight / 0x10000))


def _type_name_cell(cw, qi: Item) -> str:
    pad = "    " * qi.depth
    if qi.is_bucket():
        b = cw.crush.bucket(qi.id)
        return (f"{pad}{cw.get_type_name(b.type)} "
                f"{cw.name_map.get(qi.id, '')}")
    return f"{pad}osd.{qi.id}"


def _class_cell(cw, item: int) -> str:
    return _item_class_name(cw, item) if item >= 0 else ""


def crush_tree_lines(cw, show_shadow: bool = False) -> List[str]:
    """crushtool --tree (CrushTreePlainDumper): ID CLASS WEIGHT
    [per-choose-args weight-set column] TYPE NAME."""
    tbl = TextTable()
    tbl.define_column("ID", LEFT, RIGHT)
    tbl.define_column("CLASS", LEFT, RIGHT)
    tbl.define_column("WEIGHT", LEFT, RIGHT)
    ca_ids = sorted(getattr(cw.crush, "choose_args", {}))
    for cid in ca_ids:
        tbl.define_column("(compat)" if cid == -1 else str(cid),
                          LEFT, RIGHT)
    tbl.define_column("TYPE NAME", LEFT, LEFT)
    for qi in iter_tree(cw, show_shadow):
        row = [str(qi.id), _class_cell(cw, qi.id),
               weightf(qi.weight)]
        for cid in ca_ids:
            cell = ""
            if qi.parent < 0:
                arg = cw.crush.choose_args[cid][-1 - qi.parent] \
                    if -1 - qi.parent < len(
                        cw.crush.choose_args[cid]) else None
                ws = getattr(arg, "weight_set", None) if arg else None
                if ws:
                    b = cw.crush.bucket(qi.parent)
                    pos = b.items.index(qi.id) \
                        if qi.id in b.items else 0
                    cell = weightf(ws[0].weights[pos] / 0x10000)
            row.append(cell)
        row.append(_type_name_cell(cw, qi))
        tbl.add_row(row)
    return tbl.render()


def osd_tree_lines(osdmap) -> List[str]:
    """osdmaptool --tree=plain (OSDTreePlainDumper): adds
    STATUS/REWEIGHT/PRI-AFF; DNE osds show DNE / 0 / blank."""
    cw = osdmap.crush
    tbl = TextTable()
    tbl.define_column("ID", LEFT, RIGHT)
    tbl.define_column("CLASS", LEFT, RIGHT)
    tbl.define_column("WEIGHT", LEFT, RIGHT)
    tbl.define_column("TYPE NAME", LEFT, LEFT)
    tbl.define_column("STATUS", LEFT, RIGHT)
    tbl.define_column("REWEIGHT", LEFT, RIGHT)
    tbl.define_column("PRI-AFF", LEFT, RIGHT)
    for qi in iter_tree(cw):
        row = [str(qi.id), _class_cell(cw, qi.id),
               weightf(qi.weight), _type_name_cell(cw, qi)]
        if qi.is_bucket():
            row += ["", "", ""]
        elif not osdmap.exists(qi.id):
            row += ["DNE", "0", ""]
        else:
            status = "up" if osdmap.is_up(qi.id) else "down"
            row += [status,
                    weightf(osdmap.osd_weight[qi.id] / 0x10000),
                    weightf(_pri_aff(osdmap, qi.id))]
        tbl.add_row(row)
    return tbl.render()


def _pri_aff(osdmap, osd: int) -> float:
    pa = getattr(osdmap, "osd_primary_affinity", None)
    return (pa[osd] / 0x10000) if pa is not None else 1.0


def osd_tree_json(osdmap) -> str:
    """osdmaptool --tree=json-pretty: the FormattingDumper fields
    (dump_item_fields + OSD status extras), children DESCENDING, a
    pool_weights section on every non-root node, stray array."""
    from .dumpfmt import _F, _emit
    cw = osdmap.crush
    nodes = []
    for qi in iter_tree(cw):
        d: Dict = {"id": qi.id}
        c = _class_cell(cw, qi.id)
        if c:
            d["device_class"] = c
        if qi.is_bucket():
            b = cw.crush.bucket(qi.id)
            d["name"] = cw.name_map.get(qi.id, "")
            d["type"] = cw.get_type_name(b.type)
            d["type_id"] = b.type
        else:
            d["name"] = f"osd.{qi.id}"
            d["type"] = cw.get_type_name(0)
            d["type_id"] = 0
            d["crush_weight"] = _F(qi.weight)
            d["depth"] = qi.depth
        if qi.parent < 0:
            d["pool_weights"] = {}
        if qi.is_bucket():
            d["children"] = qi.children
        else:
            d["exists"] = 1 if osdmap.exists(qi.id) else 0
            d["status"] = "up" if osdmap.is_up(qi.id) else "down"
            d["reweight"] = _F(osdmap.osd_weight[qi.id] / 0x10000
                               if osdmap.exists(qi.id) else 0.0)
            d["primary_affinity"] = _F(_pri_aff(osdmap, qi.id))
        nodes.append(d)
    return _emit({"nodes": nodes, "stray": []}, 0) + "\n\n"
