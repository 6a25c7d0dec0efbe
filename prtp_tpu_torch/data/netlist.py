"""Netlist -> pin-level DAG builder.

A copy of ``prtp_tpu/data/netlist.py``, kept in the port
so that the port imports nothing of the JAX package.

Capability parity with the reference ``Parser``
(``src/verilog_parser_asap7.py:211-1517``), re-implemented on the
hand-rolled Verilog AST (:mod:`prtp_tpu_torch.data.verilog`) with
plain dict/array adjacency instead of networkx, emitting numpy arrays.

Pipeline (``Parser.parse``, ``:1372-1431``):
  1. post-route report  -> labels (VIOLATED => critical), arrival/required
  2. pin locations      -> 128x128 bin per pin (``pin2bin``, ``:162-176``)
  3. post-place report  -> path pin sequences + pre-route trans/delay
  4. netlist            -> hierarchy walk -> pin nodes + cell/net edges,
     assign-alias resolution, PI synthesis, net bboxes, topo levels with
     reverse de-dup, endpoint backtraces, path-mask rasterization.

Key reference semantics preserved:
  - hierarchical net-name tracing via io2arg maps with trace depth
    (``update_netname``, ``:121-160``; ``parse_io2arg``, ``:559-617``)
  - registers contribute only clk->output cell edges (``:948-950``);
    SRAM macros contribute CLK/CE->output edges gated on the lib's
    timing_tabs (``:819-827``); SRAM default sink cap 13.06 (``:806``)
  - PI pseudo-nodes for driverless nets (``:1160-1171``)
  - abstract cell type via the ``(x|xp|x\\d+p)\\d+`` drive-strength strip
    and CK prefix removal (``:864-867``)
  - per-net bounding boxes and the per-arc bbox mask rasterization to a
    sparse (num_paths, 128*128) COO (``:1301-1369``)
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .timing_report import (
    ReportDB,
    parse_postopt_report,
    parse_preopt_report,
)
from .verilog import Module, arg_to_str, expand_arg, parse_verilog

MAP_SIZE_X, MAP_SIZE_Y = 128, 128


def pin2bin(pin_x, pin_y, bin_size_x, bin_size_y,
            map_x=MAP_SIZE_X, map_y=MAP_SIZE_Y):
    """Micron coords -> clamped integer bin (reference :162-176)."""
    bin_x = min(max(int(pin_x / bin_size_x), 0), map_x - 1)
    bin_y = min(max(int(pin_y / bin_size_y), 0), map_y - 1)
    return bin_x, bin_y


def parse_pin_locations(path: str, map_size: int = MAP_SIZE_X,
                        canvas: float = 512.0,
                        ) -> Dict[str, Tuple[float, float, int, int]]:
    """``positions/pin_bin.txt`` -> {pin: (x, y, bin_x, bin_y)}.

    The chip canvas is 512x512 microns binned to map_size x map_size
    (bin size 4 at the reference default of 128, reference :252).
    """
    with open(path) as f:
        text = f.read()
    if text.startswith("===") or "\n===" in text:
        text = "\n".join(l for l in text.split("\n")
                         if not l.startswith("==="))
    # one whole-file split: every record is "name x y" and names never
    # contain whitespace, so tokens come in groups of three
    toks = text.split()
    if len(toks) % 3:
        raise ValueError(f"malformed pin location file: {path}")
    names = toks[0::3]
    if "\\" in text:
        # reference strips escapes: "\\[" -> "[", "\\]" -> "]", then all
        # remaining "\\" — the composite effect is dropping every "\\"
        names = [n.replace("\\", "") if "\\" in n else n for n in names]
    xs = np.asarray(toks[1::3], dtype=np.float64)
    ys = np.asarray(toks[2::3], dtype=np.float64)
    bs = float(int(canvas / map_size))
    # int() truncates toward zero, as does astype; then clamp (ref :162-176)
    bx = np.clip((xs / bs).astype(np.int64), 0, map_size - 1)
    by = np.clip((ys / bs).astype(np.int64), 0, map_size - 1)
    return dict(zip(names, zip(xs.tolist(), ys.tolist(),
                               bx.tolist(), by.tolist())))


@dataclass
class NetInfo:
    net_name: str
    drive_cell: str = ""
    drive_pin: str = ""
    sink_pins: List[str] = field(default_factory=list)
    total_output_cap: float = 0.0


_DRIVE_RE = re.compile(r"(x|xp|x\d+p)\d+")

_REGISTER_TYPES = {"ASYNC_DFFH", "DFFHQN", "DFFHQ", "DFFLQN",
                   "DFFLQ", "DHL", "DLL", "ICG", "SDFH", "SDFL"}


def abstract_cell_type(cell_name: str) -> str:
    """Strip drive strength + CK prefix (reference :864-867)."""
    m = _DRIVE_RE.search(cell_name)
    ctype = cell_name[: m.start()] if m else cell_name
    if ctype.startswith("CK"):
        ctype = ctype[2:]
    return ctype


def update_netname(net_name: str, call_path: str, io2arg) -> str:
    """Trace a module-local net to its global hierarchical name
    (reference :121-160)."""
    arg_name = net_name
    if io2arg is not None and io2arg.get(net_name) is not None:
        _, arg_name, trace_depth = io2arg[net_name]
        for _ in range(trace_depth):
            if "/" in call_path:
                call_path = call_path[: call_path.rfind("/")]
            else:
                call_path = ""
    return arg_name if call_path == "" else f"{call_path}/{arg_name}"


class NetlistBuilder:
    """Builds the pin DAG for one design.

    Args:
      top_module: name of the top module.
      masking: 'critical' (backtraced-path bbox masks) — 'sibling' is
        not implemented, matching the reference's stub (:1338-1340).
      cell_info_map: cell library (cell_info_map2.json of the reference)
        — {cell: {type, load, area, width, height, pin_info}}.
      cell_lib: early_lib.json — per-cell pin directions + timing_tabs.
    """

    def __init__(self, top_module: str, masking: str,
                 cell_info_map: dict, cell_lib: dict, map_size: int = 128):
        if masking not in ("critical", "sibling"):
            raise ValueError(
                f"Wrong masking technique: {masking}, "
                "It should be in [critical, sibling]!")
        if masking == "sibling":
            raise NotImplementedError(
                "masking='sibling' is stubbed in the reference "
                "(src/verilog_parser_asap7.py:1338-1340) and not provided")
        self.top_module = top_module
        self.masking = masking
        self.map_size = map_size
        self.cell_info_map = cell_info_map
        self.cell_lib = cell_lib

        self.nets: Dict[str, NetInfo] = {}
        self.cell_type_count: Dict[str, int] = {}
        self.module_wires_map: Dict[str, dict] = {}
        self.module_io2arg_map: Dict[str, Optional[dict]] = {}
        self.equal_wire_map: Dict[str, str] = {}
        self.net_bbox_map: Dict[str, List[int]] = {}
        self.db = ReportDB()
        self.pin_loc_map: Dict[str, tuple] = {}

        # graph state: insertion-ordered node attr map + edge lists
        self.node_attrs: Dict[str, dict] = {}
        self.edges: List[Tuple[str, str, str]] = []  # (src, dst, etype)

        # per-cell-type caches: leaf cells repeat a handful of library
        # types across 100k+ instances, so port classification, sink
        # caps, abstract type and register-ness are memoized by name
        self._cell_cache: Dict[str, tuple] = {}
        self._port_cache: Dict[str, Dict[str, tuple]] = {}

    def _cell_meta(self, cell_name: str):
        meta = self._cell_cache.get(cell_name)
        if meta is None:
            meta = (abstract_cell_type(cell_name),
                    self.is_register(cell_name), "DFF" in cell_name)
            self._cell_cache[cell_name] = meta
        return meta

    def _port_meta(self, cell_name: str, portname: str):
        ports = self._port_cache.get(cell_name)
        if ports is None:
            ports = {}
            self._port_cache[cell_name] = ports
        meta = ports.get(portname)
        if meta is None:
            if self.is_output_port(cell_name, portname):
                meta = ("fanout", 0.0, False)
            else:
                is_clk = "clk" in portname.lower()
                cap = float(self.cell_info_map[cell_name]["pin_info"]
                            [portname]["capacitance"])
                meta = ("CLK" if is_clk else "fanin", cap, is_clk)
            ports[portname] = meta
        return meta

    # ------------------------------------------------------------ lib

    def is_output_port(self, cell: str, port: str) -> bool:
        return self.cell_lib[cell]["pin_info"][port]["direction"] == "output"

    def is_register(self, cell_name: str) -> bool:
        return self.cell_info_map[cell_name]["type"] in _REGISTER_TYPES

    # --------------------------------------------------- module walk

    def _module_wires(self, module: Module):
        """wires {name: (type, high, low)} + assign alias map
        (reference parse_wires, :472-557)."""
        wires = {}
        equal = {}
        for d in module.decls:
            kind = {"input": "i", "output": "o", "wire": "w"}[d.kind]
            if d.name not in wires:
                wires[d.name] = (kind, max(d.msb, d.lsb), min(d.msb, d.lsb))
        for a in module.assigns:
            lhs = arg_to_str(a.lhs)
            rhs = arg_to_str(a.rhs)
            equal[lhs] = rhs
        return wires, equal

    def _io2arg(self, conns, wires, father_wires, father_io2arg):
        """Map module io bits -> father-module args with trace depth
        (reference parse_io2arg, :559-617)."""
        io2arg = {}
        for portname, arg in conns:
            arg_bits = expand_arg(arg, father_wires)
            wire_type, high, low = wires[portname]
            width = high - low + 1
            if width == 1:
                names = [portname]
            else:
                names = [f"{portname}[{i}]" for i in range(high, low - 1, -1)]
            for name, arg_name in zip(names, arg_bits):
                entry = (wire_type, arg_name, 1)
                if father_io2arg is not None and \
                        father_io2arg.get(arg_name) is not None:
                    entry = (wire_type, father_io2arg[arg_name][1],
                             father_io2arg[arg_name][2] + 1)
                io2arg[name] = entry
        return io2arg

    def _walk_module(self, modules, module_name, instance_name, conns,
                     call_path):
        module = modules.get(module_name)
        if module is None:
            raise KeyError(f"Target module {module_name} is not found!")
        wires, equal = self._module_wires(module)

        if module_name == self.top_module:
            io2arg = None
            child_call_path = ""
        else:
            father_wires = self.module_wires_map[call_path]
            father_io2arg = self.module_io2arg_map[call_path]
            io2arg = self._io2arg(conns, wires, father_wires, father_io2arg)
            child_call_path = (instance_name if call_path == ""
                               else f"{call_path}/{instance_name}")

        for w1, w2 in equal.items():
            g1 = update_netname(w1, call_path, io2arg)
            g2 = update_netname(w2, call_path, io2arg)
            self.equal_wire_map[g1] = g2
        self.module_wires_map[child_call_path] = wires
        self.module_io2arg_map[child_call_path] = io2arg

        for inst in module.instances:
            if inst.module in modules:
                self._walk_module(modules, inst.module, inst.name,
                                  inst.conns, child_call_path)
            elif inst.module.startswith("SRAM"):
                self._add_ram(inst, wires, io2arg, child_call_path)
            else:
                self._add_cell(inst, io2arg, child_call_path)

    def _pin_position(self, pinname: str):
        pos = self.pin_loc_map.get(pinname)
        if pos is None:
            raise KeyError(f"pin with no location: {pinname}")
        return pos

    def _add_cell(self, inst, io2arg, call_path):
        """Leaf standard cell -> one node per pin + fanin->fanout cell
        edges (registers: clk->output only). Reference parse_cell,
        :831-958."""
        cell_name = inst.module
        ctype, is_reg, is_dff = self._cell_meta(cell_name)
        self.cell_type_count[ctype] = self.cell_type_count.get(ctype, 0) + 1
        instance_name = (inst.name if call_path == ""
                         else f"{call_path}/{inst.name}")
        instance_name = instance_name.replace("\\", "")

        fanins, fanouts = [], []
        nets = self.nets
        node_attrs = self.node_attrs
        for portname, arg in inst.conns:
            ptype, cap, is_clk = self._port_meta(cell_name, portname)
            netname = arg_to_str(arg)
            netname = update_netname(netname, call_path, io2arg)
            netname = netname.replace("\\", "")
            pinname = f"{instance_name}/{portname}"
            position = self._pin_position(pinname)
            ninfo = nets.get(netname)
            if ninfo is None:
                ninfo = NetInfo(netname)
                nets[netname] = ninfo
            if ptype == "fanout":
                pin_type = "drive"
                ninfo.drive_pin = pinname
                ninfo.drive_cell = cell_name
                fanouts.append(portname)
            else:
                pin_type = "sink"
                ninfo.sink_pins.append(pinname)
                ninfo.total_output_cap += cap
                fanins.append((portname, is_clk))
            node_attrs[pinname] = {
                "net": netname, "cell_type": cell_name, "port": portname,
                "pin_type": pin_type, "position": position,
                "DFF": is_dff,
            }
        for fo in fanouts:
            for fi, fi_is_clk in fanins:
                if is_reg and not fi_is_clk:
                    continue
                self.edges.append((f"{instance_name}/{fi}",
                                   f"{instance_name}/{fo}", "cell"))

    def _add_ram(self, inst, wires, io2arg, call_path):
        """SRAM macro -> per-bus-bit pin nodes; only CLK/CE pins gain
        cell edges to outputs, gated on the lib's timing_tabs.
        Reference parse_RAM, :741-829."""
        cell_name = inst.module
        fanins, fanouts = [], []
        for portname, arg in inst.conns:
            bits = expand_arg(arg, wires)
            width = len(bits)
            for i, netname in enumerate(bits):
                netname = update_netname(netname, call_path, io2arg)
                netname = netname.replace("\\", "")
                base = (f"{inst.name}" if call_path == ""
                        else f"{call_path}/{inst.name}")
                pinname = (f"{base}/{portname}[{width - 1 - i}]" if width > 1
                           else f"{base}/{portname}")
                position = self._pin_position(pinname)
                ninfo = self.nets.setdefault(netname, NetInfo(netname))
                if self.is_output_port(cell_name, portname):
                    pin_type = "drive"
                    ninfo.drive_pin = pinname
                    ninfo.drive_cell = cell_name
                    fanouts.append((pinname, portname))
                else:
                    pin_type = "sink"
                    ninfo.sink_pins.append(pinname)
                    cap = (self.cell_info_map[cell_name]["pin_info"]
                           [portname]["capacitance"])
                    if cap == "":
                        cap = "13.06"  # SRAM default sink cap (ref :806)
                    ninfo.total_output_cap += float(cap)
                    if "CLK" in portname or portname in ("CE", "CE1", "CE2"):
                        fanins.append((pinname, portname))
                self.node_attrs[pinname] = {
                    "net": netname, "cell_type": cell_name, "port": portname,
                    "pin_type": pin_type, "position": position,
                    "DFF": "DFF" in cell_name,
                }
        for fo_pin, fo_port in fanouts:
            tabs = self.cell_lib[cell_name]["pin_info"][fo_port].get(
                "timing_tabs", {})
            for fi_pin, fi_port in fanins:
                if tabs.get(fi_port) is None:
                    continue
                self.edges.append((fi_pin, fo_pin, "cell"))

    # --------------------------------------------------------- graph

    def _resolve_aliases(self):
        """Transitive assign-alias resolution (reference :1122-1150).

        Deviation (MODEL_NOTES.md #8): the reference copies the aliasee's
        NetInfo over the alias, dropping the alias net's own sinks. We
        merge the alias's sinks (and their capacitance) into the aliasee
        so the shared driver drives all of them — correct Verilog
        ``assign`` semantics.
        """
        equal_net_map = {}
        for net in self.equal_wire_map:
            tgt = self.equal_wire_map[net]
            seen = {net}
            while self.equal_wire_map.get(tgt) is not None \
                    and tgt not in seen:
                seen.add(tgt)
                tgt = self.equal_wire_map[tgt]
            equal_net_map[net] = tgt
        for net1, net2 in equal_net_map.items():
            target = self.nets.get(net2)
            if target is None:
                continue
            alias = self.nets.pop(net1, None)
            if alias is not None:
                target.sink_pins.extend(alias.sink_pins)
                target.total_output_cap += alias.total_output_cap

    def _connect_nets(self):
        """PI synthesis + net edges + bboxes + pin2outcap
        (reference :1152-1198)."""
        pin2outcap = {}
        pis: Set[str] = set()
        for net, ninfo in self.nets.items():
            drive_pin = ninfo.drive_pin
            if drive_pin == "":
                ninfo.drive_pin = net
                drive_pin = net
                position = self.pin_loc_map.get(f"{net}/{net}")
                if position is None:
                    position = self.pin_loc_map[ninfo.sink_pins[0]]
                # networkx add_nodes_from merges attrs into an existing
                # node; mirror that (a driverless net may collide with an
                # existing pin node name).
                attrs = {"net": net, "cell_type": "PI", "DFF": True,
                         "position": position}
                if net in self.node_attrs:
                    self.node_attrs[net].update(attrs)
                else:
                    self.node_attrs[net] = attrs
                bin_x, bin_y = position[2:]
                pis.add(net)
            else:
                bin_x, bin_y = self.pin_loc_map[drive_pin][2:]
            bbox = [bin_x, bin_y, bin_x, bin_y]
            pin2outcap[drive_pin] = ninfo.total_output_cap
            for sink_pin in ninfo.sink_pins:
                self.edges.append((drive_pin, sink_pin, "net"))
                key = sink_pin if "/" in sink_pin else f"{sink_pin}/{sink_pin}"
                bx, by = self.pin_loc_map[key][2:]
                bbox = [min(bbox[0], bx), min(bbox[1], by),
                        max(bbox[2], bx), max(bbox[3], by)]
            self.net_bbox_map[net] = bbox
        return pin2outcap, pis

    def _topo_levels(self, succs, pis, pos, po2path):
        """Forward BFS levels + reverse de-dup so each node lands in its
        deepest level; prune nodes in no level (reference :1452-1517)."""
        # Sorted everywhere a set feeds an ordered structure: node ids,
        # every packed array, and the .npz bytes all derive from level
        # order, so string-set iteration (PYTHONHASHSEED-dependent) would
        # make preprocessing nondeterministic across runs/workers.
        # Vectorized equivalent of the reference's frontier BFS + reverse
        # de-dup: a node's final level is the DEEPEST frontier it appears
        # in (= its longest-path distance from the PI set), computed here
        # with interned ids and a CSR successor table so the per-level
        # work is numpy gathers instead of Python set unions.
        id_of: Dict[str, int] = {}
        names: List[str] = []
        eu_l: List[int] = []
        ev_l: List[int] = []
        for u, vs in succs.items():
            ui = id_of.get(u)
            if ui is None:
                ui = len(names)
                id_of[u] = ui
                names.append(u)
            for v in vs:
                vi = id_of.get(v)
                if vi is None:
                    vi = len(names)
                    id_of[v] = vi
                    names.append(v)
                eu_l.append(ui)
                ev_l.append(vi)
        for p in pis:
            if p not in id_of:
                id_of[p] = len(names)
                names.append(p)
        n = len(names)
        eu = np.asarray(eu_l, dtype=np.int64)
        ev = np.asarray(ev_l, dtype=np.int64)
        order = np.argsort(eu, kind="stable")
        ev_sorted = ev[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(eu, minlength=n), out=indptr[1:])

        deepest = np.full(n, -1, dtype=np.int64)
        cur = np.unique(np.fromiter((id_of[p] for p in pis),
                                    dtype=np.int64, count=len(pis)))
        deepest[cur] = 0
        lvl = 0
        while cur.size:
            starts = indptr[cur]
            counts = indptr[cur + 1] - starts
            total = int(counts.sum())
            if total == 0:
                break
            base = np.repeat(starts, counts)
            within = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts)
            nxt = np.unique(ev_sorted[base + within])
            lvl += 1
            deepest[nxt] = lvl
            cur = nxt
        reach = np.nonzero(deepest >= 0)[0].tolist()
        by_level: List[List[str]] = [[] for _ in range(lvl + 1)]
        dlist = deepest.tolist()
        for i in reach:
            by_level[dlist[i]].append(names[i])
        rev = []
        for lvl_nodes in by_level:
            lvl_nodes.sort()
            targets = [nd for nd in lvl_nodes if nd in pos]
            path_ids = [po2path[t] for t in targets]
            rev.append((lvl_nodes, targets, path_ids))
        remaining = {names[i] for i in reach}
        removed = set(self.node_attrs) - remaining
        for nd in removed:
            del self.node_attrs[nd]
        self.edges = [(u, v, t) for (u, v, t) in self.edges
                      if u in self.node_attrs and v in self.node_attrs]
        return rev

    def _find_critical_path(self, preds, node2level, endpoint):
        """Greedy backtrace through level-(k-1) predecessors, stopping at
        a clk pin or level<2 (reference :1433-1450), with a no-progress
        guard the reference lacks.

        Order dependence: like the reference, the backtrace takes the
        FIRST level-(k-1) predecessor in edge-insertion order; the
        result is deterministic only because ``preds`` is built from
        ``self.edges`` whose insertion order is itself deterministic
        (module walk order + sorted level construction, see
        _topo_levels)."""
        cur_node = endpoint
        cur_level = node2level[cur_node]
        path = [endpoint]
        while cur_level >= 2:
            progressed = False
            stop = False
            for nd in preds.get(cur_node, ()):
                if "clk" in nd.lower():
                    stop = True
                    break
                if node2level.get(nd) == cur_level - 1:
                    path.append(nd)
                    cur_level -= 1
                    cur_node = nd
                    progressed = True
                    break
            if stop or not progressed:
                break
        return path

    def _check_path(self, edge_set, path):
        """Verify a report path exists edge-by-edge (reference :1040-1064)."""
        pre = path[0]
        for nd in path[1:]:
            if (pre, nd) not in edge_set:
                return False, nd
            pre = nd
        return True, None

    def _path_arcs(self, ept2path, timing_paths):
        """Per-arc bbox bin pairs for every path, flattened with the
        owning path id (non-decreasing)."""
        ax1, ay1, ax2, ay2, apath = [], [], [], [], []
        for i, info in enumerate(timing_paths):
            path = ept2path[info.end]
            for j in range(len(path) - 1):
                dl = self.pin_loc_map.get(path[j])
                dl = (self.pin_loc_map[f"{path[j]}/{path[j]}"][2:]
                      if dl is None else dl[2:])
                sl = self.pin_loc_map.get(path[j + 1])
                sl = (self.pin_loc_map[f"{path[j + 1]}/{path[j + 1]}"][2:]
                      if sl is None else sl[2:])
                ax1.append(dl[0])
                ay1.append(dl[1])
                ax2.append(sl[0])
                ay2.append(sl[1])
                apath.append(i)
        return (np.array(ax1, np.int32), np.array(ay1, np.int32),
                np.array(ax2, np.int32), np.array(ay2, np.int32),
                np.array(apath, np.int32))

    def _rasterize_masks(self, ept2path, timing_paths):
        """Per-path bbox rasterization -> COO indices (reference
        :1301-1369, masking='critical'). Uses the native C++ rasterizer
        when available (prtp_tpu_torch/native/raster.cpp), with a
        pure-Python fallback of identical semantics."""
        ax1, ay1, ax2, ay2, apath = self._path_arcs(ept2path, timing_paths)
        from ..native import rasterize_paths_native
        coo = rasterize_paths_native(ax1, ay1, ax2, ay2, apath,
                                     len(timing_paths), self.map_size)
        if coo is not None:
            return coo
        rows, cols = [], []
        for i in range(len(timing_paths)):
            sel = apath == i
            idxs = set()
            for x1, y1, x2, y2 in zip(ax1[sel], ay1[sel],
                                      ax2[sel], ay2[sel]):
                xl, xh = min(x1, x2), max(x1, x2)
                yl, yh = min(y1, y2), max(y1, y2)
                for x in range(xl, xh + 1):
                    idxs.update(range(x * self.map_size + yl,
                                      x * self.map_size + yh + 1))
            rows.extend([i] * len(idxs))
            cols.extend(sorted(idxs))
        return np.array([rows, cols], dtype=np.int64)

    # ----------------------------------------------------------- API

    def parse(self, data_dir: str):
        """Parse one design directory with the reference's fixed layout
        (reference :1392-1397). Returns a ParseResult dict."""
        netlist_path = os.path.join(data_dir, "post-place/post-place.v")
        preopt_path = os.path.join(data_dir, "post-place/path.tarpt")
        postopt_path = os.path.join(data_dir, "post-route/path.tarpt")
        pin_loc_path = os.path.join(data_dir, "positions/pin_bin.txt")

        with open(postopt_path) as f:
            parse_postopt_report(f.read(), self.db)
        self.pin_loc_map = parse_pin_locations(pin_loc_path, self.map_size)
        with open(preopt_path) as f:
            timing_paths, _, _ = parse_preopt_report(f.read(), self.db)
        with open(netlist_path) as f:
            netlist_text = f.read()
        return self.build(netlist_text, timing_paths)

    def build(self, netlist_text: str, timing_paths):
        """Netlist text + parsed timing paths -> graph dict."""
        from time import time as _time
        t_start = _time()
        modules = parse_verilog(netlist_text)
        if self.top_module not in modules:
            raise KeyError(f"top module {self.top_module} not found")
        self._walk_module(modules, self.top_module, None, None, "")
        self._resolve_aliases()
        pin2outcap, pis = self._connect_nets()

        # adjacency (preds only needed post-prune, built below)
        succs: Dict[str, list] = {}
        for u, v, _t in self.edges:
            succs.setdefault(u, []).append(v)

        # per-stage wall-clock, the reference's preprocess observability
        # surface (verilog_parser_asap7.py:1222-1224,1262-1264)
        n_cell = sum(1 for _u, _v, t in self.edges if t == "cell")
        print("--- Graph successfully built! num nodes: {}, num_edges: {},"
              " spent time: {:.2f}".format(
                  len(self.node_attrs), len(self.edges), _time() - t_start))
        print("\t num cell-edges: {}, num net-edges: {}".format(
            n_cell, len(self.edges) - n_cell))

        pos = set()
        po2path = {}
        for i, info in enumerate(timing_paths):
            pos.add(info.end)
            po2path[info.end] = i

        t_topo = _time()
        topo_levels = self._topo_levels(succs, pis, pos, po2path)
        print("\t num topological level: {}, spent time: {:.2f}".format(
            len(topo_levels), _time() - t_topo))
        node2level = {}
        for li, (nodes, _t, _p) in enumerate(topo_levels):
            for nd in nodes:
                node2level[nd] = li

        # rebuild adjacency post-prune
        succs, preds = {}, {}
        edge_set = set()
        for u, v, _t in self.edges:
            succs.setdefault(u, []).append(v)
            preds.setdefault(v, []).append(u)
            edge_set.add((u, v))

        ept2path = {}
        for info in timing_paths:
            ept2path[info.end] = self._find_critical_path(
                preds, node2level, info.end)

        missing = []
        for i, info in enumerate(timing_paths):
            ok, stop = self._check_path(edge_set, info.path)
            if not ok:
                missing.append((i, info.start, info.end, stop))
        if missing:
            detail = "; ".join(
                f"path {i}: start {s}, end {e}, stopped at {st}"
                for i, s, e, st in missing[:10])
            raise AssertionError(
                f"{len(missing)} timing paths not found in the netlist: "
                + detail)

        mask_coo = self._rasterize_masks(ept2path, timing_paths)

        return {
            "node_attrs": self.node_attrs,
            "edges": self.edges,
            "topo_levels": topo_levels,
            "timing_paths": timing_paths,
            "PIs": pis,
            "pin2outcap": pin2outcap,
            "pin2delay": self.db.pin2delay,
            "pin2trans": self.db.pin2trans,
            "mask_coo": mask_coo,
            "num_paths": len(timing_paths),
        }
