"""Synthetic ASAP7-style design generator.

A copy of ``prtp_tpu/data/synthetic.py``, kept in the port
so that the port imports nothing of the JAX package.

The reference consumes external raw data (cell libraries, post-place
netlists, `.tarpt` timing reports, pin locations, CNN feature maps —
SURVEY.md §1 L0) that is not part of its repo. This generator emits a
self-consistent miniature corpus in exactly the reference's raw layout
(``src/verilog_parser_asap7.py:1392-1397``, ``src/generate_data.py:47``),
so the full pipeline — parsers, graph builder, feature extraction,
training, evaluation — can be exercised, tested and benchmarked without
the proprietary ASAP7 drops.

Each design: R timing paths; path i launches at register ``L{i}``,
propagates through a ``depth``-stage combinational chain (alternating
NAND2/INV; path 0's first two stages run through a hierarchical
submodule to exercise io2arg tracing; path 1's first stage reads an
``assign`` alias of its launch net), and is captured at ``K{i}/D``.
Roughly every third path is made VIOLATED (negative slack) in the
post-route report.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

CELLS = {
    "INVx1_ASAP7_75t_R": {
        "type": "INV", "load": 1.2, "area": 0.9, "width": 0.54,
        "height": 0.27,
        "pin_info": {
            "A": {"capacitance": "0.7", "max_capacitance": "",
                  "direction": "input"},
            "Y": {"capacitance": "", "max_capacitance": "28.0",
                  "direction": "output"},
        },
    },
    "NAND2x1_ASAP7_75t_R": {
        "type": "NAND", "load": 1.5, "area": 1.2, "width": 0.81,
        "height": 0.27,
        "pin_info": {
            "A": {"capacitance": "0.8", "max_capacitance": "",
                  "direction": "input"},
            "B": {"capacitance": "0.8", "max_capacitance": "",
                  "direction": "input"},
            "Y": {"capacitance": "", "max_capacitance": "30.0",
                  "direction": "output"},
        },
    },
    "BUFx2_ASAP7_75t_R": {
        "type": "BUF", "load": 1.1, "area": 1.0, "width": 0.54,
        "height": 0.27,
        "pin_info": {
            "A": {"capacitance": "0.6", "max_capacitance": "",
                  "direction": "input"},
            "Y": {"capacitance": "", "max_capacitance": "32.0",
                  "direction": "output"},
        },
    },
    "SRAM2RW16x16": {
        "type": "SRAM", "load": 3.0, "area": 120.0, "width": 24.0,
        "height": 5.0,
        "pin_info": {
            "CLK": {"capacitance": "2.1", "max_capacitance": "",
                    "direction": "input"},
            "CE": {"capacitance": "1.4", "max_capacitance": "",
                   "direction": "input"},
            "A": {"capacitance": "", "max_capacitance": "",
                  "direction": "input"},
            "O": {"capacitance": "", "max_capacitance": "",
                  "direction": "output"},
        },
    },
    "DFFHQNx1_ASAP7_75t_R": {
        "type": "DFFHQN", "load": 2.0, "area": 2.4, "width": 1.62,
        "height": 0.27,
        "pin_info": {
            "D": {"capacitance": "0.9", "max_capacitance": "",
                  "direction": "input"},
            "CLK": {"capacitance": "1.1", "max_capacitance": "",
                    "direction": "input"},
            "QN": {"capacitance": "", "max_capacitance": "26.0",
                   "direction": "output"},
        },
    },
}


def write_libs(rawdata_path: str):
    """Emit the library JSONs (reference L0 artifacts: cell_info_map.json,
    cell_info_map2.json, early_lib.json, ctype2id.json)."""
    os.makedirs(rawdata_path, exist_ok=True)
    with open(os.path.join(rawdata_path, "cell_info_map.json"), "w") as f:
        json.dump(CELLS, f, indent=1)
    with open(os.path.join(rawdata_path, "cell_info_map2.json"), "w") as f:
        json.dump(CELLS, f, indent=1)
    early = {
        cell: {"pin_info": {
            port: {
                "direction": info["direction"],
                **({"timing_tabs": {"CLK": {}}}
                   if info["direction"] == "output" else {}),
            } for port, info in c["pin_info"].items()
        }} for cell, c in CELLS.items()
    }
    with open(os.path.join(rawdata_path, "early_lib.json"), "w") as f:
        json.dump(early, f, indent=1)
    ctypes = sorted({c["type"] for c in CELLS.values()})
    with open(os.path.join(rawdata_path, "ctype2id.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(ctypes)}, f, indent=1)


class _Circuit:
    def __init__(self, num_paths: int, depth: int, seed: int):
        assert depth >= 2, "depth must be >= 2 (path 0 routes through sub)"
        self.R = num_paths
        self.D = depth
        # per-path chain depths vary so endpoints land on different topo
        # levels (distinguishable arrival times; exercises the per-level
        # readout like real designs)
        self.depths = [depth + (i % 3) for i in range(num_paths)]
        self.rng = np.random.default_rng(seed)
        self.positions = {}  # pin -> (x, y)

    def _pos(self, name, x, y):
        self.positions[name] = (float(x), float(y))

    def netlist(self) -> str:
        R = self.R
        pi_d = [f"pi_d{i}" for i in range(R)]
        pi_s = [f"pi_s{i}" for i in range(R)]
        lines = ["module sub ( in1, in2, out1 );",
                 "  input in1;", "  input in2;", "  output out1;",
                 "  wire w;",
                 "  NAND2x1_ASAP7_75t_R g1 ( .A(in1), .B(in2), .Y(w) );",
                 "  INVx1_ASAP7_75t_R g2 ( .A(w), .Y(out1) );",
                 "endmodule", ""]
        ports = ["clk"] + pi_d + pi_s
        lines.append(f"module top ( {', '.join(ports)} );")
        for p in ports:
            lines.append(f"  input {p};")
        wires = []
        for i in range(R):
            wires += [f"q{i}", f"qq{i}"]
            wires += [f"w{i}_{k}" for k in range(self.depths[i])]
        wires.append("alias1")
        for w in wires:
            lines.append(f"  wire {w};")
        body = []
        for i in range(R):
            y = 12 + 40 * i
            body.append(
                f"  DFFHQNx1_ASAP7_75t_R L{i} ( .D(pi_d{i}), .CLK(clk), "
                f".QN(q{i}) );")
            for pin, dx in (("D", 0), ("CLK", 1), ("QN", 2)):
                self._pos(f"L{i}/{pin}", 8 + dx, y)
            src_net = f"q{i}"
            k0 = 0
            if i == 0:
                body.append(
                    f"  sub s0 ( .in1(q0), .in2(pi_s0), .out1(w0_1) );")
                for pin, dx in (("g1/A", 0), ("g1/B", 1), ("g1/Y", 2),
                                ("g2/A", 3), ("g2/Y", 4)):
                    self._pos(f"s0/{pin}", 20 + dx, y)
                src_net = "w0_1"
                k0 = 2
            elif i == 1:
                body.append("  assign alias1 = q1;")
                src_net = "alias1"
            for k in range(k0, self.depths[i]):
                x = 20 + 30 * k
                inst = f"c{i}_{k}"
                out_net = f"w{i}_{k}"
                if k % 2 == 0:
                    body.append(
                        f"  NAND2x1_ASAP7_75t_R {inst} ( .A({src_net}), "
                        f".B(pi_s{i}), .Y({out_net}) );")
                    for pin, dx in (("A", 0), ("B", 1), ("Y", 2)):
                        self._pos(f"{inst}/{pin}", x + dx, y)
                else:
                    body.append(
                        f"  INVx1_ASAP7_75t_R {inst} ( .A({src_net}), "
                        f".Y({out_net}) );")
                    for pin, dx in (("A", 0), ("Y", 2)):
                        self._pos(f"{inst}/{pin}", x + dx, y)
                src_net = out_net
            body.append(
                f"  DFFHQNx1_ASAP7_75t_R K{i} ( .D(w{i}_{self.depths[i] - 1}), "
                f".CLK(clk), .QN(qq{i}) );")
            for pin, dx in (("D", 0), ("CLK", 1), ("QN", 2)):
                self._pos(f"K{i}/{pin}", 20 + 30 * self.depths[i] + dx, y)
        if R >= 2:
            # one SRAM macro per design: exercises parse_RAM end-to-end
            # (bus pins, timing_tabs-gated CLK/CE edges, cap defaults)
            lines.append("  wire [1:0] mem_o;")
            body.append(
                "  SRAM2RW16x16 mem0 ( .CLK(clk), .CE(pi_s0), "
                ".A({pi_d1, pi_d0}), .O(mem_o) );")
            for pin, dx in (("CLK", 0), ("CE", 1), ("A[0]", 2), ("A[1]", 3),
                            ("O[0]", 4), ("O[1]", 5)):
                self._pos(f"mem0/{pin}", 460 + dx, 480)
        lines += body
        lines.append("endmodule")
        # driverless-net pseudo-pin positions ({net}/{net} lookups)
        self._pos("clk/clk", 2, 2)
        for i in range(self.R):
            self._pos(f"pi_d{i}/pi_d{i}", 4, 12 + 40 * i)
            self._pos(f"pi_s{i}/pi_s{i}", 6, 12 + 40 * i)
        return "\n".join(lines) + "\n"

    def path_pins(self, i):
        """(startpoint, endpoint, [(pin, arc, cell)] report rows)."""
        D = self.depths[i]
        rows = []
        rows.append((f"L{i}/QN", "CLK->QN", "DFFHQNx1_ASAP7_75t_R"))
        rows.append((f"q{i}", None, "(net)"))
        if i == 0:
            rows.append(("s0/g1/Y", "A->Y", "NAND2x1_ASAP7_75t_R"))
            rows.append(("s0/w", None, "(net)"))
            rows.append(("s0/g2/Y", "A->Y", "INVx1_ASAP7_75t_R"))
            rows.append(("w0_1", None, "(net)"))
            k0 = 2
        else:
            k0 = 0
        for k in range(k0, D):
            cell = ("NAND2x1_ASAP7_75t_R" if k % 2 == 0
                    else "INVx1_ASAP7_75t_R")
            rows.append((f"c{i}_{k}/Y", "A->Y", cell))
            rows.append((f"w{i}_{k}", None, "(net)"))
        rows.append((f"K{i}/D", "D", "DFFHQNx1_ASAP7_75t_R"))
        return f"L{i}/CLK", f"K{i}/D", rows

    def report(self, post_route: bool) -> str:
        """One .tarpt report over all paths, in the block grammar the
        parser consumes (see prtp_tpu_torch.data.timing_report)."""
        out = ["# synthetic timing report"]
        jitter = 0.05 if post_route else 0.0
        for i in range(self.R):
            start, end, rows = self.path_pins(i)
            n_arcs = sum(1 for _p, a, _c in rows if a and "->" in a)
            delay = 0.2
            # arrival is a pure function of the path's arc count (chain
            # depth) so it is fully determined by observable features —
            # a per-path index term would put an un-learnable floor under
            # validation R^2 on this corpus
            arrival = round(0.1 + n_arcs * delay + jitter, 4)
            critical = post_route and (i % 3 == 2)
            required = round(arrival - 0.5, 4) if critical else 5.0
            state = "VIOLATED" if critical else "MET"
            out.append(f"Path {i + 1}: {state} Setup Check with Pin K{i}/CLK")
            out.append(f"Startpoint: {start}")
            out.append(f"Endpoint: {end}")
            out.append(f"Required Time: {required}")
            out.append(f"Data Path: {arrival}")
            out.append("# Timing Point Flags Arc Edge Cell Fanout "
                       "Trans Delay Arrival")
            out.append("#" + "-" * 60)
            acc = 0.1
            for pin, arc, cell in rows:
                if cell == "(net)":
                    out.append(f"{pin} - - - (net) 1 0.000 0.000 "
                               f"{acc:.4f}")
                    continue
                acc = round(acc + delay, 4)
                trans = 0.02 + (0.005 if post_route else 0.0)
                a = arc if arc else "-"
                out.append(f"{pin} - {a} ^ {cell} 1 {trans:.4f} "
                           f"{delay:.4f} {acc:.4f}")
        return "\n".join(out) + "\n"

    def pin_bin_txt(self) -> str:
        lines = ["=== pin locations ==="]
        for pin, (x, y) in self.positions.items():
            lines.append(f"{pin} {x} {y}")
        return "\n".join(lines) + "\n"

    def cnn_maps(self, channels=2, hw=512):
        maps = self.rng.random((channels, hw, hw)).astype(np.float32) * 0.1
        # localize some density around instance positions
        for (x, y) in self.positions.values():
            xi = min(int(x), hw - 1)
            yi = min(int(y), hw - 1)
            maps[:, max(xi - 2, 0): xi + 3, max(yi - 2, 0): yi + 3] += 0.5
        return maps


def generate_design(design_dir: str, num_paths=6, depth=4, seed=0,
                    cnn_channels=2, cnn_hw=512, top_name="top"):
    """Write one raw design directory in the reference layout."""
    c = _Circuit(num_paths, depth, seed)
    netlist = c.netlist()
    os.makedirs(os.path.join(design_dir, "post-place"), exist_ok=True)
    os.makedirs(os.path.join(design_dir, "post-route"), exist_ok=True)
    os.makedirs(os.path.join(design_dir, "positions"), exist_ok=True)
    os.makedirs(os.path.join(design_dir, "features"), exist_ok=True)
    with open(os.path.join(design_dir, "post-place/post-place.v"), "w") as f:
        f.write(netlist)
    with open(os.path.join(design_dir, "post-place/path.tarpt"), "w") as f:
        f.write(c.report(post_route=False))
    with open(os.path.join(design_dir, "post-route/path.tarpt"), "w") as f:
        f.write(c.report(post_route=True))
    with open(os.path.join(design_dir, "positions/pin_bin.txt"), "w") as f:
        f.write(c.pin_bin_txt())
    with open(os.path.join(design_dir, "features/datas.pkl"), "wb") as f:
        pickle.dump(c.cnn_maps(cnn_channels, cnn_hw), f)
    with open(os.path.join(design_dir, "top.txt"), "w") as f:
        f.write(top_name + "\n")
    return design_dir


class _BigCircuit:
    """Scale/robustness stress netlist (VERDICT r2 #6): a 50k-100k+-cell
    design exercising the fidelity-critical reference paths at size —
    3 levels of module hierarchy (top -> grp -> stage, io2arg tracing
    through two boundaries: src/verilog_parser_asap7.py:559-617), wide
    input buses with pointer args, escaped identifiers, transitive
    ``assign`` alias chains (:1122-1150), and multiple SRAM macros.

    Path i: DFF ``L{i}`` -> 2-deep assign alias chain -> ``grps``
    serial ``grp`` instances (each = ``stages`` NAND stages, every stage
    also driving a side INV load) -> DFF ``K{i}``.
    Cells ~= num_paths * grps * stages * 2 + 2 * num_paths + SRAMs.
    """

    def __init__(self, num_paths=2048, stages=8, grps=3, seed=0):
        self.R = num_paths
        self.S = stages
        self.B = grps
        self.rng = np.random.default_rng(seed)
        self.positions = {}

    def _pos(self, name, x, y):
        self.positions[name] = (float(x % 512), float(y % 512))

    def _stage_positions(self, inst_prefix, x, y):
        for pin, dx in (("n/A", 0), ("n/B", 1), ("n/Y", 2),
                        ("f0/A", 3), ("f0/Y", 4)):
            self._pos(f"{inst_prefix}/{pin}", x + dx, y)

    def netlist(self) -> str:
        R, S, B = self.R, self.S, self.B
        lines = [
            "// synthetic big stress design",
            "module stage ( in, sel, out );",
            "  input in;", "  input sel;", "  output out;",
            "  wire side;",
            "  NAND2x1_ASAP7_75t_R n ( .A(in), .B(sel), .Y(out) );",
            "  INVx1_ASAP7_75t_R f0 ( .A(out), .Y(side) );",
            "endmodule", "",
            f"module grp ( in, sel, out );",
            "  input in;", f"  input [{S - 1}:0] sel;", "  output out;",
        ]
        for k in range(S - 1):
            lines.append(f"  wire t{k};")
        for k in range(S):
            src = "in" if k == 0 else f"t{k - 1}"
            dst = "out" if k == S - 1 else f"t{k}"
            lines.append(f"  stage s{k} ( .in({src}), .sel(sel[{k}]), "
                         f".out({dst}) );")
        lines += ["endmodule", ""]

        lines.append(f"module big ( clk, pi_d, sel );")
        lines += ["  input clk;", f"  input [{R - 1}:0] pi_d;",
                  f"  input [{S - 1}:0] sel;"]
        body = []
        for i in range(R):
            y = (12 + 7 * i)
            lines.append(f"  wire q{i};")
            lines.append(f"  wire qq{i};")
            body.append(f"  DFFHQNx1_ASAP7_75t_R L{i} ( .D(pi_d[{i}]), "
                        f".CLK(clk), .QN(q{i}) );")
            for pin, dx in (("D", 0), ("CLK", 1), ("QN", 2)):
                self._pos(f"L{i}/{pin}", 2 + dx, y)
            # transitive assign alias chain (2 hops; path 0's first wire
            # is an ESCAPED identifier)
            a0 = f"\\a${i}.esc" if i == 0 else f"a{i}_0"
            lines.append(f"  wire {a0} ;")
            lines.append(f"  wire a{i}_1;")
            body.append(f"  assign {a0} = q{i};")
            body.append(f"  assign a{i}_1 = {a0} ;")
            src = f"a{i}_1"
            for b in range(B):
                out = f"h{i}_{b}"
                lines.append(f"  wire {out};")
                gname = f"g{i}_{b}"
                body.append(f"  grp {gname} ( .in({src}), .sel(sel), "
                            f".out({out}) );")
                for k in range(S):
                    self._stage_positions(f"{gname}/s{k}",
                                          16 + (b * S + k) * 9, y)
                src = out
            body.append(f"  DFFHQNx1_ASAP7_75t_R K{i} ( .D({src}), "
                        f".CLK(clk), .QN(qq{i}) );")
            for pin, dx in (("D", 0), ("CLK", 1), ("QN", 2)):
                self._pos(f"K{i}/{pin}", 16 + B * S * 9 + dx, y)
        # escaped INSTANCE name: extra off-path INV load on q0
        lines.append("  wire esc_y;")
        body.append("  INVx1_ASAP7_75t_R \\esc$inv ( .A(q0), .Y(esc_y) );")
        for pin, dx in (("A", 0), ("Y", 1)):
            self._pos(f"\\esc$inv/{pin}", 500 + dx, 500)
        # multiple SRAM macros with concat bus addresses
        for m in range(4):
            lines.append(f"  wire [1:0] mo{m};")
            body.append(
                f"  SRAM2RW16x16 mem{m} ( .CLK(clk), .CE(pi_d[{m}]), "
                f".A({{pi_d[{2 * m + 1}], pi_d[{2 * m}]}}), .O(mo{m}) );")
            for pin, dx in (("CLK", 0), ("CE", 1), ("A[0]", 2), ("A[1]", 3),
                            ("O[0]", 4), ("O[1]", 5)):
                self._pos(f"mem{m}/{pin}", 470 + dx, 460 + 8 * m)
        lines += body
        lines.append("endmodule")
        # PI pseudo-pin positions for driverless nets
        self._pos("clk/clk", 1, 1)
        for i in range(R):
            self._pos(f"pi_d[{i}]/pi_d[{i}]", 1, 12 + 7 * i)
        for k in range(S):
            self._pos(f"sel[{k}]/sel[{k}]", 1, 4 + k)
        return "\n".join(lines) + "\n"

    def path_pins(self, i):
        rows = [(f"L{i}/QN", "CLK->QN", "DFFHQNx1_ASAP7_75t_R"),
                (f"q{i}", None, "(net)")]
        for b in range(self.B):
            for k in range(self.S):
                rows.append((f"g{i}_{b}/s{k}/n/Y", "A->Y",
                             "NAND2x1_ASAP7_75t_R"))
                net = (f"h{i}_{b}" if k == self.S - 1
                       else f"g{i}_{b}/t{k}")
                rows.append((net, None, "(net)"))
        rows.append((f"K{i}/D", "D", "DFFHQNx1_ASAP7_75t_R"))
        return f"L{i}/CLK", f"K{i}/D", rows

    # report / pin_bin / cnn writers shared with the small generator
    report = _Circuit.report
    pin_bin_txt = _Circuit.pin_bin_txt
    cnn_maps = _Circuit.cnn_maps


def generate_big_design(design_dir: str, num_paths=2048, stages=8, grps=3,
                        seed=0, cnn_channels=2, cnn_hw=512,
                        top_name="big"):
    """Write one big stress design (see _BigCircuit) in the raw layout.

    Defaults give ~102k cells (2048*8*3*2 chain cells + 4096 DFFs
    + 1 escaped INV + 4 SRAMs), ~50 topo levels.
    """
    c = _BigCircuit(num_paths, stages, grps, seed)
    netlist = c.netlist()
    os.makedirs(os.path.join(design_dir, "post-place"), exist_ok=True)
    os.makedirs(os.path.join(design_dir, "post-route"), exist_ok=True)
    os.makedirs(os.path.join(design_dir, "positions"), exist_ok=True)
    os.makedirs(os.path.join(design_dir, "features"), exist_ok=True)
    with open(os.path.join(design_dir, "post-place/post-place.v"), "w") as f:
        f.write(netlist)
    with open(os.path.join(design_dir, "post-place/path.tarpt"), "w") as f:
        f.write(c.report(post_route=False))
    with open(os.path.join(design_dir, "post-route/path.tarpt"), "w") as f:
        f.write(c.report(post_route=True))
    with open(os.path.join(design_dir, "positions/pin_bin.txt"), "w") as f:
        f.write(c.pin_bin_txt())
    with open(os.path.join(design_dir, "features/datas.pkl"), "wb") as f:
        pickle.dump(c.cnn_maps(cnn_channels, cnn_hw), f)
    with open(os.path.join(design_dir, "top.txt"), "w") as f:
        f.write(top_name + "\n")
    return design_dir


def generate_corpus(rawdata_path: str, designs=("syn_a", "syn_b", "syn_c"),
                    num_paths=6, depth=4, cnn_channels=2, cnn_hw=512):
    """Library JSONs + several designs with varied sizes."""
    write_libs(rawdata_path)
    for i, name in enumerate(designs):
        generate_design(
            os.path.join(rawdata_path, name),
            num_paths=num_paths + 2 * i,
            depth=depth + i,
            seed=i,
            cnn_channels=cnn_channels,
            cnn_hw=cnn_hw,
        )
    return rawdata_path


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="generate synthetic raw designs")
    p.add_argument("--out", required=True)
    p.add_argument("--designs", nargs="+", default=["syn_a", "syn_b", "syn_c"])
    p.add_argument("--num_paths", type=int, default=None,
                   help="default 6 (small corpus) / 2048 (--big)")
    p.add_argument("--depth", type=int, default=None,
                   help="default 4 (small corpus) / 8 stages (--big)")
    p.add_argument("--cnn_channels", type=int, default=2)
    p.add_argument("--cnn_hw", type=int, default=512)
    p.add_argument("--big", action="store_true",
                   help="emit one ~100k-cell hierarchical stress design "
                        "(wide buses, escaped ids, assign chains, SRAMs) "
                        "instead of the small corpus; --num_paths/--depth "
                        "map to paths/stages-per-grp")
    args = p.parse_args(argv)
    if args.big:
        write_libs(args.out)
        generate_big_design(
            os.path.join(args.out, args.designs[0]),
            num_paths=args.num_paths if args.num_paths is not None else 2048,
            stages=args.depth if args.depth is not None else 8,
            cnn_channels=args.cnn_channels, cnn_hw=args.cnn_hw)
        print(f"wrote big stress design to {args.out}/{args.designs[0]}")
        return
    generate_corpus(args.out, args.designs,
                    args.num_paths if args.num_paths is not None else 6,
                    args.depth if args.depth is not None else 4,
                    args.cnn_channels, args.cnn_hw)
    print(f"wrote synthetic corpus to {args.out}")


if __name__ == "__main__":
    main()
