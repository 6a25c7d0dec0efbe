"""Timing-report (``.tarpt``) parser.

A copy of ``prtp_tpu/data/timing_report.py``, kept in the port
so that the port imports nothing of the JAX package.

Grammar parity with the reference (``src/verilog_parser_asap7.py:258-469``):

- A report is split into per-path blocks on the literal ``'Check with'``;
  each path's MET/VIOLATED state is the 3rd whitespace token of the last
  line *preceding* its ``Check with`` (i.e. ``Path N: STATE Setup Check
  with Pin ...``), with the first block's state coming from the preamble
  (``:357``) and subsequent states from the previous block's tail
  (``:375``).
- Within a block: ``Startpoint``/``Endpoint`` (last token),
  ``Required Time`` (last token, float), ``Data Path:`` (last token,
  arrival), and after a ``Timing Point`` header line, data rows of
  exactly 9 whitespace tokens ``pin flags arc edge cell fanout trans
  delay arrival`` (``:298-300``). ``#``-prefixed lines are skipped.
- Rows with cell ``(net)`` name nets along the path; ``(arrival)`` rows
  are skipped; an arc without ``->`` is the endpoint row and terminates
  the pin walk; a ``drive->sink`` arc appends the instance's drive and
  sink pins once the startpoint was seen, records per-pin trans/delay
  (``:314-315``), and rewrites the startpoint to the launch output pin
  when the arc's drive pin matches (``:320-324``).

The post-route report supplies labels (VIOLATED => critical) and
arrival/required times; the post-place report supplies the pin sequence,
nets and pre-route per-pin trans/delay. Must be parsed post-route first
(``:1408``) so pre-route trans/delay values win in the shared dicts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


@dataclass
class TimingPath:
    start: Optional[str] = None
    end: Optional[str] = None
    path: Optional[List[str]] = None
    nets: Optional[Set[str]] = None
    is_critical: bool = False
    required_time: float = 0.0
    arrival_time: float = 0.0


@dataclass
class ReportDB:
    """Accumulated state across both report passes."""

    timing_paths: Dict[str, TimingPath] = field(default_factory=dict)
    pin2delay: Dict[str, float] = field(default_factory=dict)
    pin2trans: Dict[str, float] = field(default_factory=dict)
    endpoints: List[str] = field(default_factory=list)


def parse_path_block(text: str, pin2delay: dict, pin2trans: dict):
    """Parse one path block. Returns
    (startpoint, endpoint, path_pins, nets, required_time, arrival_time).
    """
    startpoint, endpoint = None, None
    required_time, arrival_time = 0.0, 0.0
    path: List[str] = []
    nets: Set[str] = set()
    flag_point, flag_start = False, False
    for line in text.split("\n"):
        if "Startpoint" in line:
            startpoint = line.split(" ")[-1]
        elif "Endpoint" in line:
            endpoint = line.split(" ")[-1]
        elif "Required Time" in line:
            required_time = float(line.split(" ")[-1])
        elif "Data Path:" in line:
            arrival_time = float(line.split(" ")[-1])
        elif "Timing Point" in line:
            flag_point = True
        if line.startswith("#") or not flag_point:
            continue
        context = [c for c in line.split(" ") if c]
        if len(context) != 9:
            # header echo / separators inside the table region
            continue
        pin, _flags, arc, _edge, cell, _fanout, trans, delay, _arrival = context
        if cell == "(net)":
            if flag_start:
                nets.add(pin)
        elif cell == "(arrival)":
            continue
        elif "->" not in arc:
            path.append(pin)
            break
        else:
            pin2delay[pin] = float(delay)
            pin2trans[pin] = float(trans)
            drive_port, sink_port = arc.split("->")
            cell_name = pin[: pin.rfind("/")]
            drive_pin = cell_name + "/" + drive_port
            sink_pin = cell_name + "/" + sink_port
            if drive_pin == startpoint:
                flag_start = True
                path.append(sink_pin)
                startpoint = sink_pin
                continue
            if flag_start:
                path.append(drive_pin)
                path.append(sink_pin)
    return startpoint, endpoint, path, nets, required_time, arrival_time


def _iter_blocks(text: str):
    """Yield (block_text, state) per path, replicating the split-on-
    'Check with' + trailing-state-line convention."""
    blocks = text.split("Check with")
    state = blocks[0].split("\n")[-1].split(" ")[2]
    blocks = blocks[1:]
    for i, block in enumerate(blocks):
        yield block, state
        if i != len(blocks) - 1:
            state = block.split("\n")[-1].split(" ")[2]


def parse_postopt_report(text: str, db: ReportDB):
    """Post-route pass: creates TimingPath records keyed by endpoint with
    labels (VIOLATED => critical) and arrival/required times."""
    criticals = []
    all_paths = {}
    for i, (block, state) in enumerate(_iter_blocks(text)):
        (startpoint, endpoint, path, nets,
         required, arrival) = parse_path_block(block, db.pin2delay,
                                               db.pin2trans)
        db.endpoints.append(endpoint)
        info = TimingPath(end=endpoint, required_time=required,
                          arrival_time=arrival)
        if state == "VIOLATED":
            info.is_critical = True
            criticals.append(i)
        elif state != "MET":
            raise ValueError(f"wrong state {state} for path {i + 1}")
        db.timing_paths[endpoint] = info
        all_paths[i] = path
    return all_paths, criticals


def parse_preopt_report(text: str, db: ReportDB):
    """Post-place (pre-route) pass: fills start/path/nets of the records
    created by the post-route pass and returns them as an ordered list
    (parity with src/verilog_parser_asap7.py:389-469)."""
    all_paths = {}
    criticals = []
    for i, (block, state) in enumerate(_iter_blocks(text)):
        (startpoint, endpoint, path, nets,
         _required, _arrival) = parse_path_block(block, db.pin2delay,
                                                 db.pin2trans)
        if state == "VIOLATED":
            criticals.append(i)
        all_paths[i] = path
        info = db.timing_paths[endpoint]
        info.start = startpoint
        info.path = path
        info.nets = nets
    return list(db.timing_paths.values()), all_paths, criticals
