"""Structural (gate-level) Verilog netlist parser.

A copy of ``prtp_tpu/data/verilog.py``, kept in the port
so that the port imports nothing of the JAX package.

Replaces pyverilog for the reference's actual needs — post-placement
structural netlists (``src/verilog_parser_asap7.py:6-8,1083-1091``):
module declarations, input/output/wire declarations with bit ranges,
``assign`` aliases, and instances with named port connections whose
arguments are identifiers, bit-selects, part-selects, constants or
concatenations. No behavioral Verilog.

Hand-rolled tokenizer + recursive descent; supports escaped identifiers
(``\\foo[3].bar ``), ``//`` and ``/* */`` comments, and ``(* *)``
attributes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union


# ---------------------------------------------------------------- tokens

_PUNCT = set("()[]{};,.:#=")


def tokenize(text: str) -> List[str]:
    toks: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            i = n if j < 0 else j + 2
            continue
        if c == "(" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*)", i + 2)
            i = n if j < 0 else j + 2
            continue
        if c == "\\":  # escaped identifier: up to whitespace
            j = i + 1
            while j < n and text[j] not in " \t\r\n":
                j += 1
            toks.append(text[i:j])
            i = j
            continue
        if c in _PUNCT:
            toks.append(c)
            i += 1
            continue
        # number (possibly sized constant like 4'b0101) or identifier
        j = i
        while j < n and text[j] not in " \t\r\n" and text[j] not in _PUNCT \
                and text[j] != "\\":
            # allow ' inside sized constants
            j += 1
        tok = text[i:j]
        toks.append(tok)
        i = j
    return toks


# ------------------------------------------------------------------ AST


@dataclass
class Id:
    name: str


@dataclass
class Index:
    name: str
    idx: str  # kept as string: netlists may index with decimal ints

    def __str__(self):
        return f"{self.name}[{self.idx}]"


@dataclass
class Range:
    name: str
    msb: int
    lsb: int


@dataclass
class Const:
    value: str  # e.g. "1'b0"


@dataclass
class Concat:
    parts: List["Arg"]


Arg = Union[Id, Index, Range, Const, Concat]


@dataclass
class Decl:
    kind: str  # 'input' | 'output' | 'wire'
    name: str
    msb: int = 0
    lsb: int = 0


@dataclass
class Assign:
    lhs: Arg
    rhs: Arg


@dataclass
class Instance:
    module: str   # cell or module name
    name: str     # instance name
    conns: List[Tuple[str, Arg]] = field(default_factory=list)


@dataclass
class Module:
    name: str
    ports: List[str] = field(default_factory=list)
    decls: List[Decl] = field(default_factory=list)
    assigns: List[Assign] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)


class _Cursor:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self, k=0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, tok: str):
        t = self.next()
        if t != tok:
            raise SyntaxError(f"expected {tok!r}, got {t!r} at {self.i}")
        return t

    def done(self) -> bool:
        return self.i >= len(self.toks)


def _strip_escape(name: str) -> str:
    return name


def _parse_arg(cur: _Cursor) -> Arg:
    t = cur.next()
    if t == "{":
        parts = []
        while True:
            parts.append(_parse_arg(cur))
            if cur.peek() == ",":
                cur.next()
                continue
            cur.expect("}")
            break
        return Concat(parts)
    if "'" in t:
        return Const(t)
    name = _strip_escape(t)
    if cur.peek() == "[":
        cur.next()
        a = cur.next()
        if cur.peek() == ":":
            cur.next()
            b = cur.next()
            cur.expect("]")
            return Range(name, int(a), int(b))
        cur.expect("]")
        return Index(name, a)
    return Id(name)


def _parse_decl(cur: _Cursor, kind: str) -> List[Decl]:
    msb = lsb = 0
    if cur.peek() == "[":
        cur.next()
        msb = int(cur.next())
        cur.expect(":")
        lsb = int(cur.next())
        cur.expect("]")
    decls = []
    while True:
        name = _strip_escape(cur.next())
        decls.append(Decl(kind, name, msb, lsb))
        if cur.peek() == ",":
            cur.next()
            continue
        cur.expect(";")
        break
    return decls


def _parse_instance(cur: _Cursor, module: str) -> Instance:
    name = _strip_escape(cur.next())
    inst = Instance(module, name)
    cur.expect("(")
    if cur.peek() == ")":  # empty portlist
        cur.next()
    else:
        while True:
            cur.expect(".")
            port = cur.next()
            cur.expect("(")
            if cur.peek() == ")":  # unconnected .port()
                arg = None
            else:
                arg = _parse_arg(cur)
            cur.expect(")")
            if arg is not None:
                inst.conns.append((port, arg))
            if cur.peek() == ",":
                cur.next()
                continue
            cur.expect(")")
            break
    cur.expect(";")
    return inst


def _parse_module(cur: _Cursor) -> Module:
    name = _strip_escape(cur.next())
    mod = Module(name)
    if cur.peek() == "(":
        cur.next()
        depth = 1
        # port list may be simple names or ANSI-less lists; collect names
        while depth:
            t = cur.next()
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1
            elif t not in (",", "[", "]", ":") and "'" not in t \
                    and not t.isdigit():
                mod.ports.append(_strip_escape(t))
    cur.expect(";")
    while True:
        t = cur.next()
        if t == "endmodule":
            break
        if t in ("input", "output", "wire"):
            mod.decls.extend(_parse_decl(cur, t))
        elif t == "assign":
            lhs = _parse_arg(cur)
            cur.expect("=")
            rhs = _parse_arg(cur)
            cur.expect(";")
            mod.assigns.append(Assign(lhs, rhs))
        elif t in ("supply0", "supply1", "tri", "reg"):
            _parse_decl(cur, "wire")
        elif t == "specify":
            while cur.next() != "endspecify":
                pass
        elif t == ";":
            continue
        else:
            mod.instances.append(_parse_instance(cur, _strip_escape(t)))
    return mod


def parse_verilog(text: str) -> Dict[str, Module]:
    """Parse a structural netlist; returns {module_name: Module} in
    declaration order (dict preserves order)."""
    cur = _Cursor(tokenize(text))
    modules: Dict[str, Module] = {}
    while not cur.done():
        t = cur.next()
        if t == "module":
            m = _parse_module(cur)
            modules[m.name] = m
        # ignore anything at top level that is not a module (timescale etc.)
    return modules


def arg_to_str(arg: Arg) -> str:
    """Stringify a cell-port argument exactly like the reference's
    ``parse_cellport`` (src/verilog_parser_asap7.py:1016-1023):
    pointers as ``a[i]``, constants/identifiers verbatim."""
    if isinstance(arg, Id):
        return arg.name
    if isinstance(arg, Index):
        return str(arg)
    if isinstance(arg, Const):
        return arg.value
    if isinstance(arg, Range):
        # part-select on a leaf cell port: reference only prints these;
        # single-bit cell pins in practice. Use the msb bit.
        return f"{arg.name}[{arg.msb}]"
    raise TypeError(f"unexpected cell port arg: {arg}")


def expand_arg(arg: Arg, wires: Dict[str, Tuple[str, int, int]]) -> List[str]:
    """Expand a module-port argument into flat bit-level net names, parity
    with ``parse_arg`` (src/verilog_parser_asap7.py:27-78): identifiers
    expand over their declared range msb..lsb, part-selects over the
    given range, pointers and constants stay single."""
    out: List[str] = []
    if isinstance(arg, Concat):
        for a in arg.parts:
            out.extend(expand_arg(a, wires))
        return out
    if isinstance(arg, Id):
        if arg.name not in wires:
            raise KeyError(f"undeclared wire in argument: {arg.name}")
        _, high, low = wires[arg.name]
        if high - low + 1 == 1:
            out.append(arg.name)
        else:
            for i in range(high, low - 1, -1):
                out.append(f"{arg.name}[{i}]")
        return out
    if isinstance(arg, Const):
        out.append(arg.value)
        return out
    if isinstance(arg, Range):
        high, low = max(arg.msb, arg.lsb), min(arg.msb, arg.lsb)
        for i in range(high, low - 1, -1):
            out.append(f"{arg.name}[{i}]")
        return out
    if isinstance(arg, Index):
        out.append(str(arg))
        return out
    raise TypeError(f"unexpected module port arg: {arg}")
